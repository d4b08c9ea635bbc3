"""PyTorch/CUDA port of soft_contrastive_learning_tpu for NVIDIA Hopper.

Mirrors the JAX package's module paths. It imports ``torch`` and never JAX,
and nothing of ``soft_contrastive_learning_tpu``: what it needs from there it
keeps as its own copy. Hand-written CUDA kernels live under
``ops/kernels/csrc`` and build with nvcc at first use.
"""
