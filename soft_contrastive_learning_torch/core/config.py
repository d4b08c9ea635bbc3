"""Model configuration, trimmed to what the serving path runs.

Own copy of ``soft_contrastive_learning_tpu/core/config.py::ModelConfig``
(the port imports nothing of the JAX package). Defaults are the flagship:
VGG16 + NetVLAD-64 at 180x240, bf16 convs, raw 32,768-D descriptor.
``use_kernels`` is the counterpart of ``use_pallas``: the NetVLAD
aggregation goes through the hand-written CUDA kernel on a CUDA device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class ModelConfig:
    vlad_cores: int = 64
    reduction: str = "none"
    out_dim: int = 512
    image_height: int = 180
    image_width: int = 240
    channels: int = 3
    compute_dtype: str = "bfloat16"  # activations dtype for the conv stack
    param_dtype: str = "float32"
    use_kernels: bool = True  # NetVLAD aggregation through K1 on CUDA

    def __post_init__(self):
        if self.reduction != "none":
            raise NotImplementedError(
                f"reduction={self.reduction!r} comes with the model/loss-zoo "
                "slice of the port; this slice serves reduction='none'")
        if self.vlad_cores <= 0:
            raise NotImplementedError(
                "vlad_cores=0 (flattened VGG16 map / SPP) comes with the "
                "model/loss-zoo slice of the port; this slice serves NetVLAD")

    @property
    def descriptor_dim(self) -> int:
        """Raw descriptor dimensionality before reduction."""
        return self.vlad_cores * 512

    @property
    def output_dim(self) -> int:
        """Dimensionality after the reduction head ('none': the raw one)."""
        return self.descriptor_dim


def torch_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dtype


def resolve_device(device: str | torch.device) -> torch.device:
    """The device to run on. A CUDA device without a usable card raises:
    nothing silently runs on the CPU instead."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return device
