"""The plain reference that decides ``correct``: PyTorch and NumPy only. It
imports neither JAX nor the JAX package nor anything of the program, and
takes from the program nothing it made: it works the int8 scales and
weights, the network's outputs, the loss and the optimizer's update out
again from the benchmark's own inputs."""
