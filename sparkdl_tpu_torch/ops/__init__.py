"""Kernels of the port: a plain PyTorch version and a hand-written
CUDA kernel for each, dispatched on the device of the inputs."""
