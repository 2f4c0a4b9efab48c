"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``), their plain
PyTorch versions and the nvcc build that loads them with ctypes."""
