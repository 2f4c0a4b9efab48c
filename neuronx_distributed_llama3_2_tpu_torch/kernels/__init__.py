"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``), their plain
PyTorch versions and the nvcc build that loads them with ctypes; and the
context-parallel rings, which run K1-K3 on sequence chunks."""
