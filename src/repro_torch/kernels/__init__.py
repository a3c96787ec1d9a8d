"""Kernels of the port: CUDA C++ for Hopper (``csrc/``), their ctypes
wrappers, and the plain PyTorch versions they are held against."""
