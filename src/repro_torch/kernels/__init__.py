"""Fused partition-sweep kernels: CUDA C++ for Hopper (``csrc/``, built and
bound by ``cuda``) beside their plain PyTorch versions (``ops``)."""
