"""PyTorch/CUDA port of the multiway hash-join engine, for NVIDIA Hopper.

Mirrors the paths of the JAX package (``core/``, ``kernels/``,
``perfmodel/``, ``analysis/``).  Plain tensor code is PyTorch; the fused
partition-sweep kernels are CUDA C++ under ``kernels/csrc/``, built for
``sm_90a`` at first use.  Entry points run on the card unless the caller
passes ``device="cpu"``.
"""
