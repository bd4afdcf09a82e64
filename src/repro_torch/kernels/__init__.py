"""Hand-written Hopper kernels: CUDA C++ (``csrc/``, built and bound by
``cuda``) beside their plain PyTorch versions (``ops`` for the join
kernels and the radix histogram, ``flash_attention`` for the attention
forward)."""
