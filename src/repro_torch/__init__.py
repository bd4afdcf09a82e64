"""PyTorch/CUDA port of the multiway hash-join engine, for NVIDIA Hopper.

Mirrors the paths of the JAX package (``core/``, ``kernels/``,
``perfmodel/``, ``analysis/``, and of its LM stack ``configs/``,
``models/``, ``train/``, ``launch/`` for the dense, MoE and VLM
families' serving and training).  Plain tensor code is PyTorch; the kernels are CUDA C++ under
``kernels/csrc/``, built for ``sm_90a`` at first use.  Entry points run on
the card unless the caller passes ``device="cpu"``.
"""
