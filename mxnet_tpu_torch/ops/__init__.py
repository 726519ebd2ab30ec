"""Kernels of the port, each beside its plain PyTorch version.

- :mod:`.flash_attention` — the flash-attention forward (Hopper CUDA
  kernel ``csrc/flash_fwd.cu``) and ``attention_reference``.
"""
