"""Kernels of the port, each beside its plain PyTorch version.

- :mod:`.flash_attention` — flash attention: the forward (Hopper CUDA
  kernel ``csrc/flash_fwd.cu``), the backward (``csrc/flash_bwd.cu``),
  their plain versions and the ``FlashAttention`` autograd function.
"""
