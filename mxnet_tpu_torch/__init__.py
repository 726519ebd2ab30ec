"""mxnet_tpu_torch: the PyTorch/CUDA port of mxnet_tpu, for an NVIDIA H100.

The JAX package ``mxnet_tpu`` stays the reference; this package imports
``torch`` and never ``jax`` or anything of ``mxnet_tpu``. It keeps the
JAX package's module names and layout. This release carries two paths
of the transformer LM on one card:

- serving: ``serving.Engine``, with long prompts prefilled through
  Ulysses attention on a one-device mesh, whose local attention is the
  hand-written Hopper flash-attention forward kernel
  (``ops/csrc/flash_fwd.cu``);
- training: ``parallel.ShardedTrainer`` (or ``make_train_step``) over
  ``models.transformer.loss_fn``, with gradients from ``torch.autograd``;
  the attention goes through ``ops.flash_attention.FlashAttention``, the
  forward kernel and the hand-written backward kernels
  (``ops/csrc/flash_bwd.cu``).

Entry points run on ``cuda:0`` unless given ``device=...``; without CUDA
and without a device they raise.
"""
from __future__ import annotations

__version__ = "0.1.0"

from .base import MXNetError
from .context import Context, cpu, current_context, gpu, num_devices
from . import ops
from . import models
from . import parallel
from . import serving

__all__ = ["MXNetError", "Context", "cpu", "gpu", "current_context",
           "num_devices", "ops", "models", "parallel", "serving"]
