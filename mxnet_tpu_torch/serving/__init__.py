"""mxserve on PyTorch: paged-KV continuous-batching inference.

- :mod:`.kv_cache` — paged KV pool on the card + free-list allocator;
- :mod:`.model` — bucketed ragged step over the transformer params, and
  the context-parallel long-prompt prefill :func:`cp_prefill_kv`;
- :mod:`.sampling` — greedy and sampled draws on JAX's threefry bits
  (:mod:`mxnet_tpu_torch.threefry`);
- :mod:`.scheduler` — continuous batching (host-only copy);
- :mod:`.engine` — ``Engine.submit(prompt) -> stream of tokens``, plain
  or speculative (draft + verify), the synchronous ``generate``,
  drain/resume, live weight sync (``install_weights``,
  ``rollback_weights``) and the ``serving.*`` telemetry catalog;
- :mod:`.fleet` — replicas behind a health-routed router, redelivering
  every stream of a dead replica on a survivor.
"""
from __future__ import annotations

from .engine import (Engine, QueueFullError, ServingConfig, StreamHandle,
                     live_engines)
from .kv_cache import PagedKVPool, blocks_for_tokens
from .model import ServingModel, cp_prefill_kv
from .scheduler import Request, Scheduler, StepPlan

__all__ = [
    "Engine", "ServingConfig", "StreamHandle", "QueueFullError",
    "PagedKVPool", "blocks_for_tokens", "ServingModel", "cp_prefill_kv",
    "Request", "Scheduler", "StepPlan", "live_engines",
]
