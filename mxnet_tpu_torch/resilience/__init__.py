"""Fault injection and retry (counterpart of ``mxnet_tpu/resilience/``).

- ``faults`` — deterministic injection points (``faults.point(name)``)
  driven by the seeded ``MXNET_FAULT_SPEC`` or ``inject()``; in this
  release the fleet router and the wsync client fire ``kv.coord``
  before every RPC;
- ``retry`` — ``RetryPolicy`` (exponential backoff with jitter) and
  ``run_with_deadline``.

Both are byte copies of the JAX package's modules. The training
guardian (``guardian.py``, ``MXNET_GUARDIAN``) is not in this release
(ROADMAP Queue 1 item 6).
"""
from __future__ import annotations

from . import faults, retry
from .faults import FaultInjected, clear, inject, parse_spec, point
from .retry import DeadlineExceeded, RetryPolicy, run_with_deadline

__all__ = [
    "faults", "retry",
    "FaultInjected", "point", "inject", "clear", "parse_spec",
    "RetryPolicy", "DeadlineExceeded", "run_with_deadline",
]
