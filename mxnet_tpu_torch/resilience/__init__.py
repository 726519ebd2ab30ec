"""Fault injection, retry and the training guardian (counterpart of
``mxnet_tpu/resilience/``).

- ``faults`` — deterministic injection points (``faults.point(name)``)
  driven by the seeded ``MXNET_FAULT_SPEC`` or ``inject()``: ``kv.coord``
  before every fleet-router and wsync-client RPC, ``rio.read`` at
  RecordIO reads, ``engine.task`` before every dependency-engine task
  body, ``ckpt.write`` between a checkpoint's temporary file and its
  rename, ``grad.nan``/``loss.spike`` on the gradients of the fits;
- ``retry`` — ``RetryPolicy`` (exponential backoff with jitter) and
  ``run_with_deadline``;
- ``guardian`` — the training-run guardian (``MXNET_GUARDIAN=1``):
  on-device non-finite gradient sentinels, EMA/z-score anomaly
  detection, coordinated skip-steps, rollback-to-last-good (snapshot
  ring, then the newest on-disk checkpoint).

``faults`` and ``retry`` are byte copies of the JAX package's modules.
"""
from __future__ import annotations

from . import faults, guardian, retry
from .faults import FaultInjected, clear, inject, parse_spec, point
from .guardian import (
    AnomalyDetector, GuardianConfig, MetricLossFeed, SnapshotRing,
    TrainingGuardian, UpdaterSentinel, corrupt_grad, fast_forward,
    grad_fault_multiplier, restore_updater_states, snapshot_updater_states,
    zero_updater_states,
)
from .retry import DeadlineExceeded, RetryPolicy, run_with_deadline

__all__ = [
    "faults", "guardian", "retry",
    "FaultInjected", "point", "inject", "clear", "parse_spec",
    "TrainingGuardian", "GuardianConfig", "AnomalyDetector",
    "SnapshotRing", "UpdaterSentinel", "MetricLossFeed",
    "snapshot_updater_states", "restore_updater_states",
    "zero_updater_states", "corrupt_grad", "grad_fault_multiplier",
    "fast_forward",
    "RetryPolicy", "DeadlineExceeded", "run_with_deadline",
]
