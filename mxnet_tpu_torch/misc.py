"""Deprecated scheduler aliases (ref: python/mxnet/misc.py — the
pre-lr_scheduler module some 2016-era scripts still import)."""
from __future__ import annotations

import warnings

from .lr_scheduler import FactorScheduler as _FactorScheduler
from .lr_scheduler import LRScheduler as _LRScheduler

__all__ = ["LearningRateScheduler", "FactorScheduler"]


class LearningRateScheduler(_LRScheduler):
    """ref misc.py:7; superseded by lr_scheduler.LRScheduler."""

    def __init__(self, *args, **kwargs):
        warnings.warn("mxnet_tpu_torch.misc is deprecated; use "
                      "mxnet_tpu_torch.lr_scheduler", DeprecationWarning)
        super().__init__(*args, **kwargs)


class FactorScheduler(_FactorScheduler):
    """ref misc.py:24; superseded by lr_scheduler.FactorScheduler."""

    def __init__(self, *args, **kwargs):
        warnings.warn("mxnet_tpu_torch.misc is deprecated; use "
                      "mxnet_tpu_torch.lr_scheduler", DeprecationWarning)
        super().__init__(*args, **kwargs)
