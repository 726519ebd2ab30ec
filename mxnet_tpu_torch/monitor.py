"""Monitor: per-op output statistics for debugging
(ref: python/mxnet/monitor.py:1-119, Executor::SetMonitorCallback
include/mxnet/symbolic.h:386).

The port's copy of ``mxnet_tpu/monitor.py``; only the prose differs.
The executor taps each op output inline as its graph walk makes it
(``Executor.set_monitor_callback``), in node order, then ``toc`` adds
the argument arrays.
"""
from __future__ import annotations

import logging
import re

from .ndarray import NDArray


class Monitor:
    """Per-op tensor tap (ref: python/mxnet/monitor.py Monitor).

    PERFORMANCE: every tapped tensor is copied to the host for its
    statistic, and the interval only limits how often stats PRINT: a
    monitor is for debugging, not training runs."""

    def __init__(self, interval, stat_func=None, pattern=".*", sort=False,
                 nan_aware=False):
        if stat_func is None:
            def asum_stat(x):
                """|x|/size(x), the reference default."""
                return x.__abs__().asnumpy().sum() / x.size

            stat_func = asum_stat
        self.stat_func = stat_func
        self.interval = interval
        self.activated = False
        self.queue = []
        self.step = 0
        self.exes = []
        self.re_prog = re.compile(pattern)
        self.sort = sort
        # the JAX package's extension (guardian debugging): nan_aware
        # additionally counts non-finite elements per tapped
        # tensor, in TAP ORDER — when a run goes NaN, first_nonfinite()
        # names the earliest op output that went bad, which is the layer
        # the numerical fault originated in (everything downstream is
        # contamination)
        self.nan_aware = bool(nan_aware)
        self.nonfinite = []  # (step, name, bad_count) in tap order

    def stat_helper(self, name, arr):
        if not self.activated or not self.re_prog.match(name):
            return
        if self.nan_aware:
            import numpy as _np

            a = arr.asnumpy() if isinstance(arr, NDArray) else _np.asarray(arr)
            bad = int(a.size - _np.count_nonzero(_np.isfinite(a)))
            if bad:
                self.nonfinite.append((self.step, name, bad))
                self.queue.append(
                    (self.step, name, "NONFINITE(%d/%d)" % (bad, a.size)))
                return
        self.queue.append((self.step, name, self.stat_func(arr)))

    def first_nonfinite(self):
        """The earliest (step, name, bad_count) record whose tensor held
        non-finite values — which layer went bad FIRST — or None.
        Records accumulate across toc() calls (they are the forensic
        trail, not a per-interval stat); reset_nonfinite() clears."""
        return self.nonfinite[0] if self.nonfinite else None

    def reset_nonfinite(self):
        self.nonfinite = []

    def install(self, exe):
        """ref: monitor.py:55."""
        exe.set_monitor_callback(self.stat_helper)
        self.exes.append(exe)

    def tic(self):
        """ref: monitor.py:63."""
        if self.step % self.interval == 0:
            for exe in self.exes:
                for array in exe.arg_arrays:
                    array.wait_to_read()
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        """ref: monitor.py:76."""
        if not self.activated:
            return []
        for exe in self.exes:
            for array in exe.arg_arrays:
                array.wait_to_read()
        for exe in self.exes:
            for name, array in zip(exe._arg_names, exe.arg_arrays):
                self.stat_helper(name, array)
        self.activated = False
        res = []
        if self.sort:
            self.queue.sort(key=lambda x: x[1])
        for n, k, v_list in self.queue:
            res.append((n, k, str(v_list)))
        self.queue = []
        return res

    def toc_print(self):
        res = self.toc()
        for n, k, v in res:
            logging.info("Batch: %7d %30s %s", n, k, v)
