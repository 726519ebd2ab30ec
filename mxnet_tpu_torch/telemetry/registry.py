"""Process-wide metric registry: Counters, Gauges, streaming Histograms.

The reference's entire always-on observability is EvalMetric updates plus
LOG(INFO) lines (SURVEY §5.5); production dataflow runtimes pair trace
capture with structured counters (TensorFlow couples its runtime with
counters/timelines for the same reason, arXiv:1605.08695). This registry
is the structured half of mxtel: named metrics any runtime layer can
update cheaply, snapshotted by the exporters (export.py).

Design constraints, in priority order:

1. The *disabled* fast path in instrumented code is a single module-bool
   check (``telemetry.ENABLED``) — nothing here is ever reached.
2. The *enabled* path is a dict lookup + a locked integer/float update;
   Histogram keeps a fixed ring-buffer reservoir (no allocation per
   observe) and computes exact p50/p95/p99 over the reservoir on read.
3. Everything is thread-safe: engine worker threads, the prefetch
   producer, and the kvstore heartbeat thread all report concurrently.
"""
from __future__ import annotations

import bisect
import threading

import numpy as _np

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "default_registry"]


class Counter:
    """Monotonically increasing count (events, bytes, retries)."""

    __slots__ = ("name", "_value", "_lock")

    kind = "counter"

    def __init__(self, name):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n=1):
        # += on an int is read-modify-write, not atomic across threads
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value

    def summary(self):
        return self._value


class Gauge:
    """Last-write-wins instantaneous value (queue depth, samples/sec)."""

    __slots__ = ("name", "_value", "_lock")

    kind = "gauge"

    def __init__(self, name):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v):
        with self._lock:
            self._value = float(v)

    def inc(self, n=1):
        with self._lock:
            self._value += n

    def dec(self, n=1):
        with self._lock:
            self._value -= n

    @property
    def value(self):
        return self._value

    def summary(self):
        return self._value


class Histogram:
    """Streaming distribution over a fixed ring-buffer reservoir.

    ``observe()`` is O(1) and allocation-free: the newest ``capacity``
    observations live in a preallocated float64 ring; count/sum/min/max
    run over the full stream. Percentiles are computed on read by
    sorting the reservoir — *exact* over the window (the last
    ``capacity`` observations), which is the useful answer for runtime
    latencies: recent behavior, not epoch-0 compile spikes forever.
    """

    __slots__ = ("name", "capacity", "_buf", "_n", "_sum", "_min", "_max",
                 "_bucket_counts", "_lock")

    kind = "histogram"

    DEFAULT_CAPACITY = 2048
    QUANTILES = (50.0, 95.0, 99.0)
    #: fixed Prometheus bucket upper bounds (seconds-oriented, covering
    #: sub-ms engine tasks through multi-minute epochs); the terminal
    #: +Inf bucket is implicit (``bucket_counts`` appends it). Fixed
    #: bounds — unlike the reservoir percentiles — aggregate correctly
    #: across scrapes and ranks, which is what makes the ``_bucket``
    #: exposition families on /metrics real histograms.
    BOUNDS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
              0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 300.0)

    def __init__(self, name, capacity=DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError("histogram capacity must be >= 1, got %r"
                             % (capacity,))
        self.name = name
        self.capacity = int(capacity)
        self._buf = _np.empty(self.capacity, dtype=_np.float64)
        self._n = 0
        self._sum = 0.0
        self._min = None
        self._max = None
        # per-bound observation counts (non-cumulative; +Inf overflow
        # bucket last) — cumulated on read, O(1) per observe
        self._bucket_counts = [0] * (len(self.BOUNDS) + 1)
        self._lock = threading.Lock()

    def observe(self, v):
        v = float(v)
        idx = bisect.bisect_left(self.BOUNDS, v)
        with self._lock:
            self._buf[self._n % self.capacity] = v
            self._n += 1
            self._sum += v
            self._bucket_counts[idx] += 1
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v

    def bucket_counts(self):
        """[(upper_bound, cumulative_count)] over the FULL stream (not
        the reservoir window), Prometheus ``le`` semantics — the last
        entry is ``(inf, total count)``."""
        with self._lock:
            counts = list(self._bucket_counts)
        out = []
        cum = 0
        for le, c in zip(self.BOUNDS + (float("inf"),), counts):
            cum += c
            out.append((le, cum))
        return out

    @property
    def count(self):
        return self._n

    @property
    def sum(self):
        return self._sum

    def _window(self):
        """Sorted copy of the reservoir contents (under the lock)."""
        with self._lock:
            filled = min(self._n, self.capacity)
            win = self._buf[:filled].copy()
        win.sort()
        return win

    def percentile(self, q):
        """Exact q-th percentile of the reservoir window, linearly
        interpolated between order statistics (numpy's default method,
        so tests can diff against ``np.percentile`` directly)."""
        win = self._window()
        n = win.shape[0]
        if n == 0:
            return None
        pos = (q / 100.0) * (n - 1)
        lo = int(pos)
        frac = pos - lo
        if lo + 1 >= n:
            return float(win[-1])
        return float(win[lo] * (1.0 - frac) + win[lo + 1] * frac)

    def percentiles(self, qs=QUANTILES):
        win = self._window()
        n = win.shape[0]
        out = {}
        for q in qs:
            if n == 0:
                out[q] = None
                continue
            pos = (q / 100.0) * (n - 1)
            lo = int(pos)
            frac = pos - lo
            if lo + 1 >= n:
                out[q] = float(win[-1])
            else:
                out[q] = float(win[lo] * (1.0 - frac) + win[lo + 1] * frac)
        return out

    def summary(self):
        with self._lock:
            count, total = self._n, self._sum
            mn, mx = self._min, self._max
        ps = self.percentiles()
        return {
            "count": count, "sum": total, "min": mn, "max": mx,
            "p50": ps[50.0], "p95": ps[95.0], "p99": ps[99.0],
        }


class Registry:
    """Named metric table. ``counter/gauge/histogram`` get-or-create;
    asking for an existing name with a different kind is a bug and
    raises (two layers silently sharing one metric under different
    semantics would corrupt both)."""

    def __init__(self):
        self._metrics = {}
        self._lock = threading.Lock()

    def _get(self, name, cls, **kwargs):
        m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, cls):
                raise TypeError(
                    "metric %r already registered as %s, not %s"
                    % (name, m.kind, cls.kind))
            return m
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, **kwargs)
            elif not isinstance(m, cls):
                raise TypeError(
                    "metric %r already registered as %s, not %s"
                    % (name, m.kind, cls.kind))
            return m

    def counter(self, name):
        return self._get(name, Counter)

    def gauge(self, name):
        return self._get(name, Gauge)

    def histogram(self, name, capacity=Histogram.DEFAULT_CAPACITY):
        return self._get(name, Histogram, capacity=capacity)

    def metrics(self):
        """Stable-order snapshot of the live metric objects."""
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def snapshot(self):
        """{"counters": {...}, "gauges": {...}, "histograms": {...}} —
        plain data, safe to json-dump (the journal's metrics record)."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for m in self.metrics():
            out[m.kind + "s"][m.name] = m.summary()
        return out

    def reset(self):
        """Drop every metric (test isolation; conftest fixture)."""
        with self._lock:
            self._metrics.clear()


_default = Registry()


def default_registry():
    return _default
