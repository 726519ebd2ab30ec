"""mxtel: runtime observability — metrics registry, span tracer, journal.

Counterpart of ``mxnet_tpu/telemetry/``: an *off-by-default* structured
record of what the runtime did — counters/gauges/histograms per layer
(registry.py), nested spans (tracing.py), and a JSONL run journal +
Prometheus/console exporters (export.py), served live over HTTP
(server.py). The serving engine, live weight sync (``wsync/``), the
serving fleet (``serving/fleet/``), the dependency engine, the kvstore,
the executor, the data layer (``io.py``, ``recordio.py``), the training
loops and the guardian, and the retry and fault-injection layer
(``resilience/``) report in, under the JAX package's metric and span
names.

Enablement contract::

    MXNET_TELEMETRY=1                 # master switch (off by default)
    MXNET_TELEMETRY_JOURNAL=run.jsonl # optional JSONL run journal
    MXNET_TELEMETRY_FLUSH_SECS=10     # journal flush cadence
    MXNET_TELEMETRY_HTTP=8321         # optional live introspection
                                      # server (server.py): /metrics
                                      # /healthz /readyz /statusz
                                      # /tracez /enginez /servingz
                                      # /profilez
    MXNET_PROF=1                      # mxprof attribution layer
                                      # (prof.py, its own off-by-default
                                      # switch)

Instrumented hot paths guard on the module attribute ``ENABLED``::

    from . import telemetry as _tel
    ...
    if _tel.ENABLED:
        _tel.counter("serving.requests_admitted").inc()

so the disabled cost is one attribute read + truth test per site and
``span()`` returns a shared null context. ``reload()`` re-reads the
environment (tests toggle via monkeypatch.setenv + reload()).

Render a journal with ``tools/torch_telemetry_report.py``; merge the
journals of several ranks with ``tools/torch_trace_merge.py``
(``merge.py``).
"""
from __future__ import annotations

import os
import time as _time

from . import registry as _registry_mod
from . import tracing
from . import export
from . import server
from . import prof
from .registry import Counter, Gauge, Histogram, Registry, default_registry
from .tracing import (
    span, current_span, span_aggregates, span_tail,
    wire_context, mint_trace, open_spans, event,
)
from .export import (
    console_summary, flush_at_exit, journal_path, prometheus_text,
)

__all__ = [
    "ENABLED", "enabled", "reload", "reset", "flush",
    "counter", "gauge", "histogram", "span", "current_span",
    "span_aggregates", "span_tail", "snapshot", "prof",
    "wire_context", "mint_trace", "open_spans", "event",
    "Counter", "Gauge", "Histogram", "Registry", "default_registry",
    "console_summary", "prometheus_text", "journal_path", "flush_at_exit",
]

#: subsystem import time — /statusz uptime
_T0 = _time.time()

#: Master switch. Instrumentation reads this ONE attribute; everything
#: else in the subsystem sits behind it.
ENABLED = False


def enabled():
    return ENABLED


def _env_on(name):
    return os.environ.get(name, "").strip().lower() not in (
        "", "0", "false", "off", "no")


def reload():
    """Re-read MXNET_TELEMETRY / MXNET_TELEMETRY_JOURNAL /
    MXNET_TELEMETRY_FLUSH_SECS / MXNET_TELEMETRY_HTTP and apply them.
    Called once at import; tests call it after mutating the
    environment."""
    global ENABLED
    ENABLED = _env_on("MXNET_TELEMETRY")
    path = os.environ.get("MXNET_TELEMETRY_JOURNAL", "").strip() or None
    if not ENABLED:
        path = None
    raw = os.environ.get("MXNET_TELEMETRY_FLUSH_SECS", "").strip()
    try:
        flush_secs = float(raw) if raw else None
    except ValueError:
        flush_secs = None
    export.configure(path, flush_secs)
    # live introspection server: gated on BOTH the master switch and
    # the endpoint var — off means no thread and no socket
    http_spec = server.parse_spec(
        os.environ.get("MXNET_TELEMETRY_HTTP")) if ENABLED else None
    server.configure(http_spec)
    # mxprof (prof.py) has its own master switch (MXNET_PROF) but rides
    # the same reload cycle so one env round-trip configures both
    prof.reload()
    return ENABLED


def counter(name):
    """Process-wide named Counter (created on first use)."""
    return _registry_mod.default_registry().counter(name)


def gauge(name):
    """Process-wide named Gauge."""
    return _registry_mod.default_registry().gauge(name)


def histogram(name, capacity=Histogram.DEFAULT_CAPACITY):
    """Process-wide named Histogram (ring-buffer reservoir)."""
    return _registry_mod.default_registry().histogram(name, capacity)


def snapshot():
    """Plain-data snapshot of every registered metric."""
    return _registry_mod.default_registry().snapshot()


def flush(mark=None):
    """Flush buffered journal records (plus a metrics snapshot when
    ``mark`` is given). No-op without an active journal."""
    export.flush(mark=mark)


def reset():
    """Drop all metric and finished-span state (test isolation). Does
    not touch the enable flag or the journal file."""
    _registry_mod.default_registry().reset()
    tracing.reset()
    prof.reset()


reload()
