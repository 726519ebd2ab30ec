"""mxtel: runtime observability — metrics registry, span tracer, journal.

Counterpart of ``mxnet_tpu/telemetry/``: an *off-by-default* structured
record of what the runtime did — counters/gauges/histograms per layer
(registry.py), nested spans (tracing.py), and a JSONL run journal +
Prometheus/console exporters (export.py), served live over HTTP
(server.py). In this release the serving engine, live weight sync
(``wsync/``), the serving fleet (``serving/fleet/``) and the retry and
fault-injection layer (``resilience/``) report in, under the JAX
package's metric and span names.

Enablement contract::

    MXNET_TELEMETRY=1                 # master switch (off by default)
    MXNET_TELEMETRY_JOURNAL=run.jsonl # optional JSONL run journal
    MXNET_TELEMETRY_FLUSH_SECS=10     # journal flush cadence
    MXNET_TELEMETRY_HTTP=8321         # optional live introspection
                                      # server (server.py): /metrics
                                      # /healthz /readyz /statusz
                                      # /tracez /enginez /servingz
                                      # /profilez

Instrumented hot paths guard on the module attribute ``ENABLED``::

    from . import telemetry as _tel
    ...
    if _tel.ENABLED:
        _tel.counter("serving.requests_admitted").inc()

so the disabled cost is one attribute read + truth test per site and
``span()`` returns a shared null context. ``reload()`` re-reads the
environment (tests toggle via monkeypatch.setenv + reload()).

Not in this release (ROADMAP Queue 1 item 6): the mxprof attribution
layer (``telemetry/prof.py``; ``MXNET_PROF=1`` raises here, and
``/profilez`` answers an error), the journal merger (``merge.py``) and
the report tools; the counters of the kvstore (``MXNET_TELEMETRY=1``
still raises at ``kvstore.create``), the dependency engine, the
executor and the data layer.
"""
from __future__ import annotations

import os
import time as _time

from ..base import MXNetError
from . import registry as _registry_mod
from . import tracing
from . import export
from . import server
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
    "span_aggregates", "span_tail", "snapshot",
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
    environment. Raises MXNetError under ``MXNET_PROF`` (the mxprof
    layer, ``telemetry/prof.py``, is not ported)."""
    global ENABLED
    if _env_on("MXNET_PROF"):
        raise MXNetError("MXNET_PROF: the mxprof attribution layer "
                         "(telemetry/prof.py) is not ported; unset it")
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


reload()
