"""mxtel exporters: JSONL run journal, Prometheus text, console summary.

The journal is the queryable record of what the runtime did: one JSON
object per line, either a finished span or a metrics snapshot::

    {"kind": "span", "name": "epoch", "id": 7, "parent": null,
     "t": 1722700000.1, "dur": 12.03, "thread": "MainThread"}
    {"kind": "metrics", "t": ..., "mark": "periodic",
     "counters": {...}, "gauges": {...}, "histograms": {...}}

Activated by ``MXNET_TELEMETRY=1`` + ``MXNET_TELEMETRY_JOURNAL=<path>``
(telemetry.reload() reads both). Spans buffer in memory and hit disk on
the periodic flusher (``MXNET_TELEMETRY_FLUSH_SECS``, default 10 — each
flush also appends a ``mark="periodic"`` metrics snapshot, which is what
gives the report tool its throughput timeline), on explicit
``telemetry.flush()``, and finally at interpreter exit: the engine's
exit drain calls :func:`flush_at_exit` after pending host tasks land,
and an atexit hook (registered before the engine's, so it runs after —
atexit is LIFO) closes the journal either way.

``tools/telemetry_report.py`` renders a journal; :func:`prometheus_text`
and :func:`console_summary` serve scrape endpoints and humans.
"""
from __future__ import annotations

import atexit
import json
import os
import threading
import time

from . import registry as _registry
from . import tracing as _tracing

__all__ = [
    "configure", "emit", "flush", "flush_at_exit", "close",
    "journal_path", "prometheus_text", "console_summary",
]

DEFAULT_FLUSH_SECS = 10.0

_lock = threading.Lock()
_path = None
_file = None
_buffer = []
_flush_secs = DEFAULT_FLUSH_SECS
_flusher = None
_flusher_stop = None
_exit_snapshot_done = False


def journal_path():
    """The configured journal path, or None when journaling is off."""
    return _path


def configure(path, flush_secs=None):
    """(Re)configure the journal target. Same path is a no-op so
    ``telemetry.reload()`` is idempotent; a changed path (including
    None) flushes and closes the previous journal first."""
    global _path, _flush_secs, _exit_snapshot_done
    if flush_secs is None or flush_secs <= 0:
        flush_secs = DEFAULT_FLUSH_SECS
    with _lock:
        same = (path == _path)
        _flush_secs = float(flush_secs)
    if same:
        return
    close()
    with _lock:
        _path = path
        _exit_snapshot_done = False


def emit(record):
    """Queue one journal record (no-op when no journal is configured).
    Called from span exits and instrumentation; must never raise. The
    first record opens the journal and starts the periodic flusher —
    a run that never emits never touches the filesystem."""
    if _path is None:
        return
    with _lock:
        if _path is None:
            return
        _open_locked()
        if _path is None:  # open failed: journaling disabled itself
            return
        _buffer.append(record)


def _open_locked():
    """Open the journal file + start the periodic flusher. Caller holds
    the lock."""
    global _file, _flusher, _flusher_stop, _path
    if _file is not None or _path is None:
        return
    d = os.path.dirname(os.path.abspath(_path))
    try:
        os.makedirs(d, exist_ok=True)
        _file = open(_path, "a", encoding="utf-8")
    except OSError:
        # an unwritable journal must not take training down — disable
        # journaling entirely (metrics/spans stay queryable in-process).
        # Buffering on would grow without bound: no file means no
        # flusher thread ever drains the buffer.
        import logging

        logging.warning(
            "mxtel: journal %r is unwritable; journaling disabled "
            "(metrics remain available in-process)", _path)
        _file = None
        _path = None
        _buffer[:] = []
        return
    # identity header: trace_merge (tools/trace_merge.py) reads the
    # rank from the journal itself instead of trusting file names
    _buffer.insert(0, {
        "kind": "meta", "t": time.time(), "pid": os.getpid(),
        "rank": int(os.environ.get("MXNET_PROC_ID", "0") or 0),
        "world": int(os.environ.get("MXNET_NUM_PROCS", "1") or 1),
    })
    stop = _flusher_stop = threading.Event()
    # a zero/negative cadence would busy-loop the flusher thread
    secs = _flush_secs if _flush_secs > 0 else DEFAULT_FLUSH_SECS

    def _run():
        while not stop.wait(secs):
            try:
                flush(mark="periodic")
            except Exception:
                pass

    _flusher = threading.Thread(
        target=_run, name="mxtel-journal-flush", daemon=True)
    _flusher.start()


def _metrics_record(mark):
    snap = _registry.default_registry().snapshot()
    snap.update({"kind": "metrics", "t": time.time(), "mark": mark})
    return snap


def flush(mark=None):
    """Write buffered records to the journal; with ``mark`` also append
    a metrics snapshot record tagged with it (``periodic`` from the
    flusher, ``test_end`` from the suite fixture, ``exit`` at
    shutdown). No-op without a configured journal."""
    global _exit_snapshot_done
    if _path is None:
        return
    with _lock:
        if _path is None:
            return
        _open_locked()
        recs, _buffer[:] = list(_buffer), []
        if mark is not None:
            recs.append(_metrics_record(mark))
        if mark == "exit":
            # an explicit exit flush (controller/replica teardown,
            # chaos workloads) must suppress the atexit hook's own exit
            # snapshot: counter-folding harnesses SUM exit records, and
            # a doubled snapshot doubles every total
            _exit_snapshot_done = True
        if _file is None or not recs:
            return
        for r in recs:
            _file.write(json.dumps(r) + "\n")
        _file.flush()


def flush_at_exit():
    """Final flush: buffered spans + one ``mark="exit"`` metrics
    snapshot (written at most once — the engine drain hook and the
    atexit hook both funnel here)."""
    global _exit_snapshot_done
    if _path is None:
        return
    with _lock:
        done, _exit_snapshot_done = _exit_snapshot_done, True
    try:
        flush(mark=None if done else "exit")
    except Exception:
        pass


def close():
    """Final flush, then stop the flusher and release the file."""
    global _file, _flusher, _flusher_stop, _path
    flush_at_exit()
    with _lock:
        stop, _flusher_stop, _flusher = _flusher_stop, None, None
        f, _file = _file, None
        _path = None
        _buffer[:] = []
    if stop is not None:
        stop.set()
    if f is not None:
        try:
            f.close()
        except OSError:
            pass


# Registered at import: telemetry is imported before the engine module
# in package init, so this atexit hook runs AFTER the engine's exit
# drain (atexit is LIFO) — metrics from host tasks completing during the
# drain still make the journal.
atexit.register(flush_at_exit)


# -- human/scrape renderers ----------------------------------------------------
def _prom_name(name):
    out = []
    for ch in name:
        out.append(ch if ch.isalnum() or ch == "_" else "_")
    return "mxtpu_" + "".join(out)


def prometheus_text():
    """Prometheus exposition-format dump of the live registry.

    Histograms render as REAL histogram families — cumulative
    ``_bucket{le="..."}`` series over the registry's fixed bounds plus
    ``_sum``/``_count`` — so server-side aggregation (rate, quantile
    estimation across ranks) works the way Prometheus intends. The
    older quantile-labelled lines (reservoir-exact p50/p95/p99)
    ride along under the same metric name for dashboard backward
    compatibility; scrapers that only understand the histogram family
    ignore them."""
    lines = []
    for m in _registry.default_registry().metrics():
        pn = _prom_name(m.name)
        if m.kind == "counter":
            lines.append("# TYPE %s counter" % pn)
            lines.append("%s %d" % (pn, m.value))
        elif m.kind == "gauge":
            lines.append("# TYPE %s gauge" % pn)
            lines.append("%s %g" % (pn, m.value))
        else:
            s = m.summary()
            lines.append("# TYPE %s histogram" % pn)
            for le, cum in m.bucket_counts():
                lines.append('%s_bucket{le="%s"} %d'
                             % (pn, "+Inf" if le == float("inf")
                                else ("%g" % le), cum))
            lines.append("%s_sum %g" % (pn, s["sum"]))
            lines.append("%s_count %d" % (pn, s["count"]))
            # backward-compat: the reservoir-exact percentile gauges
            for q, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
                if s[key] is not None:
                    lines.append('%s{quantile="%g"} %g' % (pn, q, s[key]))
    return "\n".join(lines) + ("\n" if lines else "")


def console_summary(top=10):
    """One readable block: counters, gauges, histogram percentiles, and
    the top spans by total time. The quick look when you don't want the
    journal + report tool round trip."""
    reg = _registry.default_registry()
    lines = ["=== mxtel summary ==="]
    snap = reg.snapshot()
    if snap["counters"]:
        lines.append("counters:")
        for k, v in sorted(snap["counters"].items()):
            lines.append("  %-42s %d" % (k, v))
    if snap["gauges"]:
        lines.append("gauges:")
        for k, v in sorted(snap["gauges"].items()):
            lines.append("  %-42s %g" % (k, v))
    if snap["histograms"]:
        lines.append("histograms (secs unless noted):")
        lines.append("  %-42s %8s %10s %10s %10s %10s" % (
            "name", "count", "p50", "p95", "p99", "max"))
        for k, s in sorted(snap["histograms"].items()):
            lines.append("  %-42s %8d %10.6g %10.6g %10.6g %10.6g" % (
                k, s["count"], s["p50"] or 0, s["p95"] or 0,
                s["p99"] or 0, s["max"] or 0))
    aggs = _tracing.span_aggregates()
    if aggs:
        lines.append("top spans by total time:")
        lines.append("  %-30s %8s %12s %12s" % (
            "span", "count", "total_s", "max_s"))
        ranked = sorted(aggs.items(), key=lambda kv: -kv[1]["total"])[:top]
        for name, a in ranked:
            lines.append("  %-30s %8d %12.6g %12.6g" % (
                name, a["count"], a["total"], a["max"]))
    return "\n".join(lines)
