"""mxdash: live introspection HTTP server over the mxtel registry.

Counterpart of ``mxnet_tpu/telemetry/server.py``: serves the in-process
mxtel state of a running trainer or serving engine over plain HTTP:

====================  =========================================================
``/healthz``          liveness probe (200 ``ok``)
``/readyz``           readiness probe: alive AND accepting work — 503 while
                      the process is marked starting/stopping
                      (:func:`mark_ready`) or any serving engine is draining
``/metrics``          Prometheus exposition text (export.prometheus_text)
``/statusz``          uptime, rank/world, MXNET_* env config, compile
                      counters (JSON)
``/tracez``           currently-open spans + the recent finished-span ring
                      (``?n=`` bounds the tail; JSON)
``/enginez``          dependency-engine pending count, queued + in-flight
                      task dump (the wait watchdog's introspection, live;
                      ``{"engine": null}`` before the engine exists)
``/servingz``         live serving-request table, KV-pool utilization,
                      scheduler event tail for every serving Engine
``/profilez``         mxprof attribution (prof.py, ``MXNET_PROF=1``): top
                      programs by device time with their analytic flops
                      and first-call peak memory, step-time
                      decomposition, derived MFU/roofline%, device
                      memory live/peak
====================  =========================================================

Enablement: ``MXNET_TELEMETRY=1`` plus ``MXNET_TELEMETRY_HTTP=<port>``
(``host:port`` to pick an interface; bare ports bind loopback — the
same trusted-network posture as the elastic coordinator; port ``0``
binds an ephemeral port, read back via :func:`port`). Off by default:
without both variables no thread starts and no socket is opened —
:func:`configure` with None is a pure no-op on a never-started server.

The server is read-only (GET only) and deliberately stdlib-only: one
daemon ``ThreadingHTTPServer`` whose handlers read the registry/tracer
snapshots under their own locks. Handlers never take a lock of this
module while calling into other subsystems — the module lock guards
only the start/stop hand-off.
"""
from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time

from . import registry as _registry
from . import tracing as _tracing

__all__ = ["configure", "port", "running", "mark_ready", "is_ready"]

_lock = threading.Lock()
_server = None
_thread = None
_bound = None        # (host, port) actually bound
_started_t = None

# process-level readiness: /readyz (alive AND accepting work) vs
# /healthz (alive). Defaults ready so plain jobs need no opt-in; a
# replica that warms up before taking traffic calls
# mark_ready(False, "starting") first — but user code only runs AFTER
# package import, and the server answers DURING it, so a supervisor
# that must never see a booting replica as ready exports
# MXNET_TELEMETRY_READY=0 (mxctl does this for supervised replicas):
# the process then starts not-ready until its own mark_ready(True).
# Serving engines additionally gate readiness on their drain state
# (Engine.accepting()).
_ready = os.environ.get("MXNET_TELEMETRY_READY", "").strip().lower() \
    not in ("0", "false", "off", "no")
_ready_reason = "" if _ready else "starting (MXNET_TELEMETRY_READY=0)"


def mark_ready(flag, reason=""):
    """Set the process-level readiness flag (the starting/stopping
    states a liveness probe must not see as dead)."""
    global _ready, _ready_reason
    _ready = bool(flag)
    _ready_reason = reason if not flag else ""


def is_ready():
    """(ready, reasons): the /readyz verdict — the process flag AND
    every live serving engine accepting admissions. Importable for
    in-process checks; never CREATES anything."""
    reasons = []
    if not _ready:
        reasons.append(_ready_reason or "marked not ready")
    srv_mod = sys.modules.get("mxnet_tpu_torch.serving.engine")
    # getattr guard: a scrape can land DURING package import, when the
    # module is in sys.modules but not yet initialized
    live = getattr(srv_mod, "live_engines", None) if srv_mod else None
    if live is not None:
        for e in live():
            if not e.accepting():
                reasons.append("serving engine %#x draining" % id(e))
    return not reasons, reasons


def running():
    """True while the HTTP server thread is serving."""
    return _thread is not None and _thread.is_alive()


def port():
    """The bound TCP port, or None when the server is off (the useful
    accessor under ``MXNET_TELEMETRY_HTTP=0`` ephemeral-port tests)."""
    b = _bound
    return b[1] if b else None


def parse_spec(raw):
    """``MXNET_TELEMETRY_HTTP`` value -> (host, port) or None (off).
    Accepts ``<port>`` (loopback) or ``<host>:<port>``."""
    raw = (raw or "").strip()
    if not raw:
        return None
    host, sep, p = raw.rpartition(":")
    if not sep:
        host, p = "127.0.0.1", raw
    try:
        p = int(p)
    except ValueError:
        logging.warning("mxdash: MXNET_TELEMETRY_HTTP=%r is not a port "
                        "(or host:port); introspection server disabled", raw)
        return None
    if p < 0:
        return None
    return host or "127.0.0.1", p


def configure(spec):
    """Apply an endpoint spec ((host, port) tuple or None). Idempotent:
    the same spec keeps the running server (and its ephemeral port);
    a changed spec (including None) stops it first. Called from
    ``telemetry.reload()`` — never starts anything unless telemetry is
    enabled AND a spec is given."""
    global _server, _thread, _bound, _started_t
    with _lock:
        srv, thread = _server, _thread
        same = srv is not None and getattr(srv, "_mxdash_spec", None) == spec
    if same:
        return
    # stop outside the module lock: shutdown() blocks on the serve loop
    if srv is not None:
        srv.shutdown()
        srv.server_close()
        if thread is not None:
            thread.join()
        with _lock:
            _server = _thread = _bound = _started_t = None
    if spec is None:
        return
    new_srv = _build(spec)
    if new_srv is None:
        return
    t = threading.Thread(target=new_srv.serve_forever, name="mxtel-http",
                         daemon=True)
    with _lock:
        _server, _thread = new_srv, t
        _bound = new_srv.server_address[:2]
        _started_t = time.time()
    t.start()


def _build(spec):
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _Handler(BaseHTTPRequestHandler):
        # a scrape loop must not spam the job's stderr
        def log_message(self, fmt, *args):
            pass

        def do_GET(self):
            path, _, query = self.path.partition("?")
            fn = _ROUTES.get(path.rstrip("/") or "/")
            if fn is None:
                self._send(404, "text/plain; charset=utf-8",
                           "unknown endpoint %r\nknown: %s\n"
                           % (path, " ".join(sorted(_ROUTES))))
                return
            try:
                out = fn(_params(query))
            except Exception as e:  # introspection must never kill the job
                logging.exception("mxdash: %s handler failed", path)
                self._send(500, "text/plain; charset=utf-8",
                           "%s: %s\n" % (type(e).__name__, e))
                return
            # handlers return (ctype, body) for 200, or
            # (code, ctype, body) — /readyz answers 503 when draining
            if len(out) == 3:
                code, ctype, body = out
            else:
                code, (ctype, body) = 200, out
            self._send(code, ctype, body)

        def _send(self, code, ctype, body):
            data = body.encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            try:
                self.wfile.write(data)
            except OSError:
                pass  # scraper hung up mid-reply

    try:
        srv = ThreadingHTTPServer(spec, _Handler)
    except OSError as e:
        logging.warning("mxdash: cannot bind %s:%d (%s); introspection "
                        "server disabled", spec[0], spec[1], e)
        return None
    srv.daemon_threads = True
    srv._mxdash_spec = spec
    return srv


def _params(query):
    out = {}
    for part in query.split("&"):
        if "=" in part:
            k, _, v = part.partition("=")
            out[k] = v
    return out


# -- endpoint bodies -----------------------------------------------------------
def _json(obj):
    return ("application/json", json.dumps(obj, indent=1, default=str) + "\n")


def _healthz(params):
    return ("text/plain; charset=utf-8", "ok\n")


def _readyz(params):
    """Readiness split from liveness (docs/how_to/control_plane.md): a
    draining or still-starting replica is alive (200 /healthz) but not
    accepting work (503 here) — external probes and the mxctl
    controller must not conflate the two."""
    ready, reasons = is_ready()
    if ready:
        return ("text/plain; charset=utf-8", "ready\n")
    return (503, "text/plain; charset=utf-8",
            "not ready: %s\n" % "; ".join(reasons))


def _metrics(params):
    from . import export as _export

    return ("text/plain; version=0.0.4; charset=utf-8",
            _export.prometheus_text())


def _statusz(params):
    from . import _T0 as _proc_t0  # telemetry subsystem import time

    snap = _registry.default_registry().snapshot()
    compile_counters = {k: v for k, v in snap["counters"].items()
                        if k.startswith("compile.")}
    jc = sys.modules.get("mxnet_tpu_torch.compile.jit_cache")
    if jc is not None:
        # plain-int mirrors: live even across registry resets and in
        # telemetry-off subprocesses (jit_cache.HITS/MISSES/CORRUPT)
        for name in ("HITS", "MISSES", "CORRUPT"):
            compile_counters["compile.jit_cache_%s" % name.lower()] = \
                int(getattr(jc, name, 0))
    # mxjit verifier snapshot (per-boundary compile counts vs budgets,
    # D2H ledger) — only when the module is live and armed, never an
    # import from here
    cv = sys.modules.get("mxnet_tpu_torch.analysis.compile_verify")
    jit_verify = (cv.summary() if cv is not None
                  and getattr(cv, "ENABLED", False) else None)
    return _json({
        "pid": os.getpid(),
        "rank": int(os.environ.get("MXNET_PROC_ID", "0") or 0),
        "world": int(os.environ.get("MXNET_NUM_PROCS", "1") or 1),
        "uptime_s": time.time() - _proc_t0,
        "server_uptime_s": (time.time() - _started_t
                            if _started_t is not None else None),
        "journal": _journal_path(),
        "jit_cache_dir": os.environ.get("MXNET_COMPILE_CACHE_DIR") or None,
        "compile": compile_counters,
        "jit_verify": jit_verify,
        "env": {k: v for k, v in sorted(os.environ.items())
                if k.startswith(("MXNET_", "MXRACE_"))},
    })


def _journal_path():
    from . import export as _export

    return _export.journal_path()


def _tracez(params):
    try:
        n = max(1, int(params.get("n", "64")))
    except ValueError:
        n = 64
    return _json({
        "open": _tracing.open_spans(),
        "recent": _tracing.span_tail(n),
        "aggregates": _tracing.span_aggregates(),
    })


def _enginez(params):
    eng_mod = sys.modules.get("mxnet_tpu_torch.engine")
    eng = getattr(eng_mod, "Engine", None) if eng_mod else None
    inst = getattr(eng, "_instance", None) if eng else None
    if inst is None:
        # introspection must never CREATE the engine singleton: a scrape
        # of a process that never pushed host work reports exactly that
        return _json({"engine": None})
    snap = inst.pending_snapshot()
    snap.update({
        "engine": inst.engine_type,
        "native": inst.is_native,
    })
    counters = _registry.default_registry().snapshot()["counters"]
    snap["counters"] = {k: v for k, v in counters.items()
                       if k.startswith("engine.")}
    return _json(snap)


def _profilez(params):
    """mxprof live attribution. Answers with ``enabled: false`` (not an
    error) when MXNET_PROF is unset — a scraper can always tell "off"
    from "down"."""
    from . import prof as _prof

    try:
        n = max(1, int(params.get("n", "20")))
    except ValueError:
        n = 20
    return _json(_prof.snapshot(top=n))


def _servingz(params):
    srv_mod = sys.modules.get("mxnet_tpu_torch.serving.engine")
    if srv_mod is None:
        return _json({"engines": []})
    return _json({"engines": [e.introspect()
                              for e in srv_mod.live_engines()]})


_ROUTES = {
    "/": lambda p: ("text/plain; charset=utf-8",
                    "mxdash endpoints: %s\n" % " ".join(
                        sorted(k for k in _ROUTES if k != "/"))),
    "/healthz": _healthz,
    "/readyz": _readyz,
    "/metrics": _metrics,
    "/statusz": _statusz,
    "/tracez": _tracez,
    "/enginez": _enginez,
    "/servingz": _servingz,
    "/profilez": _profilez,
}
