"""Nested span tracer: monotonic-clock durations, thread-local nesting.

``span("name")`` opens a scope; on exit the finished span (name, start,
duration, id, parent id, thread) is recorded into a bounded in-memory
tail, folded into a per-name aggregate (count / total / max — the
"top spans by total time" table), and appended to the run journal when
one is active (export.py).

Parent ids propagate through a thread-local stack: spans opened on the
same thread nest naturally. Work handed to another thread (the prefetch
producer, an engine worker) inherits by *explicit* capture — the
dispatching side reads :func:`current_span` and passes it as
``span(name, parent=...)`` on the worker; an implicit ambient-context
hand-off would misattribute unrelated threads' work the moment two jobs
share a pool.

Spans also forward into :func:`mxnet_tpu_torch.profiler.scope` while
the profiler is capturing, so the same names land in the torch trace —
mxtel is the always-on record, the trace stays the deep-dive view.

Every span belongs to a **trace**: root spans mint a process-unique
``trace`` id, children inherit it through the nesting chain, and
:func:`wire_context` / ``span(name, wire=...)`` carry it across an RPC
boundary (the elastic coordinator protocol attaches it to its request
envelope) so a server-side handler's spans land in the *caller's*
trace. ``tools/trace_merge.py`` stitches per-rank journals back into one
timeline on these ids.

When telemetry is disabled ``span()`` hands back one shared
null context: a single flag check, no allocation.
"""
from __future__ import annotations

import collections
import itertools
import os
import sys
import threading
import time
from contextlib import nullcontext as _nullcontext

__all__ = ["span", "current_span", "span_aggregates", "span_tail", "reset",
           "wire_context", "mint_trace", "open_spans", "event"]

_NULL = _nullcontext()
_ids = itertools.count(1)
_trace_ids = itertools.count(1)
_tls = threading.local()

# finished spans, newest last (bounded: tooling reads the journal for the
# full stream; this tail serves console summaries and tests)
_TAIL_MAX = 4096
_tail = collections.deque(maxlen=_TAIL_MAX)
# name -> [count, total_secs, max_secs]
_agg = {}
# id -> record of every span currently OPEN (entered, not yet exited) —
# the /tracez introspection endpoint's live view
_open = {}
_lock = threading.Lock()


def mint_trace():
    """A new process-unique trace id. The pid prefix keeps ids from
    different ranks of one job distinct, so merged timelines never
    alias two ranks' traces."""
    return "%x-%x" % (os.getpid(), next(_trace_ids))


def _stack():
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


def current_span():
    """Id of the innermost open span on this thread, or None. Capture
    this before dispatching work to another thread and pass it as
    ``span(..., parent=...)`` there to keep the nesting chain."""
    s = getattr(_tls, "stack", None)
    return s[-1] if s else None


def wire_context():
    """Trace context of the innermost open span on this thread as a
    plain picklable dict (``{"trace": str, "span": int}``), or None
    when no span is open. Attach it to an RPC request so the server
    side can open child spans with ``span(name, wire=ctx)`` — the
    cross-*process* analog of ``parent=``."""
    s = getattr(_tls, "stack", None)
    if not s:
        return None
    sid = s[-1]
    with _lock:
        rec = _open.get(sid)
    if rec is None:
        return None
    return {"trace": rec["trace"], "span": sid}


class _Span:
    __slots__ = ("name", "id", "parent", "trace", "remote_parent",
                 "_t0", "_wall", "_prof")

    def __init__(self, name, parent, wire=None):
        self.name = name
        self.id = next(_ids)
        self.parent = parent
        self.trace = None
        self.remote_parent = None
        if wire:
            self.trace = wire.get("trace")
            self.remote_parent = wire.get("span")
        self._t0 = 0.0
        self._wall = 0.0
        self._prof = None

    def __enter__(self):
        stack = _stack()
        if self.parent is None and stack:
            self.parent = stack[-1]
        # trace inheritance: explicit wire context wins, else the
        # parent's trace (parent may live on another thread — the
        # open-span table is the lookup), else mint a fresh root trace
        if self.trace is None and self.parent is not None:
            with _lock:
                prec = _open.get(self.parent)
            if prec is not None:
                self.trace = prec["trace"]
        if self.trace is None:
            self.trace = mint_trace()
        stack.append(self.id)
        # forward into the torch trace only while a capture runs —
        # record_function costs a torch call per span otherwise. The
        # sys.modules probe (not an import) keeps light processes — the
        # standalone elastic coordinator — from paying the full package
        # import just because telemetry is on.
        _profiler = sys.modules.get("mxnet_tpu_torch.profiler")
        if _profiler is not None and _profiler.state() == "run":
            self._prof = _profiler.scope(self.name)
            self._prof.__enter__()
        self._wall = time.time()
        self._t0 = time.monotonic()
        with _lock:
            _open[self.id] = {
                "name": self.name, "id": self.id, "parent": self.parent,
                "trace": self.trace, "t": self._wall,
                "thread": threading.current_thread().name,
            }
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.monotonic() - self._t0
        if self._prof is not None:
            self._prof.__exit__(exc_type, exc, tb)
            self._prof = None
        stack = _stack()
        if stack and stack[-1] == self.id:
            stack.pop()
        rec = {
            "kind": "span", "name": self.name, "id": self.id,
            "parent": self.parent, "trace": self.trace,
            "t": self._wall, "dur": dur,
            "thread": threading.current_thread().name,
        }
        if self.remote_parent is not None:
            rec["remote_parent"] = self.remote_parent
        with _lock:
            _open.pop(self.id, None)
            _tail.append(rec)
            a = _agg.get(self.name)
            if a is None:
                _agg[self.name] = [1, dur, dur]
            else:
                a[0] += 1
                a[1] += dur
                if dur > a[2]:
                    a[2] = dur
        from . import export as _export

        _export.emit(rec)
        return False


def span(name, parent=None, wire=None):
    """Open a named span. A context manager; cheap no-op when telemetry
    is off. ``parent`` overrides the thread-local nesting (cross-thread
    propagation); ``wire`` adopts a remote caller's trace context (a
    :func:`wire_context` dict that crossed an RPC boundary) — the
    span's trace id and remote parent come from the caller's process,
    so merged timelines keep the causal chain."""
    from . import ENABLED

    if not ENABLED:
        return _NULL
    return _Span(name, parent, wire=wire)


def event(name, t=None, dur=0.0, trace=None, parent=None, **fields):
    """Record one span with *explicit* timestamps (epoch seconds) —
    lifecycle events reconstructed after the fact, like a serving
    request's submit/prefill/decode/complete phases, where the phases
    are known only once the request finishes. Lands in the tail, the
    per-name aggregates, and the journal exactly like a context-manager
    span. No-op when telemetry is off."""
    from . import ENABLED

    if not ENABLED:
        return None
    rec = {
        "kind": "span", "name": name, "id": next(_ids), "parent": parent,
        "trace": trace if trace is not None else mint_trace(),
        "t": time.time() if t is None else float(t), "dur": float(dur),
        "thread": threading.current_thread().name,
    }
    rec.update(fields)
    with _lock:
        _tail.append(rec)
        a = _agg.get(name)
        if a is None:
            _agg[name] = [1, rec["dur"], rec["dur"]]
        else:
            a[0] += 1
            a[1] += rec["dur"]
            if rec["dur"] > a[2]:
                a[2] = rec["dur"]
    from . import export as _export

    _export.emit(rec)
    return rec


def open_spans():
    """Snapshot of every currently open span (entered, not yet exited),
    each with an ``age_s`` field — the /tracez live view."""
    now = time.time()
    with _lock:
        recs = [dict(r) for r in _open.values()]
    for r in recs:
        r["age_s"] = now - r["t"]
    return sorted(recs, key=lambda r: r["id"])


def span_aggregates():
    """{name: {"count": n, "total": secs, "max": secs}} over every
    finished span since the last reset — the top-spans table's data."""
    with _lock:
        return {k: {"count": v[0], "total": v[1], "max": v[2]}
                for k, v in _agg.items()}


def span_tail(n=None):
    """The newest ``n`` finished span records (all retained if None)."""
    with _lock:
        recs = list(_tail)
    return recs if n is None else recs[-n:]


def reset():
    """Drop finished-span state (test isolation). Open spans on live
    threads are untouched — they complete into the fresh tables."""
    with _lock:
        _tail.clear()
        _agg.clear()
