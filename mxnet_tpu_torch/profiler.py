"""Profiler: trace capture + named regions over ``torch.profiler``.

Counterpart of ``mxnet_tpu/profiler.py``, whose timeline is jax's xplane
trace. The 2016 reference has no dedicated profiler (SURVEY §5.1): its
observability is the Monitor per-op callback (python/mxnet/monitor.py),
the Speedometer samples/sec log, and `MXNET_ENGINE_INFO` engine debug.
This module supplies the piece the reference lacks, behind the same
mxnet-style start/stop surface: ``torch.profiler`` with the host's
activity and, when a card is present, CUDA's (kernel launches and their
device time), written as a Chrome trace (Perfetto, chrome://tracing).

Usage::

    mx.profiler.profiler_set_config(filename="/tmp/traces")
    mx.profiler.profiler_set_state("run")
    ... training steps ...
    mx.profiler.profiler_set_state("stop")   # writes the trace

    with mx.profiler.scope("data-load"):     # named trace region
        batch = next(it)

    @mx.profiler.annotate("fwd-step")        # annotate a function
    def step(...): ...

``start_server`` (the JAX package's on-demand TensorBoard capture
server) has no torch counterpart and raises.
"""
from __future__ import annotations

import contextlib
import os

from .base import MXNetError

__all__ = [
    "profiler_set_config", "profiler_set_state", "scope", "annotate",
    "start_server", "state", "last_trace",
]

_config = {"filename": "profile_output"}
_state = "stop"
_session = {"profile": None, "count": 0, "last": None}


def profiler_set_config(mode="all", filename="profile_output"):
    """Configure the trace output directory (mirrors the later-era
    MXSetProfilerConfig surface; `mode` accepted for compatibility)."""
    del mode
    _config["filename"] = filename


def profiler_set_state(new_state="stop"):
    """'run' starts capture, 'stop' ends it and writes the trace
    (mirrors MXSetProfilerState): ``<filename>/trace-<pid>-<n>.json``,
    the path :func:`last_trace` returns."""
    global _state
    import torch

    if new_state not in ("run", "stop"):
        raise ValueError("state must be 'run' or 'stop'")
    if new_state == _state:
        return
    if new_state == "run":
        os.makedirs(_config["filename"], exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        _session["profile"] = prof
    else:
        prof, _session["profile"] = _session["profile"], None
        prof.stop()
        _session["count"] += 1
        path = os.path.join(_config["filename"], "trace-%d-%d.json"
                            % (os.getpid(), _session["count"]))
        prof.export_chrome_trace(path)
        _session["last"] = path
    _state = new_state


def state():
    return _state


def last_trace():
    """Path of the trace the last 'stop' wrote, or None."""
    return _session["last"]


@contextlib.contextmanager
def scope(name):
    """Named region visible in the trace timeline (record_function)."""
    import torch

    with torch.profiler.record_function(name):
        yield


def annotate(name=None):
    """Decorator: wrap a function in a named trace region."""
    def deco(fn):
        import functools

        label = name or fn.__name__

        @functools.wraps(fn)
        def wrapped(*a, **k):
            with scope(label):
                return fn(*a, **k)

        return wrapped

    return deco


def start_server(port=9012):
    """The JAX package's on-demand profiling server (TensorBoard's
    capture dialog) has no torch counterpart: raises."""
    raise MXNetError(
        "profiler.start_server(port=%d): torch.profiler has no on-demand "
        "capture server; use profiler_set_state('run'/'stop'), which "
        "writes a Chrome trace" % port)
