"""Dependency engine: host-task scheduler with read/write-var ordering.

Re-design of the reference engine (ref: include/mxnet/engine.h:74-226,
src/engine/threaded_engine.h:87-189, src/engine/engine.cc:13-39 —
SURVEY §2.1). A CUDA stream already orders device work, so this engine
schedules *host-side* tasks — checkpoint writes, IO stages, host
callbacks — with the reference's exact dependency semantics: reads on a
variable run concurrently, a write waits for prior reads to drain and
runs alone, later ops queue in program order.

mxnet_tpu_torch's counterpart of ``mxnet_tpu/engine.py``. The scheduler
core is the port's copy of the JAX package's C++ engine,
``csrc/engine.cc``: ``g++`` builds it at first use into
``build/torch_engine/`` of the checkout (the library named by the hash
of its source), and ``ctypes`` binds it. A failed build raises
``MXNetError``; there is no pure-Python fallback.

Engine choice follows the reference env protocol (src/engine/engine.cc:13):
MXNET_ENGINE_TYPE = ThreadedEngine | ThreadedEnginePerDevice (default) |
NaiveEngine (the C++ engine running each op inline on the pushing
thread). Worker count: MXNET_CPU_WORKER_NTHREADS. The compiler is
``$CXX`` (default ``g++``).

As in the JAX package (``mxnet_tpu/engine.py``): every task body fires
the ``engine.task`` fault point first; ``MXNET_ENGINE_WAIT_TIMEOUT``
(seconds, read at each wait) bounds ``wait_for_var``/``wait_for_all``
and the exit drain, raising (at exit: logging) the pending-task dump
(``pending_dump``: the native pending count, the queued and the
in-flight tasks) instead of blocking forever; ``MXNET_ENGINE_INFO=1``
logs each push; ``pending_snapshot`` feeds ``/enginez``. Telemetry
(``MXNET_TELEMETRY=1``): ``engine.push_total``, ``engine.waits_total``,
``engine.watchdog_fires_total``, the ``engine.task_secs`` histogram and
the ``engine.queue_depth`` gauge. Not carried over: the verify/record
trace (``MXNET_ENGINE_VERIFY``, ``analysis/engine_verify.py``).
"""
from __future__ import annotations

import atexit
import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from . import telemetry as _tel
from .base import MXNetError
from .resilience import faults as _faults

__all__ = ["Engine", "get", "push", "wait_for_all", "BUILD_DIR"]

_ENGINE_FN = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_void_p)

_SRC = Path(__file__).resolve().parent / "csrc" / "engine.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "torch_engine"
_CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lib_lock = threading.Lock()
_lib = None


def _wait_timeout():
    """MXNET_ENGINE_WAIT_TIMEOUT in seconds, or None when the watchdog
    is off. Read per wait so an operator can arm it at any time."""
    raw = os.environ.get("MXNET_ENGINE_WAIT_TIMEOUT", "").strip()
    if not raw:
        return None
    try:
        t = float(raw)
    except ValueError:
        raise MXNetError(
            "MXNET_ENGINE_WAIT_TIMEOUT must be a number of seconds, "
            "got %r" % raw)
    return t if t > 0 else None


def library_path(build_dir=None):
    """Where :func:`build` puts the library of this ``csrc/engine.cc``
    (named by the hash of the source and the flags)."""
    digest = hashlib.sha256(
        _SRC.read_bytes() + " ".join(_CXX_FLAGS).encode()).hexdigest()[:16]
    return Path(build_dir or BUILD_DIR) / ("libengine-%s.so" % digest)


def build(build_dir=None, cxx=None):
    """Compile ``csrc/engine.cc`` (if its library is not there yet) and
    return the library's path; raises ``MXNetError`` when the compiler
    is missing or fails."""
    build_dir = Path(build_dir or BUILD_DIR)
    cxx = cxx or os.environ.get("CXX") or "g++"
    so = library_path(build_dir)
    if so.exists():
        return so
    exe = shutil.which(cxx)
    if exe is None:
        raise MXNetError("cannot build the dependency engine: compiler %r "
                         "not found (set CXX)" % cxx)
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(".so.tmp%d" % os.getpid())
    proc = subprocess.run([exe, *_CXX_FLAGS, str(_SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise MXNetError("cannot build the dependency engine (%s):\n%s%s"
                         % (cxx, proc.stdout, proc.stderr))
    os.replace(tmp, so)
    return so


def _engine_lib():
    """The bound engine library, built on first use."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        c = ctypes
        lib.EngineCreate.restype = c.c_void_p
        lib.EngineCreate.argtypes = [c.c_int, c.c_int]
        lib.EngineDestroy.argtypes = [c.c_void_p]
        lib.EngineNewVariable.restype = c.c_void_p
        lib.EngineNewVariable.argtypes = [c.c_void_p]
        lib.EngineDeleteVariable.argtypes = [c.c_void_p, c.c_void_p]
        lib.EnginePush.restype = c.c_int
        lib.EnginePush.argtypes = [
            c.c_void_p, _ENGINE_FN, c.c_void_p,
            c.POINTER(c.c_void_p), c.c_int,
            c.POINTER(c.c_void_p), c.c_int, c.c_int, c.c_int,
        ]
        lib.EngineOprComplete.argtypes = [c.c_void_p]
        lib.EngineWaitForVar.argtypes = [c.c_void_p, c.c_void_p]
        lib.EngineWaitForAll.argtypes = [c.c_void_p]
        lib.EnginePendingCount.restype = c.c_int64
        lib.EnginePendingCount.argtypes = [c.c_void_p]
        lib.EngineLastError.restype = c.c_char_p
        lib.EngineLastError.argtypes = [c.c_void_p]
        _lib = lib
        return lib


class VarHandle:
    """Opaque engine variable (ref: engine.h VarHandle)."""

    __slots__ = ("_ptr", "_engine")

    def __init__(self, ptr, engine):
        self._ptr = ptr
        self._engine = engine


class Engine:
    """Singleton scheduler. API parity: engine.h:74-226."""

    _instance = None
    _instance_lock = threading.Lock()

    def __init__(self, engine_type=None, num_workers=None):
        if engine_type is None:
            engine_type = os.environ.get(
                "MXNET_ENGINE_TYPE", "ThreadedEnginePerDevice")
        if num_workers is None:
            num_workers = int(os.environ.get("MXNET_CPU_WORKER_NTHREADS", "0"))
        self.engine_type = engine_type
        # MXNET_ENGINE_INFO: log each push (ref: threaded_engine.h:253)
        self._verbose = os.environ.get("MXNET_ENGINE_INFO", "").strip() \
            not in ("", "0", "false")
        threaded = 0 if engine_type == "NaiveEngine" else 1
        self._lib = _engine_lib()
        self._handle = ctypes.c_void_p(
            self._lib.EngineCreate(threaded, num_workers))
        # keep callback objects alive until their op completes
        self._live = {}
        self._live_lock = threading.Lock()
        self._next_key = 1
        self._errors = []
        # key -> fn name for ops dispatched to a worker but not yet
        # completed (the wait watchdog's "in-flight" dump)
        self._inflight = {}
        lib = self._lib

        def _trampoline(argp, token):
            key = argp  # void* cast back to the int key
            with self._live_lock:
                fn, is_async = self._live.pop(key)
                self._inflight[key] = getattr(fn, "__name__", None) or "fn"
            t0 = time.monotonic() if _tel.ENABLED else 0.0
            if is_async:
                called = [False]

                def on_complete(_tok=token, _key=key):
                    if not called[0]:
                        called[0] = True
                        with self._live_lock:
                            self._inflight.pop(_key, None)
                        lib.EngineOprComplete(_tok)

                try:
                    _faults.point("engine.task")
                    fn(on_complete)
                except BaseException as e:  # surface on next wait()
                    with self._live_lock:
                        self._errors.append(e)
                    on_complete()
            else:
                try:
                    _faults.point("engine.task")
                    fn()
                except BaseException as e:
                    with self._live_lock:
                        self._errors.append(e)
                finally:
                    with self._live_lock:
                        self._inflight.pop(key, None)
            if _tel.ENABLED:
                # async latency covers fn's dispatch body (durability is
                # on_complete's clock, which may outlive this frame)
                _tel.histogram("engine.task_secs").observe(
                    time.monotonic() - t0)

        self._trampoline = _ENGINE_FN(_trampoline)

    def close(self):
        """Drain pending work and free the native engine + worker pool.
        Must only run once all threads that push to or wait on this
        engine have quiesced (see the JAX package's ``Engine.close``)."""
        with self._live_lock:
            h, self._handle = self._handle, None
        if h is not None:
            self._lib.EngineDestroy(h)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # -- factory ---------------------------------------------------------------
    @classmethod
    def get(cls):
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    @property
    def is_native(self):
        return self._handle is not None

    def _handle_snapshot(self):
        """Read the handle once under the lock; callers use the snapshot
        for the whole native call so a concurrent close() can never turn
        a passed None-check into a NULL dereference."""
        with self._live_lock:
            return self._handle

    # -- variables -------------------------------------------------------------
    def new_variable(self):
        h = self._handle_snapshot()
        if h is None:
            raise MXNetError("engine is closed")
        return VarHandle(self._lib.EngineNewVariable(h), self)

    def delete_variable(self, var):
        """Deferred deletion after all pending ops (ref: engine.h:148-160)."""
        h = self._handle_snapshot()
        if h is not None and var._ptr:
            self._lib.EngineDeleteVariable(h, var._ptr)
            var._ptr = None

    # -- push ------------------------------------------------------------------
    def _check_dup(self, const_vars, mutable_vars):
        seen = set()
        for v in list(const_vars) + list(mutable_vars):
            if id(v) in seen:
                raise MXNetError(
                    "duplicate variable in const/mutable lists "
                    "(ref: threaded_engine.cc:205 CheckDuplicate)")
            seen.add(id(v))

    def push(self, fn, const_vars=(), mutable_vars=(), priority=0):
        """PushSync (ref: engine.h:197-207): fn() runs once deps are met;
        completion is automatic when it returns."""
        self._push(fn, const_vars, mutable_vars, priority, is_async=False)

    def push_async(self, fn, const_vars=(), mutable_vars=(), priority=0):
        """PushAsync (ref: engine.h:142-146): fn(on_complete) must invoke
        on_complete() when the op's effects are durable."""
        self._push(fn, const_vars, mutable_vars, priority, is_async=True)

    def _push(self, fn, const_vars, mutable_vars, priority, is_async):
        self._check_dup(const_vars, mutable_vars)
        if self._verbose:
            logging.info(
                "engine: push %s const=%d mutable=%d priority=%d async=%s",
                getattr(fn, "__name__", "fn"), len(const_vars),
                len(mutable_vars), priority, is_async)
        with self._live_lock:
            handle = self._handle
        if handle is None:
            raise MXNetError("engine is closed")
        for v in list(const_vars) + list(mutable_vars):
            if not v._ptr:
                raise MXNetError("engine variable used after delete_variable")
        if _tel.ENABLED:
            _tel.counter("engine.push_total").inc()
        with self._live_lock:
            key = self._next_key
            self._next_key += 1
            self._live[key] = (fn, is_async)
        n_c, n_m = len(const_vars), len(mutable_vars)
        c_arr = (ctypes.c_void_p * max(n_c, 1))(
            *[v._ptr for v in const_vars])
        m_arr = (ctypes.c_void_p * max(n_m, 1))(
            *[v._ptr for v in mutable_vars])
        rc = self._lib.EnginePush(
            handle, self._trampoline, ctypes.c_void_p(key),
            c_arr, n_c, m_arr, n_m, priority, 0 if is_async else 1)
        if _tel.ENABLED and rc == 0:
            _tel.gauge("engine.queue_depth").set(
                self._lib.EnginePendingCount(handle))
        if rc != 0:
            with self._live_lock:
                self._live.pop(key, None)
            raise MXNetError(
                self._lib.EngineLastError(handle).decode())

    # -- sync ------------------------------------------------------------------
    def wait_for_var(self, var):
        """ref: engine.h:166 WaitForVar. With MXNET_ENGINE_WAIT_TIMEOUT
        set, a sentinel read op on the var bounds the wait: if it has
        not run by the deadline, raise the pending-op dump instead of
        blocking forever behind a task that never completes."""
        if _tel.ENABLED:
            _tel.counter("engine.waits_total").inc()
        h = self._handle_snapshot()
        if h is not None and var._ptr:
            timeout = _wait_timeout()
            if timeout is None:
                self._lib.EngineWaitForVar(h, var._ptr)
            else:
                reached = threading.Event()

                def __engine_wait_sentinel__():
                    reached.set()

                # an ordinary read push: runs once every op queued on
                # the var before this wait has drained — WaitForVar's
                # contract (ref: threaded_engine.cc:300)
                self.push(__engine_wait_sentinel__, const_vars=[var],
                          priority=1 << 20)
                if not reached.wait(timeout):
                    if _tel.ENABLED:
                        _tel.counter("engine.watchdog_fires_total").inc()
                    # a deferred task error is the likely ROOT CAUSE of
                    # the wedge; surface it before the generic timeout
                    self._raise_pending()
                    raise MXNetError(
                        "engine wait_for_var exceeded "
                        "MXNET_ENGINE_WAIT_TIMEOUT=%gs\n%s"
                        % (timeout, self.pending_dump()))
        self._raise_pending()

    def wait_for_all(self):
        """ref: engine.h:170 WaitForAll. With MXNET_ENGINE_WAIT_TIMEOUT
        set, polls the pending count with a deadline and raises the
        pending-op dump instead of deadlocking."""
        if _tel.ENABLED:
            _tel.counter("engine.waits_total").inc()
        h = self._handle_snapshot()
        if h is not None:
            timeout = _wait_timeout()
            if timeout is None:
                self._lib.EngineWaitForAll(h)
            elif not self._poll_pending(h, timeout):
                if _tel.ENABLED:
                    _tel.counter("engine.watchdog_fires_total").inc()
                self._raise_pending()  # root cause beats generic timeout
                raise MXNetError(
                    "engine wait_for_all exceeded "
                    "MXNET_ENGINE_WAIT_TIMEOUT=%gs\n%s"
                    % (timeout, self.pending_dump()))
        self._raise_pending()

    def _poll_pending(self, h, timeout):
        """Watchdog wait body: poll the native pending count until it
        drains (True) or the deadline passes (False)."""
        deadline = time.monotonic() + timeout
        while self._lib.EnginePendingCount(h) > 0:
            if time.monotonic() > deadline:
                return False
            time.sleep(0.002)
        return True

    def pending_count(self):
        h = self._handle_snapshot()
        if h is None:
            return 0
        return self._lib.EnginePendingCount(h)

    def pending_snapshot(self):
        """Structured pending-work snapshot: the native pending count
        plus the queued (pushed, not yet dispatched) and in-flight
        (dispatched, not yet completed) task names. The wait watchdog's
        dump and ``/enginez`` both read this."""
        with self._live_lock:
            queued = [getattr(fn, "__name__", None) or "fn"
                      for fn, _a in self._live.values()]
            inflight = list(self._inflight.values())
        return {"pending": self.pending_count(), "queued": queued,
                "in_flight": inflight}

    def pending_dump(self):
        """Diagnostic text for the wait watchdog: how many ops the
        native engine still counts pending, which tasks are queued and
        which are in flight (dispatched, on_complete never called)."""
        snap = self.pending_snapshot()
        return "\n".join([
            "pending ops: %d native; queued: %s; in-flight: %s"
            % (snap["pending"], ", ".join(snap["queued"]) or "(none)",
               ", ".join(snap["in_flight"]) or "(none)"),
            "likely cause: an async task never invoked on_complete, or a "
            "host task is blocked"])

    def _raise_pending(self):
        with self._live_lock:
            if not self._errors:
                return
            err = self._errors[0]
            dropped = self._errors[1:]
            self._errors.clear()
        # Raise the first failure; the rest must not vanish silently
        # (two async checkpoint writes can both fail in one wait).
        for extra in dropped:
            logging.error("engine: additional deferred task error "
                          "(raised error takes precedence): %r", extra)
        raise err


@atexit.register
def _drain_at_exit():
    """Fence pending host tasks (async checkpoints etc.) at interpreter
    exit; a swallowed worker-thread error must not vanish silently.
    Honors MXNET_ENGINE_WAIT_TIMEOUT: a task wedged at exit logs the
    pending-op dump instead of hanging interpreter shutdown forever."""
    e = Engine._instance
    if e is None or e._handle is None:
        _tel.flush_at_exit()  # the journal's final flush rides this hook
        return
    try:
        timeout = _wait_timeout()
        if timeout is None:
            e._lib.EngineWaitForAll(e._handle)
        elif not e._poll_pending(e._handle, timeout):
            if _tel.ENABLED:
                _tel.counter("engine.watchdog_fires_total").inc()
            logging.error(
                "engine: exit drain exceeded "
                "MXNET_ENGINE_WAIT_TIMEOUT=%gs\n%s",
                timeout, e.pending_dump())
    except Exception:
        _tel.flush_at_exit()
        return
    for err in e._errors:
        logging.error("engine: pending task failed: %r", err)
    # metrics recorded by tasks that completed during the drain are now
    # final — flush them before the interpreter tears the journal down
    _tel.flush_at_exit()


def get():
    return Engine.get()


def push(fn, const_vars=(), mutable_vars=(), priority=0):
    Engine.get().push(fn, const_vars, mutable_vars, priority)


def wait_for_all():
    Engine.get().wait_for_all()
