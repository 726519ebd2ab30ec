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
``$CXX`` (default ``g++``). Not carried over: the verify/record trace
(``MXNET_ENGINE_VERIFY``), fault injection and telemetry.
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
from pathlib import Path

from .base import MXNetError

__all__ = ["Engine", "get", "push", "wait_for_all", "BUILD_DIR"]

_ENGINE_FN = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_void_p)

_SRC = Path(__file__).resolve().parent / "csrc" / "engine.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "torch_engine"
_CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lib_lock = threading.Lock()
_lib = None


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
        threaded = 0 if engine_type == "NaiveEngine" else 1
        self._lib = _engine_lib()
        self._handle = ctypes.c_void_p(
            self._lib.EngineCreate(threaded, num_workers))
        # keep callback objects alive until their op completes
        self._live = {}
        self._live_lock = threading.Lock()
        self._next_key = 1
        self._errors = []
        lib = self._lib

        def _trampoline(argp, token):
            key = argp  # void* cast back to the int key
            with self._live_lock:
                fn, is_async = self._live.pop(key)
            if is_async:
                called = [False]

                def on_complete(_tok=token):
                    if not called[0]:
                        called[0] = True
                        lib.EngineOprComplete(_tok)

                try:
                    fn(on_complete)
                except BaseException as e:  # surface on next wait()
                    with self._live_lock:
                        self._errors.append(e)
                    on_complete()
            else:
                try:
                    fn()
                except BaseException as e:
                    with self._live_lock:
                        self._errors.append(e)

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
        with self._live_lock:
            handle = self._handle
        if handle is None:
            raise MXNetError("engine is closed")
        for v in list(const_vars) + list(mutable_vars):
            if not v._ptr:
                raise MXNetError("engine variable used after delete_variable")
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
        if rc != 0:
            with self._live_lock:
                self._live.pop(key, None)
            raise MXNetError(
                self._lib.EngineLastError(handle).decode())

    # -- sync ------------------------------------------------------------------
    def wait_for_var(self, var):
        """ref: engine.h:166 WaitForVar."""
        h = self._handle_snapshot()
        if h is not None and var._ptr:
            self._lib.EngineWaitForVar(h, var._ptr)
        self._raise_pending()

    def wait_for_all(self):
        """ref: engine.h:170 WaitForAll."""
        h = self._handle_snapshot()
        if h is not None:
            self._lib.EngineWaitForAll(h)
        self._raise_pending()

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
    exit; a swallowed worker-thread error must not vanish silently."""
    e = Engine._instance
    if e is None or e._handle is None:
        return
    try:
        e._lib.EngineWaitForAll(e._handle)
    except Exception:
        return
    for err in e._errors:
        logging.error("engine: pending task failed: %r", err)


def get():
    return Engine.get()


def push(fn, const_vars=(), mutable_vars=(), priority=0):
    Engine.get().push(fn, const_vars, mutable_vars, priority)


def wait_for_all():
    Engine.get().wait_for_all()
