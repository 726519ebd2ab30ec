"""Persistent compilation cache: NVRTC cubins survive process restarts.

Counterpart of ``mxnet_tpu/compile/jit_cache.py``. The JAX package
points jax's persistent compilation cache at ``MXNET_COMPILE_CACHE_DIR``.
The port builds no XLA executables: the compiled programs it builds in
a process are NVRTC's cubins — the RTC bodies (``rtc.py``) and anything
else that goes through ``ops/_nvrtc.compile_cubin``. With
``MXNET_COMPILE_CACHE_DIR`` set those persist, and the next process
that compiles the same source LOADS the cubin instead of running NVRTC.
(The nvcc kernels of ``ops/csrc`` keep their own build directory,
``ops/_build.py``.)

Keying: entries live under ``<dir>/jit-<config-hash>/``, the hash
covering the rewrite-pass configuration (``compile.config_key()``), as
in the JAX package; an entry's file name is the SHA-256 of its source,
kernel name, target architecture and NVRTC version, so a new toolkit or
another ``-arch`` never loads an old cubin. The tuning database lives
in ``<dir>`` itself (``autotune.make_tuner``).

Robustness: an entry is written atomically (a temporary file, fsync,
then rename) and carries the SHA-256 of its payload. A truncated or
bit-flipped entry costs one recompile, never a crash: ``ensure()``
sweeps the directory when it arms it and deletes every entry whose
checksum fails, and a read that finds one does the same; each counts
``compile.cache_corrupt_total`` (``CORRUPT``).

Hit/miss accounting: ``HITS``, ``MISSES`` and ``CORRUPT`` are plain ints
readable without telemetry (a bare subprocess reports them), mirrored
into ``compile.cache_hits_total``/``misses_total``/``corrupt_total``
when telemetry is on.
"""
from __future__ import annotations

import hashlib
import os

from .. import telemetry as _tel

__all__ = ["ensure", "verify_cache_dir", "cache_dir", "stats", "keyed_dir",
           "entry_key", "load_or_build", "active_dir", "donation_unsafe"]

#: process-lifetime counters (mirrors of the mxtel counters; plain ints
#: so subprocesses can report them without enabling telemetry)
HITS = 0
MISSES = 0
CORRUPT = 0

_MAGIC = b"MXC1"
_SUFFIX = "-cubin"

_configured_dir = None


def cache_dir():
    """MXNET_COMPILE_CACHE_DIR, or None (cache off)."""
    return os.environ.get("MXNET_COMPILE_CACHE_DIR", "").strip() or None


def donation_unsafe():
    """Always False in the port. The JAX package strips buffer donation
    where a persistently cached CPU executable would corrupt the heap
    under it; torch has no buffer donation (the trainers update their
    tensors in place) and loads no serialized executables, so no entry
    point has anything to strip."""
    return False


def stats():
    return {"hits": HITS, "misses": MISSES, "corrupt": CORRUPT}


def active_dir():
    """The armed entry directory, or None."""
    return _configured_dir


def _count(kind):
    global HITS, MISSES, CORRUPT
    if kind == "hits":
        HITS += 1
    elif kind == "misses":
        MISSES += 1
    else:
        CORRUPT += 1
    if _tel.ENABLED:
        _tel.counter("compile.cache_%s_total" % kind).inc()


def _payload(blob):
    """The payload of an entry's bytes, or None when its checksum (or
    framing) fails."""
    head = len(_MAGIC) + 32
    if len(blob) < head or not blob.startswith(_MAGIC):
        return None
    digest, payload = blob[len(_MAGIC):head], blob[head:]
    if hashlib.sha256(payload).digest() != digest:
        return None
    return payload


def _remove_corrupt(path):
    _count("corrupt")
    try:
        os.remove(path)
    except OSError:
        pass


def verify_cache_dir(path):
    """Sweep ``path`` for entries whose checksum fails; delete them
    (recompile beats crash) and count each via
    ``compile.cache_corrupt_total``. Returns (n_checked, n_removed)."""
    checked = removed = 0
    try:
        names = os.listdir(path)
    except OSError:
        return 0, 0
    for name in names:
        if not name.endswith(_SUFFIX):
            continue
        fpath = os.path.join(path, name)
        checked += 1
        try:
            with open(fpath, "rb") as f:
                ok = _payload(f.read()) is not None
        except OSError:
            ok = False
        if not ok:
            removed += 1
            _remove_corrupt(fpath)
    return checked, removed


def keyed_dir(base, config_key):
    h = hashlib.sha256(config_key.encode()).hexdigest()[:16]
    return os.path.join(base, "jit-%s" % h)


def ensure(config_key=""):
    """Idempotently arm the persistent cache when MXNET_COMPILE_CACHE_DIR
    is set. Returns the active entry directory or None. Called from
    every compile entry point (Executor bind, the Symbol trainers, the
    Predictor, NVRTC compiles) — the first caller creates and sweeps the
    directory, later calls are one string compare."""
    global _configured_dir
    base = cache_dir()
    if base is None:
        return None
    target = keyed_dir(base, config_key)
    if _configured_dir == target:
        return target
    os.makedirs(target, exist_ok=True)
    verify_cache_dir(target)
    _configured_dir = target
    return target


def entry_key(*parts):
    """The entry name of a compiled program: SHA-256 over its parts
    (source, kernel name, architecture, compiler version)."""
    h = hashlib.sha256()
    for p in parts:
        h.update(str(p).encode())
        h.update(b"\0")
    return h.hexdigest()


def load_or_build(key, build, directory=None):
    """The program bytes for ``key``: loaded from the armed directory
    (a hit), or ``build()`` and stored there (a miss). A corrupt entry
    is deleted, counted and rebuilt. Without an armed directory this is
    ``build()`` alone, uncounted."""
    d = directory or _configured_dir
    if d is None:
        return build()
    path = os.path.join(d, key + _SUFFIX)
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError:
        blob = None
    if blob is not None:
        payload = _payload(blob)
        if payload is not None:
            _count("hits")
            return payload
        _remove_corrupt(path)
    _count("misses")
    payload = bytes(build())
    tmp = "%s.tmp.%d" % (path, os.getpid())
    try:
        with open(tmp, "wb") as f:
            f.write(_MAGIC + hashlib.sha256(payload).digest() + payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except OSError:
        try:
            os.remove(tmp)
        except OSError:
            pass
    return payload
