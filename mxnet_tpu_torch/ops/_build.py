"""Build and bind the port's CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` into a shared library under
``build/torch_kernels/`` of the checkout at first use, and loaded with
``ctypes``. A library is named by the hash of its source and of every
header it includes from ``csrc/`` (``#include "..."``, followed
through the headers), so an edited kernel or shared header rebuilds.
Pointers and the stream are passed as ``c_void_p``; each C entry
returns a ``cudaError_t`` that the caller checks.

Imported only when a kernel is about to launch on a CUDA tensor: the
CPU path never reaches this module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from ..base import MXNetError

__all__ = ["SOURCES", "build_all", "library", "raw_stream", "BUILD_DIR",
           "build_log"]

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

# library name -> (source file, {C entry: (argtypes, restype)})
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
SOURCES = {
    "flash_fwd": ("flash_fwd.cu", {
        "mx_flash_fwd": ([_P] * 5 + [_I] * 5 + [_L] * 9 + [_F] + [_I] * 3
                         + [_P], _I),
    }),
    "flash_bwd": ("flash_bwd.cu", {
        "mx_flash_bwd_dq": ([_P] * 7 + [_I] * 5 + [_L] * 12 + [_F]
                            + [_I] * 2 + [_P], _I),
        "mx_flash_bwd_dkv": ([_P] * 8 + [_I] * 5 + [_L] * 12 + [_F]
                             + [_I] * 2 + [_P], _I),
    }),
    "softmax": ("softmax.cu", {
        "mx_softmax": ([_P, _P, _L, _L, _I, _I, _P], _I),
    }),
    "matmul_stats": ("matmul_stats.cu", {
        "mx_matmul_stats": ([_P] * 4 + [_I] * 4 + [_P], _I),
    }),
}

_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs = {}
build_log = {}   # library name -> {"seconds": s, "ptxas": compiler output}


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise MXNetError("nvcc not found: the port's CUDA kernels are "
                         "built from source on the machine with the card")
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _sources(src):
    """``src`` and the ``csrc/`` headers it includes, directly or
    through another header, in the order first met."""
    seen, todo = [], [src]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [_CSRC / m.decode() for m in _INCLUDE.findall(
            path.read_bytes())]
    return seen


def _so_path(name):
    src = _CSRC / SOURCES[name][0]
    h = hashlib.sha256()
    for path in _sources(src):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return src, BUILD_DIR / ("lib%s-%s.so" % (name, h.hexdigest()[:16]))


def _compile(name):
    src, so = _so_path(name)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(".so.tmp%d" % os.getpid())
    t0 = time.monotonic()
    proc = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise MXNetError("nvcc failed for %s:\n%s%s"
                         % (src.name, proc.stdout, proc.stderr))
    os.replace(tmp, so)
    build_log[name] = {"seconds": time.monotonic() - t0,
                       "ptxas": (proc.stdout + proc.stderr).strip()}
    return so


def _load(name, so):
    lib = ctypes.CDLL(str(so))
    for fn, (argtypes, restype) in SOURCES[name][1].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype
    return lib


def build_all():
    """Compile every kernel library, one ``nvcc`` per source, all
    started together; returns the wall seconds."""
    t0 = time.monotonic()
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as ex:
        sos = dict(zip(SOURCES, ex.map(_compile, SOURCES)))
    with _lock:
        for name, so in sos.items():
            if name not in _libs:
                _libs[name] = _load(name, so)
    return time.monotonic() - t0


def raw_stream(device_index):
    """The handle of the current CUDA stream of a device, as an int,
    without the ``torch.cuda.Stream`` object that
    ``torch.cuda.current_stream`` builds (a few microseconds a launch)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device_index)


def library(name):
    """The loaded library ``name``, built on first use. Once it is loaded
    the lookup takes no lock: a kernel's wrapper calls this on every
    launch."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = _load(name, _compile(name))
        return lib
