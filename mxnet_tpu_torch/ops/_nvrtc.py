"""NVRTC and the CUDA driver API through ``ctypes``: the runtime compiler
and loader behind :mod:`mxnet_tpu_torch.rtc`.

- :func:`compile_cubin` compiles one CUDA C source with NVRTC for
  ``sm_90a`` (``-std=c++17``, the toolkit's headers on the include path
  so ``cuda_fp16.h``/``cuda_bf16.h`` resolve) and returns the CUBIN; a
  failed compile raises :class:`MXNetError` carrying NVRTC's log. Under
  ``MXNET_COMPILE_CACHE_DIR`` the cubin is loaded from, or stored in,
  the persistent cache (``compile/jit_cache.py``), keyed by the source,
  the name, :data:`ARCH` and the NVRTC version; :data:`COMPILES` counts
  the NVRTC compiles this process actually ran.
- :func:`load_function` loads a CUBIN into the primary context of one
  device (``cuModuleLoadData``) and looks a kernel up by name.
- :func:`launch` calls ``cuLaunchKernel`` with one pointer argument per
  tensor on a given stream.

Every handle, pointer and stream goes through ``c_void_p`` and every
dimension through ``c_uint``: with ctypes' default ``int`` a 64-bit
pointer would be cut to 32 bits. Each ``CUresult`` and ``nvrtcResult``
is checked; anything but 0 raises, named by ``cuGetErrorName`` or
``nvrtcGetErrorString``.

The libraries are found at first use, never at import (the CPU path
never imports this module): the driver is ``libcuda.so.1``; NVRTC is the
first ``libnvrtc.so*`` in ``$CUDA_HOME/lib64``, then in the toolkit
beside ``nvcc`` (as :mod:`._build` finds it), then in the
``nvidia/cuda_nvrtc/lib`` directory of the wheel that PyTorch's CUDA
build installs. :data:`info` records the file loaded and
``nvrtcVersion``.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import sys
import threading
from pathlib import Path

from ..base import MXNetError

__all__ = ["compile_cubin", "load_function", "launch", "info", "ARCH",
           "COMPILES"]

ARCH = "sm_90a"

#: NVRTC compiles run in this process (a cache hit runs none)
COMPILES = 0

_P = ctypes.c_void_p
_U = ctypes.c_uint
_I = ctypes.c_int
_S = ctypes.c_size_t
_PP = ctypes.POINTER(ctypes.c_void_p)
_CP = ctypes.c_char_p

_lock = threading.Lock()
_libs = {}      # "cuda" / "nvrtc" -> CDLL
_contexts = {}  # device index -> primary CUcontext (retained once)
info = {}       # "nvrtc_path", "nvrtc_version", "include"


def _toolkit_dirs():
    """Toolkit roots in search order: ``$CUDA_HOME``, then the one whose
    ``bin/`` holds ``nvcc``."""
    roots = []
    home = os.environ.get("CUDA_HOME")
    if home:
        roots.append(Path(home))
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if os.path.exists(nvcc):
        roots.append(Path(nvcc).resolve().parent.parent)
    return roots


def _nvrtc_candidates():
    dirs = [root / "lib64" for root in _toolkit_dirs()]
    dirs += [Path(p) / "nvidia" / "cuda_nvrtc" / "lib" for p in sys.path
             if p and os.path.isdir(os.path.join(p, "nvidia"))]
    return dirs


def _find_nvrtc():
    tried = _nvrtc_candidates()
    for d in tried:
        names = sorted(p.name for p in d.glob("libnvrtc.so*"))
        if names:
            return d / names[0]
    raise MXNetError("NVRTC not found: no libnvrtc.so* in %s"
                     % [str(d) for d in tried])


def _include_dir():
    for root in _toolkit_dirs():
        if (root / "include" / "cuda_fp16.h").exists():
            return root / "include"
    return None


def _bind(lib, name, argtypes, restype=_I):
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = restype
    return fn


def _load():
    """Load and bind both libraries once; returns (cuda, nvrtc)."""
    with _lock:
        if _libs:
            return _libs["cuda"], _libs["nvrtc"]
        try:
            cuda = ctypes.CDLL("libcuda.so.1")
        except OSError as exc:
            raise MXNetError("CUDA driver libcuda.so.1 not loadable: %s"
                             % exc)
        path = _find_nvrtc()
        nvrtc = ctypes.CDLL(str(path))
        _bind(cuda, "cuInit", [_U])
        _bind(cuda, "cuGetErrorName", [_I, ctypes.POINTER(_CP)])
        _bind(cuda, "cuDeviceGet", [ctypes.POINTER(_I), _I])
        _bind(cuda, "cuDevicePrimaryCtxRetain", [_PP, _I])
        _bind(cuda, "cuCtxGetCurrent", [_PP])
        _bind(cuda, "cuCtxSetCurrent", [_P])
        _bind(cuda, "cuModuleLoadData", [_PP, _P])
        _bind(cuda, "cuModuleGetFunction", [_PP, _P, _CP])
        _bind(cuda, "cuLaunchKernel",
              [_P, _U, _U, _U, _U, _U, _U, _U, _P, _PP, _PP])
        _bind(nvrtc, "nvrtcVersion", [ctypes.POINTER(_I), ctypes.POINTER(_I)])
        _bind(nvrtc, "nvrtcGetErrorString", [_I], _CP)
        _bind(nvrtc, "nvrtcCreateProgram",
              [_PP, _CP, _CP, _I, ctypes.POINTER(_CP), ctypes.POINTER(_CP)])
        _bind(nvrtc, "nvrtcCompileProgram", [_P, _I, ctypes.POINTER(_CP)])
        _bind(nvrtc, "nvrtcGetProgramLogSize", [_P, ctypes.POINTER(_S)])
        _bind(nvrtc, "nvrtcGetProgramLog", [_P, ctypes.c_char_p])
        _bind(nvrtc, "nvrtcGetCUBINSize", [_P, ctypes.POINTER(_S)])
        _bind(nvrtc, "nvrtcGetCUBIN", [_P, ctypes.c_char_p])
        _bind(nvrtc, "nvrtcDestroyProgram", [_PP])
        major, minor = _I(), _I()
        _nvrtc_check(nvrtc, nvrtc.nvrtcVersion(ctypes.byref(major),
                                               ctypes.byref(minor)),
                     "nvrtcVersion")
        include = _include_dir()
        info.update(nvrtc_path=str(path),
                    nvrtc_version="%d.%d" % (major.value, minor.value),
                    include=str(include) if include else None)
        _libs["cuda"], _libs["nvrtc"] = cuda, nvrtc
        _cu_check(cuda, cuda.cuInit(0), "cuInit")
        return cuda, nvrtc


def _cu_check(cuda, res, what):
    if res != 0:
        name = _CP()
        cuda.cuGetErrorName(res, ctypes.byref(name))
        raise MXNetError("%s failed: %s (CUresult %d)"
                         % (what, (name.value or b"?").decode(), res))


def _nvrtc_check(nvrtc, res, what, log=""):
    if res != 0:
        msg = (nvrtc.nvrtcGetErrorString(res) or b"?").decode()
        raise MXNetError("%s failed: %s (nvrtcResult %d)%s"
                         % (what, msg, res, "\n" + log if log else ""))


def compile_cubin(source, name):
    """CUBIN bytes of ``source`` compiled by NVRTC for :data:`ARCH`;
    raises with NVRTC's log on a compile error. With the persistent
    cache armed, a stored cubin of the same source, name, architecture
    and NVRTC version is loaded instead."""
    _load()
    from ..compile import ensure_jit_cache, jit_cache

    d = ensure_jit_cache()
    if d is None:
        return _nvrtc_compile(source, name)
    key = jit_cache.entry_key(source, name, ARCH, info["nvrtc_version"])
    return jit_cache.load_or_build(
        key, lambda: _nvrtc_compile(source, name), directory=d)


def _nvrtc_compile(source, name):
    global COMPILES
    _, nvrtc = _load()
    COMPILES += 1
    prog = _P()
    _nvrtc_check(nvrtc, nvrtc.nvrtcCreateProgram(
        ctypes.byref(prog), source.encode(), ("%s.cu" % name).encode(), 0,
        None, None), "nvrtcCreateProgram")
    try:
        opts = ["--gpu-architecture=%s" % ARCH, "-std=c++17"]
        if info.get("include"):
            opts.append("--include-path=%s" % info["include"])
        argv = (_CP * len(opts))(*[o.encode() for o in opts])
        res = nvrtc.nvrtcCompileProgram(prog, len(opts), argv)
        size = _S()
        nvrtc.nvrtcGetProgramLogSize(prog, ctypes.byref(size))
        buf = ctypes.create_string_buffer(size.value)
        nvrtc.nvrtcGetProgramLog(prog, buf)
        log = buf.value.decode(errors="replace").strip()
        _nvrtc_check(nvrtc, res, "NVRTC compile of %s" % name, log)
        _nvrtc_check(nvrtc, nvrtc.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                     "nvrtcGetCUBINSize")
        cubin = ctypes.create_string_buffer(size.value)
        _nvrtc_check(nvrtc, nvrtc.nvrtcGetCUBIN(prog, cubin), "nvrtcGetCUBIN")
        return cubin.raw
    finally:
        nvrtc.nvrtcDestroyProgram(ctypes.byref(prog))


def _make_current(cuda, device_index):
    """Make ``device_index``'s primary context current on this thread:
    the one PyTorch's runtime uses, so modules and launches share its
    memory and streams."""
    ctx = _contexts.get(device_index)
    if ctx is None:
        dev = _I()
        _cu_check(cuda, cuda.cuDeviceGet(ctypes.byref(dev), device_index),
                  "cuDeviceGet")
        ctx = _P()
        _cu_check(cuda, cuda.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev),
                  "cuDevicePrimaryCtxRetain")
        _contexts[device_index] = ctx
    cur = _P()
    _cu_check(cuda, cuda.cuCtxGetCurrent(ctypes.byref(cur)), "cuCtxGetCurrent")
    if cur.value != ctx.value:
        _cu_check(cuda, cuda.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")


def load_function(cubin, name, device_index):
    """The ``CUfunction`` ``name`` of ``cubin`` loaded on the device;
    the module stays loaded for the life of the process."""
    cuda, _ = _load()
    _make_current(cuda, device_index)
    module = _P()
    _cu_check(cuda, cuda.cuModuleLoadData(ctypes.byref(module), cubin),
              "cuModuleLoadData")
    fn = _P()
    _cu_check(cuda, cuda.cuModuleGetFunction(ctypes.byref(fn), module,
                                             name.encode()),
              "cuModuleGetFunction(%s)" % name)
    return fn


def launch(fn, device_index, grid, block, pointers, stream):
    """``cuLaunchKernel(fn, grid, block, 0 bytes shared, stream)`` with
    one pointer argument per entry of ``pointers``."""
    cuda, _ = _load()
    _make_current(cuda, device_index)
    vals = [_P(p) for p in pointers]
    params = (_P * len(vals))(*[ctypes.addressof(v) for v in vals])
    _cu_check(cuda, cuda.cuLaunchKernel(
        fn, *[_U(int(g)) for g in grid], *[_U(int(b)) for b in block], _U(0),
        _P(stream), ctypes.cast(params, _PP), None), "cuLaunchKernel")
