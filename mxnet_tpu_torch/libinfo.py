"""Locate the framework's native libraries (ref: python/mxnet/libinfo.py).

Counterpart of ``mxnet_tpu/libinfo.py``. The reference's find_lib_path
hunts for libmxnet.so; the port's native parts are the hand-written
CUDA kernels, which ``ops/_build.py`` compiles with ``nvcc`` into
``build/torch_kernels/`` at first use (one library a source, named by
the hash of the source and the headers it includes), and the dependency
engine, which ``engine.py`` compiles from ``csrc/engine.cc`` into
``build/torch_engine/``.
"""
from __future__ import annotations

import os

__all__ = ["find_lib_path"]


def find_lib_path():
    """Paths of the native libraries of this checkout, the existing ones
    when any exist, else every candidate (ref: libinfo.py:8
    find_lib_path). As in the JAX package an empty build is not an
    error: each library is built where it is first needed."""
    from . import engine
    from .ops import _build

    candidates = [str(_build._so_path(name)[1]) for name in _build.SOURCES]
    candidates.append(str(engine.library_path()))
    found = [p for p in candidates if os.path.exists(p)]
    return found or candidates
