"""Error type and environment knobs for mxnet_tpu_torch.

The port's own copy of the pieces of ``mxnet_tpu/base.py`` the serving
slice needs (``MXNetError``, ``env_int``, ``env_bool``): importing the
JAX package's module would run ``mxnet_tpu/__init__.py``, which imports
jax.
"""
from __future__ import annotations

import os

__all__ = ["MXNetError", "env_int", "env_bool"]


class MXNetError(Exception):
    """Error raised by the framework."""


def env_int(name, default):
    """Integer env config knob; an unset or empty variable gives the
    default, a malformed one raises."""
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    try:
        return int(v)
    except ValueError:
        raise MXNetError("env var %s=%r is not an int" % (name, v))


def env_bool(name, default):
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    return v not in ("0", "false", "False", "")
