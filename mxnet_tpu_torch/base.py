"""Error types, dtype tables and environment knobs for mxnet_tpu_torch.

The port's own copy of the pieces of ``mxnet_tpu/base.py`` it needs
(``MXNetError``, ``InferShapeFatal``, the dtype codes, ``getenv``,
``env_int``, ``env_bool``, ``env_str``, ``check_call``): importing the JAX package's module would run
``mxnet_tpu/__init__.py``, which imports jax. ``deterministic_grads``
and :func:`rdiv_scalar` are the port's own (the JAX package's gradients
repeat without the first; XLA divides correctly rounded without the
second).

The dtype codes are the reference's type flags (float32 0 ... int64 6)
plus bfloat16 as code 7, as in the JAX package. numpy has no bfloat16
without ``ml_dtypes`` (which the machine with the card lacks), so code 7
maps to ``torch.bfloat16`` in the torch table and has no entry in the
numpy table.
"""
from __future__ import annotations

import contextlib
import os

import numpy as _np
import torch

__all__ = ["MXNetError", "InferShapeFatal", "string_types", "numeric_types",
           "mx_real_t", "_DTYPE_NP_TO_MX", "_DTYPE_MX_TO_NP",
           "_DTYPE_TORCH_TO_MX", "_DTYPE_MX_TO_TORCH", "torch_dtype",
           "np_dtype", "getenv", "env_int", "env_bool", "env_str",
           "check_call", "deterministic_grads", "rdiv_scalar"]


class MXNetError(Exception):
    """Error raised by the framework."""


class InferShapeFatal(MXNetError):
    """Shape-inference failure that is NOT "inputs not yet known": the
    graph fixed point (``symbol._infer_shape_impl``) retries an op whose
    ``infer_shape`` raises a plain MXNetError once more inputs resolve,
    and aborts on this subclass."""


string_types = (str,)
numeric_types = (float, int, _np.generic)

_DTYPE_NP_TO_MX = {
    _np.dtype(_np.float32): 0,
    _np.dtype(_np.float64): 1,
    _np.dtype(_np.float16): 2,
    _np.dtype(_np.uint8): 3,
    _np.dtype(_np.int32): 4,
    _np.dtype(_np.int8): 5,
    _np.dtype(_np.int64): 6,
}
_DTYPE_MX_TO_NP = {v: k for k, v in _DTYPE_NP_TO_MX.items()}

_DTYPE_TORCH_TO_MX = {
    torch.float32: 0,
    torch.float64: 1,
    torch.float16: 2,
    torch.uint8: 3,
    torch.int32: 4,
    torch.int8: 5,
    torch.int64: 6,
    torch.bfloat16: 7,
}
_DTYPE_MX_TO_TORCH = {v: k for k, v in _DTYPE_TORCH_TO_MX.items()}

mx_real_t = _np.float32   # default real type


# outside the file format's codes: a uint8 array's sum (``jnp.sum``'s
# uint32)
_DTYPE_EXTRA = {torch.uint32: _np.dtype(_np.uint32)}


def torch_dtype(dtype):
    """The ``torch.dtype`` of a numpy dtype, a dtype name or a torch
    dtype; ``None`` is ``mx_real_t``."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    # a name, or ml_dtypes' bfloat16 type or numpy dtype
    if getattr(dtype, "__name__", str(dtype)) in ("bfloat16", "bf16"):
        return torch.bfloat16
    code = _DTYPE_NP_TO_MX.get(_np.dtype(dtype))
    if code is None:
        for t, n in _DTYPE_EXTRA.items():
            if n == _np.dtype(dtype):
                return t
        raise MXNetError("unsupported dtype %r" % (dtype,))
    return _DTYPE_MX_TO_TORCH[code]


def np_dtype(dtype):
    """The numpy dtype of a torch dtype; bfloat16, which numpy lacks,
    stays ``torch.bfloat16``."""
    t = torch_dtype(dtype)
    code = _DTYPE_TORCH_TO_MX.get(t)
    if code is None:
        if t in _DTYPE_EXTRA:
            return _DTYPE_EXTRA[t]
        raise MXNetError("unsupported dtype %r" % (dtype,))
    return _DTYPE_MX_TO_NP.get(code, torch.bfloat16)


def getenv(name, default=None):
    return os.environ.get(name, default)


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


def env_str(name, default):
    return os.environ.get(name, default)


def check_call(ret):
    """Kept for API familiarity; there is no C return code to check."""
    return ret


def rdiv_scalar(s, x):
    """``s / x`` for a Python scalar ``s``, correctly rounded as
    ``jnp.divide`` is: torch evaluates ``s / x`` as ``reciprocal(x) * s``,
    which rounds twice. ``s`` becomes a 0-d tensor of ``x``'s dtype
    (float32 for an integer ``x``, as the JAX package's weak typing
    gives), made on ``x``'s device without a host copy."""
    dt = x.dtype if x.is_floating_point() else torch.get_default_dtype()
    return torch.div(torch.full((), s, dtype=dt, device=x.device), x)


@contextlib.contextmanager
def deterministic_grads():
    """cuDNN held to its deterministic algorithms for the gradients taken
    inside, unless ``MXNET_ENFORCE_DETERMINISM=0`` (MXNet's variable; on
    by default here, since the JAX package's runs repeat from a seed).
    Some of cuDNN's convolution backward algorithms sum with atomics in
    no fixed order, so without this two trainings from one seed part on
    the card and can end far apart; the forward algorithms are
    deterministic already. The flag is restored on the way out."""
    cudnn = torch.backends.cudnn
    old = cudnn.deterministic
    cudnn.deterministic = old or env_bool("MXNET_ENFORCE_DETERMINISM", True)
    try:
        yield
    finally:
        cudnn.deterministic = old
