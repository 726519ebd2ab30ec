"""NDArray: a mutable array on one device, over a ``torch.Tensor``.

Counterpart of ``mxnet_tpu/ndarray.py``. The JAX package wraps an
immutable ``jax.Array`` and rebuilds it on every write; here the
NDArray owns a ``torch.Tensor`` and writes go into its storage
(``copy_``, indexed assignment), so a handle taken before a write sees
it, and so does every basic-index view (a torch view of the same
storage). The executor relies on that: ``exe.arg_dict["data"][:] = x``
writes the tensor that the next ``forward`` reads, and the optimizer
updates the weights the executor reads in place. ``version`` is the
tensor's in-place version counter.

The device is explicit: creation functions take ``ctx`` and default to
the current context, ``gpu(0)``, which raises without CUDA, so a program
never runs on the CPU unless it asked for ``cpu()``.

Arithmetic and comparison operators apply torch to the tensors, as the
JAX package's apply ``jax.numpy`` (a Python scalar keeps its weak type:
int32 arrays stay int32 under ``+ - * **``; comparisons give float32
0/1). The registered ops (``_plus``, ``_mul_scalar``, ...) that
``ops.install`` attaches to this module as imperative functions stay
the Symbol path's.

The module functions ``add``, ``subtract``, ``multiply``, ``divide``
(``true_divide``), ``power``, ``maximum``, ``minimum`` and ``negative``
take an NDArray or a scalar on either side, as the JAX package's
(``mxnet_tpu/ndarray.py:679-770``); ``onehot_encode`` writes into its
``out``; ``waitall`` waits for the dependency engine's host tasks
and synchronises the cards; ``imdecode`` decodes an image with PIL.

``save``/``load``/``load_frombuffer`` read and write the JAX package's
binary format byte for byte (``mxnet_tpu/ndarray.py`` ``_write_tensor``
and ``save``), on local paths and stream URIs (``stream.py``); bfloat16 (dtype code 7) is written from
the tensor's int16 view.
"""
from __future__ import annotations

import io as _io
import operator as _operator
import struct

import numpy as _np
import torch

from .base import (MXNetError, _DTYPE_MX_TO_NP, _DTYPE_MX_TO_TORCH,
                   _DTYPE_TORCH_TO_MX, mx_real_t, np_dtype, numeric_types,
                   rdiv_scalar, torch_dtype)
from .context import Context, cpu, current_context, gpu

__all__ = ["NDArray", "zeros", "ones", "full", "empty", "array", "arange",
           "concatenate", "load", "save", "load_frombuffer", "waitall",
           "imdecode",
           "onehot_encode", "add", "subtract", "multiply", "divide",
           "true_divide", "negative", "power", "maximum", "minimum"]


def _ctx_of(tensor):
    dev = tensor.device
    return gpu(dev.index or 0) if dev.type == "cuda" else cpu()


def _as_tensor(value, device, dtype=None):
    """A tensor on ``device`` from an NDArray, tensor, numpy array or
    scalar."""
    if isinstance(value, NDArray):
        value = value._data
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=dtype)
    arr = _np.asarray(value)
    if arr.dtype.name == "bfloat16":   # an ml_dtypes array
        t = torch.from_numpy(_np.array(arr, copy=True).view(_np.int16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(_np.array(arr, copy=True))
    return t.to(device=device, dtype=dtype)


class NDArray:
    """A handle on a ``torch.Tensor`` on one device; see the module
    docstring. Basic-index ``__getitem__`` returns a view sharing the
    storage, as the reference's slices do; advanced indices copy."""

    __slots__ = ("_data", "_ctx", "writable")

    def __init__(self, data, ctx=None, writable=True):
        if isinstance(data, torch.Tensor) and ctx is None:
            ctx = _ctx_of(data)
        if ctx is None:
            ctx = current_context()
        self._ctx = ctx
        self._data = _as_tensor(data, ctx.torch_device)
        self.writable = writable

    def _set_data(self, new_data):
        """Write ``new_data`` into this array's storage (cast to its
        dtype, broadcast to its shape)."""
        if not self.writable:
            raise MXNetError("trying to write to a read-only NDArray")
        src = _as_tensor(new_data, self._data.device)
        if src.shape != self._data.shape:
            try:
                src = src.expand(self._data.shape)
            except RuntimeError:
                raise MXNetError("cannot write shape %s into %s"
                                 % (tuple(src.shape), self.shape))
        with torch.no_grad():
            self._data.copy_(src)

    @property
    def version(self):
        """The content generation: the tensor's in-place version count,
        shared with every view of the same storage."""
        return self._data._version

    def wait_to_read(self):
        """Block until the work that writes this array has finished (a
        synchronisation of its device; nothing on the host)."""
        if self._data.is_cuda:
            torch.cuda.synchronize(self._data.device)

    wait_to_write = wait_to_read

    # -- basic properties ----------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def context(self):
        return self._ctx

    ctx = context

    @property
    def dtype(self):
        """numpy dtype; bfloat16, which numpy lacks, is
        ``torch.bfloat16``."""
        return np_dtype(self._data.dtype)

    @property
    def T(self):
        """A copy with every axis reversed."""
        t = self._data.permute(*reversed(range(self._data.dim())))
        return NDArray(t.clone(memory_format=torch.contiguous_format),
                       self._ctx)

    # -- conversion ----------------------------------------------------------
    def asnumpy(self):
        """Blocking copy to a host numpy array (bfloat16 comes back as
        float32)."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        if t.is_cuda:
            return t.cpu().numpy()
        return t.numpy().copy()

    def asscalar(self):
        """The one element of a (1,)- or ()-shaped array, as a numpy
        scalar."""
        if self.shape != (1,) and self.shape != ():
            raise MXNetError("The current array is not a scalar")
        return self.asnumpy().reshape(-1)[0]

    def astype(self, dtype):
        return NDArray(self._data.to(torch_dtype(dtype), copy=True),
                       self._ctx)

    def copyto(self, other):
        """Copy into an NDArray (its storage, device and dtype) or onto
        a Context (a new array)."""
        if isinstance(other, NDArray):
            if other is self:
                return other
            if other.shape != self.shape:
                raise MXNetError("copyto shape mismatch: %s vs %s"
                                 % (self.shape, other.shape))
            other._set_data(self._data)
            return other
        if isinstance(other, Context):
            return NDArray(self._data.to(other.torch_device, copy=True),
                           other)
        raise TypeError("copyto does not support type " + str(type(other)))

    def copy(self):
        return self.copyto(self._ctx)

    def as_in_context(self, context):
        if self._ctx == context:
            return self
        return self.copyto(context)

    # -- shape ---------------------------------------------------------------
    def reshape(self, new_shape):
        """A view of the same storage where the strides allow it (one
        -1 wildcard)."""
        return NDArray(self._data.reshape(tuple(new_shape)), self._ctx,
                       writable=self.writable)

    def broadcast_to(self, shape):
        """A new array of ``shape``: size-1 axes grow, the rank stays."""
        shape = tuple(shape)
        cur = self.shape
        if len(cur) != len(shape):
            raise MXNetError(
                "Broadcasting the array to shape %s needs the same ndim as %s"
                % (shape, cur))
        for c, s in zip(cur, shape):
            if c != s and c != 1:
                raise MXNetError(
                    "cannot broadcast %s to %s: only size-1 axes may grow"
                    % (cur, shape))
        return NDArray(self._data.expand(shape).contiguous(), self._ctx)

    # -- indexing ------------------------------------------------------------
    def __getitem__(self, key):
        # torch indexing: a view for ints, slices and Ellipsis, a copy
        # for index arrays and masks
        return NDArray(self._data[key], self._ctx, writable=self.writable)

    def __setitem__(self, key, value):
        if not self.writable:
            raise MXNetError("trying to write to a read-only NDArray")
        if isinstance(value, numeric_types):
            with torch.no_grad():
                self._data[key] = value
            return
        src = _as_tensor(value, self._data.device, self._data.dtype)
        with torch.no_grad():
            self._data[key] = src

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    # -- arithmetic ----------------------------------------------------------
    def _binary(self, other, fn, reverse=False):
        """``fn(self, other)`` on the tensors (``fn(other, self)`` when
        ``reverse``). A Python scalar goes in as it is, so torch's
        promotion gives what JAX's weak typing gives in the JAX package:
        an int32 array stays int32 under ``+ - * **`` with an int, and
        ``/`` gives float32."""
        if isinstance(other, NDArray):
            if other._ctx != self._ctx:
                raise MXNetError("operands are on different contexts: %s "
                                 "vs %s" % (self._ctx, other._ctx))
            rhs = other._data
        elif isinstance(other, numeric_types):
            rhs = other.item() if isinstance(other, _np.generic) else other
        else:
            return NotImplemented
        a, b = (rhs, self._data) if reverse else (self._data, rhs)
        return NDArray(fn(a, b), self._ctx)

    def __add__(self, other):
        return self._binary(other, _operator.add)

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, _operator.sub)

    def __rsub__(self, other):
        return self._binary(other, _operator.sub, reverse=True)

    def __mul__(self, other):
        return self._binary(other, _operator.mul)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary(other, _operator.truediv)

    def __rtruediv__(self, other):
        # only a scalar reaches here: NDArray / NDArray is __truediv__
        return self._binary(other, rdiv_scalar, reverse=True)

    def __mod__(self, other):
        """Floor modulo (the divisor's sign), as ``jnp.mod``; like the
        JAX package's NDArray there is no ``__rmod__``."""
        return self._binary(other, torch.remainder)

    def __pow__(self, other):
        return self._binary(other, _operator.pow)

    def __rpow__(self, other):
        return self._binary(other, _operator.pow, reverse=True)

    def __neg__(self):
        return NDArray(torch.neg(self._data), self._ctx)

    def __abs__(self):
        return NDArray(torch.abs(self._data), self._ctx)

    def _inplace(self, other, fn):
        out = fn(other)
        if out is NotImplemented:
            return NotImplemented
        self._set_data(out._data)
        return self

    def __iadd__(self, other):
        return self._inplace(other, self.__add__)

    def __isub__(self, other):
        return self._inplace(other, self.__sub__)

    def __imul__(self, other):
        return self._inplace(other, self.__mul__)

    def __itruediv__(self, other):
        return self._inplace(other, self.__truediv__)

    # comparisons give float32 0/1 arrays, as the JAX package's do
    def _cmp(self, other, fn):
        return self._binary(other, lambda a, b: fn(a, b).to(torch.float32))

    def __eq__(self, other):
        return self._cmp(other, _operator.eq)

    def __ne__(self, other):
        return self._cmp(other, _operator.ne)

    def __gt__(self, other):
        return self._cmp(other, _operator.gt)

    def __ge__(self, other):
        return self._cmp(other, _operator.ge)

    def __lt__(self, other):
        return self._cmp(other, _operator.lt)

    def __le__(self, other):
        return self._cmp(other, _operator.le)

    def __bool__(self):
        if self.size == 1:
            return bool(self._data.reshape(-1)[0].item())
        raise ValueError("The truth value of an NDArray with more than one "
                         "element is ambiguous")

    __hash__ = None  # mutable handle

    def __repr__(self):
        return "<NDArray %s @%s>" % ("x".join(str(d) for d in self.shape),
                                     self._ctx)


# -- creation ----------------------------------------------------------------

def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _device(ctx):
    ctx = ctx or current_context()
    return ctx, ctx.torch_device


def empty(shape, ctx=None, dtype=mx_real_t):
    ctx, dev = _device(ctx)
    return NDArray(torch.empty(_shape(shape), dtype=torch_dtype(dtype),
                               device=dev), ctx)


def zeros(shape, ctx=None, dtype=mx_real_t):
    ctx, dev = _device(ctx)
    return NDArray(torch.zeros(_shape(shape), dtype=torch_dtype(dtype),
                               device=dev), ctx)


def ones(shape, ctx=None, dtype=mx_real_t):
    ctx, dev = _device(ctx)
    return NDArray(torch.ones(_shape(shape), dtype=torch_dtype(dtype),
                              device=dev), ctx)


def full(shape, val, ctx=None, dtype=mx_real_t):
    ctx, dev = _device(ctx)
    return NDArray(torch.full(_shape(shape), val, dtype=torch_dtype(dtype),
                              device=dev), ctx)


# numpy's 64-bit defaults -> the JAX package's 32-bit types
_X32 = {_np.dtype(_np.float64): mx_real_t, _np.dtype(_np.int64): _np.int32}


def array(source_array, ctx=None, dtype=None):
    """An array from a numpy array, list or NDArray; float64 sources
    become float32 and int64 sources int32 unless ``dtype`` says
    otherwise, as in the JAX package (JAX's default 32-bit mode)."""
    if isinstance(source_array, NDArray):
        src = source_array._data
        if dtype is None:
            dtype = src.dtype
    else:
        src = _np.asarray(source_array)
        if dtype is None:
            dtype = (torch.bfloat16 if src.dtype.name == "bfloat16"
                     else _X32.get(src.dtype, src.dtype))
    ctx, dev = _device(ctx)
    return NDArray(_as_tensor(src, dev, torch_dtype(dtype)), ctx)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=mx_real_t):
    ctx, dev = _device(ctx)
    if stop is None:
        start, stop = 0, start
    data = torch.arange(start, stop, step, dtype=torch_dtype(dtype),
                        device=dev)
    if repeat != 1:
        data = data.repeat_interleave(repeat)
    return NDArray(data, ctx)


def concatenate(arrays, axis=0, always_copy=True):
    """One array of ``arrays`` joined along ``axis``, on the first
    array's context (ref: python/mxnet/ndarray.py:824)."""
    if not arrays:
        raise MXNetError("need at least one array to concatenate")
    if len(arrays) == 1 and not always_copy:
        return arrays[0]
    ctx = arrays[0].context
    return NDArray(torch.cat([_as_tensor(a, ctx.torch_device)
                              for a in arrays], dim=axis), ctx)


def onehot_encode(indices, out):
    """Write the one-hot rows of ``indices`` into ``out`` (its width is
    the depth) and return ``out``."""
    depth = out.shape[1]
    idx = indices._data.to(torch.int32)
    oh = idx[:, None] == torch.arange(depth, dtype=torch.int32,
                                      device=idx.device)[None, :]
    out._set_data(oh.to(out._data.dtype))
    return out


def waitall():
    """Block until the host tasks pushed to the dependency engine (async
    checkpoints) and the work queued on every initialised card have
    finished."""
    from . import engine as _engine

    if _engine.Engine._instance is not None:
        _engine.Engine._instance.wait_for_all()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def imdecode(str_img, clip_rect=(0, 0, 0, 0), out=None, index=0, channels=3,
             mean=None):
    """Decode an image from compressed bytes into a [1, C, H, W] f32
    array on the current context (ref: src/ndarray/ndarray.cc:798
    _imdecode, which uses OpenCV; PIL here, as in the JAX package)."""
    try:
        from PIL import Image
    except ImportError as e:  # pragma: no cover
        raise MXNetError("imdecode requires PIL") from e
    img = Image.open(_io.BytesIO(str_img))
    if channels == 3:
        img = img.convert("RGB")
    arr = _np.asarray(img, dtype=_np.float32)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    x0, y0, x1, y1 = clip_rect
    if x1 > 0 and y1 > 0:
        arr = arr[y0:y1, x0:x1]
    if mean is not None:
        arr = arr - mean.asnumpy()
    arr = arr.transpose(2, 0, 1)[None]  # NCHW
    res = array(arr)
    if out is not None:
        out._set_data(res._data)
        return out
    return res


# -- serialization -----------------------------------------------------------
# file  := MAGIC(u64) RESERVED(u64) count(u64) names(u64) [len(u64) name]
#          [tensor]
# tensor:= ndim(u32) shape(u32*ndim) dtype_code(u32) raw little-endian data
_ND_MAGIC = 0x112


def _write_tensor(f, arr):
    t = arr._data if isinstance(arr, NDArray) else arr
    if not isinstance(t, torch.Tensor):
        t = _as_tensor(t, "cpu")
    t = t.detach().contiguous().cpu()
    code = _DTYPE_TORCH_TO_MX.get(t.dtype)
    if code is None:
        raise MXNetError("save: unsupported dtype %s" % t.dtype)
    f.write(struct.pack("<I", t.dim()))
    for d in t.shape:
        f.write(struct.pack("<I", d))
    f.write(struct.pack("<I", code))
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    f.write(t.numpy().tobytes())


def _read_tensor(f, ctx):
    ndim = struct.unpack("<I", f.read(4))[0]
    shape = tuple(struct.unpack("<I", f.read(4))[0] for _ in range(ndim))
    code = struct.unpack("<I", f.read(4))[0]
    tdtype = _DTYPE_MX_TO_TORCH[code]
    npdtype = _DTYPE_MX_TO_NP.get(code, _np.dtype(_np.int16))
    n = int(_np.prod(shape)) if shape else 1
    raw = f.read(n * npdtype.itemsize)
    if len(raw) != n * npdtype.itemsize:
        raise MXNetError("truncated tensor data")
    t = torch.from_numpy(_np.frombuffer(raw, dtype=npdtype).copy())
    if tdtype == torch.bfloat16:
        t = t.view(torch.bfloat16)
    return NDArray(t.reshape(shape), ctx)


def save(fname, data):
    """Save a list or dict of NDArray to a file or stream URI
    (``mem://``, ``s3://``, ``hdfs://``; ``stream.open_stream``)."""
    if isinstance(data, dict):
        names = list(data.keys())
        arrays = [data[k] for k in names]
    elif isinstance(data, (list, tuple)):
        names = []
        arrays = list(data)
    else:
        raise MXNetError("save requires a list or dict of NDArray")
    from .stream import open_stream

    with open_stream(fname, "wb") as f:
        f.write(struct.pack("<QQQ", _ND_MAGIC, 0, len(arrays)))
        f.write(struct.pack("<Q", len(names)))
        for name in names:
            enc = name.encode("utf-8")
            f.write(struct.pack("<Q", len(enc)))
            f.write(enc)
        for arr in arrays:
            _write_tensor(f, arr)


def load(fname, ctx=None):
    """Load a list or dict of NDArray from a file or stream URI (onto
    ``ctx``, by default the host)."""
    from .stream import open_stream

    with open_stream(fname, "rb") as f:
        return load_frombuffer(f.read(), ctx)


def load_frombuffer(buf, ctx=None):
    """Load a list or dict of NDArray from the bytes of a ``.params``
    file."""
    if ctx is None:
        ctx = cpu()
    f = _io.BytesIO(buf)
    try:
        magic, _, count = struct.unpack("<QQQ", f.read(24))
        if magic != _ND_MAGIC:
            raise MXNetError("invalid NDArray buffer")
        num_names = struct.unpack("<Q", f.read(8))[0]
        names = []
        for _ in range(num_names):
            ln = struct.unpack("<Q", f.read(8))[0]
            names.append(f.read(ln).decode("utf-8"))
        arrays = [_read_tensor(f, ctx) for _ in range(count)]
    except MXNetError:
        raise
    except Exception as exc:
        raise MXNetError("invalid or truncated NDArray buffer: %s" % exc)
    if names:
        return dict(zip(names, arrays))
    return arrays


# -- module-level arithmetic: NDArray or scalar on either side -----------------
def maximum(lhs, rhs):
    """Elementwise max of arrays or scalars, through ``_maximum`` and
    ``_maximum_scalar`` (attached to this module by ``ops.install``)."""
    if isinstance(lhs, numeric_types) and isinstance(rhs, numeric_types):
        # not max(): the 'max' reduction op is attached to this module
        return lhs if lhs > rhs else rhs
    if isinstance(rhs, numeric_types):
        return _maximum_scalar(lhs, scalar=float(rhs))  # noqa: F821
    if isinstance(lhs, numeric_types):
        return _maximum_scalar(rhs, scalar=float(lhs))  # noqa: F821
    return _maximum(lhs, rhs)  # noqa: F821


def minimum(lhs, rhs):
    """Elementwise min of arrays or scalars."""
    if isinstance(lhs, numeric_types) and isinstance(rhs, numeric_types):
        return lhs if lhs < rhs else rhs   # see maximum(): 'min' is an op
    if isinstance(rhs, numeric_types):
        return _minimum_scalar(lhs, scalar=float(rhs))  # noqa: F821
    if isinstance(lhs, numeric_types):
        return _minimum_scalar(rhs, scalar=float(lhs))  # noqa: F821
    return _minimum(lhs, rhs)  # noqa: F821


def add(lhs, rhs):
    if isinstance(lhs, numeric_types) and isinstance(rhs, numeric_types):
        return lhs + rhs
    return (lhs + rhs) if isinstance(lhs, NDArray) else (rhs + lhs)


def subtract(lhs, rhs):
    if isinstance(lhs, numeric_types) and isinstance(rhs, numeric_types):
        return lhs - rhs
    if isinstance(lhs, NDArray):
        return lhs - rhs
    return rhs.__rsub__(lhs)


def multiply(lhs, rhs):
    if isinstance(lhs, numeric_types) and isinstance(rhs, numeric_types):
        return lhs * rhs
    return (lhs * rhs) if isinstance(lhs, NDArray) else (rhs * lhs)


def divide(lhs, rhs):
    if isinstance(lhs, numeric_types) and isinstance(rhs, numeric_types):
        return lhs / rhs
    if isinstance(lhs, NDArray):
        return lhs / rhs
    return rhs.__rtruediv__(lhs)


true_divide = divide


def negative(arr):
    """``-arr``, in the array's dtype."""
    return -arr


def power(base, exp):
    if isinstance(base, numeric_types) and isinstance(exp, numeric_types):
        return base ** exp
    if isinstance(base, NDArray):
        return base ** exp
    return exp.__rpow__(base)
