"""Simple tensor ops: the whole of the JAX package's
``mxnet_tpu/ops/tensor.py``, computed with torch.

Counterpart of ``mxnet_tpu/ops/tensor.py`` with the same names, aliases
and parameters: the unary ops (``:25-38``; ``_neg`` is an alias of
``negative``'s op, and ``tanh_op`` is a Symbol op only), the elementwise
binaries and array-scalar ops (``:41-59``; ``scalar`` a float),
``clip`` (``:68``), the reductions ``sum``/``sum_axis``,
``max``/``max_axis``, ``min``/``min_axis`` and ``mean`` (``:106-136``:
``axis`` and ``keepdims``; a full reduction gives shape (1,)), ``norm``
(``:144``, shape (1,)), ``argmax_channel``, ``argmax`` and ``argmin``
(``:158-188``: the index in the input's dtype, the first of ties),
the ``broadcast_*`` binaries (``:204-215``; the comparisons give 0/1 in
the left operand's dtype), ``broadcast_axis`` and ``broadcast_to``
(``:240``, ``:267``; a 0 in ``shape`` keeps the input's size), ``dot``
(``:304``: ``transpose_a``/``_b`` reverse every axis, the product is
``jnp.dot``'s over the last axis of the left and the second-to-last of
the right, and two vectors give shape (1,)), ``batch_dot`` (``:336``),
``transpose`` (``:365``; ``axes=()`` reverses the axes, and the result
is a view), ``expand_dims``, ``flip``, ``slice_axis``, ``crop_nd``,
``smooth_l1`` (SSD's localisation loss; ``scalar`` is sigma),
``softmax_cross_entropy`` (the summed loss, shape (1,)),
``element_mask`` and the NDArray functions ``choose_element_0index``
and ``fill_element_0index``. The products are ``torch.tensordot`` and
``torch.matmul``, as the JAX package leaves ``jnp.dot`` and
``jnp.matmul`` to XLA outside any Pallas kernel.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError, rdiv_scalar
from .registry import REGISTRY, Field, OpDef, register, scalar_op, \
    simple_binary, simple_unary

simple_unary("abs", torch.abs)
simple_unary("ceil", torch.ceil)
simple_unary("cos", torch.cos)
simple_unary("exp", torch.exp)
simple_unary("floor", torch.floor)
simple_unary("log", torch.log)
simple_unary("round", torch.round)   # half to even, as jnp.round
simple_unary("rsqrt", lambda x: 1.0 / torch.sqrt(x))
simple_unary("sign", torch.sign)
simple_unary("sin", torch.sin)
simple_unary("sqrt", torch.sqrt)
simple_unary("square", torch.square)
simple_unary("negative", torch.neg, aliases=("_neg",))
simple_unary("tanh_op", torch.tanh, imperative=False)

simple_binary("_plus", torch.add, aliases=("_add", "elemwise_add"))
simple_binary("_minus", torch.sub, aliases=("_sub",))
simple_binary("_mul", torch.mul)
simple_binary("_div", torch.div)
simple_binary("_power", torch.pow)
simple_binary("_maximum", torch.maximum)
simple_binary("_minimum", torch.minimum)

scalar_op("_plus_scalar", lambda x, s: x + s)
scalar_op("_minus_scalar", lambda x, s: x - s)
scalar_op("_rminus_scalar", lambda x, s: s - x)
scalar_op("_mul_scalar", lambda x, s: x * s)
scalar_op("_div_scalar", lambda x, s: x / s)
scalar_op("_rdiv_scalar", lambda x, s: rdiv_scalar(s, x))
scalar_op("_power_scalar", lambda x, s: torch.pow(x, s))
scalar_op("_rpower_scalar", lambda x, s: torch.pow(s, x))
scalar_op("_maximum_scalar", lambda x, s: torch.clamp(x, min=s))
scalar_op("_minimum_scalar", lambda x, s: torch.clamp(x, max=s))


# -- reductions ----------------------------------------------------------------
def _axis_param(params):
    ax = params.get("axis")
    if ax is None or ax == ():
        return None
    if isinstance(ax, tuple) and len(ax) == 1:
        return ax[0]
    return ax


def _reduce_shape(params, in_shapes):
    if in_shapes[0] is None:
        raise MXNetError("reduction: input shape unknown")
    shape = in_shapes[0]
    ax = _axis_param(params)
    keepdims = params.get("keepdims", False)
    if ax is None:
        out = (1,) if not keepdims else tuple(1 for _ in shape)
    else:
        axes = (ax,) if isinstance(ax, int) else tuple(ax)
        axes = tuple(a % len(shape) for a in axes)
        if keepdims:
            out = tuple(1 if i in axes else d for i, d in enumerate(shape))
        else:
            out = tuple(d for i, d in enumerate(shape) if i not in axes)
            if out == ():
                out = (1,)
    return [shape], [out], []


def _make_reduce(name, fn, aliases=()):
    def fwd(params, inputs, aux, is_train, rng):
        ax = _axis_param(params)
        keepdims = params.get("keepdims", False)
        x = inputs[0]
        if ax is None:
            out = fn(x)
            out = out.reshape((1,) * x.dim()) if keepdims else out
        else:
            out = fn(x, dim=ax, keepdim=keepdims)
        if out.dim() == 0:
            out = out.reshape(1)
        return [out], []

    op = register(
        OpDef(
            name,
            fwd,
            params={
                "axis": Field("shape", default=None),
                "keepdims": Field("bool", default=False),
            },
            infer_shape=_reduce_shape,
        )
    )
    for a in aliases:
        REGISTRY[a] = op
    return op


_UNSIGNED = (torch.uint8, torch.uint16, torch.uint32, torch.uint64)


def _sum(x, *args, **kwargs):
    """``jnp.sum``'s dtypes: integer and bool inputs sum to int32, or to
    uint32 when unsigned (torch's sum gives int64); the wrap is modulo
    2^32 either way."""
    out = torch.sum(x, *args, **kwargs)
    if x.is_floating_point() or x.is_complex():
        return out
    return out.to(torch.uint32 if x.dtype in _UNSIGNED else torch.int32)


def _mean(x, *args, **kwargs):
    """``jnp.mean``: an integer input is averaged in float32."""
    return torch.mean(x if x.is_floating_point() else x.float(), *args,
                      **kwargs)


# amax/amin share a tie's gradient evenly, as the JAX reductions do
_make_reduce("sum", _sum, aliases=("sum_axis",))
_make_reduce("max", torch.amax, aliases=("max_axis",))
_make_reduce("min", torch.amin, aliases=("min_axis",))
_make_reduce("mean", _mean)


def _norm_fwd(params, inputs, aux, is_train, rng):
    return [torch.sqrt(torch.sum(torch.square(inputs[0]))).reshape(1)], []


register(
    OpDef(
        "norm",
        _norm_fwd,
        infer_shape=lambda p, s: ([s[0]], [(1,)], []),
    )
)


def _argmax_channel_fwd(params, inputs, aux, is_train, rng):
    return [torch.argmax(inputs[0], dim=1).to(inputs[0].dtype)], []


register(
    OpDef(
        "argmax_channel",
        _argmax_channel_fwd,
        infer_shape=lambda p, s: ([s[0]], [(s[0][0],)], []),
    )
)


def _make_arg(name, fn):
    def fwd(params, inputs, aux, is_train, rng):
        ax = params.get("axis")
        x = inputs[0]
        out = fn(x) if ax is None else fn(x, dim=ax)
        if out.dim() == 0:
            out = out.reshape(1)
        return [out.to(x.dtype)], []

    def ishape(params, s):
        if s[0] is None:
            raise MXNetError("%s: input shape unknown" % name)
        ax = params.get("axis")
        if ax is None:
            return [s[0]], [(1,)], []
        ax = ax % len(s[0])
        out = tuple(d for i, d in enumerate(s[0]) if i != ax) or (1,)
        return [s[0]], [out], []

    register(OpDef(name, fwd, params={"axis": Field("int", default=None)}, infer_shape=ishape))


_make_arg("argmax", torch.argmax)
_make_arg("argmin", torch.argmin)


# -- clip ----------------------------------------------------------------------
def _clip_fwd(params, inputs, aux, is_train, rng):
    return [torch.clamp(inputs[0], params["a_min"], params["a_max"])], []


register(
    OpDef(
        "clip",
        _clip_fwd,
        params={"a_min": Field("float", required=True), "a_max": Field("float", required=True)},
    )
)


# -- broadcast ops -------------------------------------------------------------
def _broadcast_binary_shape(params, in_shapes):
    a, b = in_shapes
    if a is None or b is None:
        known = a or b
        if known is None:
            raise MXNetError("broadcast op: no input shape known")
        return [known, known], [known], []
    out = tuple(_np.broadcast_shapes(a, b))
    return [a, b], [out], []


for _nm, _fn in [
    ("broadcast_plus", torch.add),
    ("broadcast_minus", torch.sub),
    ("broadcast_mul", torch.mul),
    ("broadcast_div", torch.div),
    ("broadcast_power", torch.pow),
    ("broadcast_equal", lambda a, b: torch.eq(a, b).to(a.dtype)),
    ("broadcast_greater", lambda a, b: torch.gt(a, b).to(a.dtype)),
    ("broadcast_lesser", lambda a, b: torch.lt(a, b).to(a.dtype)),
    ("broadcast_maximum", torch.maximum),
    ("broadcast_minimum", torch.minimum),
]:
    simple_binary(_nm, _fn, infer_shape=_broadcast_binary_shape)


def _broadcast_axis_fwd(params, inputs, aux, is_train, rng):
    x = inputs[0]
    shape = list(x.shape)
    for a, s in zip(params["axis"], params["size"]):
        shape[a] = s
    return [x.expand(tuple(shape))], []


def _broadcast_axis_shape(params, in_shapes):
    if in_shapes[0] is None:
        raise MXNetError("broadcast_axis: input shape unknown")
    shape = list(in_shapes[0])
    for a, s in zip(params["axis"], params["size"]):
        if shape[a] != 1:
            raise MXNetError("broadcast_axis: axis %d is not 1" % a)
        shape[a] = s
    return [in_shapes[0]], [tuple(shape)], []


register(
    OpDef(
        "broadcast_axis",
        _broadcast_axis_fwd,
        params={"axis": Field("shape", required=True), "size": Field("shape", required=True)},
        infer_shape=_broadcast_axis_shape,
    )
)


def _broadcast_to_fwd(params, inputs, aux, is_train, rng):
    x = inputs[0]
    # a 0 in the target keeps the input's size on that axis
    tgt = tuple(x.shape[i] if t == 0 else t
                for i, t in enumerate(params["shape"]))
    return [x.expand(tgt)], []


def _broadcast_to_shape(params, in_shapes):
    if in_shapes[0] is None:
        raise MXNetError("broadcast_to: input shape unknown")
    tgt = tuple(
        in_shapes[0][i] if t == 0 else t for i, t in enumerate(params["shape"])
    )
    return [in_shapes[0]], [tgt], []


register(
    OpDef(
        "broadcast_to",
        _broadcast_to_fwd,
        params={"shape": Field("shape", required=True)},
        infer_shape=_broadcast_to_shape,
    )
)


# -- matrix ops ----------------------------------------------------------------
def _reverse_axes(x):
    return x.permute(*reversed(range(x.dim())))


def _dot_fwd(params, inputs, aux, is_train, rng):
    a, b = inputs
    if params.get("transpose_a"):
        a = _reverse_axes(a)
    if params.get("transpose_b"):
        b = _reverse_axes(b)
    # two vectors give their inner product as shape (1,)
    if a.dim() == 1 and b.dim() == 1:
        return [torch.dot(a, b).reshape(1)], []
    # jnp.dot: the last axis of a against the second-to-last of b
    return [torch.tensordot(a, b, dims=([a.dim() - 1],
                                         [max(b.dim() - 2, 0)]))], []


def _dot_shape(params, in_shapes):
    a, b = in_shapes
    if a is None or b is None:
        raise MXNetError("dot: input shapes unknown")
    ta, tb = params.get("transpose_a"), params.get("transpose_b")
    if len(a) == 1 and len(b) == 1:
        return [a, b], [(1,)], []
    aa = tuple(reversed(a)) if ta else a
    bb = tuple(reversed(b)) if tb else b
    if aa[-1] != bb[0]:
        raise MXNetError("dot shape mismatch: %s x %s" % (aa, bb))
    return [a, b], [aa[:-1] + bb[1:]], []


register(
    OpDef(
        "dot",
        _dot_fwd,
        params={
            "transpose_a": Field("bool", default=False),
            "transpose_b": Field("bool", default=False),
        },
        arguments=("lhs", "rhs"),
        infer_shape=_dot_shape,
    )
)


def _batch_dot_fwd(params, inputs, aux, is_train, rng):
    a, b = inputs
    if params.get("transpose_a"):
        a = torch.swapaxes(a, -1, -2)
    if params.get("transpose_b"):
        b = torch.swapaxes(b, -1, -2)
    return [torch.matmul(a, b)], []


def _batch_dot_shape(params, in_shapes):
    a, b = in_shapes
    if a is None or b is None:
        raise MXNetError("batch_dot: input shapes unknown")
    aa = a[:-2] + (a[-1], a[-2]) if params.get("transpose_a") else a
    bb = b[:-2] + (b[-1], b[-2]) if params.get("transpose_b") else b
    return [a, b], [aa[:-1] + (bb[-1],)], []


register(
    OpDef(
        "batch_dot",
        _batch_dot_fwd,
        params={
            "transpose_a": Field("bool", default=False),
            "transpose_b": Field("bool", default=False),
        },
        arguments=("lhs", "rhs"),
        infer_shape=_batch_dot_shape,
    )
)


# -- transpose -----------------------------------------------------------------
def _transpose_fwd(params, inputs, aux, is_train, rng):
    x = inputs[0]
    axes = params.get("axes") or tuple(reversed(range(x.dim())))
    return [x.permute(axes)], []


def _transpose_shape(params, in_shapes):
    if in_shapes[0] is None:
        raise MXNetError("transpose: input shape unknown")
    s = in_shapes[0]
    axes = params.get("axes") or tuple(reversed(range(len(s))))
    return [s], [tuple(s[a] for a in axes)], []


register(
    OpDef(
        "transpose",
        _transpose_fwd,
        params={"axes": Field("shape", default=())},
        infer_shape=_transpose_shape,
    )
)


def _expand_dims_fwd(params, inputs, aux, is_train, rng):
    return [inputs[0].unsqueeze(params["axis"])], []


def _expand_dims_shape(params, in_shapes):
    if in_shapes[0] is None:
        raise MXNetError("expand_dims: input shape unknown")
    s = list(in_shapes[0])
    s.insert(params["axis"], 1)
    return [in_shapes[0]], [tuple(s)], []


register(
    OpDef(
        "expand_dims",
        _expand_dims_fwd,
        params={"axis": Field("int", required=True)},
        infer_shape=_expand_dims_shape,
    )
)


def _flip_fwd(params, inputs, aux, is_train, rng):
    return [torch.flip(inputs[0], (params["axis"],))], []


register(
    OpDef(
        "flip",
        _flip_fwd,
        params={"axis": Field("int", required=True)},
        infer_shape=lambda p, s: ([s[0]], [s[0]], []),
    )
)


def _slice_axis_fwd(params, inputs, aux, is_train, rng):
    ax, b, e = params["axis"], params["begin"], params["end"]
    x = inputs[0]
    if e is None or e == 0:
        e = x.shape[ax]
    idx = [slice(None)] * x.dim()
    idx[ax] = slice(b, e)
    return [x[tuple(idx)]], []


def _slice_axis_shape(params, in_shapes):
    if in_shapes[0] is None:
        raise MXNetError("slice_axis: input shape unknown")
    s = list(in_shapes[0])
    ax = params["axis"] % len(s)
    e = params["end"] if params["end"] not in (None, 0) else s[ax]
    b = params["begin"]
    if b < 0:
        b += s[ax]
    if e < 0:
        e += s[ax]
    s[ax] = e - b
    return [in_shapes[0]], [tuple(s)], []


register(
    OpDef(
        "slice_axis",
        _slice_axis_fwd,
        params={
            "axis": Field("int", required=True),
            "begin": Field("int", required=True),
            "end": Field("int", default=None),
        },
        infer_shape=_slice_axis_shape,
    )
)


def _crop_simple_fwd(params, inputs, aux, is_train, rng):
    idx = tuple(slice(b, e) for b, e in zip(params["begin"], params["end"]))
    return [inputs[0][idx]], []


register(
    OpDef(
        "crop_nd",
        _crop_simple_fwd,
        params={"begin": Field("shape", required=True), "end": Field("shape", required=True)},
        infer_shape=lambda p, s: (
            [s[0]],
            [tuple(e - b for b, e in zip(p["begin"], p["end"]))],
            [],
        ),
    )
)


# -- smooth_l1 -----------------------------------------------------------------
def _smooth_l1_fwd(params, inputs, aux, is_train, rng):
    sigma = params["scalar"]
    s2 = sigma * sigma
    x = inputs[0]
    out = torch.where(
        torch.abs(x) < 1.0 / s2, 0.5 * s2 * torch.square(x),
        torch.abs(x) - 0.5 / s2)
    return [out], []


register(
    OpDef(
        "smooth_l1",
        _smooth_l1_fwd,
        params={"scalar": Field("float", default=1.0)},
    )
)


# -- softmax_cross_entropy -----------------------------------------------------
def _sce_fwd(params, inputs, aux, is_train, rng):
    data, label = inputs
    logp = torch.log_softmax(data, dim=-1)
    nll = -torch.gather(logp, -1, label.long()[:, None])[:, 0]
    return [torch.sum(nll).reshape(1)], []


register(
    OpDef(
        "softmax_cross_entropy",
        _sce_fwd,
        arguments=("data", "label"),
        infer_shape=lambda p, s: ([s[0], (s[0][0],)], [(1,)], []),
    )
)


# -- element_mask --------------------------------------------------------------
def _element_mask_fwd(params, inputs, aux, is_train, rng):
    data, mask = inputs
    m = mask.reshape((mask.shape[0],) + (1,) * (data.dim() - 1))
    return [data * m.to(data.dtype)], []


register(
    OpDef(
        "element_mask",
        _element_mask_fwd,
        arguments=("data", "mask"),
        infer_shape=lambda p, s: ([s[0], (s[0][0],)], [s[0]], []),
    )
)


# -- NDArray-only functions ----------------------------------------------------
def _choose_element_0index_fwd(params, inputs, aux, is_train, rng):
    # out[i] = lhs[i, rhs[i]]
    lhs, rhs = inputs
    return [torch.gather(lhs, 1, rhs.long()[:, None])[:, 0]], []


register(
    OpDef(
        "choose_element_0index",
        _choose_element_0index_fwd,
        arguments=("lhs", "rhs"),
        infer_shape=lambda p, s: ([s[0], (s[0][0],)], [(s[0][0],)], []),
    )
)


def _fill_element_0index_fwd(params, inputs, aux, is_train, rng):
    # lhs[i, mhs[i]] = rhs[i], out of place
    lhs, mhs, rhs = inputs
    rows = torch.arange(lhs.shape[0], device=lhs.device)
    return [lhs.index_put((rows, mhs.long()), rhs.to(lhs.dtype))], []


register(
    OpDef(
        "fill_element_0index",
        _fill_element_0index_fwd,
        arguments=("lhs", "mhs", "rhs"),
        infer_shape=lambda p, s: ([s[0], (s[0][0],), (s[0][0],)], [s[0]], []),
    )
)
