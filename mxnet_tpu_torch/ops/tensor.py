"""Elementwise binary and array-scalar ops (the subset that Symbol and
NDArray arithmetic emit), the ``sum`` reduction, ``transpose`` and
``smooth_l1``.

Counterpart of ``mxnet_tpu/ops/tensor.py:41-60`` and ``:75-133``, with
the same names, aliases and parameters (``scalar``, a float; ``sum``'s
``axis`` and ``keepdims``, alias ``sum_axis``; a full reduction gives
shape (1,)), ``transpose`` (``:349``; ``axes=()`` reverses the axes,
and the result is a view) and ``smooth_l1`` (``:472``, SSD's
localisation loss; ``scalar`` is sigma), computed with torch. The JAX
package's unary, other reductions, broadcast and matrix ops are a later
slice.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .registry import REGISTRY, Field, OpDef, register, scalar_op, \
    simple_binary

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
scalar_op("_rdiv_scalar", lambda x, s: s / x)
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


def _sum_fwd(params, inputs, aux, is_train, rng):
    ax = _axis_param(params)
    keepdims = params.get("keepdims", False)
    x = inputs[0]
    if ax is None:
        out = x.sum()
        out = out.reshape((1,) * x.dim()) if keepdims else out
    else:
        out = torch.sum(x, dim=ax, keepdim=keepdims)
    if out.dim() == 0:
        out = out.reshape(1)
    return [out], []


REGISTRY["sum_axis"] = register(
    OpDef(
        "sum",
        _sum_fwd,
        params={
            "axis": Field("shape", default=None),
            "keepdims": Field("bool", default=False),
        },
        infer_shape=_reduce_shape,
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
