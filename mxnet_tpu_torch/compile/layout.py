"""Layout-selection pass: rewrite NCHW conv subgraphs to NHWC with
transpose hoisting.

Counterpart of ``mxnet_tpu/compile/layout.py``: the same regions, the
same boundary transposes and the same rewritten node list. Every
eligible ``Convolution`` is rewritten to compute channels-last, and the
transposes are HOISTED — a layout region grows forward through every
layout-capable consumer (BatchNorm, Pooling, Activation and all plain
elementwise ops), so ``conv -> bn -> relu -> conv`` chains carry NO
interior transposes; conversions happen only at region borders (the
data input, shortcut joins from NCHW producers, and graph heads /
layout-incapable consumers such as Flatten, whose element order depends
on the layout).

In the port a region's tensors are logically NHWC, as in the JAX ops,
and contiguous in that order: the boundary transposes copy. The conv
and pooling ops hand torch an NCHW *view* of their NHWC input (a
permute, never ``.contiguous()``), whose strides are torch's
``channels_last`` format, so cuDNN runs its channels-last kernels and
returns a ``channels_last`` output, which the permute back makes a
contiguous NHWC tensor again. BatchNorm runs the port's own training
normalisation (``ops/nn.py`` ``_BNTrainNorm``, its hand-written
backward) over channel axis 3.

Weights stay in their reference OIHW layout (the bound parameter arrays,
checkpoints and the optimizer never see the rewrite).

Per-conv layout is a *contested* choice: with an autotuner the decision
is measured once on the card and persisted in the tuning DB keyed by
(op, shapes, dtype, backend); without one, every eligible conv converts.

Numerics: convolution and BN reductions in NHWC sum in a different
order, so rewritten graphs are tolerance-equivalent, not bit-identical.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError
from . import ir

__all__ = ["apply", "TO_NHWC", "TO_NCHW", "CONV_NHWC", "BN_NHWC",
           "POOL_NHWC"]

TO_NHWC = "_mxc_to_nhwc"
TO_NCHW = "_mxc_to_nchw"
CONV_NHWC = "_mxc_conv_nhwc"
BN_NHWC = "_mxc_bn_nhwc"
POOL_NHWC = "_mxc_pool_nhwc"


def _nchw_of(s):
    return (s[0], s[3], s[1], s[2])


def _nhwc_of(s):
    return (s[0], s[2], s[3], s[1])


# -- internal OpDefs (built lazily: this module only loads when the
#    pipeline runs) -------------------------------------------------------------
_OPS = {}


def _op(name):
    if not _OPS:
        _build_ops()
    return _OPS[name]


def _nchw_view(x):
    """The NCHW view of a logically NHWC tensor: ``channels_last``
    strides when ``x`` is contiguous, no copy."""
    return x.permute(0, 3, 1, 2)


def _nhwc_view(x):
    return x.permute(0, 2, 3, 1)


def _build_ops():
    from ..ops.registry import Field, OpDef
    from ..ops import nn as _nn

    def _t_nhwc_fwd(params, inputs, aux, is_train, rng):
        return [_nhwc_view(inputs[0]).contiguous()], []

    def _t_nchw_fwd(params, inputs, aux, is_train, rng):
        return [_nchw_view(inputs[0]).contiguous()], []

    def _t_shape(perm_in, perm_out):
        def infer(params, in_shapes):
            s = in_shapes[0]
            if s is None:
                raise MXNetError("transpose: input shape unknown")
            if len(s) != 4:
                raise MXNetError("transpose: rank-4 input required")
            return [s], [perm_out(s)], []
        return infer

    _OPS[TO_NHWC] = OpDef(TO_NHWC, _t_nhwc_fwd,
                          infer_shape=_t_shape(_nchw_of, _nhwc_of),
                          doc="layout-pass NCHW->NHWC boundary transpose")
    _OPS[TO_NCHW] = OpDef(TO_NCHW, _t_nchw_fwd,
                          infer_shape=_t_shape(_nhwc_of, _nchw_of),
                          doc="layout-pass NHWC->NCHW boundary transpose")

    # -- NHWC convolution: data NHWC, weight kept OIHW --------------------------
    def _conv_nhwc_fwd(params, inputs, aux, is_train, rng):
        # the NCHW view of the NHWC data is channels_last: the stock
        # convolution's F.conv2d then takes cuDNN's channels-last route
        # and its output permutes back to a contiguous NHWC tensor
        out, _ = _nn._conv_fwd(params, [_nchw_view(inputs[0])]
                               + list(inputs[1:]), aux, is_train, rng)
        return [_nhwc_view(out[0])], []

    def _conv_nhwc_shape(params, in_shapes):
        if in_shapes[0] is None:
            raise MXNetError("conv_nhwc: data shape unknown")
        ins, outs, aux = _nn._conv_shape(
            params, [_nchw_of(in_shapes[0])] + list(in_shapes[1:]))
        return [_nhwc_of(ins[0])] + ins[1:], [_nhwc_of(outs[0])], aux

    _OPS[CONV_NHWC] = OpDef(
        CONV_NHWC, _conv_nhwc_fwd, params=dict(_nn._CONV_PARAMS),
        arguments=_nn._fc_args, infer_shape=_conv_nhwc_shape,
        doc="layout-pass channels-last Convolution (weights stay OIHW)")

    # -- NHWC BatchNorm: channel axis -1, the same hand-written backward --------
    def _bn_nhwc_fwd(params, inputs, aux, is_train, rng):
        data, gamma, beta = inputs
        moving_mean, moving_var = aux
        eps, momentum = params["eps"], params["momentum"]
        if params["fix_gamma"]:
            gamma = torch.ones_like(gamma.detach())
        axes = (0, 1, 2)
        bshape = (1, 1, 1, -1)
        if is_train and not params["use_global_stats"]:
            out, mean, var = _nn._BNTrainNorm.apply(
                data, gamma.float(), beta.float(), eps, axes, bshape)
            new_mm = moving_mean * momentum + mean.detach() * (1 - momentum)
            new_mv = moving_var * momentum + var.detach() * (1 - momentum)
            return [out], [new_mm, new_mv]
        mean = moving_mean.detach().float()
        var = moving_var.detach().float()
        inv = torch.rsqrt(var.reshape(bshape) + eps)
        out = (data.float() - mean.reshape(bshape)) * inv
        out = (out * gamma.float().reshape(bshape)
               + beta.float().reshape(bshape))
        return [out.to(data.dtype)], [moving_mean, moving_var]

    def _bn_nhwc_shape(params, in_shapes):
        if in_shapes[0] is None:
            raise MXNetError("bn_nhwc: data shape unknown")
        c = (in_shapes[0][3],)
        return [in_shapes[0], c, c], [in_shapes[0]], [c, c]

    _OPS[BN_NHWC] = OpDef(
        BN_NHWC, _bn_nhwc_fwd,
        params={
            "eps": Field("float", default=1e-3),
            "momentum": Field("float", default=0.9),
            "fix_gamma": Field("bool", default=True),
            "use_global_stats": Field("bool", default=False),
        },
        arguments=("data", "gamma", "beta"),
        aux=("moving_mean", "moving_var"),
        infer_shape=_bn_nhwc_shape,
        init_aux=_nn._bn_init_aux,
        doc="layout-pass channels-last BatchNorm")

    # -- NHWC Pooling -----------------------------------------------------------
    def _pool_nhwc_fwd(params, inputs, aux, is_train, rng):
        out, _ = _nn._pool_fwd(params, [_nchw_view(inputs[0])], aux,
                               is_train, rng)
        return [_nhwc_view(out[0])], []

    def _pool_nhwc_shape(params, in_shapes):
        if in_shapes[0] is None:
            raise MXNetError("pool_nhwc: data shape unknown")
        ins, outs, aux = _nn._pool_shape(params, [_nchw_of(in_shapes[0])])
        return [_nhwc_of(ins[0])], [_nhwc_of(outs[0])], aux

    _OPS[POOL_NHWC] = OpDef(
        POOL_NHWC, _pool_nhwc_fwd,
        params={
            "kernel": Field("shape", required=True),
            "pool_type": Field("str", required=True,
                               enum=["max", "avg", "sum"]),
            "global_pool": Field("bool", default=False),
            "pooling_convention": Field("str", default="valid",
                                        enum=["valid", "full"]),
            "stride": Field("shape", default=None),
            "pad": Field("shape", default=None),
        },
        infer_shape=_pool_nhwc_shape,
        doc="layout-pass channels-last Pooling")


# -- capability + region growth ------------------------------------------------

def _capability(node, shapes):
    """How this node can participate in an NHWC region:
    'conv' (region seed), 'bn'/'pool' (converted in place),
    'eltwise' (layout-agnostic passthrough) or None (region border)."""
    if node.is_variable:
        return None
    out_shape = shapes.get((id(node), 0))
    if out_shape is None or len(out_shape) != 4:
        return None
    name = node.op.name
    if name == "Convolution":
        dshape = shapes.get((id(node.inputs[0][0]), node.inputs[0][1]))
        if dshape is not None and len(dshape) == 4:
            return "conv"
        return None
    if name == "BatchNorm":
        return "bn"
    if name == "Pooling":
        return "pool"
    if ir.is_elementwise(node):
        return "eltwise"
    return None


def apply(sym, input_shapes=None, input_types=None, tuner=None):
    """Rewrite eligible NCHW conv subgraphs to NHWC.

    Returns ``(new_sym, n_converted_convs)``; ``new_sym is sym`` when
    nothing converted. ``input_shapes`` seeds the shape sweep that
    gates eligibility (the executor passes its bound arg shapes)."""
    nodes = sym.nodes
    seed = {}
    for n in nodes:
        if not n.is_variable:
            continue
        s = None
        if input_shapes and n.name in input_shapes:
            s = tuple(input_shapes[n.name])
        else:
            raw = n.attrs.get("__shape__")
            if raw:
                import ast

                try:
                    s = tuple(int(d) for d in ast.literal_eval(str(raw)))
                except (ValueError, SyntaxError, TypeError):
                    s = None
        if s is not None:
            seed[(id(n), 0)] = s
    shapes = ir.propagate_shapes(nodes, seed) if seed else {}
    if not shapes:
        return sym, 0
    dtype_map = {}
    if tuner is not None and input_types:
        tseed = {(id(n), 0): _np.dtype(input_types[n.name])
                 for n in nodes
                 if n.is_variable and n.name in input_types}
        # tuning decisions key by the dtype each conv ACTUALLY computes
        # in — an interior edge for every layer past the first, so the
        # bound-argument dtypes must propagate through the graph
        dtype_map = ir.propagate_dtypes(nodes, tseed) if tseed else {}

    nhwc, n_convs = set(), 0
    for n in nodes:
        kind = _capability(n, shapes)
        if kind == "conv":
            if tuner is not None:
                dshape = shapes.get((id(n.inputs[0][0]), n.inputs[0][1]))
                dtype = dtype_map.get((id(n.inputs[0][0]), n.inputs[0][1]))
                choice = tuner.pick_conv_layout(n.params, dshape, dtype)
            else:
                choice = "nhwc"
            if choice == "nhwc":
                nhwc.add(id(n))
                n_convs += 1
        elif kind in ("bn", "pool", "eltwise"):
            if any(id(s) in nhwc for s, _ in n.inputs):
                nhwc.add(id(n))
    if not nhwc:
        return sym, 0

    from ..symbol import _Node, Symbol

    t_cache = {}  # (id(clone), oidx, target) -> transpose node

    def _wrap(entry, target):
        """Insert a boundary transpose around a cloned entry (cached so
        one conversion serves every consumer — the hoisting)."""
        node, oidx = entry
        key = (id(node), oidx, target)
        if key not in t_cache:
            t_cache[key] = _Node(
                _op(target), "%s_%s" % (node.name, target.strip("_")),
                {}, [entry], {"__mxc_opt__": "layout"})
        return (t_cache[key], 0)

    _CONVERT = {"conv": CONV_NHWC, "bn": BN_NHWC, "pool": POOL_NHWC}

    def replace(node, new_inputs, memo):
        in_region = id(node) in nhwc
        kind = _capability(node, shapes) if in_region else None
        if not in_region:
            # NCHW consumer: any input produced inside a region needs a
            # conversion back to NCHW at the border
            ins = [
                _wrap(e, TO_NCHW) if id(src) in nhwc else e
                for e, (src, _i) in zip(new_inputs, node.inputs)
            ]
            if all(a is b for (a, _), (b, _) in zip(ins, new_inputs)):
                return None  # default clone/share path
            return _Node(node.op, node.name, node.params, ins, node.attrs)

        def act(pos):
            """Activation operand at input slot pos, converted to NHWC."""
            src, _i = node.inputs[pos]
            e = new_inputs[pos]
            return e if id(src) in nhwc else _wrap(e, TO_NHWC)

        if kind == "conv":
            ins = [act(0)] + list(new_inputs[1:])  # weight/bias stay put
            return _Node(_op(CONV_NHWC), node.name, node.params, ins,
                         dict(node.attrs, __mxc_opt__="layout"))
        if kind == "bn":
            ins = [act(0)] + list(new_inputs[1:])
            return _Node(_op(BN_NHWC), node.name, node.params, ins,
                         dict(node.attrs, __mxc_opt__="layout"))
        if kind == "pool":
            return _Node(_op(POOL_NHWC), node.name, node.params, [act(0)],
                         dict(node.attrs, __mxc_opt__="layout"))
        # eltwise passthrough: every operand becomes NHWC
        ins = [act(p) for p in range(len(node.inputs))]
        return _Node(node.op, node.name, node.params, ins, node.attrs)

    new_sym = ir.rebuild(sym, replace)
    # heads produced inside a region leave the graph in NCHW (the
    # public output contract is layout-invariant)
    outs = []
    for (orig, i), entry in zip(sym._outputs, new_sym._outputs):
        outs.append(_wrap(entry, TO_NCHW) if id(orig) in nhwc else entry)
    return Symbol(outs), n_convs
