"""Matmul-precision pass: tune the FullyConnected accumulation choice.

Counterpart of ``mxnet_tpu/compile/precision.py``. The stock
FullyConnected (``ops/nn.py``) is ``torch.matmul`` under the process's
matmul flags, which ``chip_smoke.py`` and the defaults keep exact: bf16
and f16 products accumulate in f32 in cuBLAS (the JAX package's 'f32'
choice, ``preferred_element_type=float32``) and f32 products do not use
TF32. The 'fast' choice is the same ``torch.matmul`` with the backend's
reduced-precision paths allowed *for that call only*: cuBLAS's
reduced-precision reduction for bf16 and f16 operands, TF32 for f32.
The flags are set and restored around the one call (in a ``finally``),
so no other matmul of the process sees them. On the CPU the flags
change nothing and 'fast' computes what 'f32' does.

With a tuner, each FC problem is timed under both choices and the
winner is keyed into the tuning DB; the rewrite swaps in an
``_mxc_fc_prec`` node carrying the explicit choice. Where both choices
run the same kernel the timings tie and the tuner keeps whichever it
measured faster in that run.

The pass is deliberately inert without a tuner decision or an explicit
``MXNET_COMPILE_MATMUL_PREC`` override — 'fast' accumulation changes
numerics (tolerance-bounded in the golden-equivalence tests), so it
must be asked for, never defaulted in.
"""
from __future__ import annotations

import contextlib

import torch

from . import ir

__all__ = ["apply", "FC_PREC", "fast_matmul"]

FC_PREC = "_mxc_fc_prec"


@contextlib.contextmanager
def _reduced_precision(dtype):
    """Allow cuBLAS's reduced-precision paths for the matmuls inside,
    and restore the process's flags on the way out."""
    m = torch.backends.cuda.matmul
    if dtype == torch.bfloat16:
        name = "allow_bf16_reduced_precision_reduction"
    elif dtype == torch.float16:
        name = "allow_fp16_reduced_precision_reduction"
    else:
        name = "allow_tf32"
    saved = getattr(m, name)
    setattr(m, name, True)
    try:
        yield
    finally:
        setattr(m, name, saved)


def fast_matmul(x, w):
    """``x @ w.T`` with the backend's reduced-precision accumulation
    allowed for this call only (the 'fast' choice)."""
    with _reduced_precision(x.dtype):
        return torch.matmul(x, w.to(x.dtype).t())


def _make_fc_op(base_params, choice):
    from ..ops.registry import Field, OpDef
    from ..ops import nn as _nn

    # only the 'fast' choice ever builds a node — 'f32' IS the stock
    # FullyConnected, so apply() leaves those untouched
    assert choice == "fast", choice

    def forward(params, inputs, aux, is_train, rng):
        data, w = inputs[0], inputs[1]
        x = data.reshape(data.shape[0], -1)
        out = fast_matmul(x, w)
        if not params["no_bias"]:
            out = out + inputs[2].to(out.dtype)
        return [out], []

    return OpDef(
        FC_PREC + "[%s]" % choice, forward,
        params={
            "num_hidden": Field("int", required=True),
            "no_bias": Field("bool", default=False),
        },
        arguments=_nn._fc_args,
        infer_shape=_nn._fc_shape,
        doc="compile-time FullyConnected with tuned accumulation flag")


def apply(sym, input_shapes=None, input_types=None, tuner=None, mode="auto"):
    """Rewrite FullyConnected nodes to the tuned accumulation flag.

    ``mode``: 'auto' (consult the tuner; inert without one), 'f32' or
    'fast' (explicit override for every FC). Returns
    ``(new_sym, n_rewritten)``."""
    if mode == "auto" and tuner is None:
        return sym, 0
    import numpy as _np

    nodes = sym.nodes
    seed = {}
    for n in nodes:
        if n.is_variable and input_shapes and n.name in input_shapes:
            seed[(id(n), 0)] = tuple(input_shapes[n.name])
    shapes = ir.propagate_shapes(nodes, seed) if seed else {}
    tseed = {(id(n), 0): _np.dtype(input_types[n.name])
             for n in nodes
             if n.is_variable and input_types and n.name in input_types}
    # dtype of the FC's ACTUAL input edge (interior past the first
    # layer) — propagated, not looked up by bound-argument name
    dtype_map = ir.propagate_dtypes(nodes, tseed) if tseed else {}

    choices = {}
    for n in nodes:
        if n.is_variable or n.op.name != "FullyConnected":
            continue
        if mode in ("f32", "fast"):
            choice = mode
        else:
            dshape = shapes.get((id(n.inputs[0][0]), n.inputs[0][1]))
            if dshape is None:
                continue
            dtype = dtype_map.get((id(n.inputs[0][0]), n.inputs[0][1]))
            choice = tuner.pick_matmul_precision(
                dshape, n.params["num_hidden"], dtype)
        if choice != "f32":  # f32 IS the stock op; no rewrite needed
            choices[id(n)] = choice
    if not choices:
        return sym, 0

    from ..symbol import _Node

    def replace(node, new_inputs, memo):
        choice = choices.get(id(node))
        if choice is None:
            return None
        return _Node(_make_fc_op(node.params, choice), node.name,
                     node.params, new_inputs,
                     dict(node.attrs, __mxc_opt__="precision"))

    return ir.rebuild(sym, replace), len(choices)
