"""Constant-folding pass: evaluate parameter-only subexpressions once.

Counterpart of ``mxnet_tpu/compile/fold.py``. Two folding modes, both
replacing a maximal foldable subgraph with a single ``_mxc_const`` node
whose forward returns the baked value:

- **pure constants** (always safe): subexpressions with no variable
  leaves at all — graphs built from constant-producing ops and scalar
  chains. These re-evaluated on every traced step for no reason.
- **frozen parameters** (opt-in via ``frozen_params``): subexpressions
  whose variable leaves are ALL in the caller-supplied frozen set.
  ``Predictor`` passes its checkpoint weights here — predict-time
  weights never change after bind, so weight-transformation chains
  (reshapes/transposes/scalar math on parameters) collapse into baked
  constants and disappear from the per-request program. Training
  executors must NOT pass ``frozen_params`` (the optimizer mutates
  weights in place every step); the pipeline only enables this mode on
  the predict path.

Safety envelope: a node folds only when it has no aux state, no RNG, no
host kernel, no ``is_train`` sensitivity risk (evaluation runs with
``is_train=False`` — predict-path semantics), and the baked output is
not larger than its inputs (``GROWTH_LIMIT``; folding a broadcast would
trade a few FLOPs for resident device memory).

The region is evaluated once, without autograd, on the bind's device
(the frozen arrays' own, or ``device``); the baked constants stay there
and do not require grad.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import np_dtype
from . import ir

__all__ = ["apply", "CONST_OP"]

CONST_OP = "_mxc_const"

#: Refuse to bake a constant larger than this multiple of its inputs'
#: total size (a folded broadcast/tile would pin the expanded tensor).
GROWTH_LIMIT = 4.0


def _make_const_op(value, name):
    from ..ops.registry import OpDef

    def forward(params, inputs, aux, is_train, rng):
        return [value], []

    def infer_shape(params, in_shapes):
        return [], [tuple(value.shape)], []

    def infer_type(params, in_types):
        return [], [np_dtype(value.dtype)], []

    return OpDef(CONST_OP, forward, arguments=(),
                 infer_shape=infer_shape, infer_type=infer_type,
                 doc="compile-time folded constant (compile/fold.py)")


def _foldable_op(node):
    if node.is_variable:
        return False
    op = node.op
    if op.is_host_op or op.need_rng:
        return False
    if op.head_no_grad(node.params):
        return False
    if op.list_auxiliary_states(node.params):
        return False
    return True


def _tensor(v, device):
    data = getattr(v, "_data", None)
    if isinstance(data, torch.Tensor):
        v = data
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(_np.ascontiguousarray(_np.asarray(v)))
    return v.detach().to(device) if device is not None else v.detach()


def _nbytes(t):
    return t.numel() * t.element_size()


def apply(sym, frozen_params=None, device=None):
    """Fold constant subexpressions in ``sym``.

    ``frozen_params``: optional dict name -> array-like for variables
    the caller guarantees will never change after bind (predict path).
    ``device``: where a frozen value that is not already a tensor
    there is put (and so where the region evaluates).
    Returns ``(new_sym, n_folded_nodes)``.
    """
    frozen = dict(frozen_params or {})
    nodes = sym.nodes
    heads = ir.head_keys(sym)

    # mark every node whose transitive leaves are foldable
    constish = {}  # id(node) -> True/False
    for n in nodes:
        if n.is_variable:
            constish[id(n)] = n.name in frozen
        else:
            constish[id(n)] = (_foldable_op(n)
                               and all(constish[id(s)] for s, _ in n.inputs))
    if not any(constish[id(n)] and not n.is_variable for n in nodes):
        return sym, 0

    # fold only MAXIMAL const subgraphs: a const node whose every
    # consumer is also const evaluates inside its consumer's fold —
    # baking it separately would duplicate the value
    cons = ir.consumers_map(nodes)
    fold_roots = []
    for serial, n in enumerate(nodes):
        if n.is_variable or not constish[id(n)]:
            continue
        out_keys = [(id(n), i)
                    for i in range(len(n.op.list_outputs(n.params)))]
        is_root = any(k in heads for k in out_keys) or any(
            not constish[id(nodes[c])]
            for k in out_keys for c in cons.get(k, ())
        )
        # only single-output roots bake cleanly into one const node;
        # a multi-output root stays (const consumers of it still fold
        # THROUGH it — the evaluator walks originals, not the rewrite)
        if is_root and len(out_keys) == 1:
            fold_roots.append(serial)
    if not fold_roots:
        return sym, 0

    # evaluate the const region once, bottom-up, on host
    env = {}

    def value_of(node, oidx):
        key = (id(node), oidx)
        if key in env:
            return env[key]
        if node.is_variable:
            v = _tensor(frozen[node.name], device)
            env[key] = v
            return v
        ins = [value_of(s, i) for s, i in node.inputs]
        with torch.no_grad():
            outs, _aux = node.op.apply(node.params, ins, [], False, None)
        for i, o in enumerate(outs):
            env[(id(node), i)] = o.detach()
        return env[key]

    folded = {}  # id(node) -> const node (or None when growth-gated)
    n_folded = 0
    from ..symbol import _Node

    for serial in fold_roots:
        n = nodes[serial]
        try:
            val = value_of(n, 0)
        except Exception:
            folded[id(n)] = None  # evaluation failed: leave the subgraph
            continue
        in_bytes = sum(
            _nbytes(v) for k, v in env.items()
            if k[0] in {id(s) for s, _ in n.inputs}
        ) or _nbytes(val)
        if _nbytes(val) > GROWTH_LIMIT * max(1, in_bytes):
            folded[id(n)] = None
            continue
        baked = val.contiguous()
        folded[id(n)] = _Node(
            _make_const_op(baked, n.name), n.name, {}, [],
            dict(n.attrs, __mxc_opt__="fold"))
        n_folded += 1

    if not n_folded:
        return sym, 0

    def replace(node, new_inputs, memo):
        return folded.get(id(node))

    return ir.rebuild(sym, replace), n_folded
