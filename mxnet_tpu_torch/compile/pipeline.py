"""Pass pipeline: ordered application + pass-level correctness check.

Counterpart of ``mxnet_tpu/compile/pipeline.py``. Order matters and is
fixed: ``fold`` first (a folded subgraph is fewer nodes for everyone
downstream), ``layout`` second (NHWC regions are established before
fusion so chains *inside* a region fuse), ``fuse`` third (the boundary
transposes and converted ops carry custom infer_shape and never enter a
chain), ``precision`` last (it rewrites FC nodes wherever they ended
up). Each pass is individually disableable via ``MXNET_COMPILE_PASSES``
(see compile/__init__).

``MXNET_COMPILE_VERIFY=1`` adds a pass-level golden check at
optimize() time: both graphs run in the port, without autograd, on
shared random inputs, and the heads must agree — bit-exactly after
fold and fuse, within 2e-3 after layout or precision. The unrewritten
graph is the reference; a mismatch raises (a wrong rewrite must never
train silently).
"""
from __future__ import annotations

import time as _time

import numpy as _np
import torch

from ..base import MXNetError
from .. import telemetry as _tel
from . import CompileVerifyError

__all__ = ["run", "check_equivalence"]

#: most recent optimize() report: pass -> rewrite count (test hook and
#: tools surface; one optimize at a time — binds are host-serial)
LAST_REPORT = {}


def run(sym, passes, input_shapes=None, input_types=None,
        frozen_params=None, tuner=None, matmul_prec="auto", verify=False,
        device=None):
    """Apply ``passes`` (iterable of names) to ``sym``; returns the
    rewritten Symbol (``sym`` itself when nothing applied)."""
    global LAST_REPORT
    report = {}
    new = sym
    t0 = _time.monotonic()
    for name in passes:
        with _tel.span("compile.pass.%s" % name):
            if name == "fold":
                from . import fold

                new, n = fold.apply(new, frozen_params=frozen_params,
                                    device=device)
            elif name == "layout":
                from . import layout

                new, n = layout.apply(new, input_shapes=input_shapes,
                                      input_types=input_types, tuner=tuner)
            elif name == "fuse":
                from . import fuse

                new, n = fuse.apply(new, input_shapes=input_shapes,
                                    tuner=tuner)
            elif name == "precision":
                from . import precision

                new, n = precision.apply(
                    new, input_shapes=input_shapes, input_types=input_types,
                    tuner=tuner, mode=matmul_prec)
            else:
                raise MXNetError("unknown compile pass %r" % (name,))
        report[name] = n
        if n and _tel.ENABLED:
            _tel.counter("compile.passes_applied_total").inc()
            _tel.counter("compile.pass.%s_rewrites_total" % name).inc(n)
    report["secs"] = round(_time.monotonic() - t0, 4)
    LAST_REPORT = report
    if verify and new is not sym:
        check_equivalence(sym, new, input_shapes or {},
                          frozen_params=frozen_params,
                          loose=bool(report.get("layout")
                                     or report.get("precision")),
                          device=device)
    return new


# -- pass-level golden check ---------------------------------------------------

def _as_tensor(v, device):
    data = getattr(v, "_data", None)
    if isinstance(data, torch.Tensor):
        v = data
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(_np.ascontiguousarray(_np.asarray(v)))
    return v.to(device) if device is not None else v


def _eval_graph(sym, arg_vals, device=None):
    """Eager reference interpreter: run every node with op.apply
    (is_train=False, no RNG, no autograd) and return the head values.
    aux states get their op-declared init (init_aux) or the
    zeros/ones-by-name default simple_bind uses. An intermediate is
    dropped after its last reader."""
    env = {}
    nodes = sym.nodes
    heads = {(id(n), i) for n, i in sym._outputs}
    last = {}
    for serial, n in enumerate(nodes):
        for s, i in n.inputs:
            last[(id(s), i)] = serial
    release = {}
    for key, serial in last.items():
        if key not in heads:
            release.setdefault(serial, []).append(key)
    with torch.no_grad():
        for serial, n in enumerate(nodes):
            if n.is_variable:
                env[(id(n), 0)] = _as_tensor(arg_vals[n.name], device)
                continue
            ins = [env[(id(s), i)] for s, i in n.inputs]
            aux_names = n.op.list_auxiliary_states(n.params)
            aux = []
            if aux_names:
                _i, _o, aux_shapes = n.op.infer_shape(
                    n.params, [tuple(x.shape) for x in ins])
                if n.op.init_aux is not None:
                    aux = [_as_tensor(a, ins[0].device)
                           for a in n.op.init_aux(n.params, aux_shapes)]
                else:
                    aux = [(torch.ones if "var" in an else torch.zeros)(
                        s, dtype=torch.float32, device=ins[0].device)
                           for an, s in zip(aux_names, aux_shapes)]
            outs, _new_aux = n.op.apply(n.params, ins, aux, False, None)
            for i, o in enumerate(outs):
                env[(id(n), i)] = o
            for key in release.get(serial, ()):
                env.pop(key, None)
    return [env[(id(n), i)] for n, i in sym._outputs]


def _draw(rng, name, shape):
    """One random argument: labels as {0, 1}; weights (rank >= 2,
    named ``*weight``) uniform at unit gain, ``(rand - 0.5) *
    sqrt(12 / fan_in)``, so a deep graph's heads stay finite without
    BatchNorm's batch statistics; everything else ``rand - 0.5``."""
    if name.endswith("label"):
        return rng.randint(0, 2, shape).astype(_np.float32)
    v = rng.rand(*shape).astype(_np.float32) - 0.5
    if name.endswith("weight") and len(shape) >= 2:
        fan_in = float(_np.prod(shape[1:]))
        v *= _np.float32(_np.sqrt(12.0 / max(fan_in, 1.0)))
    return v


def check_equivalence(ref_sym, opt_sym, input_shapes, frozen_params=None,
                      loose=False, rtol=None, atol=None, seed=0,
                      device=None):
    """Run both graphs on shared random inputs on ``device`` (default:
    the CPU); raise :class:`CompileVerifyError` when a head diverges.
    ``loose`` applies the layout/precision tolerance (reduction-order
    and accumulation changes are legitimate); fuse/fold rewrites must
    match bit-exactly. ``frozen_params`` must be the same values the
    fold pass baked — the reference graph reads them as arguments, the
    rewritten graph carries them as constants."""
    rng = _np.random.RandomState(seed)
    frozen = dict(frozen_params or {})
    arg_names = ref_sym.list_arguments()
    shapes = {k: tuple(v) for k, v in input_shapes.items()
              if k in set(arg_names)}
    if any(n not in shapes and n not in frozen for n in arg_names):
        # data/label-only callers (Symbol.optimize with just the input
        # shapes): weight shapes are fully inferable from those
        try:
            arg_shapes, _, _ = ref_sym.infer_shape(**shapes)
            for n, s in zip(arg_names, arg_shapes):
                if s is not None:
                    shapes.setdefault(n, tuple(s))
        except MXNetError:
            pass  # underdetermined: the explicit check below reports it
    arg_vals = {}
    for name in arg_names:
        if name in frozen:
            arg_vals[name] = _as_tensor(frozen[name], device)
        elif name not in shapes:
            raise MXNetError(
                "compile verify: no shape for argument %s" % name)
        else:
            arg_vals[name] = _as_tensor(_draw(rng, name, shapes[name]),
                                        device)
    ref = [o.float().cpu().numpy() for o in _eval_graph(ref_sym, arg_vals,
                                                         device)]
    opt = [o.float().cpu().numpy() for o in _eval_graph(opt_sym, arg_vals,
                                                         device)]
    if rtol is None:
        rtol = 2e-3 if loose else 0.0
    if atol is None:
        atol = 2e-3 if loose else 0.0
    for i, (a, b) in enumerate(zip(ref, opt)):
        if a.shape != b.shape:
            raise CompileVerifyError(
                "compile verify: head %d shape %s != reference %s"
                % (i, b.shape, a.shape))
        if not _np.allclose(a, b, rtol=rtol, atol=atol):
            err = float(_np.max(_np.abs(a - b))) if a.size else 0.0
            raise CompileVerifyError(
                "compile verify: head %d diverges from the unrewritten "
                "graph (max abs err %.3g, rtol=%g atol=%g)"
                % (i, err, rtol, atol))
