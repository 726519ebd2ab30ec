"""Fused train step built from a Symbol graph.

Counterpart of ``mxnet_tpu/parallel/symbol_trainer.py``: forward,
backward (the loss heads seeded with ones, as ``Executor.backward``
does) and the optimizer update of a Symbol graph as one call, over
parameters the step owns. The JAX package compiles that call into one
XLA program; here it is the executor's graph walk (``Executor._run``,
borrowed from a throwaway ``simple_bind``), ``torch.autograd.grad`` and
a ``torch.optim`` step, eager on the card. ``step.loop`` runs K steps
in a Python loop that makes no host synchronisation, so the card runs
the K steps back to back while the host queues them.

Mixed precision as in the JAX step: master parameters and gradients are
f32; parameters of two or more dimensions are cast to
``compute_dtype`` inside the step; the batch is used in the dtype it
arrives in (``bench.py`` passes bf16 images); BatchNorm keeps f32
statistics (``ops/nn.py``).

Used by the ResNet-50 phase of ``chip_smoke.py``, at ``bench.py``'s
configuration. ``parallel/fit_trainer.py`` shares :func:`train_grads`.
"""
from __future__ import annotations

import numpy as _np
import torch

from .. import compile as _compile
from .. import threefry
from ..analysis import compile_verify as _cv
from ..base import MXNetError, deterministic_grads, torch_dtype
from ..context import Context, cpu, current_context, gpu
from ..ndarray import _as_tensor

__all__ = ["make_symbol_train_step", "train_grads"]


def _cast(p, cdt):
    return p.to(cdt) if (cdt is not None and p.dim() >= 2) else p


def train_grads(run, arg_names, params, batch, aux, key, cdt=None):
    """One training forward of ``run`` (an ``Executor._run``) over
    ``params`` (name -> f32 tensor) and ``batch`` (name -> tensor), with
    random nodes keyed by ``fold_in(key, serial)``, and the f32
    gradients of every parameter, each inexact head seeded with ones
    (a parameter no head reaches gets zeros). Returns ``(grads, outs,
    new_aux)``, all detached; the parameters are not written."""
    leaves = {n: p.detach().requires_grad_() for n, p in params.items()}
    with torch.enable_grad():
        vals = [batch[n] if n in batch else _cast(leaves[n], cdt)
                for n in arg_names]
        outs, new_aux = run(vals, aux, True, key=key)
    heads = [o for o in outs if o.is_floating_point() and o.requires_grad]
    names = list(leaves)
    got = [None] * len(names)
    if heads:
        with deterministic_grads():
            got = torch.autograd.grad(
                heads, [leaves[n] for n in names],
                [torch.ones_like(o) for o in heads], allow_unused=True)
    grads = {n: (torch.zeros_like(params[n]) if g is None
                 else g.to(torch.float32))
             for n, g in zip(names, got)}
    return grads, [o.detach() for o in outs], [a.detach() for a in new_aux]


def write_aux(aux, new_aux):
    """Write the step's new aux states (BatchNorm's moving statistics)
    into ``aux``'s tensors, in place."""
    with torch.no_grad():
        for a, v in zip(aux, new_aux):
            if v is not a:
                a.copy_(v)


def _context(ctx, mesh):
    if ctx is None:
        if mesh is None:
            return current_context()
        dev = mesh.device
        return gpu(dev.index or 0) if dev.type == "cuda" else cpu()
    return ctx if isinstance(ctx, Context) else Context(ctx)


def make_symbol_train_step(symbol, input_shapes, optimizer=None,
                           compute_dtype=None, ctx=None, mesh=None,
                           batch_axis="data", donate=True, seed=0):
    """Build a fused train step for ``symbol``; returns ``(step, state)``.

    ``input_shapes``: data/label name -> shape (the arguments that are
    not parameters). ``state`` is ``dict(params, opt_state, aux)``:
    ``params`` name -> f32 tensor, ``aux`` the aux states in
    ``list_auxiliary_states`` order, both on the device, and
    ``opt_state`` the ``torch.optim.Optimizer`` over ``params``.
    ``step(state, batch, key) -> (state, outs)`` runs one step on
    ``batch`` (name -> tensor, NDArray or numpy array; moved to the
    device if it is not there); ``outs`` holds one tensor a head.
    ``step.loop(state, batches, key) -> (state, outs)`` runs K steps over
    ``batches`` whose arrays carry a leading axis K, under the K keys of
    ``threefry.split(key, K)`` (as ``jax.random.split``), and stacks each
    head's outputs over K. A key is a ``[2]`` int64 host tensor,
    ``threefry.prng_key(seed, device="cpu")``; a random node draws under
    ``fold_in(key, serial)``. Both update ``state``'s tensors in place and
    return the same ``state``.

    Initial parameters are drawn as the JAX package draws them, so both
    start from the same bits: numpy ``RandomState(seed)``, in argument
    order, normal(0, sqrt(2 / fan_in)) for weights, zeros for ``*bias``
    and ``*beta``, ones for ``*gamma``; aux states named ``*mean*``
    zeros and the rest ones.

    The one API difference: there is no optax. ``optimizer`` is a
    callable that maps the list of f32 parameter tensors to a
    ``torch.optim.Optimizer``; the default,
    ``torch.optim.SGD(ps, lr=0.05, momentum=0.9)``, updates as optax's
    ``sgd(0.05, momentum=0.9)`` does, step for step.

    ``ctx`` defaults to the mesh's device, else the current context
    (``cuda:0``; without CUDA it raises). A ``mesh`` of more than one
    device raises ``NotImplementedError``; ``batch_axis`` names its data
    axis and ``donate`` is accepted and changes nothing (the update is
    in place). Not ported: the persistent compile cache and the
    ``compile_verify`` wrappers.
    """
    if mesh is not None and getattr(mesh, "size", 1) != 1:
        raise NotImplementedError(
            "make_symbol_train_step: multi-device meshes are not ported "
            "yet (ROADMAP queue 1, multiple GPUs)")
    ctx = _context(ctx, mesh)
    device = ctx.torch_device
    if optimizer is None:
        def optimizer(ps):
            return torch.optim.SGD(ps, lr=0.05, momentum=0.9)

    arg_names = symbol.list_arguments()
    aux_names = symbol.list_auxiliary_states()
    arg_shapes, _, aux_shapes = symbol.infer_shape(**input_shapes)
    if any((not n.is_variable) and n.op.is_host_op for n in symbol.nodes):
        raise MXNetError("make_symbol_train_step does not support host "
                         "ops (Custom/NumpyOp/torch bridge)")
    # the throwaway bind applies the MXNET_COMPILE_OPT rewrites to the
    # walk the step borrows
    _compile.ensure_jit_cache()
    exe = symbol.simple_bind(ctx, grad_req="null", **input_shapes)
    run = exe._run
    no_head_grad = exe._head_no_grad
    exe._release_device_arrays()
    if not all(no_head_grad):
        raise MXNetError("make_symbol_train_step requires loss-op heads")

    rng0 = _np.random.RandomState(seed)
    params = {}
    for n, s in zip(arg_names, arg_shapes):
        if n in input_shapes:
            continue
        fan_in = float(_np.prod(s[1:])) if len(s) > 1 else float(s[0])
        scale = _np.sqrt(2.0 / max(fan_in, 1.0))
        if n.endswith("bias") or n.endswith("beta"):
            params[n] = torch.zeros(s, dtype=torch.float32, device=device)
        elif n.endswith("gamma"):
            params[n] = torch.ones(s, dtype=torch.float32, device=device)
        else:
            params[n] = torch.from_numpy(
                rng0.normal(0, scale, s).astype(_np.float32)).to(device)
    aux = [
        (torch.zeros if "mean" in n else torch.ones)(
            s, dtype=torch.float32, device=device)
        for n, s in zip(aux_names, aux_shapes)
    ]
    cdt = torch_dtype(compute_dtype) if compute_dtype else None
    state = {"params": params, "opt_state": optimizer(list(params.values())),
             "aux": aux}

    def _step(state, batch, key):
        params = state["params"]
        grads, outs, new_aux = train_grads(run, arg_names, params, batch,
                                           state["aux"], key, cdt)
        opt = state["opt_state"]
        with torch.no_grad():
            for n, p in params.items():
                p.grad = grads[n]
            opt.step()
            for p in params.values():
                p.grad = None
            write_aux(state["aux"], new_aux)
        return state, outs

    # fixed-shape bind: the step and each chunk length of the loop
    # "compile" once (MXNET_JIT_VERIFY names an argument that varies)
    jitted = _cv.wrap("symbol_trainer.step", _step, budget=1,
                      group="train.symbol_step")

    def step(state, batch, key):
        batch = {k: _as_tensor(v, device) for k, v in batch.items()}
        return jitted(state, batch, key)

    def _loop(state, batches, key):
        K = next(iter(batches.values())).shape[0]
        keys = threefry.split(key, K)
        outs = []
        for k in range(K):
            state, o = _step(state, {n: b[k] for n, b in batches.items()},
                             keys[k])
            outs.append(o)
        return state, tuple(torch.stack(col) for col in zip(*outs))

    jitted_loop = _cv.wrap("symbol_trainer.loop", _loop, budget=4,
                           group="train.symbol_step")

    def loop(state, batches, key):
        """K train steps, one a batch slice, queued without a host
        synchronisation; returns ``(state, outs)`` with each head's
        outputs stacked over the K steps."""
        batches = {k: _as_tensor(v, device) for k, v in batches.items()}
        return jitted_loop(state, batches, key)

    step.loop = loop
    return step, state
