"""The scanned path of the public ``fit()`` loops.

Counterpart of ``mxnet_tpu/parallel/fit_trainer.py``: ``FeedForward.fit``
and ``Module.fit`` on one device hand K batches at a time to a
:class:`FitTrainer`, which runs K training steps (forward, backward and
the user's real ``Optimizer.update`` once a parameter) with no host
synchronisation between them; the caller reads the chunk's outputs
afterwards (``model._scan_drain``), one synchronisation a chunk. The
JAX package traces the K steps into one ``lax.scan`` program; here they
are queued eagerly on the card, the graph walk of ``Executor._run`` and
``torch.autograd`` as in ``parallel/symbol_trainer.py``.

Semantics kept from the JAX trainer:

- step k of a chunk takes base lr ``lr_scheduler(base + k + 1)``
  (``base`` the optimizer's ``num_update`` before the chunk) for every
  parameter, times its lr multiplier: ``lr`` is set to it and the
  scheduler unset while the step's updates run, which count as usual,
  so the counts stand K higher after the chunk, and Adam's bias
  correction reads step k's own count, ``base + k + 1``, as the JAX
  trainer's traced count is;
- the trainer keeps its own f32 copies of the parameters, aux states and
  optimizer states until :meth:`FitTrainer.write_back`;
- with ``compute_dtype``, parameters of two or more dimensions and
  floating inputs of two or more dimensions are cast inside the step; a
  bf16 trainer casts f32 images (three or more dimensions) to bf16
  before they are moved to the card;
- one key is taken from ``random.next_key()`` at construction; each
  chunk splits off a subkey and splits that into K, one a step.

With ``MXNET_GUARDIAN=1`` (``resilience/guardian.py``) every step
computes its gradients' finiteness and global squared norm on the
device and applies the WHOLE update (parameters, optimizer states, aux)
through ``torch.where(ok, new, old)``: a poisoned step is suppressed on
the card with no host synchronisation, and the K per-step verdicts
(``take_step_flags``) come back with the chunk's one device-to-host
copy. The ``grad.nan``/``loss.spike`` fault points stage one host-drawn
multiplier a step, as the JAX trainer does. ``snapshot_state``,
``restore_state`` and ``load_params`` are the guardian's ring payload,
rollback and disk-rollback fallback. Under ``MXNET_PROF=1`` the chunk
program is attributed once a chunk length (``telemetry/prof.py``: K
times the graph's analytic training FLOPs) and ``last_program_key``
names it for the fit loop's step breakdown.

The bind applies the ``MXNET_COMPILE_OPT`` graph rewrites to the walk
the steps run and arms the persistent cubin cache
(``mxnet_tpu/parallel/fit_trainer.py:121-126``). Under
``MXNET_JIT_VERIFY`` each chunk length's program is the verifier
boundary ``fit_trainer.loop|K=<K>`` (budget 1, group
``train.fit_loop``): its learning rates, keys and fault multipliers go
in as arrays, as they do into the JAX trainer's scanned program, so a
new schedule value is not a new signature.
"""
from __future__ import annotations

import numpy as _np
import torch

from .. import compile as _compile
from .. import random as _random
from .. import telemetry as _tel
from .. import threefry
from ..resilience import faults as _flt
from ..resilience import guardian as _grd
from ..telemetry import prof as _prof
from ..analysis import compile_verify as _cv
from ..base import MXNetError, torch_dtype
from ..ndarray import NDArray, _as_tensor
from .symbol_trainer import train_grads, write_aux

__all__ = ["FitTrainer", "make_fit_trainer", "supports_optimizer"]

# exactly these classes (not subclasses: a subclass may override update
# with host logic); only the port's registered optimizers can match
_SCANNABLE_OPTIMIZERS = ("SGD", "ccSGD", "NAG", "Adam", "AdaGrad",
                         "RMSProp", "AdaDelta", "Test")


def supports_optimizer(optimizer):
    from .. import optimizer as opt

    cls = type(optimizer)
    return any(
        cls is opt.Optimizer.opt_registry.get(n.lower())
        for n in _SCANNABLE_OPTIMIZERS)


def _to_device(t, device):
    """A host tensor onto ``device``; to a card from pinned memory,
    without waiting for the card's stream."""
    if device.type != "cuda" or t.is_cuda:
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class FitTrainer:
    """K-step trainer over a Symbol graph and the user's Optimizer.
    Create with :func:`make_fit_trainer`."""

    def __init__(self, symbol, ctx, input_shapes, optimizer, arg_params,
                 aux_params, param_names, compute_dtype=None):
        self.optimizer = optimizer
        self.param_names = list(param_names)
        self.input_names = list(input_shapes)
        self.ctx = ctx
        self._cdt = torch_dtype(compute_dtype) if compute_dtype else None
        if any((not n.is_variable) and n.op.is_host_op for n in symbol.nodes):
            raise MXNetError("scanned fit does not support host ops "
                             "(Custom/NumpyOp/torch bridge)")
        # the bind applies the MXNET_COMPILE_OPT rewrites to the walk
        _compile.ensure_jit_cache()
        exe = symbol.simple_bind(ctx, grad_req="null", **input_shapes)
        if not all(exe._head_no_grad):
            raise MXNetError("scanned fit requires loss-op heads")
        self._run = exe._run
        exe._release_device_arrays()
        self._arg_names = symbol.list_arguments()
        self._device = dev = ctx.torch_device

        def own(a):
            return _as_tensor(a, dev, torch.float32).clone()

        self.params = {n: own(arg_params[n]) for n in self.param_names}
        self.aux = [own(aux_params[n])
                    for n in symbol.list_auxiliary_states()]
        # NDArray facades over the trainer's tensors: what update() reads
        # and writes in place
        self._weights = [NDArray(self.params[n], ctx)
                         for n in self.param_names]
        self.opt_states = [optimizer.create_state(i, w)
                           for i, w in enumerate(self._weights)]
        self._key = _random.next_key()
        self._aux_names = symbol.list_auxiliary_states()
        # guardian sentinel and fault points, read once at construction
        self._guard_on = _grd.enabled()
        self._guard_max_norm = (
            _grd._env_float("MXNET_GUARDIAN_GRADNORM_MAX", 0.0)
            if self._guard_on else 0.0)
        self._inject = _flt.armed("grad.nan") or _flt.armed("loss.spike")
        self._last_flags = None
        self._flats = self._guard_buffers() if self._guard_on else []
        # mxprof: what attributes the chunk program
        self._symbol = symbol
        self._input_shapes = dict(input_shapes)
        self._prof_analytic = None
        self._prof_keys = {}
        self.last_program_key = None
        self._jit_cache = {}   # K -> the chunk program (a boundary)

    def _guard_buffers(self):
        """Re-home every tensor a step writes (parameters, optimizer-state
        leaves, aux states) into one flat buffer a dtype, each tensor a
        view of it: the guarded step then keeps or reverts its whole
        update with one clone and one ``torch.where`` a dtype. A select a
        tensor would queue ~1,300 small kernels a ResNet-50 step, and the
        scanned fit's host is what bounds it. The optimizers write their
        weights and states in place (``copy_``), so the views stay the
        live tensors. Returns the flat buffers."""
        leaves = [l for st in self.opt_states
                  for l in _grd._state_nd_leaves(st)]
        groups = {}
        for t in (list(self.params.values()) + [l._data for l in leaves]
                  + self.aux):
            groups.setdefault(t.dtype, []).append(t)
        flats, views = [], {}
        for dtype, ts in groups.items():
            flat = torch.empty(sum(t.numel() for t in ts), dtype=dtype,
                               device=self._device)
            off = 0
            for t in ts:
                v = flat[off:off + t.numel()].view(t.shape)
                v.copy_(t)
                views[id(t)] = v
                off += t.numel()
            flats.append(flat)
        for n in self.param_names:
            self.params[n] = views[id(self.params[n])]
        for w, n in zip(self._weights, self.param_names):
            w._data = self.params[n]
        for l in leaves:
            l._data = views[id(l._data)]
        self.aux = [views[id(a)] for a in self.aux]
        return flats

    def _update(self, grads, lr):
        """The real ``optimizer.update`` once a parameter, at base lr
        ``lr`` (times each index's multiplier, as ``_get_lr`` takes it)."""
        opt = self.optimizer
        saved = opt.lr, opt.lr_scheduler
        opt.lr, opt.lr_scheduler = lr, None
        try:
            for i, n in enumerate(self.param_names):
                opt.update(i, self._weights[i], NDArray(grads[n], self.ctx),
                           self.opt_states[i])
        finally:
            opt.lr, opt.lr_scheduler = saved

    def _cast_data(self, v):
        cdt = self._cdt
        if cdt is not None and v.dim() >= 2 and v.is_floating_point():
            return v.to(cdt)
        return v

    def stage_chunk(self, batch_list):
        """Stack K batches (name -> tensor or numpy array) into device
        tensors with a leading axis K; returns the staged chunk. Arrays
        already on the device stack there; host arrays stack on the host
        and go over once, f32 images cast to bf16 first by a bf16
        trainer."""
        dev = self._device
        bf16 = self._cdt == torch.bfloat16
        staged = {}
        for n in self.input_names:
            vals = [b[n] if torch.is_tensor(b[n]) else _as_tensor(b[n], "cpu")
                    for b in batch_list]
            on_dev = all(v.device == dev for v in vals)
            v = torch.stack(vals if on_dev else [v.cpu() for v in vals])
            if bf16 and v.dim() >= 3 and v.dtype == torch.float32:
                v = v.to(torch.bfloat16)
            staged[n] = v if on_dev else _to_device(v, dev)
        return len(batch_list), staged

    def run_chunk(self, staged):
        """Run K train steps on a staged chunk, queued without a host
        synchronisation. Returns the heads' outputs, each stacked over
        the K steps (device tensors)."""
        K, batches = staged
        opt = self.optimizer
        base = opt.num_update
        # lr for step k = scheduler(base + k + 1), the count every
        # parameter after the first sees in the per-batch loop (the JAX
        # trainer's choice, mxnet_tpu/parallel/fit_trainer.py:367-383)
        lrs = [(opt.lr_scheduler(base + k + 1)
                if opt.lr_scheduler is not None else opt.lr)
               for k in range(K)]
        self._key, sub = threefry.split(self._key)
        keys = threefry.split(sub, K)
        # one host fire decision a step for the chaos points, staged
        # into the chunk (the JAX trainer stages them the same way)
        mults = ([_grd.grad_fault_multiplier() for _ in range(K)]
                 if self._inject else [1.0] * K)
        if K not in self._jit_cache:
            # one "compile" per chunk length K (the memo key IS the
            # bucket) — MXNET_JIT_VERIFY names any arg that breaks it
            self._jit_cache[K] = _cv.wrap(
                "fit_trainer.loop|K=%d" % K, self._chunk_program, budget=1,
                group="train.fit_loop")
            if _tel.ENABLED:
                # a chunk length's first run, the JAX trainer's jit build
                _tel.counter("executor.jit_builds_total").inc()
            if _prof.ENABLED:
                self._attribute(K, batches)
        fn = self._jit_cache[K]
        args = (batches, _np.asarray(lrs, _np.float64), keys,
                _np.asarray(mults, _np.float64))
        self.last_program_key = self._prof_keys.get(K)
        if self.last_program_key is not None:
            with _prof.measure_first_call(self.last_program_key,
                                          self._device):
                outs, flags = fn(*args)
        else:
            outs, flags = fn(*args)
        self._last_flags = flags
        return [torch.stack(col) for col in zip(*outs)]

    def _chunk_program(self, batches, lrs, keys, mults):
        """The K-step program of one chunk: ``lrs`` and ``mults`` are
        float64 arrays (their values exact), ``keys`` the K step keys."""
        return self._steps(len(lrs), batches, lrs.tolist(), keys,
                           mults.tolist())

    def _steps(self, K, batches, lrs, keys, mults):
        guard = self._guard_on
        oks, gnorms, outs = [], [], []
        for k in range(K):
            batch = {n: self._cast_data(b[k]) for n, b in batches.items()}
            grads, o, new_aux = train_grads(
                self._run, self._arg_names, self.params, batch, self.aux,
                keys[k], self._cdt)
            with torch.no_grad():
                if mults[k] != 1.0:
                    grads = {n: g * mults[k] for n, g in grads.items()}
                if guard:
                    ok, gsq = _grd.grad_flags(grads.values(),
                                              self._guard_max_norm)
                    old = [f.clone() for f in self._flats]
                self._update(grads, lrs[k])
                write_aux(self.aux, new_aux)
                if guard:
                    # the whole step lands or none of it does
                    for f, prev in zip(self._flats, old):
                        f.copy_(torch.where(ok, f, prev))
                    oks.append(ok)
                    gnorms.append(torch.sqrt(gsq))
            outs.append(o)
        flags = (torch.stack(oks), torch.stack(gnorms)) if guard else None
        return outs, flags

    def _attribute(self, K, batches):
        """mxprof: record the K-step chunk program once (K times the
        graph's analytic training FLOPs and bytes)."""
        if self._prof_analytic is None:
            try:
                self._prof_analytic = _prof.graph_cost(
                    self._symbol, self._input_shapes)
            except Exception:
                self._prof_analytic = {}
        an = self._prof_analytic or {}
        sig = ",".join(
            "%s=%s" % (n, "x".join(str(d) for d in batches[n].shape))
            for n in sorted(batches))
        pkey = "fit_trainer|K=%d|%s" % (K, sig)
        opt = self.optimizer
        # graph identity: the symbol, the optimizer's static config, the
        # compute dtype and the guardian / fault-injection switches
        ghash = _prof.graph_hash("%s|%s|%s|%s|g=%d,%s,%d" % (
            _prof.symbol_fingerprint(self._symbol), type(opt).__name__,
            sorted((k, v) for k, v in vars(opt).items()
                   if isinstance(v, (int, float, str, bool))),
            self._cdt, self._guard_on, self._guard_max_norm, self._inject))
        _prof.attribute_program(
            pkey, self._steps, site="fit_trainer.scan", analytic=an or None,
            meta={"K": K, "steps_per_call": K}, graph_key=ghash,
            flops=(K * an["flops_train"]) if an.get("flops_train") else None,
            bytes_accessed=(3 * K * an["bytes"]) if an.get("bytes") else None)
        self._prof_keys[K] = _prof.program_key_for(pkey, graph_key=ghash)

    def take_step_flags(self):
        """The newest chunk's per-step guardian verdicts — ``(ok[K],
        grad_norm[K])`` device tensors — or None when the trainer runs
        unguarded. Consumed once (cleared on read) so a drain can never
        double-account a chunk."""
        flags, self._last_flags = self._last_flags, None
        return flags

    # -- guardian snapshot/rollback -------------------------------------------
    def snapshot_state(self):
        """Host copy of the trainer state (parameters, optimizer states,
        aux, the optimizer's step bookkeeping) — the guardian's
        in-memory last-good ring payload."""
        opt = self.optimizer

        def host(t):
            return t.detach().to("cpu", copy=True)

        return {
            "params": {n: host(v) for n, v in self.params.items()},
            "aux": [host(a) for a in self.aux],
            "opt_states": [[host(l._data)
                            for l in _grd._state_nd_leaves(st)]
                           for st in self.opt_states],
            "num_update": opt.num_update,
            "counts": dict(opt._index_update_count),
        }

    def restore_state(self, snap):
        """Adopt a :meth:`snapshot_state` dump (guardian rollback),
        written into the trainer's own tensors in place."""
        with torch.no_grad():
            for n, v in snap["params"].items():
                self.params[n].copy_(v)
            for a, v in zip(self.aux, snap["aux"]):
                a.copy_(v)
            for st, saved in zip(self.opt_states, snap["opt_states"]):
                for l, v in zip(_grd._state_nd_leaves(st), saved):
                    l._data.copy_(v)
        opt = self.optimizer
        opt.num_update = snap["num_update"]
        opt._index_update_count = dict(snap["counts"])

    def load_params(self, arg_params, aux_params):
        """Adopt checkpoint params/aux (the guardian's DISK rollback
        fallback). Names missing from the checkpoint keep their current
        values. A .params checkpoint carries no optimizer state, so the
        states restart from fresh ``create_state`` values, as a resume
        without a ``.states`` file does."""
        dev = self._device
        with torch.no_grad():
            for n in self.param_names:
                if n in arg_params:
                    self.params[n].copy_(
                        _as_tensor(arg_params[n], dev, torch.float32))
            for n, a in zip(self._aux_names, self.aux):
                if n in aux_params:
                    a.copy_(_as_tensor(aux_params[n], dev, torch.float32))
        self.opt_states = [self.optimizer.create_state(i, w)
                           for i, w in enumerate(self._weights)]
        if self._guard_on:
            self._flats = self._guard_buffers()

    def write_back(self, arg_params, aux_params, aux_names):
        """Copy the trainer's parameters and aux states into the
        user-visible NDArray dicts (epoch ends, checkpoints, the end)."""
        for n in self.param_names:
            arg_params[n][:] = self.params[n]
        for n, a in zip(aux_names, self.aux):
            aux_params[n][:] = a


def make_fit_trainer(symbol, ctx, input_shapes, optimizer, arg_params,
                     aux_params, param_names, compute_dtype=None):
    return FitTrainer(symbol, ctx, input_shapes, optimizer, arg_params,
                      aux_params, param_names, compute_dtype=compute_dtype)
