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

Not ported: the guardian's hooks (``snapshot_state``,
``restore_state``, ``load_params``, the sentinel), fault injection,
mxprof and telemetry (``MXNET_GUARDIAN=1`` raises in the port's fits).
"""
from __future__ import annotations

import torch

from .. import random as _random
from .. import threefry
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
        outs = []
        for k in range(K):
            batch = {n: self._cast_data(b[k]) for n, b in batches.items()}
            grads, o, new_aux = train_grads(
                self._run, self._arg_names, self.params, batch, self.aux,
                keys[k], self._cdt)
            with torch.no_grad():
                self._update(grads, lrs[k])
                write_aux(self.aux, new_aux)
            outs.append(o)
        return [torch.stack(col) for col in zip(*outs)]

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
