"""Optimizers (ref: python/mxnet/optimizer.py:1-823).

Counterpart of ``mxnet_tpu/optimizer.py``: the registry and the
reference's set, ``SGD``, ``ccSGD``, ``NAG``, ``SGLD``, ``Adam``,
``AdaGrad``, ``RMSProp``, ``AdaDelta`` and ``Test``, with ``create`` and
``get_updater``. The ``Optimizer`` base is the JAX package's: the lr
scheduler, the idx2name lr/wd multipliers, ``__lr_mult__``/
``__wd_mult__`` symbol attrs, and wd 0 for every name ending in neither
``_weight`` nor ``_gamma``. Each update keeps the JAX update's
arithmetic, operation for operation, in the weight's dtype, and writes
the weight and its state in place (the executor reads the same
storage). Two notes:

- ``SGLD``'s noise is JAX's: ``threefry.normal`` under the key that
  ``random.next_key()`` gives, as ``jax.random.normal`` is in the JAX
  package (its ``erfinv`` may differ from XLA's by ulps);
- ``Adam``'s bias correction reads the index's update count, which in
  the scanned fit (``parallel/fit_trainer.py``) is the step's own count
  inside the chunk, since the trainer calls ``update`` once a step.

``get_updater`` creates state lazily per index, applies the
``grad.nan``/``loss.spike`` fault points, and under ``MXNET_GUARDIAN=1``
runs each update through the guardian's on-device sentinel.
"""
from __future__ import annotations

import math

import torch

from . import random as _random
from . import threefry
from .ndarray import NDArray, zeros

__all__ = [
    "Optimizer", "SGD", "NAG", "SGLD", "ccSGD", "Adam", "AdaGrad", "RMSProp",
    "AdaDelta", "Test", "create", "get_updater", "register", "state_nbytes",
]


class Optimizer:
    opt_registry = {}

    @staticmethod
    def register(klass):
        """ref: optimizer.py:21 — name registry (case-insensitive)."""
        assert isinstance(klass, type)
        name = klass.__name__.lower()
        Optimizer.opt_registry[name] = klass
        return klass

    @staticmethod
    def create_optimizer(name, rescale_grad=1, **kwargs):
        """ref: optimizer.py:38."""
        if name.lower() in Optimizer.opt_registry:
            return Optimizer.opt_registry[name.lower()](rescale_grad=rescale_grad, **kwargs)
        raise ValueError("Cannot find optimizer %s" % name)

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        if param_idx2name is None:
            param_idx2name = {}
        assert isinstance(param_idx2name, dict)
        self.idx2name = param_idx2name.copy()
        self.sym = sym
        self.set_lr_mult({})
        self.set_wd_mult({})

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError()

    def set_lr_scale(self, args_lrscale):
        """Deprecated in the reference too (optimizer.py:126): use
        set_lr_mult."""
        raise DeprecationWarning("set_lr_scale is deprecated; use set_lr_mult")

    def set_lr_mult(self, args_lr_mult):
        """ref: optimizer.py:109 — reads __lr_mult__ attrs from self.sym."""
        self.lr_mult = {}
        if self.sym is not None:
            attr = self.sym.attr_dict()
            for name in self.sym.list_arguments():
                if name in attr and "__lr_mult__" in attr[name]:
                    self.lr_mult[name] = float(attr[name]["__lr_mult__"])
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        """ref: optimizer.py:134 — no-wd default for bias/gamma/beta."""
        self.wd_mult = {}
        for n in self.idx2name.values():
            if not (n.endswith("_weight") or n.endswith("_gamma")):
                self.wd_mult[n] = 0.0
        if self.sym is not None:
            attr = self.sym.attr_dict()
            for name in self.sym.list_arguments():
                if name in attr and "__wd_mult__" in attr[name]:
                    self.wd_mult[name] = float(attr[name]["__wd_mult__"])
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index], self.num_update)

    def _get_lr(self, index):
        if self.lr_scheduler is not None:
            lr = self.lr_scheduler(self.num_update)
        else:
            lr = self.lr
        if index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    def _preprocess_grad(self, grad):
        g = grad._data * self.rescale_grad
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        return g


register = Optimizer.register


@register
class SGD(Optimizer):
    """SGD with momentum."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return zeros(weight.shape, weight.context, dtype=weight.dtype)

    def update(self, index, weight, grad, state):
        assert isinstance(weight, NDArray) and isinstance(grad, NDArray)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        with torch.no_grad():
            g = self._preprocess_grad(grad)
            w = weight._data
            step = (g + wd * w) * lr
            if state is not None:
                mom = state._data
                mom.mul_(self.momentum).sub_(step)
                w.add_(mom)
            else:
                w.sub_(step)


@register
class ccSGD(SGD):
    """Alias of SGD; the reference's C++-engine variant (ref:
    src/optimizer/sgd.cc:24, python/mxnet/optimizer.py:426); a negative
    ``clip_gradient`` means none."""

    def __init__(self, momentum=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                 **kwargs):
        if clip_gradient is not None and clip_gradient < 0:
            clip_gradient = None
        super().__init__(momentum=momentum, rescale_grad=rescale_grad,
                         clip_gradient=clip_gradient, **kwargs)


@register
class NAG(SGD):
    """Nesterov accelerated SGD (ref: optimizer.py:313)."""

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        with torch.no_grad():
            g = self._preprocess_grad(grad)
            w = weight._data
            if state is not None:
                mom = self.momentum * state._data + g + wd * w
                g2 = self.momentum * mom + g
                state._data.copy_(mom)
                w.copy_(w - lr * g2)
            else:
                w.copy_(w - lr * (g + wd * w))


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics (ref: optimizer.py:361)."""

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        with torch.no_grad():
            g = self._preprocess_grad(grad)
            w = weight._data
            key = _random.keys_to(_random.next_key(), w.device)
            noise = threefry.normal(key, w.shape).to(w.dtype) * math.sqrt(lr)
            w.copy_(w - lr / 2 * (g + wd * w) + noise)


@register
class Adam(Optimizer):
    """ref: optimizer.py:504. ``decay_factor`` is accepted for the
    reference's API; the bias correction uses the index's update
    count."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, decay_factor=(1 - 1e-8), **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.decay_factor = decay_factor

    def create_state(self, index, weight):
        return (
            zeros(weight.shape, weight.context, dtype=weight.dtype),  # mean
            zeros(weight.shape, weight.context, dtype=weight.dtype),  # variance
        )

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        self._update_count(index)
        t = self._index_update_count[index]
        mean, var = state
        with torch.no_grad():
            g = self._preprocess_grad(grad)
            wd = self._get_wd(index)
            w = weight._data
            g = g + wd * w
            m = self.beta1 * mean._data + (1 - self.beta1) * g
            v = self.beta2 * var._data + (1 - self.beta2) * torch.square(g)
            mean._data.copy_(m)
            var._data.copy_(v)
            coef1 = 1.0 - self.beta1 ** t
            coef2 = 1.0 - self.beta2 ** t
            lr_t = lr * math.sqrt(coef2) / coef1
            w.copy_(w - lr_t * m / (torch.sqrt(v) + self.epsilon))


@register
class AdaGrad(Optimizer):
    """ref: optimizer.py:605."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return zeros(weight.shape, weight.context, dtype=weight.dtype)

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        with torch.no_grad():
            g = self._preprocess_grad(grad)
            h = state._data + torch.square(g)
            state._data.copy_(h)
            w = weight._data
            w.copy_(w - lr * (g / torch.sqrt(h + self.float_stable_eps)
                              + wd * w))


@register
class RMSProp(Optimizer):
    """Tieleman & Hinton variant with E[g], E[g^2] and momentum delta
    (ref: optimizer.py:654)."""

    def __init__(self, learning_rate=0.002, gamma1=0.95, gamma2=0.9,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2

    def create_state(self, index, weight):
        return (
            zeros(weight.shape, weight.context, dtype=weight.dtype),  # n = E[g^2]
            zeros(weight.shape, weight.context, dtype=weight.dtype),  # g = E[g]
            zeros(weight.shape, weight.context, dtype=weight.dtype),  # delta
        )

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        n, g_avg, delta = state
        with torch.no_grad():
            g = self._preprocess_grad(grad)
            w = weight._data
            g = g + wd * w
            n_ = (1 - self.gamma1) * torch.square(g) + self.gamma1 * n._data
            g_ = (1 - self.gamma1) * g + self.gamma1 * g_avg._data
            d_ = self.gamma2 * delta._data - lr * g / torch.sqrt(
                n_ - torch.square(g_) + 1e-4)
            n._data.copy_(n_)
            g_avg._data.copy_(g_)
            delta._data.copy_(d_)
            w.copy_(w + d_)


@register
class AdaDelta(Optimizer):
    """ref: optimizer.py:730."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (
            zeros(weight.shape, weight.context, dtype=weight.dtype),  # E[g^2]
            zeros(weight.shape, weight.context, dtype=weight.dtype),  # E[dx^2]
        )

    def update(self, index, weight, grad, state):
        wd = self._get_wd(index)
        self._update_count(index)
        acc_g, acc_delta = state
        with torch.no_grad():
            g = self._preprocess_grad(grad)
            ag = self.rho * acc_g._data + (1.0 - self.rho) * torch.square(g)
            delta = (torch.sqrt(acc_delta._data + self.epsilon)
                     / torch.sqrt(ag + self.epsilon) * g)
            ad = self.rho * acc_delta._data + (1.0 - self.rho) * torch.square(
                delta)
            acc_g._data.copy_(ag)
            acc_delta._data.copy_(ad)
            w = weight._data
            w.copy_(w - delta - wd * w)


@register
class Test(Optimizer):
    """ref: optimizer.py:784 — weight += grad * rescale_grad."""

    def create_state(self, index, weight):
        return zeros(weight.shape, weight.context, dtype=weight.dtype)

    def update(self, index, weight, grad, state):
        with torch.no_grad():
            w = weight._data
            w.copy_(w + grad._data * self.rescale_grad)


create = Optimizer.create_optimizer


def get_updater(optimizer, inject_faults=True):
    """Closure ``updater(index, grad, weight)`` with per-index state,
    created on the first update of each index
    (``mxnet_tpu/optimizer.py:368-409``).

    With ``MXNET_GUARDIAN=1`` every update runs through the guardian's
    on-device sentinel (``resilience/guardian.py``): a gradient with
    NaN/Inf (or past ``MXNET_GUARDIAN_GRADNORM_MAX``) leaves the weight
    and the optimizer state as they were, through ``torch.where`` on the
    device, with no host synchronisation; the sentinel rides on
    ``updater.sentinel`` for the training loop's per-step read. The
    ``grad.nan``/``loss.spike`` fault points live here too, outside the
    guardian switch (an unguarded run can be poisoned the same way);
    ``inject_faults=False`` opts a secondary updater out of the draw.
    ``updater.states`` is what the guardian's snapshots read."""
    from .resilience import guardian as _guardian

    states = {}
    sentinel = _guardian.updater_sentinel()  # None unless MXNET_GUARDIAN=1

    def updater(index, grad, weight):
        if index not in states:
            states[index] = optimizer.create_state(index, weight)
        if inject_faults:
            grad = _guardian.corrupt_grad(grad)  # no-op unless armed
        if sentinel is None:
            optimizer.update(index, weight, grad, states[index])
        else:
            sentinel.guarded_update(optimizer, index, weight, grad,
                                    states[index])

    updater.sentinel = sentinel
    updater.states = states
    return updater


def state_nbytes(updater):
    """Total bytes of optimizer state an updater has materialized (the
    JAX package's ``kvstore.optimizer_state_bytes`` gauge). Walks the
    lazy per-index state dict; tuple/list states (Adam, RMSProp) count
    every slot."""
    def _leaf_bytes(st):
        if st is None:
            return 0
        if isinstance(st, (tuple, list)):
            return sum(_leaf_bytes(s) for s in st)
        t = st._data if hasattr(st, "_data") else st
        return t.numel() * t.element_size()

    total = 0
    for st in getattr(updater, "states", {}).values():
        total += _leaf_bytes(st)
    return total
