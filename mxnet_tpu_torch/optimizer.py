"""Optimizers: ``Optimizer``, ``SGD``, ``create`` and ``get_updater``.

Counterpart of ``mxnet_tpu/optimizer.py:29-170`` and ``:368``. The
``Optimizer`` base is the JAX package's: the lr scheduler, the
idx2name lr/wd multipliers, ``__lr_mult__``/``__wd_mult__`` symbol
attrs, and wd 0 for every name ending in neither ``_weight`` nor
``_gamma``. ``SGD`` keeps the JAX update's order of operations,
``mom = mom * momentum - lr * (clip(rescale * g) + wd * w)`` then
``w += mom``, and writes state and weight in place (the executor reads
the same storage). ``get_updater`` creates state lazily per index and
has no fault injection or guardian. The JAX package's other optimizers
are a later slice.
"""
from __future__ import annotations

import torch

from .ndarray import NDArray, zeros

__all__ = ["Optimizer", "SGD", "create", "get_updater", "register"]


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


create = Optimizer.create_optimizer


def get_updater(optimizer):
    """Closure ``updater(index, grad, weight)`` with per-index state,
    created on the first update of each index."""
    states = {}

    def updater(index, grad, weight):
        if index not in states:
            states[index] = optimizer.create_state(index, weight)
        optimizer.update(index, weight, grad, states[index])

    updater.states = states
    return updater
