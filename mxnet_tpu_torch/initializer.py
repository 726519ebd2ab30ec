"""Weight initializers (ref: python/mxnet/initializer.py).

Counterpart of ``mxnet_tpu/initializer.py``: ``Uniform``, ``Normal``,
``Orthogonal``, ``Xavier``, ``MSRAPrelu``, ``Load``, ``Mixed``, ``One``
and ``Zero``, with the same dispatch on the parameter name (bias 0,
gamma 1, beta 0, weight by the scheme, moving_mean 0, moving_var 1) and
the same schemes. Random schemes draw through the port's ``random`` (one
``torch.Generator`` per device), so their numbers differ from the JAX
package's for the same seed; ``Orthogonal`` takes its SVD on the host,
as the JAX package does.
"""
from __future__ import annotations

import math
import re

import numpy as _np

from . import ndarray
from . import random as _random
from .base import MXNetError

__all__ = ["Initializer", "Uniform", "Normal", "Orthogonal", "Xavier",
           "MSRAPrelu", "Load", "Mixed", "One", "Zero", "init"]


class Initializer:
    """Base initializer; dispatches on parameter name
    (ref: initializer.py:18 __call__)."""

    def __call__(self, name, arr):
        if not isinstance(name, str):
            raise TypeError("name must be a string")
        if name.startswith("upsampling"):
            self._init_bilinear(name, arr)
        elif name.endswith("bias"):
            self._init_bias(name, arr)
        elif name.endswith("gamma"):
            self._init_gamma(name, arr)
        elif name.endswith("beta"):
            self._init_beta(name, arr)
        elif name.endswith("weight"):
            self._init_weight(name, arr)
        elif name.endswith("moving_mean"):
            self._init_zero(name, arr)
        elif name.endswith("moving_var"):
            self._init_one(name, arr)
        elif name.endswith("moving_inv_var"):
            self._init_zero(name, arr)
        elif name.endswith("moving_avg"):
            self._init_zero(name, arr)
        else:
            self._init_default(name, arr)

    def _init_bilinear(self, _, arr):
        weight = _np.zeros(arr.size, dtype="float32")
        shape = arr.shape
        f = shape[3] / 2.0
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(arr.size):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            weight[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        arr[:] = weight.reshape(shape)

    def _init_bias(self, _, arr):
        arr[:] = 0.0

    def _init_gamma(self, _, arr):
        arr[:] = 1.0

    def _init_beta(self, _, arr):
        arr[:] = 0.0

    def _init_zero(self, _, arr):
        arr[:] = 0.0

    def _init_one(self, _, arr):
        arr[:] = 1.0

    def _init_weight(self, name, arr):
        raise NotImplementedError("must override _init_weight")

    def _init_default(self, name, arr):
        self._init_weight(name, arr)


class Uniform(Initializer):
    """ref: initializer.py:94."""

    def __init__(self, scale=0.07):
        self.scale = scale

    def _init_weight(self, _, arr):
        _random.uniform(-self.scale, self.scale, out=arr)


class Normal(Initializer):
    """ref: initializer.py:107."""

    def __init__(self, sigma=0.01):
        self.sigma = sigma

    def _init_weight(self, _, arr):
        _random.normal(0, self.sigma, out=arr)


class Orthogonal(Initializer):
    """ref: initializer.py:121."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, _, arr):
        nout = arr.shape[0]
        nin = int(_np.prod(arr.shape[1:]))
        if self.rand_type == "uniform":
            tmp = _random.uniform(-1.0, 1.0, shape=(nout, nin),
                                  ctx=arr.context).asnumpy()
        else:
            tmp = _random.normal(0.0, 1.0, shape=(nout, nin),
                                 ctx=arr.context).asnumpy()
        u, _, v = _np.linalg.svd(tmp, full_matrices=False)
        q = u if u.shape == tmp.shape else v
        arr[:] = (self.scale * q).reshape(arr.shape)


class Xavier(Initializer):
    """ref: initializer.py:159."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, _, arr):
        shape = arr.shape
        hw_scale = 1.0
        if len(shape) > 2:
            hw_scale = _np.prod(shape[2:])
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factor = 1.0
        if self.factor_type == "avg":
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == "in":
            factor = fan_in
        elif self.factor_type == "out":
            factor = fan_out
        else:
            raise ValueError("Incorrect factor type")
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            _random.uniform(-scale, scale, out=arr)
        elif self.rnd_type == "gaussian":
            _random.normal(0, scale, out=arr)
        else:
            raise ValueError("Unknown random type")


class MSRAPrelu(Xavier):
    """ref: initializer.py:209."""

    def __init__(self, factor_type="avg", slope=0.25):
        magnitude = 2.0 / (1 + slope ** 2)
        super().__init__("gaussian", factor_type, magnitude)


class Load:
    """Init from a dict of saved params (ref: initializer.py:46)."""

    def __init__(self, param, default_init=None, verbose=False):
        if isinstance(param, str):
            param = ndarray.load(param)
        self.param = {
            (k[4:] if k.startswith("arg:") or k.startswith("aux:") else k): v
            for k, v in param.items()
        }
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr):
        if name in self.param:
            if self.param[name].shape != arr.shape:
                raise MXNetError(
                    "Parameter %s shape mismatch: %s vs %s"
                    % (name, self.param[name].shape, arr.shape)
                )
            self.param[name].copyto(arr)
        else:
            if self.default_init is None:
                raise MXNetError("Cannot init %s: not in loaded params" % name)
            self.default_init(name, arr)


class Mixed:
    """Pattern-dispatched mix of initializers (ref: initializer.py:75)."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise MXNetError("patterns and initializers must have same length")
        self.map = list(zip([re.compile(p) for p in patterns], initializers))

    def __call__(self, name, arr):
        for prog, i in self.map:
            if prog.match(name):
                i(name, arr)
                return
        raise MXNetError("Parameter %s did not match any pattern" % name)


class One(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 1.0


class Zero(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 0.0


class init:
    """The ``mx.init.*`` alias namespace of the initializers."""
    Initializer = Initializer
    Uniform = Uniform
    Normal = Normal
    Orthogonal = Orthogonal
    Xavier = Xavier
    MSRAPrelu = MSRAPrelu
    Load = Load
    Mixed = Mixed
    One = One
    Zero = Zero
