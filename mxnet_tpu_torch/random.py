"""Random sampling on NDArray: the subset the initializers need.

Counterpart of ``mxnet_tpu/random.py``: ``seed``, ``uniform`` and
``normal``. The JAX package splits one threefry key chain; here each
device has one ``torch.Generator``, and ``seed`` reseeds them all. The
two packages draw different numbers from the same seed, so parity tests
carry parameters across instead (``model.params_from_numpy``).
"""
from __future__ import annotations

import torch

from .context import current_context
from .ndarray import NDArray

__all__ = ["seed", "uniform", "normal"]

_state = {"seed": 0, "generators": {}}


def _generator(device):
    gens = _state["generators"]
    key = str(device)
    if key not in gens:
        gens[key] = torch.Generator(device=device).manual_seed(
            _state["seed"])
    return gens[key]


def seed(seed_state):
    """Seed every device's generator."""
    _state["seed"] = int(seed_state)
    _state["generators"].clear()


def _draw(fill, shape, ctx, out):
    if out is not None:
        shape, ctx = out.shape, out.context
    ctx = ctx or current_context()
    if shape is None:
        shape = (1,)
    if isinstance(shape, int):
        shape = (shape,)
    dev = ctx.torch_device
    data = fill(torch.empty(tuple(shape), dtype=torch.float32, device=dev),
                _generator(dev))
    if out is not None:
        out._set_data(data)
        return out
    return NDArray(data, ctx)


def uniform(low=0.0, high=1.0, shape=None, ctx=None, out=None):
    """Samples of U[low, high) in float32."""
    return _draw(lambda t, g: t.uniform_(low, high, generator=g), shape,
                 ctx, out)


def normal(loc=0.0, scale=1.0, shape=None, ctx=None, out=None):
    """Samples of N(loc, scale^2) in float32."""
    return _draw(lambda t, g: t.normal_(loc, scale, generator=g), shape,
                 ctx, out)
