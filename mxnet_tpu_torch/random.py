"""Random sampling on NDArray and the key chain of the graph's random ops.

Counterpart of ``mxnet_tpu/random.py``: ``seed``, ``uniform``,
``normal``, ``randint`` and ``next_key``. Two kinds of draw live here:

- **The key chain follows the JAX package's bit for bit.**
  ``next_key()`` splits one threefry key (``mxnet_tpu/random.py:21-50``):
  the chain starts at ``PRNGKey(seed)`` (seed 0 until :func:`seed` is
  called), and every call replaces it with ``split(key)[0]`` and returns
  ``split(key)[1]``. The executor takes one key a training forward and
  folds each random node's serial into it, so ``Dropout`` masks and the
  fused ``RNN`` op's inter-layer masks equal the JAX package's under the
  same seed. The chain is kept on the host on purpose: its keys are
  ``[2]`` int64 tensors (:mod:`.threefry`), and a split or a fold-in is
  a few scalar ops that the host does without a launch. A key reaches
  its device through :func:`keys_to`, one copy from pinned memory that
  does not wait for the card's stream.
- **Values of ``uniform``, ``normal`` and ``randint`` do not.** They come from one
  ``torch.Generator`` a device, which ``seed`` reseeds, so the two
  packages' initial weights differ under one seed and parity tests carry
  parameters across (``model.params_from_numpy``). Each call still takes
  one key from the chain, as the JAX package's draw does, so the chain
  stays in step across an initialisation.
"""
from __future__ import annotations

import torch

from . import threefry
from .context import current_context
from .ndarray import NDArray

__all__ = ["seed", "uniform", "normal", "randint", "next_key", "keys_to"]

_state = {"seed": 0, "generators": {}, "key": None}


def _generator(device):
    gens = _state["generators"]
    key = str(device)
    if key not in gens:
        gens[key] = torch.Generator(device=device).manual_seed(
            _state["seed"])
    return gens[key]


def next_key():
    """Split the chain's key and return the fresh subkey (a ``[2]``
    int64 host tensor)."""
    if _state["key"] is None:
        _state["key"] = threefry.prng_key(_state["seed"], device="cpu")
    _state["key"], sub = threefry.split(_state["key"])
    return sub


def keys_to(keys, device):
    """Host keys on ``device``; to a card, through pinned memory and
    without synchronising its stream."""
    device = torch.device(device)
    if device.type != "cuda":
        return keys.to(device)
    return keys.pin_memory().to(device, non_blocking=True)


def seed(seed_state):
    """Seed every device's generator and restart the key chain at
    ``PRNGKey(seed_state)``."""
    _state["seed"] = int(seed_state)
    _state["generators"].clear()
    _state["key"] = threefry.prng_key(int(seed_state), device="cpu")


def _draw(fill, shape, ctx, out):
    if out is not None:
        shape, ctx = out.shape, out.context
    ctx = ctx or current_context()
    if shape is None:
        shape = (1,)
    if isinstance(shape, int):
        shape = (shape,)
    dev = ctx.torch_device
    next_key()
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


def randint(low, high, shape=None, ctx=None):
    """Integers of [low, high) in int32."""
    ctx = ctx or current_context()
    if shape is None:
        shape = (1,)
    if isinstance(shape, int):
        shape = (shape,)
    dev = ctx.torch_device
    next_key()
    data = torch.randint(low, high, tuple(shape), generator=_generator(dev),
                         dtype=torch.int32, device=dev)
    return NDArray(data, ctx)
