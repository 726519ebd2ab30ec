"""JAX's counter-based PRNG (threefry2x32) as integer torch ops.

The serving sampler keys every draw by ``fold_in`` chains of
``jax.random`` (``mxnet_tpu/serving/sampling.py``), so a sampled stream
of the port equals the JAX package's only if the bits are JAX's. The
port imports no JAX, so this module keeps its own copy of exactly what
that sampler uses, read from JAX 0.9.0 (``jax/_src/prng.py`` and
``jax/_src/random.py``):

- ``threefry2x32`` is ``_threefry2x32_lowering`` (prng.py:883, rounds
  by ``apply_round`` :863): 20 rounds in five groups of four, rotations
  (13, 15, 26, 6) and (17, 29, 16, 24) alternating, the key schedule
  ``k1, k2, k1 ^ k2 ^ 0x1BD11BDA`` injected after each group with the
  group's index added to the second word;
- :func:`prng_key` is ``threefry_seed`` (prng.py:802-830): a uint32
  seed ``s`` gives the key ``[0, s]``;
- :func:`fold_in` is ``threefry_fold_in`` (prng.py:1163-1169):
  ``threefry_2x32(key, threefry_seed(uint32(data)))``, which hashes the
  counter pair ``(0, data)``;
- :func:`split` is ``_threefry_split_foldlike`` (prng.py:1155-1160,
  the partitionable split): key ``i`` of ``num`` is threefry of the
  counter pair ``(0, i)``, so ``split(key)[1]`` equals
  ``fold_in(key, 1)``;
- :func:`random_bits` is ``_threefry_random_bits_partitionable``
  (prng.py:1184-1201) at 32 bits. ``jax_threefry_partitionable`` is
  True in JAX 0.9.0 (config.py:1302), and the JAX package runs under
  that default: element ``i`` of a draw is ``y1 ^ y2`` of threefry over
  the ``iota_2x32_shape`` counters (high word 0, low word ``i``,
  prng.py:989). The older non-partitionable layout gives other bits and
  is not carried;
- :func:`uniform` is ``_uniform`` (random.py:435-475) for float32: the
  top 23 bits as the mantissa of a float in [1, 2) (``(bits >> 9) |
  0x3F800000``), minus 1, times ``maxval - minval``, plus ``minval``,
  then the max with ``minval``. A scalar draw (shape ``()``) is element
  0 of a vector draw;
- :func:`bernoulli` is ``bernoulli`` in mode "low" (random.py:1028-1089)
  with a float32 ``p``: ``uniform(key, shape) < float32(p)``, the
  uniform of an n-d shape drawn over its row-major linear index;
- :func:`gumbel` is ``_gumbel`` in mode "low" (random.py:1723-1740;
  ``jax_high_dynamic_range_gumbel`` defaults to False):
  ``-log(-log(uniform(key, minval=tiny, maxval=1)))``;
- :func:`normal` is ``_normal_real`` for float32:
  ``sqrt(2) * erf_inv(uniform(key, minval=nextafter(-1, 0), maxval=1))``,
  with ``erf_inv`` as XLA expands ``chlo.erf_inv`` for f32 (Giles'
  single-precision polynomials in ``w = -log1p(-x * x)``, split at
  ``w = 5``); ``torch.erfinv`` is more exact and differs from it by up
  to ~60 ulp in the tails.

Words are held in int64 tensors masked to 32 bits (torch's uint32
support is partial); a rotation is ``((x << r) & M) | (x >> (32 - r))``.
Keys are ``[..., 2]`` int64 tensors. :func:`prng_key` puts them on
``device``, by default the current context's (``cuda:0``; it raises
without CUDA, so keys are never built on the host by accident). Every
other function runs on its keys' device and vectorises over the
leading axes: ``[N, 2]`` keys give
``[N, V]`` draws in one pass. Keys, bits and uniforms are integers or
bit patterns and equal JAX's exactly on any device; only the two
``log``s of :func:`gumbel` and the ``erfinv`` of :func:`normal` may
differ from XLA's by ulps.

``threefry2x32.calls`` counts hash evaluations by device type (``{"cuda":
n}``); every key derivation and draw goes through it, so a caller can
show that a batch made no draw or that its draws ran on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from .context import resolve_device

__all__ = ["threefry2x32", "prng_key", "fold_in", "split", "random_bits",
           "uniform", "bernoulli", "gumbel", "normal"]

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_F32_ONE_BITS = 0x3F800000
_TINY = float(np.finfo(np.float32).tiny)


def _rotl(x, r):
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(key, x1, x2):
    """Threefry-2x32 of the counter words ``(x1, x2)`` under ``key``.

    ``key`` is ``[..., 2]`` int64; ``x1``/``x2`` int64 words that
    broadcast against ``key[..., 0]``. Returns the two output words,
    int64 in [0, 2^32)."""
    k1, k2 = key[..., 0], key[..., 1]
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    dev = key.device.type
    threefry2x32.calls[dev] = threefry2x32.calls.get(dev, 0) + 1
    x1 = (x1 + ks[0]) & M32
    x2 = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & M32
            x2 = x1 ^ _rotl(x2, r)
        x1 = (x1 + ks[(i + 1) % 3]) & M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x1, x2


threefry2x32.calls = {}


def _words(data, device):
    """``data`` (ints, numpy or a tensor) as int64 words on ``device``:
    the uint32 conversion JAX applies (negative values wrap)."""
    if isinstance(data, torch.Tensor):
        return data.to(device=device, dtype=torch.int64) & M32
    return torch.as_tensor(np.asarray(data).astype(np.int64) & M32,
                           device=device)


def prng_key(seed, device=None):
    """``jax.random.PRNGKey(uint32(seed))`` for each seed: ``[..., 2]``
    int64 keys ``[0, seed]`` on ``device`` (default: the current
    context's, ``cuda:0``)."""
    s = _words(seed, resolve_device(device))
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def fold_in(key, data):
    """``jax.random.fold_in(key, data)`` row by row: ``data`` broadcasts
    against ``key[..., 0]``."""
    d = _words(data, key.device)
    y1, y2 = threefry2x32(key, torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def split(key, num=2):
    """``jax.random.split(key, num)`` of one ``[2]`` key: ``[num, 2]``
    int64 keys on the key's device."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    y1, y2 = threefry2x32(key, torch.zeros_like(i), i)
    return torch.stack([y1, y2], dim=-1)


def random_bits(key, n):
    """``jax.random.bits(key, (n,), uint32)`` for each key: ``[..., n]``
    int64 words in [0, 2^32)."""
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    y1, y2 = threefry2x32(key[..., None, :], torch.zeros_like(lo), lo)
    return y1 ^ y2


def uniform(key, n, minval=0.0, maxval=1.0):
    """``jax.random.uniform(key, (n,), float32, minval, maxval)`` for
    each key: ``[..., n]`` float32."""
    bits = random_bits(key, n)
    f = ((bits >> 9) | _F32_ONE_BITS).to(torch.int32).view(torch.float32)
    lo = torch.tensor(np.float32(minval), device=key.device)
    scale = torch.tensor(np.float32(maxval) - np.float32(minval),
                         device=key.device)
    return torch.maximum(lo, (f - 1.0) * scale + lo)


def bernoulli(key, p, shape):
    """``jax.random.bernoulli(key, p, shape)`` (mode "low", a float
    ``p``) of one ``[2]`` key: a bool tensor of ``shape``."""
    shape = tuple(int(d) for d in shape)
    u = uniform(key, int(np.prod(shape, dtype=np.int64)))
    return u.reshape(shape) < torch.tensor(np.float32(p), device=key.device)


def gumbel(key, n):
    """``jax.random.gumbel(key, (n,), float32)`` (mode "low") for each
    key: ``[..., n]`` float32."""
    u = uniform(key, n, minval=_TINY, maxval=1.0)
    return -torch.log(-torch.log(u))


_NORMAL_LO = np.nextafter(np.float32(-1.0), np.float32(0.0))
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                  -0.00367342844, 0.00573950773, -0.0076224613,
                  0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x):
    """XLA's float32 ``erf_inv`` of a float32 tensor."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    coef = [torch.where(lt, torch.tensor(np.float32(a), device=x.device),
                        torch.tensor(np.float32(b), device=x.device))
            for a, b in zip(_ERFINV_W_LT_5, _ERFINV_W_GE_5)]
    p = coef[0]
    for c in coef[1:]:
        p = c + p * w
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max,
                       p * x)


def normal(key, shape):
    """``jax.random.normal(key, shape, float32)`` of one ``[2]`` key: a
    float32 tensor of ``shape``, drawn over its row-major linear index."""
    shape = tuple(int(d) for d in shape)
    u = uniform(key, int(np.prod(shape, dtype=np.int64)),
                minval=_NORMAL_LO, maxval=1.0)
    return (np.float32(np.sqrt(2)) * erf_inv(u)).reshape(shape)
