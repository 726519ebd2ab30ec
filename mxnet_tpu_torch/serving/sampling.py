"""Sampling for the serving engine: greedy and sampled draws.

Counterpart of ``mxnet_tpu/serving/sampling.py``. The same sampler
drives plain decode, the final prefill chunk's first token, the draft
model's proposals, and the speculative verify's accept/reject and
rejection resampling (``model.py``).

Determinism contract, as in the JAX package:

- every random draw is keyed by ``(request seed, global token
  position, salt)`` through ``fold_in`` chains of JAX's threefry, ported
  bit for bit in :mod:`mxnet_tpu_torch.threefry`, so a request replayed
  after eviction or re-chunked draws the same samples at the same
  positions, and the port's streams equal the JAX package's;
- ``temperature == 0`` is exact greedy argmax over the RAW f32 logits
  (first index on ties, as ``jnp.argmax``), with no filtering;
- a sampled row is the Gumbel-max over the filtered logits
  (:func:`filter_dist`): ``argmax(masked + gumbel(key))``.

The draws run on the logits' device. The per-row parameters
(temperature, top-k, top-p) are host arrays, so the branches the JAX
package takes with ``lax.cond`` are decided on the host without a
device round trip: a batch with no sampled row makes no threefry draw
and no filtering, and a batch with no filtering row skips the sorts.

Salt layout (one stream per random purpose at each position)::

    SALT_TARGET   the token a plain decode at this position draws (also
                  the speculative bonus draw);
    SALT_ACCEPT   the accept/reject uniform judging a draft token;
    SALT_DRAFT    the draft model's proposal draw;
    SALT_RESIDUAL the rejection-resampling draw from max(p - q, 0).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import threefry as _tf

__all__ = ["SALT_TARGET", "SALT_ACCEPT", "SALT_DRAFT", "SALT_RESIDUAL",
           "filter_dist", "fold_keys", "sample_tokens", "host_key",
           "host_sample"]

SALT_TARGET = 0
SALT_ACCEPT = 1
SALT_DRAFT = 2
SALT_RESIDUAL = 3

_NEG = -1e30  # effective -inf that survives arithmetic


def _host(a, dtype):
    """A per-row parameter as a host numpy array (tensors are copied
    back; the engine always passes numpy)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


def _filter_full(scaled, top_k, top_p):
    """The sort-based top-k/top-p masking (see filter_dist)."""
    V = scaled.shape[-1]
    neg = torch.full((), _NEG, dtype=scaled.dtype, device=scaled.device)
    k = torch.as_tensor(top_k, dtype=torch.int64, device=scaled.device)
    k = torch.where(k <= 0, torch.full_like(k, V), k)
    k = torch.broadcast_to(k[..., None], scaled.shape[:-1] + (1,))
    desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = torch.gather(desc, -1, torch.clamp(k - 1, 0, V - 1))
    masked = torch.where(scaled < kth, neg, scaled)
    m = masked.amax(dim=-1, keepdim=True)
    e = torch.exp(masked - m) * (masked > _NEG)
    probs = e / e.sum(dim=-1, keepdim=True)
    order = torch.argsort(-probs, dim=-1, stable=True)
    sp = torch.gather(probs, -1, order)
    before = torch.cumsum(sp, dim=-1) - sp
    tp = torch.as_tensor(top_p, dtype=torch.float32, device=scaled.device)
    keep_sorted = before < tp[..., None]
    inv = torch.argsort(order, dim=-1, stable=True)
    keep = torch.gather(keep_sorted, -1, inv)
    masked = torch.where(keep, masked, neg)
    e2 = torch.exp(masked - masked.amax(dim=-1, keepdim=True)) \
        * (masked > _NEG)
    probs = e2 / e2.sum(dim=-1, keepdim=True)
    return masked, probs


def _filter_fast(scaled):
    """The no-filtering path: plain softmax (the same arithmetic as the
    full path when every token is kept)."""
    m = scaled.amax(dim=-1, keepdim=True)
    e = torch.exp(scaled - m) * (scaled > _NEG)
    return scaled, e / e.sum(dim=-1, keepdim=True)


def filter_dist(logits, temp, top_k, top_p):
    """Temperature/top-k/top-p filtering of ``[..., V]`` logits.

    ``temp`` / ``top_k`` / ``top_p`` broadcast over the leading axes
    (``top_k <= 0`` disables top-k, ``top_p >= 1`` keeps everything);
    they are host values, so the choice of the sort-free path when no
    row filters costs no device round trip. Returns ``(masked,
    probs)``: filtered scaled f32 logits (disallowed entries at -1e30)
    and the renormalized distribution."""
    logits = logits.float()
    temp, top_k, top_p = (_host(temp, np.float32), _host(top_k, np.int64),
                          _host(top_p, np.float32))
    t = torch.as_tensor(temp, device=logits.device)
    scaled = logits / torch.clamp(t, min=1e-6)[..., None]
    if np.any((top_k > 0) | (top_p < 1.0)):
        return _filter_full(scaled, top_k, top_p)
    return _filter_fast(scaled)


def fold_keys(seed, pos, salt, device=None):
    """Per-row threefry keys ``fold_in(fold_in(PRNGKey(seed), pos),
    salt)`` over matching ``[N]`` seed/pos (numpy or tensors; ``salt``
    an int or ``[N]``) as ``[N, 2]`` int64 on ``device``: by default
    ``pos``'s device when ``pos`` is a tensor, else the current
    context's (``cuda:0``). One call derives any number of keys in the
    same two hash passes, so a caller derives all of a turn's keys at
    once."""
    if device is None and isinstance(pos, torch.Tensor):
        device = pos.device
    key = _tf.prng_key(seed, device)
    return _tf.fold_in(_tf.fold_in(key, pos), salt)


def _one_hot(idx, V):
    return torch.nn.functional.one_hot(idx, V).to(torch.float32)


def sample_tokens(logits, temp, top_k, top_p, seed, pos, salt, keys=None):
    """Sampler over ``[N, V]`` logits rows on the logits' device.

    ``temp``/``top_k``/``top_p``/``seed`` are per-row host arrays;
    ``pos`` the rows' global positions (host or on the device).
    ``keys`` ([N, 2], optional) are the rows' :func:`fold_keys` of
    (seed, pos, salt), derived ahead by a caller that batches a turn's
    keys. Returns ``(tokens [N] int32, probs [N, V] f32)``: ``probs`` is
    the distribution the token was drawn from, one-hot at the argmax
    for ``temp == 0`` rows (what speculative rejection needs for
    ``q``). A batch with no sampled row makes no threefry draw."""
    logits = logits.float()
    V = logits.shape[-1]
    greedy = torch.argmax(logits, dim=-1)
    is_sampled = _host(temp, np.float32) > 0
    if not is_sampled.any():
        return greedy.to(torch.int32), _one_hot(greedy, V)
    masked, probs = filter_dist(logits, temp, top_k, top_p)
    if keys is None:
        keys = fold_keys(seed, pos, salt, logits.device)
    sampled = torch.argmax(masked + _tf.gumbel(keys, V), dim=-1)
    rows = torch.as_tensor(is_sampled, device=logits.device)
    tok = torch.where(rows, sampled, greedy).to(torch.int32)
    probs = torch.where(rows[:, None], probs, _one_hot(greedy, V))
    return tok, probs


def host_key(seed, pos, salt):
    """The ``[2]`` key of one (seed, position, salt) on the host: the
    chain :func:`fold_keys` builds for a row. Kept, with
    :func:`host_sample`, for parity with the JAX package's API."""
    return fold_keys(np.asarray([seed]), np.asarray([pos]), salt, "cpu")[0]


def host_sample(logits, temperature, top_k, top_p, seed, pos,
                salt=SALT_TARGET):
    """One logits row (numpy or a tensor) sampled on the host:
    :func:`sample_tokens` over that row on the CPU. Kept for parity
    with the JAX package's API; the engine samples on the device."""
    if isinstance(logits, torch.Tensor):
        logits = logits.detach().float().cpu().numpy()
    row = torch.from_numpy(np.asarray(logits, np.float32).reshape(1, -1))
    tok, _ = sample_tokens(row, [temperature], [top_k], [top_p], [seed],
                           np.asarray([pos]), salt)
    return int(tok[0])
