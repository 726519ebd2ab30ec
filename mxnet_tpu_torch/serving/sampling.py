"""Sampling for the serving engine: greedy in this release.

Counterpart of ``mxnet_tpu/serving/sampling.py``.

- ``temperature == 0`` is exact greedy argmax over the raw f32 logits
  (first index on ties, as ``jnp.argmax`` and ``np.argmax``), on the
  card in :func:`sample_tokens` and on the host in :func:`host_sample`.
- A sampled draw keys its Gumbel noise with JAX's threefry ``fold_in``
  chain per (seed, position, salt); until those bits are ported (ROADMAP
  queue 1, the sampled path), a positive temperature raises
  ``NotImplementedError``.
- :func:`filter_dist` (temperature / top-k / top-p masking) is ported
  now in torch, op for op, for that sampled path.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["SALT_TARGET", "SAMPLED_NOT_PORTED", "filter_dist",
           "sample_tokens", "host_sample"]

SALT_TARGET = 0

SAMPLED_NOT_PORTED = (
    "sampled decoding (temperature > 0) needs JAX's threefry fold_in/"
    "gumbel bits, not ported yet: ROADMAP queue 1, the sampled path")

_NEG = -1e30  # effective -inf that survives arithmetic


def _filter_full(scaled, top_k, top_p):
    """The sort-based top-k/top-p masking (see filter_dist)."""
    V = scaled.shape[-1]
    neg = torch.full((), _NEG, dtype=scaled.dtype, device=scaled.device)
    k = torch.as_tensor(top_k, dtype=torch.int64, device=scaled.device)
    k = torch.where(k <= 0, torch.full_like(k, V), k)
    desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = torch.gather(desc, -1, torch.clamp(k[..., None] - 1, 0, V - 1))
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
    """The no-filtering path: plain softmax."""
    m = scaled.amax(dim=-1, keepdim=True)
    e = torch.exp(scaled - m) * (scaled > _NEG)
    return scaled, e / e.sum(dim=-1, keepdim=True)


def filter_dist(logits, temp, top_k, top_p):
    """Temperature/top-k/top-p filtering of ``[..., V]`` logits.

    ``temp`` / ``top_k`` / ``top_p`` broadcast over the leading axes
    (``top_k <= 0`` disables top-k, ``top_p >= 1`` keeps everything).
    Returns ``(masked, probs)``: filtered scaled f32 logits (disallowed
    entries at -1e30) and the renormalized distribution."""
    logits = logits.float()
    t = torch.as_tensor(temp, dtype=torch.float32, device=logits.device)
    scaled = logits / torch.clamp(t, min=1e-6)[..., None]
    tk = torch.as_tensor(top_k, device=logits.device)
    tp = torch.as_tensor(top_p, dtype=torch.float32, device=logits.device)
    if bool(((tk > 0) | (tp < 1.0)).any()):
        return _filter_full(scaled, top_k, top_p)
    return _filter_fast(scaled)


def sample_tokens(logits, temp, top_k, top_p, seed, pos, salt):
    """Sampler over ``[N, V]`` logits rows on the logits' device.

    Returns ``(tokens [N] int32, probs [N, V] f32)``: the greedy argmax
    and its one-hot "distribution". Raises NotImplementedError when a
    row asks for a sampled draw."""
    if bool((torch.as_tensor(temp) > 0).any()):
        raise NotImplementedError(SAMPLED_NOT_PORTED)
    greedy = torch.argmax(logits.float(), dim=-1)
    probs = torch.nn.functional.one_hot(
        greedy, logits.shape[-1]).to(torch.float32)
    return greedy.to(torch.int32), probs


def host_sample(logits, temperature, top_k, top_p, seed, pos,
                salt=SALT_TARGET):
    """Host sampler for ONE logits row (the context-parallel prefill's
    first token): exact greedy argmax at temperature 0."""
    if temperature > 0:
        raise NotImplementedError(SAMPLED_NOT_PORTED)
    if isinstance(logits, torch.Tensor):
        logits = logits.detach().float().cpu().numpy()
    return int(np.argmax(np.asarray(logits, np.float32).reshape(-1)))
