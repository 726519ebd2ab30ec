"""Ring attention at one device.

Counterpart of ``mxnet_tpu/parallel/ring_attention.py``. With a ring of
one device the K/V rotation (``ppermute``) has no partner, so the ring
loop is one block: :func:`_block_attn` against the local K/V merged into
f32 accumulators by :func:`_merge_block`, the same arithmetic the JAX
package runs per ring step.
"""
from __future__ import annotations

import math

import torch

__all__ = ["ring_attention", "make_ring_attention"]

_NEG = -1e30


def _block_attn(q, k, v, mask, scale):
    """One blockwise attention contribution with running-max
    bookkeeping, in the inputs' dtype. q: [B,H,Tq,D], k/v: [B,H,Tk,D];
    mask: [Tq,Tk] bool (True = keep). Returns (o, l, m)."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    neg = torch.full((), _NEG, dtype=scores.dtype, device=scores.device)
    scores = torch.where(mask[None, None], scores, neg)
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    # fully-masked rows: exp(neg - neg) = 1 would pollute; zero them
    row_any = mask.any(dim=-1)
    p = p * row_any[None, None, :, None].to(p.dtype)
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v)
    m = torch.where(row_any[None, None], m, neg)
    return o, l, m


def _merge_block(o_acc, l_acc, m_acc, o, l, m):
    """Merge one block's (o, l, m) into running accumulators with
    log-sum-exp rescaling. Shared by ring_attention and ulysses."""
    new_m = torch.maximum(m_acc, m)
    alpha = torch.exp(m_acc - new_m)
    beta = torch.exp(m - new_m)
    return (o_acc * alpha[..., None] + o * beta[..., None],
            l_acc * alpha + l * beta,
            new_m)


def ring_attention(q, k, v, causal=True, scale=None, q_offset=0):
    """Ring attention over a ring of one: q [B,H,Tq,D], k/v [B,H,Tk,D];
    query i sits at key position ``q_offset + i`` for causal masking
    (the chunked-prefill geometry). Returns [B,H,Tq,D] in q's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    tq, tk = q.shape[2], k.shape[2]
    acc = torch.float32
    dev = q.device
    o_acc = torch.zeros(q.shape[:3] + (v.shape[-1],), dtype=acc, device=dev)
    l_acc = torch.zeros(q.shape[:3], dtype=acc, device=dev)
    m_acc = torch.full(q.shape[:3], _NEG, dtype=acc, device=dev)
    if causal:
        iq = torch.arange(tq, device=dev)[:, None] + q_offset
        ik = torch.arange(tk, device=dev)[None, :]
        mask = ik <= iq
    else:
        mask = torch.ones((tq, tk), dtype=torch.bool, device=dev)
    o, l, m = _block_attn(q, k, v, mask, scale)
    o_acc, l_acc, m_acc = _merge_block(o_acc, l_acc, m_acc, o.to(acc),
                                       l.to(acc), m.to(acc))
    out = o_acc / torch.clamp(l_acc, min=1e-30)[..., None]
    return out.to(q.dtype)


def make_ring_attention(mesh, seq_axis="seq", causal=True, q_offset=0):
    """Factory with the JAX package's contract: returns ``f(q, k, v)``
    over global ``[B, H, T, D]`` tensors sequence-sharded on
    ``seq_axis`` of ``mesh`` (one device here)."""
    if mesh.shape[seq_axis] != 1:
        raise NotImplementedError("ring attention over more than one "
                                  "device: ROADMAP queue 1")

    def f(q, k, v):
        return ring_attention(q, k, v, causal=causal, q_offset=q_offset)

    return f
