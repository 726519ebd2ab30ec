"""Ulysses (all-to-all) sequence parallelism at one device.

Counterpart of ``mxnet_tpu/parallel/ulysses.py``. With one device on the
sequence axis both all-to-alls (sequence -> heads and back) are
identities, and what remains is the local attention with the JAX
package's gate: when the queries start at key 0 (``q_offset == 0``),
cover as many positions as the keys and :func:`flash_kernel_usable`
holds, it is :func:`flash_attention` (the Hopper kernel on CUDA
tensors); otherwise the blockwise ``_block_attn``/``_merge_block`` loop
over key chunks.
"""
from __future__ import annotations

import math

import torch

from ..ops import flash_attention as _fa  # the module
from .ring_attention import _block_attn, _merge_block

__all__ = ["ulysses_attention", "make_ulysses_attention"]


def ulysses_attention(q, k, v, causal=True, scale=None, q_offset=0,
                      axis_size=1):
    """q [B,H,Tq,D], k/v [B,H,Tk,D] on one device; ``q_offset`` is the
    queries' absolute start in the key sequence (chunked prefill).
    Returns [B,H,Tq,D] in q's dtype."""
    b, h, t_local, d = q.shape
    tk_local = k.shape[2]
    if h % axis_size != 0:
        raise ValueError("ulysses: heads (%d) must divide by mesh axis "
                         "size (%d)" % (h, axis_size))
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    ql, kl, vl = q, k, v     # the all-to-alls of a one-device axis
    t_global, tk_global = ql.shape[2], kl.shape[2]
    if (q_offset == 0 and t_global == tk_global
            and _fa.flash_kernel_usable(t_global, tk_global, d,
                                        vl.shape[-1])):
        out = _fa.flash_attention(ql, kl, vl, causal=causal, scale=scale)
        return out.to(q.dtype)
    # fallback: blockwise over key chunks with the flash-style LSE
    # accumulation — peak memory O(T_global * chunk) scores
    chunk = tk_local
    acc = torch.float32
    dev = q.device
    iq = torch.arange(t_global, device=dev)[:, None] + q_offset
    o_acc = torch.zeros(ql.shape[:3] + (vl.shape[-1],), dtype=acc,
                        device=dev)
    l_acc = torch.zeros(ql.shape[:3], dtype=acc, device=dev)
    m_acc = torch.full(ql.shape[:3], -1e30, dtype=acc, device=dev)
    for c in range(tk_global // chunk):
        kc = kl[:, :, c * chunk:(c + 1) * chunk]
        vc = vl[:, :, c * chunk:(c + 1) * chunk]
        if causal:
            ik = c * chunk + torch.arange(chunk, device=dev)[None, :]
            mask = ik <= iq
        else:
            mask = torch.ones((t_global, chunk), dtype=torch.bool,
                              device=dev)
        o, l, m = _block_attn(ql, kc, vc, mask, scale)
        o_acc, l_acc, m_acc = _merge_block(o_acc, l_acc, m_acc, o.to(acc),
                                           l.to(acc), m.to(acc))
    out = o_acc / torch.clamp(l_acc, min=1e-30)[..., None]
    return out.to(q.dtype)


def make_ulysses_attention(mesh, seq_axis="seq", causal=True, q_offset=0):
    """Factory with the JAX package's contract: returns ``f(q, k, v)``
    over global ``[B, H, T, D]`` tensors sequence-sharded on
    ``seq_axis`` of ``mesh`` (one device here)."""
    n = mesh.shape[seq_axis]
    if n != 1:
        raise NotImplementedError("Ulysses over more than one device: "
                                  "ROADMAP queue 1")

    def apply(q, k, v):
        return ulysses_attention(q, k, v, causal=causal, q_offset=q_offset,
                                 axis_size=n)

    return apply
