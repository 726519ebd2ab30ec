"""Decode-model adapter: bucketed ragged batches over a paged KV pool.

Counterpart of ``mxnet_tpu/serving/model.py``. One step function covers
both phases:

- **prefill chunk**: ``C`` prompt tokens per request enter at arbitrary
  start offsets, attend causally to their own chunk plus everything the
  request already has in the paged pool, and write their K/V into the
  pool blocks named by the request's block table;
- **decode**: the same function at ``C == 1``.

Ragged batches keep the JAX package's **fixed bucketed shapes** (batch
rows pad to the next batch bucket, chunk lengths to the next chunk
bucket, the block-table width is fixed), so both packages run the same
shapes. PyTorch runs eagerly, so a bucket costs no compile here. Padded
lanes redirect their K/V writes to the pool's scratch block 0 and are
masked out of attention reads.

Numerical contract: a token decoded through the paged path produces the
logits ``transformer.forward`` would at that position, and greedy decode
is exact argmax, so greedy streams match the JAX package token for
token.

Long-context prefill on a mesh reuses the context-parallel attention of
``parallel/ring_attention.py`` / ``parallel/ulysses.py``: see
:func:`cp_prefill_kv`. Speculative ``draft_turn``/``verify`` come with
the spec slice (ROADMAP queue 1).
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.transformer import TransformerConfig, _gelu, _layer_norm
from . import sampling as _samp

__all__ = ["ServingModel", "bucket_for", "cp_prefill_kv"]


def bucket_for(n, buckets):
    """Smallest bucket >= n (buckets sorted ascending); raises when n
    exceeds every bucket."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError("no bucket fits %d (buckets %s)" % (n, list(buckets)))


class ServingModel:
    """Paged-attention step over transformer params.

    Parameters
    ----------
    cfg : TransformerConfig
    block_size : int
        Paged-pool tokens per block.
    max_blocks_per_req : int
        Block-table width ``W``; a request spans at most ``W *
        block_size`` tokens.
    batch_buckets, chunk_buckets : tuple of int
        Padded batch sizes / chunk lengths (ascending). Decode uses
        chunk 1.
    """

    def __init__(self, cfg: TransformerConfig, block_size,
                 max_blocks_per_req, batch_buckets=(1, 2, 4, 8),
                 chunk_buckets=(32, 64, 128)):
        self.cfg = cfg
        self.block_size = int(block_size)
        self.max_blocks = int(max_blocks_per_req)
        self.batch_buckets = tuple(sorted(set(int(b) for b in batch_buckets)))
        self.chunk_buckets = tuple(sorted(set(int(c) for c in chunk_buckets)))

    # -- the transformer body ------------------------------------------------
    def _body(self, params, kpool, vpool, tokens, start, chunk_len,
              block_tables, active):
        """One forward over ``C`` new tokens per request.

        tokens [B, C] int64, start [B] (global position of tokens[:, 0]),
        chunk_len [B] (real tokens this chunk, 0 for padded rows),
        block_tables [B, W], active [B] bool, all on the pool's device.
        Writes the chunk's K/V into the pools in place and returns x
        [B, C, d_model], the post-ln_f hidden states.
        """
        cfg = self.cfg
        B, C = tokens.shape
        W, bs = self.max_blocks, self.block_size
        S = W * bs
        H, D = cfg.num_heads, cfg.head_dim
        scale = 1.0 / float(D) ** 0.5
        dev = kpool.device

        ar = torch.arange(C, device=dev)
        pos = start[:, None] + ar[None, :]                       # [B, C]
        in_chunk = ar[None, :] < chunk_len[:, None]              # [B, C]
        valid = in_chunk & active[:, None]
        # pos_embed rows are clipped for padded lanes (jnp.take clips,
        # torch indexing would raise); their outputs are never read back
        x = params["embed"][tokens]
        x = x + params["pos_embed"][
            torch.clamp(pos, max=cfg.max_seq_len - 1)].to(x.dtype)

        # K/V write coordinates: padded / inactive lanes redirect to the
        # scratch block 0 (kv_cache.py module docstring)
        blk_idx = torch.clamp(pos // bs, 0, W - 1)
        table_blk = torch.gather(block_tables, 1, blk_idx)
        zero = torch.zeros((), dtype=table_blk.dtype, device=dev)
        write_blk = torch.where(valid, table_blk, zero)
        write_slot = torch.where(valid, pos % bs, zero)

        # slot (w, i) of a request's table holds its token w*bs + i; the
        # pool keys visible to a chunk are those before its first token,
        # and the chunk attends to itself causally
        key_pos = torch.arange(S, device=dev)
        pool_mask = (key_pos[None, None, :]
                     < start[:, None, None]).expand(B, C, S)
        chunk_mask = ((ar[None, :, None] >= ar[None, None, :])
                      & in_chunk[:, None, :]).expand(B, C, C)
        full_mask = torch.cat([pool_mask, chunk_mask], dim=2)[:, None]
        row_any = full_mask.any(dim=-1, keepdim=True)
        neg = torch.full((), -1e30, dtype=torch.float32, device=dev)

        for li, lp in enumerate(params["layers"]):
            h = _layer_norm(x, lp["ln1"])
            q, k, v = (h @ lp["wqkv"]).chunk(3, dim=-1)
            k = k.reshape(B, C, H, D)
            v = v.reshape(B, C, H, D)
            # scatter this chunk's K/V into the pool in place; duplicate
            # padded-lane writes all land in scratch (block 0, slot 0)
            kpool[li, write_blk, write_slot] = k.to(kpool.dtype)
            vpool[li, write_blk, write_slot] = v.to(vpool.dtype)
            # gather the requests' paged history [B, S, H, D]
            k_hist = kpool[li][block_tables].reshape(B, S, H, D)
            v_hist = vpool[li][block_tables].reshape(B, S, H, D)
            k_all = torch.cat([k_hist.to(k.dtype), k], dim=1)
            v_all = torch.cat([v_hist.to(v.dtype), v], dim=1)

            qh = q.reshape(B, C, H, D)
            scores = torch.einsum("bchd,bshd->bhcs", qh, k_all) * scale
            scores = torch.where(full_mask, scores.float(), neg)
            m = scores.amax(dim=-1, keepdim=True)
            p = torch.exp(scores - m)
            # fully masked (padded) rows would be uniform, not zero
            p = p * row_any.to(p.dtype)
            l = p.sum(dim=-1, keepdim=True)
            p = p / torch.clamp(l, min=1e-30)
            o = torch.einsum("bhcs,bshd->bchd", p.to(v_all.dtype), v_all)
            x = x + o.reshape(B, C, H * D) @ lp["wo"]
            h = _layer_norm(x, lp["ln2"])
            x = x + _gelu(h @ lp["w1"]) @ lp["w2"]

        return _layer_norm(x, params["ln_f"])

    def _last_logits(self, params, x, chunk_len):
        """Logits at each row's last real chunk position. [B, V] f32."""
        C = x.shape[1]
        last = torch.clamp(chunk_len - 1, 0, C - 1)
        x_last = x[torch.arange(x.shape[0], device=x.device), last]
        return (x_last @ params["embed"].T).float()

    # -- host-facing API -----------------------------------------------------
    def step(self, params, kpool, vpool, tokens, start, chunk_len,
             block_tables, active, min_batch_bucket=None):
        """Run one bucketed step over host-side (numpy) batch inputs.

        ``tokens`` is [B, C_real<=bucket] padded per row by the caller
        via ``chunk_len``; batch and chunk pad to their buckets and the
        result is sliced back. ``min_batch_bucket`` forces at least that
        batch bucket (the static-batching baseline). Decoding is greedy
        (the sampled path is not ported yet).

        Returns next_token [B_real] int32 numpy; the chunk's K/V are
        written into ``kpool``/``vpool`` in place.
        """
        B_real, C_real = tokens.shape
        B = bucket_for(max(B_real, min_batch_bucket or 1),
                       self.batch_buckets)
        C = 1 if C_real == 1 else bucket_for(C_real, self.chunk_buckets)

        def padb(a):
            a = np.asarray(a)
            if a.shape[0] == B:
                return a
            pad = np.zeros((B - a.shape[0],) + a.shape[1:], a.dtype)
            return np.concatenate([a, pad], axis=0)

        tok = np.zeros((B, C), np.int64)
        tok[:B_real, :C_real] = tokens
        bt = np.zeros((B, self.max_blocks), np.int64)
        bt[:B_real] = block_tables
        act = np.zeros((B,), bool)
        act[:B_real] = active
        dev = kpool.device

        def t(a, dtype=torch.int64):
            return torch.as_tensor(np.asarray(a), device=dev).to(dtype)

        clen = t(padb(chunk_len))
        with torch.no_grad():
            x = self._body(params, kpool, vpool, t(tok), t(padb(start)), clen,
                           t(bt), t(act, torch.bool))
            logits = self._last_logits(params, x, clen)
            nxt, _ = _samp.sample_tokens(logits, np.zeros((B,), np.float32),
                                         0, 1.0, 0, None, _samp.SALT_TARGET)
        # the step's one device->host pull: the token vector
        return nxt.cpu().numpy()[:B_real]


def cp_prefill_kv(params, cfg, tokens, mesh, kind="ring", chunk=None,
                  seq_axis="seq"):
    """Context-parallel chunked prefill: per-layer K/V for one long
    prompt, computed over ``mesh`` with ring or Ulysses attention.

    A ``chunk``-token slice of activations exists at a time, and each
    chunk's queries attend to the full accumulated prefix through the
    sequence-parallel attention's ``q_offset`` form. The chunk length
    must divide by the mesh axis size and T by the chunk.

    tokens: [T] or [1, T] ints. Returns (k [L, T, H, D] f32, v likewise,
    x_last [d_model] f32 final-position hidden state) as tensors on the
    params' device: the K/V accumulate in f32 and are cast back to the
    model dtype before attending, as in the JAX package, but stay on
    the card instead of a host round trip (exact either way).
    """
    from ..parallel.ring_attention import make_ring_attention
    from ..parallel.ulysses import make_ulysses_attention

    tokens = np.asarray(tokens, np.int64).reshape(1, -1)
    T = tokens.shape[1]
    n = mesh.shape[seq_axis]
    if chunk is None:
        chunk = T
    if chunk % n or T % chunk:
        raise ValueError(
            "cp prefill: chunk %d must divide by mesh axis %d and T %d "
            "by chunk" % (chunk, n, T))
    H, D = cfg.num_heads, cfg.head_dim
    L = cfg.num_layers
    factory = {"ring": make_ring_attention,
               "ulysses": make_ulysses_attention}[kind]
    dev = params["embed"].device
    tok = torch.as_tensor(tokens, device=dev)

    k_out = torch.zeros((L, T, H, D), dtype=torch.float32, device=dev)
    v_out = torch.zeros((L, T, H, D), dtype=torch.float32, device=dev)
    x_last = None

    def heads(t):
        return t.reshape(1, t.shape[1], H, D).transpose(1, 2)

    with torch.no_grad():
        for c0 in range(0, T, chunk):
            c1 = c0 + chunk
            x = params["embed"][tok[:, c0:c1]]
            x = x + params["pos_embed"][c0:c1][None].to(x.dtype)
            attn = factory(mesh, seq_axis=seq_axis, causal=True,
                           q_offset=c0)
            for li, lp in enumerate(params["layers"]):
                h = _layer_norm(x, lp["ln1"])
                q, k, v = (h @ lp["wqkv"]).chunk(3, dim=-1)
                k_out[li, c0:c1] = k.reshape(chunk, H, D).float()
                v_out[li, c0:c1] = v.reshape(chunk, H, D).float()
                k_full = k_out[li, :c1][None].to(x.dtype)
                v_full = v_out[li, :c1][None].to(x.dtype)
                o = attn(heads(q), k_full.transpose(1, 2),
                         v_full.transpose(1, 2))
                o = o.transpose(1, 2).reshape(1, chunk, H * D)
                x = x + o @ lp["wo"]
                h = _layer_norm(x, lp["ln2"])
                x = x + _gelu(h @ lp["w1"]) @ lp["w2"]
            x_last = _layer_norm(x, params["ln_f"])[0, -1].float()
    return k_out, v_out, x_last
