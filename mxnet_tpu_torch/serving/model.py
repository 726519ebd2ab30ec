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

Three entry points share the transformer body, as the JAX package's
three program kinds do:

- :meth:`ServingModel.step`: prefill/decode with the sampler
  (:mod:`.sampling`) on the device; the one device->host pull is the
  ``[B]`` token vector;
- :meth:`ServingModel.draft_turn`: the draft model ingests the 1-2
  stream tokens its pool lacks and chains ``K`` proposals, sampled
  token and filtered distribution ``q`` each, all kept on the device;
- :meth:`ServingModel.verify`: the speculative verify, target logits at
  all ``K+1`` chunk positions, accept/reject against the proposals and
  the residual or bonus draw. A ``chunk_len == 1`` row is plain sampled
  decode.

Numerical contract: a token decoded through the paged path produces the
logits ``transformer.forward`` would at that position, greedy decode is
exact argmax, and every sampled draw takes JAX's threefry bits keyed by
(seed, position, salt), so greedy streams, spec or not, and sampled
streams match the JAX package token for token.

Long-context prefill on a mesh reuses the context-parallel attention of
``parallel/ring_attention.py`` / ``parallel/ulysses.py``: see
:func:`cp_prefill_kv`.

mxprof (``MXNET_PROF=1``, ``mxnet_tpu/serving/model.py:415-513``): each
bucket's program is attributed on its first call (``telemetry/prof.py``:
the step's matmul FLOPs at its bucket shape, 2 x parameters x tokens;
attention's score products, which depend on each row's context, are
left out), and every later :meth:`ServingModel.step` lands a
``serve.prefill``/``serve.decode`` step breakdown (host staging,
dispatch, the wait on the card, the token pull) with its ``d2h_bytes``.

Under ``MXNET_JIT_VERIFY`` (``analysis/compile_verify.py``) each bucket's
program is a verifier boundary, memoized by ``(kind, *bucket)`` as the
JAX package memoizes its jitted programs and with its names
(``serve.step|B|C``, ``serve.draft_turn|B|C|K``, ``serve.verify|B|K``,
budget 1 each) and group budgets (``serve.step`` and
``serve.draft_turn``: batch buckets x (chunk buckets + 1);
``serve.verify``: batch buckets); :meth:`ServingModel.step` accounts its
token-vector pull in the D2H ledger.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import threefry as _tf
from ..analysis import compile_verify as _cv
from ..telemetry import prof as _prof
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
        self._prof_keys = {}
        self._programs = {}  # (kind, *bucket) -> the program (a boundary)
        # bucket-derived compile budgets: decode (C=1) plus one program
        # per (batch, chunk) bucket pair; draft_turn/verify budgets are
        # per (batch, K) but K is static per engine — bound by batches
        n_bc = len(self.batch_buckets) * (len(self.chunk_buckets) + 1)
        _cv.declare_budget("serve.step", n_bc)
        _cv.declare_budget("serve.draft_turn", n_bc)
        _cv.declare_budget("serve.verify", len(self.batch_buckets))

    def _step_flops(self, tokens):
        """Matmul FLOPs of the layers over ``tokens`` (padded) positions:
        the q/k/v/o and MLP products, 2 FLOPs a weight a token (the
        callers add the unembedding of the positions that sample)."""
        c = self.cfg
        d = c.d_model
        per_token = c.num_layers * 2 * (4 * d * d + 2 * d * c.d_ff)
        return tokens * per_token

    def _attribute(self, key, fn, meta):
        """mxprof: record this bucket's program on its first call;
        returns True when the attribution happened now."""
        if not _prof.ENABLED or key in self._prof_keys:
            return False
        kind = key[0]
        name = "serve.%s|%s" % (kind, "|".join(str(k) for k in key[1:]))
        # graph identity: the program kind, the full model geometry and
        # the paged-pool layout
        ghash = _prof.graph_hash("%s|%r|bs=%d|W=%d" % (
            kind, self.cfg, self.block_size, self.max_blocks))
        unembed = 2 * self.cfg.d_model * self.cfg.vocab_size
        B = key[1]
        if kind == "step":
            flops = self._step_flops(B * key[2]) + B * unembed
        elif kind == "draft_turn":
            C, K = key[2], key[3]
            flops = (self._step_flops(B * C + B * (K - 1))
                     + B * K * unembed)
        else:   # verify over K + 1 positions a row
            flops = (self._step_flops(B * (key[2] + 1))
                     + B * (key[2] + 1) * unembed)
        _prof.attribute_program(name, fn, site="serving.%s" % kind,
                                meta=meta, graph_key=ghash, flops=flops)
        self._prof_keys[key] = _prof.program_key_for(name, graph_key=ghash)
        return True

    _KIND_IMPLS = {"step": "_sample_step", "draft_turn": "_draft_turn_impl",
                   "verify": "_verify"}

    def _compiled(self, key):
        """key = (kind, *bucket): the program of that kind at that
        bucket, memoized — a verifier boundary under MXNET_JIT_VERIFY
        (one "compile" per memo entry: the key IS the bucket, and a
        second signature behind the same key is a broken contract the
        verifier names by arg-diff)."""
        fn = self._programs.get(key)
        if fn is None:
            fn = getattr(self, self._KIND_IMPLS[key[0]])
            fn = _cv.wrap("serve.%s|%s" % (key[0], "|".join(
                str(k) for k in key[1:])), fn, budget=1,
                group="serve.%s" % key[0])
            self._programs[key] = fn
        return fn

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

    def _sample_step(self, params, kpool, vpool, tokens, start, chunk_len,
                     block_tables, active, samp, salt, keys=None):
        """Body + last-position logits + sampler for one bucketed batch
        (device tensors in, device tensors out): the sampled token for
        global position ``start + chunk_len`` of every row, and the
        distribution it was drawn from. ``keys``: the rows' draw keys,
        when the caller derived them ahead."""
        x = self._body(params, kpool, vpool, tokens, start, chunk_len,
                       block_tables, active)
        logits = self._last_logits(params, x, chunk_len)
        return _samp.sample_tokens(logits, *samp, start + chunk_len, salt,
                                   keys)

    # -- host-facing API -----------------------------------------------------
    @staticmethod
    def _sampling_arrays(B, B_real, temperature, top_k, top_p, seed):
        """Per-request sampling params padded to the batch bucket as
        host arrays (padded rows greedy with seed 0: their draws are
        never read)."""
        def pad(vals, dtype, default):
            a = np.full((B,), default, dtype)
            if vals is not None:
                a[:B_real] = np.asarray(vals, dtype)
            return a

        return (pad(temperature, np.float32, 0.0),
                pad(top_k, np.int32, 0),
                pad(top_p, np.float32, 1.0),
                pad(seed, np.uint32, 0))

    def _batch(self, B, dev, start, chunk_len, block_tables, active):
        """Host batch inputs padded to bucket ``B`` as int64/bool
        tensors on ``dev``: (start, chunk_len, block_tables, active)."""
        def padb(a):
            a = np.asarray(a)
            if a.shape[0] == B:
                return a
            pad = np.zeros((B - a.shape[0],) + a.shape[1:], a.dtype)
            return np.concatenate([a, pad], axis=0)

        bt = np.zeros((B, self.max_blocks), np.int64)
        bt[:len(block_tables)] = block_tables
        act = np.zeros((B,), bool)
        act[:len(active)] = active
        return (_tensor(padb(start), dev), _tensor(padb(chunk_len), dev),
                _tensor(bt, dev), _tensor(act, dev, torch.bool))

    def _tokens(self, tokens, B, C, dev):
        tok = np.zeros((B, C), np.int64)
        tok[:tokens.shape[0], :tokens.shape[1]] = tokens
        return _tensor(tok, dev)

    def step(self, params, kpool, vpool, tokens, start, chunk_len,
             block_tables, active, min_batch_bucket=None, temperature=None,
             top_k=None, top_p=None, seed=None):
        """Run one bucketed step over host-side (numpy) batch inputs.

        ``tokens`` is [B, C_real<=bucket] padded per row by the caller
        via ``chunk_len``; batch and chunk pad to their buckets and the
        result is sliced back. ``min_batch_bucket`` forces at least that
        batch bucket (the static-batching baseline). Sampling params
        default to greedy (temperature 0).

        Returns next_token [B_real] int32 numpy; the chunk's K/V are
        written into ``kpool``/``vpool`` in place.
        """
        tokens = np.asarray(tokens)
        B_real, C_real = tokens.shape
        B = bucket_for(max(B_real, min_batch_bucket or 1),
                       self.batch_buckets)
        C = 1 if C_real == 1 else bucket_for(C_real, self.chunk_buckets)
        dev = kpool.device
        prof_on = _prof.ENABLED
        t0 = time.monotonic() if prof_on else 0.0
        samp = self._sampling_arrays(B, B_real, temperature, top_k, top_p,
                                     seed)
        tok_t = self._tokens(tokens, B, C, dev)
        batch = self._batch(B, dev, start, chunk_len, block_tables, active)
        attributed_now = prof_on and self._attribute(
            ("step", B, C), self._sample_step,
            meta={"batch_bucket": B, "chunk_bucket": C})
        t1 = time.monotonic() if prof_on else 0.0
        fn = self._compiled(("step", B, C))
        with torch.no_grad():
            nxt, _ = fn(params, kpool, vpool, tok_t, *batch, samp,
                        _samp.SALT_TARGET)
        if prof_on:
            t2 = time.monotonic()
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
            t3 = time.monotonic()
        # the step's one device->host pull: the token vector
        host_nxt = nxt.cpu().numpy()
        _cv.note_d2h(host_nxt.nbytes,
                     "mxnet_tpu_torch/serving/model.py::ServingModel.step")
        out_tok = host_nxt[:B_real]
        if prof_on and not attributed_now:
            # the bucket's first step is left out: its allocations and
            # kernel selection would drown the steady-state shares
            _prof.note_step(
                "serve.decode" if C == 1 else "serve.prefill",
                {"host": t1 - t0, "dispatch": t2 - t1,
                 "device": t3 - t2, "d2h": time.monotonic() - t3},
                key=self._prof_keys.get(("step", B, C)),
                tokens=int(np.sum(np.asarray(chunk_len)[:B_real])),
                d2h_bytes=int(nxt.element_size() * B_real))
        return out_tok

    def draft_turn(self, params, kpool, vpool, tokens, start, chunk_len,
                   block_tables, active, ks, K, temperature=None,
                   top_k=None, top_p=None, seed=None):
        """The whole draft phase: ingest the catch-up chunk (``tokens``
        [B_real, Cin], ``chunk_len`` real tokens a row: the 1-2 stream
        tokens the draft pool lacks) and chain ``K`` proposals, each
        feeding the previous sample back in. The K-1 follow-ups are a
        loop over the single-token body; no proposal visits the host.
        ``ks`` [B_real] is the per-row draft budget: rows past theirs go
        inactive (their writes land in scratch, their proposals are
        masked later by the verify's chunk_len). A sampled turn derives
        the K proposals' keys in one :func:`~.sampling.fold_keys` call.

        Returns (draft [B_real, K] int32, qdists [B_real, K, V] f32),
        both on the pools' device.
        """
        tokens = np.asarray(tokens)
        B_real, C_real = tokens.shape
        B = bucket_for(B_real, self.batch_buckets)
        C = 1 if C_real == 1 else bucket_for(C_real, self.chunk_buckets)
        dev = kpool.device
        samp = self._sampling_arrays(B, B_real, temperature, top_k, top_p,
                                     seed)
        start, clen, bt, act = self._batch(B, dev, start, chunk_len,
                                           block_tables, active)
        ks = np.concatenate([np.asarray(ks, np.int64),
                             np.zeros((B - B_real,), np.int64)])
        ks = _tensor(ks, dev)
        K = int(K)
        self._attribute(("draft_turn", B, C, K), self.draft_turn,
                        meta={"batch_bucket": B, "chunk_bucket": C, "K": K})
        fn = self._compiled(("draft_turn", B, C, K))
        tok = self._tokens(tokens, B, C, dev)
        with torch.no_grad():
            toks, qs = fn(params, kpool, vpool, tok, start, clen, bt, act,
                          ks, samp, K)
        return toks[:B_real], qs[:B_real]

    def _draft_turn_impl(self, params, kpool, vpool, tok, start, clen, bt,
                         act, ks, samp, K):
        """The draft turn on padded device inputs: the catch-up chunk,
        then K - 1 single-token steps; (draft [B, K], qdists [B, K,
        V])."""
        dev = kpool.device
        B = tok.shape[0]
        p0 = start + clen        # global position of proposal d_0
        keys = [None] * K
        if (samp[0] > 0).any():
            pos = p0[:, None] + torch.arange(K, device=dev)[None, :]
            keys = _samp.fold_keys(np.repeat(samp[3], K), pos.reshape(-1),
                                   _samp.SALT_DRAFT).reshape(B, K, 2)
            keys = keys.unbind(1)
        t, q = self._sample_step(params, kpool, vpool, tok, start, clen, bt,
                                 act, samp, _samp.SALT_DRAFT, keys[0])
        toks, qs = [t], [q]
        ones = torch.ones_like(start)
        for j in range(1, K):
            t, q = self._sample_step(
                params, kpool, vpool, t[:, None].long(), p0 + j - 1, ones,
                bt, act & (ks > j), samp, _samp.SALT_DRAFT, keys[j])
            toks.append(t)
            qs.append(q)
        return torch.stack(toks, dim=1), torch.stack(qs, dim=1)

    def verify(self, params, kpool, vpool, prev_tokens, draft_tokens,
               qdists, start, chunk_len, block_tables, active,
               temperature=None, top_k=None, top_p=None, seed=None):
        """The speculative verify over a [B, K+1] chunk.

        ``prev_tokens`` [B_real, 1] (host) is each row's last emitted
        token, at global position ``start``; ``draft_tokens`` [B_real,
        K] and ``qdists`` [B_real, K, V] come from :meth:`draft_turn` on
        the device. A row proposes ``k_i = chunk_len - 1`` drafts
        (``k_i == 0`` is plain sampled decode). Returns (n_accept
        [B_real], tok [B_real]) on the device: the leading drafts
        accepted, and the one non-draft token to emit after them (the
        rejection resample, or the bonus sample on full acceptance).
        Logits never leave the device.
        """
        B_real, K = draft_tokens.shape
        B = bucket_for(B_real, self.batch_buckets)
        dev = kpool.device
        V = self.cfg.vocab_size
        # padded rows: chunk_len 0 would make k_i negative; clamp to 1
        chunk_len = np.maximum(np.asarray(chunk_len), 1)
        temp, tk, tp, sd = self._sampling_arrays(
            B, B_real, temperature, top_k, top_p, seed)
        start, clen, bt, act = self._batch(
            B, dev, start, np.concatenate(
                [chunk_len, np.ones((B - B_real,), chunk_len.dtype)]),
            block_tables, active)
        pad = B - B_real
        d = torch.cat([draft_tokens.long(),
                       draft_tokens.new_zeros((pad, K)).long()])
        q = torch.cat([qdists, qdists.new_ones((pad, K, V))])
        prev = self._tokens(np.asarray(prev_tokens), B, 1, dev)
        self._attribute(("verify", B, K), self.verify,
                        meta={"batch_bucket": B, "K": K})
        fn = self._compiled(("verify", B, K))
        with torch.no_grad():
            n, tok = fn(params, kpool, vpool, torch.cat([prev, d], dim=1), d,
                        q, start, clen, bt, act, (temp, tk, tp, sd))
        return n[:B_real], tok[:B_real]

    def _verify(self, params, kpool, vpool, tokens, d, qdists, start,
                chunk_len, block_tables, active, samp):
        """Accept/reject, bonus and residual draws of :meth:`verify` on
        padded device inputs. A batch with no sampled row takes only
        the greedy comparisons: no threefry draw, no filtering. A
        sampled batch derives all of its keys in one
        :func:`~.sampling.fold_keys` call (the K accept positions, the
        bonus position and the K + 1 candidate residual positions a
        row) and draws the bonus and residual Gumbels in one pass."""
        temp, tk, tp, seed = samp
        x = self._body(params, kpool, vpool, tokens, start, chunk_len,
                       block_tables, active)
        B, C = tokens.shape
        K = C - 1
        V = self.cfg.vocab_size
        dev = x.device
        logits = (x @ params["embed"].T).float()                # [B, C, V]
        argm = torch.argmax(logits, dim=-1)                     # [B, C]
        k_i = chunk_len - 1                                     # [B]
        any_sampled = bool((temp > 0).any())
        is_sampled = torch.as_tensor(temp > 0, device=dev)
        d = torch.clamp(d, 0, V - 1)
        arK = torch.arange(K, device=dev)

        # -- accept/reject the K draft positions -----------------------------
        accept = d == argm[:, :K]
        if any_sampled:
            masked, pdist = _samp.filter_dist(
                logits, temp[:, None], tk[:, None], tp[:, None])
            p_d = torch.gather(pdist[:, :K], -1, d[..., None])[..., 0]
            q_d = torch.gather(qdists, -1, d[..., None])[..., 0]
            nxt = start[:, None] + 1 + torch.arange(C, device=dev)[None, :]
            pos = torch.cat([nxt[:, :K], (start + chunk_len)[:, None], nxt],
                            dim=1)                               # [B, 2K+2]
            salt = torch.as_tensor(
                [_samp.SALT_ACCEPT] * K + [_samp.SALT_TARGET]
                + [_samp.SALT_RESIDUAL] * C, device=dev).expand(B, -1)
            keys = _samp.fold_keys(np.repeat(seed, 2 * C), pos.reshape(-1),
                                   salt.reshape(-1)).reshape(B, 2 * C, 2)
            u = _tf.uniform(keys[:, :K], 1)[..., 0]              # [B, K]
            ratio = torch.clamp(p_d / torch.clamp(q_d, min=1e-20), max=1.0)
            accept = torch.where(is_sampled[:, None], u < ratio, accept)
        accept = accept & (arK[None, :] < k_i[:, None])
        stop = (~accept).to(torch.int32)
        n = torch.where(stop.any(dim=1), torch.argmax(stop, dim=1),
                        torch.full_like(k_i, K))

        # -- the one non-draft token ------------------------------------------
        # full acceptance: the bonus draw at start + chunk_len under the
        # TARGET salt, exactly the draw plain decode would make there
        ri = torch.arange(B, device=dev)
        nc = torch.clamp(n, 0, C - 1)
        bonus = argm[ri, k_i]
        resample = argm[ri, nc]
        if any_sampled:
            # the bonus key, and the residual key at start + 1 + n
            g = _tf.gumbel(torch.stack([keys[:, K], keys[ri, C + nc]], 1), V)
            bonus = torch.where(is_sampled, torch.argmax(
                masked[ri, k_i] + g[:, 0], dim=-1), bonus)
            # rejection at draft index n: resample from max(p - q, 0)
            p_n = pdist[ri, nc]
            q_n = qdists[ri, torch.clamp(n, 0, K - 1)]
            r = torch.clamp(p_n - q_n, min=0.0)
            rs = r.sum(dim=-1, keepdim=True)
            r = torch.where(rs > 1e-12, r / torch.clamp(rs, min=1e-12), p_n)
            r_logits = torch.where(r > 0, torch.log(torch.clamp(r, min=1e-30)),
                                   torch.full_like(r, -1e30))
            resample = torch.where(is_sampled, torch.argmax(
                r_logits + g[:, 1], dim=-1), resample)
        tok = torch.where(n >= k_i, bonus, resample)
        return n.to(torch.int32), tok.to(torch.int32)

    def warmup(self, params, pool, batch_sizes=None):
        """Run the decode step once at each batch bucket (inactive rows,
        which write only the scratch block), so lazy CUDA and cuBLAS
        set-up lands before traffic. Prefill buckets warm on first
        use."""
        for B in (batch_sizes or self.batch_buckets):
            self.step(params, pool.k, pool.v, np.zeros((B, 1), np.int64),
                      np.zeros((B,), np.int64), np.ones((B,), np.int64),
                      np.zeros((B, self.max_blocks), np.int64),
                      np.zeros((B,), bool))


def _tensor(a, dev, dtype=torch.int64):
    return torch.as_tensor(np.asarray(a), device=dev).to(dtype)


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
