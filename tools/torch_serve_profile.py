#!/usr/bin/env python3
"""Where the time of mxnet_tpu_torch serving goes, on one NVIDIA GPU.

    python3 tools/torch_serve_profile.py [--repeats 2] [--spec]

Builds the flagship LM (bench_lm.py's width: 12 layers, d_model 1024,
8 heads, vocab 32000, bf16, random seeded weights) behind
``serving.Engine`` with the one-device Ulysses mesh, serves the same
requests as chip_smoke.py (two 2048-token prompts through the
context-parallel prefill, prompts of 5 and 37 tokens through the paged
path, 16 new tokens each) once cold, then ``--repeats`` more times warm,
the last under ``torch.profiler``. Prints one JSON line per run and a
final JSON line with the warm run's device busy share (CUDA kernel time
over wall time), the flash kernel's share of device time, and the top
CUDA kernels and host-side ops by time. Needs CUDA; exits non-zero
without it.

``--spec`` serves chip_smoke.py's sampled and speculative leg instead
(``phase_serving_sampled``: the tail layers' ``wo``/``w2`` scaled by
0.005, bench_serve.py's 1-layer draft, ``spec_k`` 4, two of the four
requests sampled, 32 new tokens each), and also profiles, each alone,
one sampled ``sample_tokens`` call at [8, vocab] (temperature 0.8,
top-k 50) and, after the served runs, one sampled draft turn and one
sampled verify at B = 4, K = 4 (chip_smoke.py's timing inputs): ms a
call unprofiled (CUDA events over 10 calls), then one profiled call's
wall ms, device ms, kernel launches, top kernels and host ops.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_serve_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import (DRAFT_LAYERS, DRAFT_RESID, FLAGSHIP,
                            SAMPLED_REQUESTS, cuda_ms)
    from mxnet_tpu_torch.models.transformer import (TransformerConfig,
                                                    init_params)
    from mxnet_tpu_torch.ops.flash_attention import flash_attention
    from mxnet_tpu_torch.parallel import create_mesh
    from mxnet_tpu_torch.serving import Engine, ServingConfig
    from mxnet_tpu_torch.serving import sampling as samp

    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--spec", action="store_true",
                    help="the sampled + speculative leg")
    args = ap.parse_args()

    cfg = TransformerConfig(**FLAGSHIP)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    scfg = dict(mesh=create_mesh((1,), ("seq",)), cp_kind="ulysses",
                cp_min_tokens=2048, block_size=16, num_blocks=512,
                max_batch=8, prefill_chunk=64)
    if args.spec:
        for lp in params["layers"][DRAFT_LAYERS:]:
            lp["wo"] = lp["wo"] * DRAFT_RESID
            lp["w2"] = lp["w2"] * DRAFT_RESID
        draft = dict(params, layers=params["layers"][:DRAFT_LAYERS])
        dcfg = TransformerConfig(**dict(FLAGSHIP, num_layers=DRAFT_LAYERS))
        rng = np.random.RandomState(1)
        requests = [(rng.randint(0, cfg.vocab_size, (
            2048 if n == "long" else n,)).astype(np.int32), kw)
                    for n, kw in SAMPLED_REQUESTS]
        new = 32
    else:
        rng = np.random.RandomState(0)
        requests = [(rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32),
                     {}) for n in (2048, 2048, 5, 37)]
        new = 16

    def serve(prof=None):
        if args.spec:
            eng = Engine(params, cfg, ServingConfig(spec=True, spec_k=4,
                                                    **scfg),
                         draft_params=draft, draft_cfg=dcfg)
        else:
            eng = Engine(params, cfg, ServingConfig(**scfg))
        flash_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hs = [eng.submit(p, max_new_tokens=new, **kw) for p, kw in requests]
        eng.run_until_idle()
        outs = [h.result() for h in hs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = eng.stats()
        ttfts, _ = eng.latency_samples()
        rec = {"wall_s": wall, "tokens_per_s": sum(map(len, outs)) / wall,
               "ttft_s": ttfts, "token_latency_p50_s":
               st["token_latency_p50_s"], "steps": st["steps"],
               "spec_turns": st["spec_turns"],
               "spec_accept_rate": st["spec_accept_rate"],
               "flash_fwd_launches": flash_attention.launches,
               "profiled": prof is not None}
        print(json.dumps(rec), flush=True)
        return wall, eng

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0)

    def device_kernels(events):
        # device-side events only (each aten op also carries its
        # kernels' time, so summing every event would count it twice)
        return sorted((e for e in events
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and dev_us(e) > 0), key=dev_us, reverse=True)

    def profile_call(fn, **label):
        """``fn``'s ms a call by CUDA events, then one warm call alone
        under the profiler."""
        ms = cuda_ms(fn, iters=10)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = prof.key_averages()
        kernels = device_kernels(events)
        host = sorted((e for e in events if e.key.startswith("aten::")),
                      key=lambda e: e.self_cpu_time_total, reverse=True)
        print(json.dumps(dict(
            label, ms=ms, wall_ms=wall * 1e3,
            device_ms=sum(dev_us(e) for e in kernels) / 1e3,
            launches=sum(e.count for e in kernels),
            top_kernels=[{"name": e.key[:90], "device_ms": dev_us(e) / 1e3,
                          "calls": e.count} for e in kernels[:8]],
            top_host_ops=[{"name": e.key, "self_cpu_ms":
                           e.self_cpu_time_total / 1e3, "calls": e.count}
                          for e in host[:8]])), flush=True)

    if args.spec:
        g = torch.Generator(device="cuda").manual_seed(6)
        logits = torch.randn(8, cfg.vocab_size, generator=g,
                             device="cuda") * 2
        pos = torch.arange(8, device="cuda") + 2048
        profile_call(lambda: samp.sample_tokens(
            logits, np.full(8, 0.8, np.float32), np.full(8, 50),
            np.ones(8, np.float32), np.arange(8, dtype=np.uint32), pos,
            samp.SALT_TARGET), sampler=[8, cfg.vocab_size])

    serve()  # cold: first-use costs (library handles, lazy module loads)
    for _ in range(args.repeats - 1):
        serve()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, eng = serve(prof=True)
    events = prof.key_averages()
    kernels = device_kernels(events)
    device_us = sum(dev_us(e) for e in kernels)
    flash_us = sum(dev_us(e) for e in kernels if "flash_fwd" in e.key)
    host = sorted((e for e in events if e.key.startswith("aten::")),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    print(json.dumps({
        "warm_wall_s": wall, "device_kernel_s": device_us / 1e6,
        "device_busy_share": device_us / 1e6 / wall,
        "flash_fwd_device_s": flash_us / 1e6,
        "flash_fwd_share_of_device": flash_us / max(device_us, 1),
        "launches": sum(e.count for e in kernels),
        "top_kernels": [{"name": e.key[:90], "device_ms": dev_us(e) / 1e3,
                         "calls": e.count} for e in kernels[:12]],
        "top_host_ops": [{"name": e.key, "self_cpu_ms":
                          e.self_cpu_time_total / 1e3, "calls": e.count}
                         for e in host[:12]],
        "card": torch.cuda.get_device_name(0)}), flush=True)

    if args.spec:
        # chip_smoke.py's draft turn and verify timing inputs: inactive
        # rows, whose writes land in the scratch block
        B, K = 4, eng.cfg.spec_k
        bt = np.zeros((B, eng.model.max_blocks), np.int32)
        act = np.zeros(B, bool)
        start = np.full(B, 2048, np.int32)
        ks = np.full(B, K, np.int32)
        kw = dict(temperature=np.full(B, 0.8, np.float32),
                  top_p=np.full(B, 0.95, np.float32),
                  seed=np.arange(B, dtype=np.uint32))

        def turn():
            return eng.draft_model.draft_turn(
                eng.draft_params, eng.draft_pool.k, eng.draft_pool.v,
                np.zeros((B, 1), np.int32), start, np.ones(B, np.int32), bt,
                act, ks, K, **kw)

        d, q = turn()
        profile_call(turn, draft_turn=[B, K], sampled=True)
        profile_call(lambda: eng.model.verify(
            eng.params, eng.pool.k, eng.pool.v, np.zeros((B, 1), np.int32),
            d, q, start, 1 + ks, bt, act, **kw), verify=[B, K], sampled=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
