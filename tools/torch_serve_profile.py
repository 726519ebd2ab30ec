#!/usr/bin/env python3
"""Where the time of mxnet_tpu_torch serving goes, on one NVIDIA GPU.

    python3 tools/torch_serve_profile.py [--repeats 2]

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

    from chip_smoke import FLAGSHIP
    from mxnet_tpu_torch.models.transformer import (TransformerConfig,
                                                    init_params)
    from mxnet_tpu_torch.ops.flash_attention import flash_attention
    from mxnet_tpu_torch.parallel import create_mesh
    from mxnet_tpu_torch.serving import Engine, ServingConfig

    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args()

    cfg = TransformerConfig(**FLAGSHIP)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (2048, 2048, 5, 37)]

    def serve(prof=None):
        eng = Engine(params, cfg, ServingConfig(
            mesh=create_mesh((1,), ("seq",)), cp_kind="ulysses",
            cp_min_tokens=2048, block_size=16, num_blocks=512, max_batch=8,
            prefill_chunk=64))
        flash_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = eng.generate(prompts, max_new_tokens=16)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = eng.stats()
        ttfts, _ = eng.latency_samples()
        rec = {"wall_s": wall, "tokens_per_s": sum(map(len, outs)) / wall,
               "ttft_s": ttfts, "token_latency_p50_s":
               st["token_latency_p50_s"], "steps": st["steps"],
               "flash_fwd_launches": flash_attention.launches,
               "profiled": prof is not None}
        print(json.dumps(rec), flush=True)
        return wall

    serve()  # cold: first-use costs (library handles, lazy module loads)
    for _ in range(args.repeats - 1):
        serve()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = serve(prof=True)
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0)

    # device-side events only (each aten op also carries its kernels'
    # time, so summing every event would count it twice)
    kernels = sorted((e for e in events
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and dev_us(e) > 0), key=dev_us, reverse=True)
    device_us = sum(dev_us(e) for e in kernels)
    flash_us = sum(dev_us(e) for e in kernels if "flash_fwd" in e.key)
    host = sorted((e for e in events if e.key.startswith("aten::")),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    print(json.dumps({
        "warm_wall_s": wall, "device_kernel_s": device_us / 1e6,
        "device_busy_share": device_us / 1e6 / wall,
        "flash_fwd_device_s": flash_us / 1e6,
        "flash_fwd_share_of_device": flash_us / max(device_us, 1),
        "top_kernels": [{"name": e.key[:90], "device_ms": dev_us(e) / 1e3,
                         "calls": e.count} for e in kernels[:12]],
        "top_host_ops": [{"name": e.key, "self_cpu_ms":
                          e.self_cpu_time_total / 1e3, "calls": e.count}
                         for e in host[:12]],
        "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
