#!/usr/bin/env python3
"""Where the time of an mxnet_tpu_torch training step goes, on one
NVIDIA GPU.

    python3 tools/torch_train_profile.py [--warmup 2]

Builds the flagship LM at bench_lm.py's training configuration (the one
chip_smoke.py trains: 12 layers, d_model 1024, 8 heads, vocab 32000,
seq 1024, batch 16, bf16, Adam 1e-4, random seeded weights and tokens)
behind ``ShardedTrainer``, runs ``--warmup`` steps, times one step
without the profiler, then profiles one step under ``torch.profiler``.
Prints one JSON line per step and a final JSON line with the profiled
step's device busy share (CUDA kernel time over wall time), the shares
of device time of the flash kernels K2 (flash_fwd), K3 (flash_bwd_dq)
and K4 (flash_bwd_dkv), the device time and launches by kind of kernel
(flash, cuBLAS products, softmax/cross-entropy, copies, the rest), and
the top CUDA kernels and host-side ops by time. Needs CUDA; exits
non-zero without it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main():
    import torch

    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import (PEAK_BF16, TRAIN, TRAIN_BATCH, _train_batch,
                            model_flops_per_token)
    from mxnet_tpu_torch.models.transformer import (TransformerConfig,
                                                    init_params, loss_fn)
    from mxnet_tpu_torch.parallel import ShardedTrainer

    ap = argparse.ArgumentParser()
    ap.add_argument("--warmup", type=int, default=2)
    args = ap.parse_args()

    cfg = TransformerConfig(**TRAIN)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    data = _train_batch(cfg, TRAIN_BATCH)
    trainer = ShardedTrainer(loss_fn(cfg), params,
                             lambda ps: torch.optim.Adam(ps, lr=1e-4))
    flops = model_flops_per_token(cfg, cfg.max_seq_len) * (
        TRAIN_BATCH * cfg.max_seq_len)

    def step(profiled):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = trainer.step(data).item()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(json.dumps({"wall_s": wall, "loss": loss,
                          "tokens_per_s": TRAIN_BATCH * cfg.max_seq_len
                          / wall, "mfu": flops / wall / PEAK_BF16,
                          "profiled": profiled}), flush=True)
        return wall

    for _ in range(args.warmup):
        step(False)
    unprofiled = step(False)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = step(True)
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0)

    # device-side kernels only (each aten op also carries its kernels'
    # time, and a device-side user annotation such as the optimizer's
    # step range spans kernels listed on their own, so summing those
    # would count the time twice)
    kernels = sorted((e for e in events
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)
                      and dev_us(e) > 0), key=dev_us, reverse=True)
    device_us = sum(dev_us(e) for e in kernels)

    def share(tag):
        us = sum(dev_us(e) for e in kernels if tag in e.key)
        return {"device_ms": us / 1e3, "share_of_device": us / max(
            device_us, 1), "calls": sum(e.count for e in kernels
                                        if tag in e.key)}

    # device time by kind of kernel: the flash kernels, cuBLAS matrix
    # products, the softmax/cross-entropy kernels, copies (layout changes
    # such as .contiguous()) and everything else (elementwise,
    # reductions, the optimizer)
    groups = {"flash": 0.0, "gemm": 0.0, "softmax": 0.0, "copy": 0.0,
              "other": 0.0}
    calls = dict.fromkeys(groups, 0)
    for e in kernels:
        name = e.key.lower()
        kind = ("flash" if "flash_" in name else
                "gemm" if any(t in name for t in ("nvjet", "gemm",
                                                   "cutlass")) else
                "softmax" if "softmax" in name or "nll" in name else
                "copy" if "copy" in name else "other")
        groups[kind] += dev_us(e)
        calls[kind] += e.count
    host = sorted((e for e in events if e.key.startswith("aten::")),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    print(json.dumps({
        "unprofiled_step_s": unprofiled, "profiled_step_s": wall,
        "device_kernel_s": device_us / 1e6,
        "device_busy_share": device_us / 1e6 / wall,
        "flash_fwd": share("flash_fwd"),
        "flash_bwd_dq": share("flash_bwd_dq"),
        "flash_bwd_dkv": share("flash_bwd_dkv"),
        "device_ms_by_kind": {k: v / 1e3 for k, v in groups.items()},
        "kernel_calls_by_kind": calls,
        "top_kernels": [{"name": e.key[:90], "device_ms": dev_us(e) / 1e3,
                         "calls": e.count} for e in kernels[:15]],
        "top_host_ops": [{"name": e.key, "self_cpu_ms":
                          e.self_cpu_time_total / 1e3, "calls": e.count}
                         for e in host[:12]],
        "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
