#!/usr/bin/env python3
"""Drive mxnet_tpu_torch on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. setup: torch/CUDA versions, the card's name and power limit, and the
   build of every CUDA kernel from ``mxnet_tpu_torch/ops/csrc``;
2. each kernel against its plain PyTorch version on the same card
   tensors, at the serving path's shape and at a ragged and an f32
   shape, within the stated tolerances, then timed with CUDA events
   beside the plain version and one PyTorch library call;
3. serving: ``Engine.generate`` at the full width of the flagship LM
   (bench_lm.py's 190M-parameter config, random seeded weights on the
   card), two 2048-token prompts through the context-parallel Ulysses
   prefill (the flash kernel, once per layer) and two short prompts
   through the paged path; the kernel counts are zeroed just before and
   read just after, and the outputs are held against the plain
   ``transformer.forward``;
4. a JSON line ``{"kernels": [...]}`` with each kernel's launches on the
   main path, error, times and bound;
5. the last line: ``{"ok": true, "device": {...}}``.

Without CUDA, or run from a directory that lacks the package, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

FLAGSHIP = dict(vocab_size=32000, num_layers=12, d_model=1024, num_heads=8,
                d_ff=4096, max_seq_len=4096, dtype="bfloat16")


def log(obj):
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_flops(b, h, tq, tk, d, causal):
    """Operations the attention forward needs on these inputs: two
    products of 2*d per visible (query, key) pair (top-left causal)."""
    pairs = sum(min(i + 1, tk) for i in range(tq)) if causal else tq * tk
    return 4.0 * b * h * d * pairs


def attention_bound_ms(b, h, tq, tk, d, causal, elem_bytes, peak):
    """Least time for the attention forward on these inputs: the larger
    of its operations over the type's peak and its bytes (Q, K, V read
    once, O and the f32 lse written once) over the memory rate."""
    flops = attention_flops(b, h, tq, tk, d, causal)
    nbytes = elem_bytes * b * h * (2 * tq * d + 2 * tk * d) + 4 * b * h * tq
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_setup():
    import torch

    from mxnet_tpu_torch.ops import _build

    log("torch %s cuda %s python %s" % (torch.__version__,
                                        torch.version.cuda,
                                        sys.version.split()[0]))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi: %s" % smi.stderr.strip()
    log(card)
    secs = _build.build_all()
    log({"phase": "build", "seconds": secs,
         "libraries": {n: {"seconds": v["seconds"],
                           "ptxas": v["ptxas"].splitlines()}
                       for n, v in _build.build_log.items()}})
    return card


def phase_kernels():
    """Flash forward on the card against attention_reference."""
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops.flash_attention import (attention_reference,
                                                     flash_attention_fwd)

    cases = [((1, 8, 2048, 128), torch.bfloat16, True),
             ((2, 4, 2000, 64), torch.bfloat16, True),
             ((2, 4, 2000, 64), torch.bfloat16, False),
             ((1, 8, 384, 128), torch.float32, True)]
    results = []
    for shape, dtype, causal in cases:
        g = torch.Generator(device="cuda").manual_seed(len(results))
        q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype)
                   for _ in range(3))
        o, lse = flash_attention_fwd(q, k, v, causal=causal)
        o_ref, lse_ref = attention_reference(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        tol_o = 2e-2 if dtype == torch.bfloat16 else 1e-4
        ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, causal=causal))
        plain_ms = cuda_ms(
            lambda: attention_reference(q, k, v, causal=causal))
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal))
        b, h, t, d = shape
        bf16 = dtype == torch.bfloat16
        bound, by = attention_bound_ms(b, h, t, t, d, causal, 2 if bf16
                                       else 4, PEAK_BF16 if bf16
                                       else PEAK_F32)
        rec = {"phase": "kernel_check", "kernel": "flash_fwd",
               "shape": list(shape), "dtype": str(dtype).split(".")[1],
               "causal": causal, "max_abs_err": err_o,
               "max_abs_err_lse": err_lse, "tol": tol_o, "tol_lse": 1e-3,
               "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": bound, "bound_by": by,
               "achieved_tflops": attention_flops(b, h, t, t, d, causal)
               / (ms * 1e-3) / 1e12}
        log(rec)
        if not (err_o <= tol_o and err_lse <= 1e-3):
            raise AssertionError("flash_fwd disagrees with its plain "
                                 "version at %s: %r" % (shape, rec))
        results.append(rec)
    return results


def phase_serving(device="cuda", model_kw=FLAGSHIP, long_len=2048):
    """The main path; ``device``/``model_kw``/``long_len`` let a CPU
    rehearsal run the same code at a tiny size."""
    import numpy as np
    import torch

    from mxnet_tpu_torch.models.transformer import (TransformerConfig,
                                                    forward, init_params)
    from mxnet_tpu_torch.ops.flash_attention import (attention_reference,
                                                     flash_attention)
    from mxnet_tpu_torch.parallel import create_mesh
    from mxnet_tpu_torch.serving import Engine, ServingConfig, cp_prefill_kv

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    cfg = TransformerConfig(**model_kw)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    n_params = sum(t.numel() for t in _leaves(params))
    mesh = create_mesh((1,), ("seq",), devices=[device])
    scfg = ServingConfig(mesh=mesh, cp_kind="ulysses",
                         cp_min_tokens=long_len, block_size=16,
                         num_blocks=512, max_batch=8, prefill_chunk=64)
    eng = Engine(params, cfg, scfg, device=device)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (long_len, long_len, 5, 37)]
    new = 16

    sync()
    flash_attention.launches = 0
    t0 = time.perf_counter()
    outs = eng.generate(prompts, max_new_tokens=new)
    sync()
    wall = time.perf_counter() - t0
    launches = flash_attention.launches
    stats = eng.stats()
    ttfts, _ = eng.latency_samples()

    expected = 2 * cfg.num_layers if device == "cuda" else 0
    if launches != expected:
        raise AssertionError("flash_fwd launched %d times on the serving "
                             "path, expected %d" % (launches, expected))
    if [len(s) for s in outs] != [new] * len(prompts):
        raise AssertionError("stream lengths %r" % [len(s) for s in outs])
    if stats["cp_prefills"] != 2:
        raise AssertionError("cp prefills: %d" % stats["cp_prefills"])

    def plain_attn(q, k, v):
        return attention_reference(q, k, v, causal=True)[0]

    checks = []
    with torch.no_grad():
        unembed = params["embed"].float().T
        for i, (p, s) in enumerate(zip(prompts, outs)):
            # teacher-forced plain forward over prompt + stream
            seq = np.concatenate([p, np.asarray(s[:-1], np.int32)])
            ref = forward(params, seq[None], cfg, attn_fn=plain_attn)[0]
            ref = ref[len(p) - 1:].float()
            if not torch.isfinite(ref).all():
                raise AssertionError("non-finite reference logits")
            top2 = ref.topk(2, dim=-1).values
            gap = (top2[:, 0] - top2[:, 1]).cpu().numpy()
            arg = ref.argmax(dim=-1).cpu().numpy()
            rec = {"prompt_len": int(len(p)), "first_token": int(s[0]),
                   "ref_argmax0": int(arg[0]), "top2_gap0": float(gap[0])}
            if len(p) >= scfg.cp_min_tokens:
                _, _, x_last = cp_prefill_kv(params, cfg, p, mesh,
                                             kind="ulysses")
                cp_logits = x_last @ unembed
                diff = (cp_logits - ref[0]).abs().max().item()
                rec["cp_logits_max_abs_diff"] = diff
                if not diff <= 5e-2:
                    raise AssertionError("cp logits differ from forward "
                                         "by %g > 5e-2" % diff)
                if gap[0] > diff and int(s[0]) != int(arg[0]):
                    raise AssertionError("cp first token %d != forward "
                                         "argmax %d (gap %g > diff %g)"
                                         % (s[0], arg[0], gap[0], diff))
            # the rest of the stream: where forward's top-2 gap is wide
            # (> 0.25, far above bf16 path differences) the engine's
            # greedy token must be forward's argmax
            wide = gap > 0.25
            bad = int(np.sum(wide & (np.asarray(s) != arg)))
            rec.update({"tokens_checked": int(wide.sum()),
                        "mismatches_at_wide_gap": bad,
                        "agree_all": int(np.sum(np.asarray(s) == arg))})
            log(dict(phase="serving_check", **rec))
            if bad:
                raise AssertionError("stream %d disagrees with forward at "
                                     "%d wide-gap positions" % (i, bad))
            checks.append(rec)
    tokens = sum(len(s) for s in outs)
    log({"phase": "serving", "params": n_params, "prompts":
         [int(len(p)) for p in prompts], "max_new_tokens": new,
         "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
         "ttft_s": ttfts, "ttft_p50_s": stats["ttft_p50_s"],
         "token_latency_p50_s": stats["token_latency_p50_s"],
         "steps": stats["steps"], "flash_fwd_launches": launches,
         "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                         if device == "cuda" else None)})
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "mxnet_tpu_torch")):
        print("chip_smoke: mxnet_tpu_torch not found beside the script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_setup()
    checks = phase_kernels()
    launches = phase_serving()
    main_shape = checks[0]
    log({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "mxnet_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:93",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"]}]})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
