#!/usr/bin/env python3
"""Feasibility probe of mxnet_tpu_torch: the fused matmul + column
statistics kernel (K6) against the unfused sequence, on one NVIDIA GPU.

    python3 tools/torch_probe_matmul_stats.py [--device cuda|cpu]

The port's counterpart of ``tools/probe_matmul_stats.py``. BatchNorm
after a convolution reads the convolution's output once more for its
per-channel sum and sum of squares; a 1x1 convolution is a matmul, and a
matmul whose epilogue takes those sums while the output tile is still on
chip saves that read. For each of the probe's four shapes (ResNet-50's
1x1 convolution bodies at batch 128, as matmuls [M, K] x [K, N]) and its
inputs (``np.random.RandomState(0)``: ``x = randn``, ``w = randn * 0.05``,
both bf16) it

- holds K6 (``ops.matmul_stats.matmul_stats``) to the probe's own checks
  against the unfused sequence (``y = x @ w`` in bf16, then the sums of
  ``y.float()`` and its square: the torch form of the probe's
  ``xla_ref``), with the probe's tolerances;
- holds K6 to its plain version (``matmul_stats_reference``) with
  ``chip_smoke.matmul_stats_check``'s limits;
- holds K6 to itself: a second call gives the same bits;
- times K6, its plain version, ``torch.matmul`` alone (the probe's
  "mm-only") and the sequence with CUDA events around 20 calls after 3
  warm-up calls (``chip_smoke.cuda_ms``), and K6 and ``torch.matmul``
  also as device time from a CUDA graph of 20 calls
  (``chip_smoke.graph_ms``: without the host's launch cost), beside the
  card's bound for the shape (``chip_smoke.matmul_stats_bound_ms``) and
  K6's share of it (bound over time, by events and by graph);
- splits K6's time between its two CUDA kernels (the row tiles and the
  sum of their column partials) by ``torch.profiler``'s device time over
  5 calls.

The TPU probe timed by the slope of wall time over scan lengths because
its remote TPU backend added tens of milliseconds of dispatch and fence
to every call; CUDA events bracket the device work of a run of calls on
the card's own stream, so no slope is needed here.

Prints one JSON line a shape (kernel, plain, ``torch.matmul`` and
sequence ms, the graph times, the bound, what bounds it and the shares
of it, the sequence/kernel ratio, device ms per call of each of K6's
CUDA kernels, and the checks), then the card's name and power limit.
``--device cpu`` runs the checks at a small size with the plain version
(times not measured, ``null``); without CUDA and without ``--device
cpu`` it exits 2.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (M, K, N): ResNet-50 1x1 convolution bodies at batch 128 as matmuls
# (tools/probe_matmul_stats.py:74-80)
SHAPES = [(128 * 56 * 56, 64, 256), (128 * 56 * 56, 256, 64),
          (128 * 28 * 28, 512, 128), (128 * 14 * 14, 1024, 256)]
# the same depths and widths at a few hundred rows, for the CPU
CPU_SHAPES = [(1024, 64, 256), (1024, 256, 64), (512, 512, 128),
              (256, 1024, 256)]


def probe_inputs(m, k, n, device):
    """The probe's inputs: ``RandomState(0)``, ``x = randn(m, k)``,
    ``w = randn(k, n) * 0.05``, both rounded to bf16 on ``device``."""
    import numpy as np
    import torch

    rng = np.random.RandomState(0)
    x = rng.randn(m, k).astype(np.float32)
    w = (rng.randn(k, n) * 0.05).astype(np.float32)
    return (torch.from_numpy(x).to(device=device, dtype=torch.bfloat16),
            torch.from_numpy(w).to(device=device, dtype=torch.bfloat16))


def sequence(x, w):
    """The unfused sequence (the probe's ``xla_ref``): a bf16 matmul, then
    the column sums of its output and of its square in f32."""
    y = x @ w
    y32 = y.float()
    return y, y32.sum(0), y32.square().sum(0)


def _allclose(got, want, rtol, atol):
    """``numpy.testing.assert_allclose``'s test: the worst ratio of
    ``|got - want|`` to ``atol + rtol * |want|`` (<= 1 to pass)."""
    got, want = got.float().reshape(-1), want.float().reshape(-1)
    lim = atol + rtol * want.abs()
    return ((got - want).abs() / lim.clamp_min(1e-30)).max().item()


def probe_checks(got, seq):
    """The probe's three checks (tools/probe_matmul_stats.py:96-103) of
    K6's ``(y, s, s2)`` against the sequence's, as worst ratios."""
    y, s, s2 = got
    y0, s0, q0 = seq
    return {"s": _allclose(s, s0, 2e-2, 2e2),
            "s2": _allclose(s2, q0, 2e-2, q0.abs().max().item() * 2e-2),
            "y": _allclose(y, y0, 2e-2, 1e-1)}


def kernel_device_ms(fn, calls=5):
    """Device ms per call of each CUDA kernel of K6 that ``fn`` runs,
    by name, from ``torch.profiler`` over ``calls`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0)
        if "matmul_stats" in e.key and us > 0:
            name = "reduce" if "reduce" in e.key else "tile"
            out[name] = out.get(name, 0.0) + us / calls / 1e3
    return out


def run(device="cuda", shapes=SHAPES, timed=True):
    """Check and time K6 at each shape; returns one record a shape and
    raises if a check fails. The checks call K6 twice a shape; the
    timing (``timed``) calls it again, also inside CUDA graph captures.
    On the CPU the kernel is its plain version and nothing is timed."""
    import torch

    import chip_smoke as cs
    from mxnet_tpu_torch.ops.matmul_stats import (matmul_stats,
                                                  matmul_stats_reference)

    on_card = device == "cuda"
    records = []
    for m, k, n in shapes:
        x, w = probe_inputs(m, k, n, device)
        got = matmul_stats(x, w)
        same_bits = all(torch.equal(a, b)
                        for a, b in zip(got, matmul_stats(x, w)))
        checks = probe_checks(got, sequence(x, w))
        plain = cs.matmul_stats_check(got, matmul_stats_reference(x, w),
                                      x, w)
        bound, by = cs.matmul_stats_bound_ms(m, k, n)
        rec = {"probe": "matmul_stats", "device": device, "shape": [m, k, n],
               "ms": None, "graph_ms": None, "plain_ms": None,
               "matmul_ms": None, "matmul_graph_ms": None,
               "sequence_ms": None, "bound_ms": bound, "bound_by": by,
               "bound_share": None, "graph_bound_share": None,
               "sequence_over_kernel": None, "kernel_device_ms": None,
               "probe_checks": checks, "plain_check": plain,
               "same_bits": same_bits}
        if on_card and timed:
            rec.update(
                ms=cs.cuda_ms(lambda: matmul_stats(x, w)),
                plain_ms=cs.cuda_ms(lambda: matmul_stats_reference(x, w)),
                matmul_ms=cs.cuda_ms(lambda: torch.matmul(x, w)),
                sequence_ms=cs.cuda_ms(lambda: sequence(x, w)))
            rec.update(
                graph_ms=cs.graph_ms(lambda: matmul_stats(x, w)),
                matmul_graph_ms=cs.graph_ms(lambda: torch.matmul(x, w)))
            rec["sequence_over_kernel"] = rec["sequence_ms"] / rec["ms"]
            rec["bound_share"] = bound / rec["ms"]
            rec["graph_bound_share"] = bound / rec["graph_ms"]
            rec["kernel_device_ms"] = kernel_device_ms(
                lambda: matmul_stats(x, w))
        records.append(rec)
        print(json.dumps(rec), flush=True)
        if max(checks.values()) > 1.0 or not plain["ok"] or not same_bits:
            raise AssertionError("matmul_stats fails a check at %s: %r"
                                 % ((m, k, n), rec))
        del x, w, got
    return records


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    import torch

    sys.path.insert(0, ROOT)

    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_probe_matmul_stats: no CUDA device", file=sys.stderr)
        return 2
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        run("cuda", SHAPES)
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(), flush=True)
    else:
        run("cpu", CPU_SHAPES)
    return 0


if __name__ == "__main__":
    sys.exit(main())
