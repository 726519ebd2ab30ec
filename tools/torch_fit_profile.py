#!/usr/bin/env python3
"""Where the card's time goes in a warm ResNet-50 ``FeedForward`` step of
mxnet_tpu_torch, on one NVIDIA GPU.

    python3 tools/torch_fit_profile.py [--warmup 4] [--steps 2]

    python3 tools/torch_fit_profile.py --bench [--warmup 2] [--steps 1]

Fits ResNet-50 as chip_smoke.py's ``phase_resnet_fit`` does (batch 128,
3x224x224, 1000 classes, f32 with TF32 off, SGD lr 0.05 momentum 0.9,
seeded random data and the default initializer, the per-batch loop:
``MXNET_SCAN_TRAIN=0``) and profiles ``--steps`` batches under
``torch.profiler`` after ``--warmup`` batches. The tool labels each
registered op's forward (``mx::<op>``) and each optimizer update
(``mx::sgd_update``) with ``record_function`` ranges, which the port's
code does not carry, and charges every CUDA kernel to the nearest range
or autograd backward node above the op that launched it. Prints one
JSON line: the wall time of an unprofiled warm step and of a profiled
one, the device busy share (CUDA kernel time of a profiled step over an
unprofiled step's wall time: the profiler's own host work stretches the
steps it records), device ms per step by layer kind and
direction (convolution, BatchNorm, activation, pooling, fully connected,
residual add, SoftmaxOutput, the K1 kernel, the SGD update, the input's
host-to-device copy, the rest), device ms by kernel family (cuDNN/GEMM
products, the K1 kernel, everything else) and the top kernels.

``--bench`` profiles bench.py's ResNet-50 leg instead, as
chip_smoke.py's ``phase_resnet_bench`` runs it: the fused step of
``parallel.make_symbol_train_step`` on the s2d stem, bf16 products,
batch 128, ``torch.optim.SGD`` 0.05 / 0.9, through ``step.loop`` over
bench.py's 16 seeded batches on the card; ``--warmup`` loops, one timed
unprofiled loop, then ``--steps`` profiled loops (16 steps each); the
optimizer's step is charged to ``sgd_update`` and the parameters'
casts to bf16 to ``cast``. Needs CUDA; exits non-zero without it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

_OP_KIND = {"Convolution": "convolution", "BatchNorm": "batchnorm",
            "Activation": "activation", "Pooling": "pooling",
            "FullyConnected": "fully_connected", "_plus": "residual_add",
            "SoftmaxOutput": "softmax_output", "Flatten": "other"}
# substrings of autograd backward node names, in order of precedence
_BWD_KIND = (("Convolution", "convolution"), ("BNTrainNorm", "batchnorm"),
             ("Relu", "activation"), ("Pool", "pooling"),
             ("SoftmaxOutput", "softmax_output"), ("Mm", "fully_connected"),
             ("Add", "residual_add"), ("ToCopy", "cast"))


def _kind(event, kernel):
    if "softmax_narrow" in kernel or "softmax_wide" in kernel:
        return "softmax_kernel_K1"
    if "HtoD" in kernel:
        return "input_copy_h2d"
    e = event
    while e is not None:
        name = e.name
        if name == "mx::sgd_update" or name.startswith("Optimizer.step#"):
            return "sgd_update"
        if name == "mx::cast":
            return "cast_fwd"
        if name.startswith("mx::"):
            return _OP_KIND.get(name[4:], "other") + "_fwd"
        if name.startswith("autograd::engine::evaluate_function: "):
            fn = name.split(": ", 1)[1]
            for tag, kind in _BWD_KIND:
                if tag in fn:
                    return kind + "_bwd"
            return "other_bwd"
        e = e.cpu_parent
    return "other"


def _family(kernel):
    k = kernel.lower()
    if "softmax_narrow" in k or "softmax_wide" in k:
        return "softmax_kernel_K1"
    if any(t in k for t in ("conv", "cudnn", "xmma", "gemm", "nvjet",
                            "cutlass", "implicit", "wgrad", "dgrad",
                            "winograd", "fft")):
        return "cudnn_or_gemm"
    if "memcpy" in k or "memset" in k:
        return "copies"
    return "elementwise_reductions_other"


def main():
    import torch

    if not torch.cuda.is_available():
        print("torch_fit_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from torch.profiler import ProfilerActivity, profile, record_function

    import chip_smoke
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import registry

    ap = argparse.ArgumentParser()
    ap.add_argument("--warmup", type=int, default=4)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--bench", action="store_true",
                    help="profile the fused bf16 s2d step (bench.py's leg)")
    args = ap.parse_args()
    if args.warmup < (1 if args.bench else 2) or args.steps < 1:
        ap.error("needs --warmup >= 2 (1 with --bench) and --steps >= 1")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    apply = registry.OpDef.apply

    def labelled_apply(self, *a, **k):
        with record_function("mx::" + self.name):
            return apply(self, *a, **k)

    registry.OpDef.apply = labelled_apply
    get_updater = mx.optimizer.get_updater

    def labelled_get_updater(optimizer):
        updater = get_updater(optimizer)

        def update(index, grad, weight):
            with record_function("mx::sgd_update"):
                updater(index, grad, weight)
        return update

    mx.optimizer.get_updater = labelled_get_updater
    if args.bench:
        return _bench(args, chip_smoke, mx, profile, ProfilerActivity,
                      record_function)

    batch, image, classes = 128, 224, 1000
    n_batches = args.warmup + args.steps
    x, y = chip_smoke._resnet_inputs(batch, image, classes, n_batches)
    it = mx.io.NDArrayIter(x, y, batch_size=batch)
    mx.random.seed(0)
    # the per-batch loop: its callbacks fire after each batch, which the
    # stamps and the profiler's window need (the scanned fit, the default
    # on one device, calls them after each chunk of 8)
    os.environ["MXNET_SCAN_TRAIN"] = "0"
    model = mx.FeedForward(mx.models.get_resnet(classes, 50), ctx=mx.gpu(0),
                           num_epoch=1, learning_rate=0.05, momentum=0.9)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    stamps = []

    def on_batch(param):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        if param.nbatch == args.warmup:
            prof.start()
        elif param.nbatch == n_batches:
            prof.stop()

    model.fit(X=it, batch_end_callback=on_batch)
    # step_s[j] is batch j + 2 (the cold batch 1 has no start stamp):
    # batches 2..warmup ran unprofiled, the last ``steps`` profiled
    step_s = [b - a for a, b in zip(stamps, stamps[1:])]
    plain_s = step_s[:args.warmup - 1]
    plain_wall = sum(plain_s) / len(plain_s)
    prof_wall = sum(step_s[args.warmup - 1:]) / args.steps

    _report(prof, args.steps, plain_wall, prof_wall, batch, image)
    return 0


def _bench(args, chip_smoke, mx, profile, ProfilerActivity, record_function):
    import torch

    from mxnet_tpu_torch import threefry
    from mxnet_tpu_torch.parallel import symbol_trainer

    cast = symbol_trainer._cast

    def labelled_cast(p, cdt):
        with record_function("mx::cast"):
            return cast(p, cdt)

    symbol_trainer._cast = labelled_cast
    batch, image, classes, k = 128, 224, 1000, 16
    shapes = {"data": (batch, 3, image, image), "softmax_label": (batch,)}
    step, state = symbol_trainer.make_symbol_train_step(
        mx.models.get_resnet(classes, 50, stem="s2d", image=image), shapes,
        ctx=mx.gpu(0), compute_dtype="bfloat16")
    batches = chip_smoke._bench_batches(k, batch, image, classes,
                                        torch.bfloat16, "cuda")
    key = threefry.prng_key(0, device="cpu")

    def loops(n):
        nonlocal state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            state, _ = step.loop(state, batches, key)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / (n * k)

    loops(args.warmup)
    plain_wall = loops(1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_wall = loops(args.steps)
    _report(prof, args.steps * k, plain_wall, prof_wall, batch, image,
            leg="bench: s2d, bf16, make_symbol_train_step")
    return 0


def _report(prof, steps, plain_wall, prof_wall, batch, image,
            leg="FeedForward.fit: conv7, f32, per-batch loop"):
    import torch

    by_kind, by_family, by_kernel = {}, {}, {}
    for e in prof.events():
        for k in getattr(e, "kernels", ()):
            us = k.duration
            kind = _kind(e, k.name)
            by_kind[kind] = by_kind.get(kind, 0.0) + us
            fam = _family(k.name)
            by_family[fam] = by_family.get(fam, 0.0) + us
            by_kernel[k.name] = by_kernel.get(k.name, 0.0) + us
    device_us = sum(by_kind.values())

    def per_step_ms(d):
        return {k: v / 1e3 / steps
                for k, v in sorted(d.items(), key=lambda kv: -kv[1])}

    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]
    print(json.dumps({
        "card": torch.cuda.get_device_name(0), "leg": leg, "batch": batch,
        "image": image, "steps_profiled": steps,
        "unprofiled_wall_ms_per_step": plain_wall * 1e3,
        "profiled_wall_ms_per_step": prof_wall * 1e3,
        "device_ms_per_step": device_us / 1e3 / steps,
        # the profiler's host-side cost stretches the profiled steps, so
        # the share is taken against an unprofiled step's wall time
        "device_busy_share": device_us / 1e6 / steps / plain_wall,
        "device_ms_per_step_by_kind": per_step_ms(by_kind),
        "device_ms_per_step_by_family": per_step_ms(by_family),
        "top_kernels": [{"name": n[:90], "device_ms_per_step":
                         us / 1e3 / steps} for n, us in top]}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
