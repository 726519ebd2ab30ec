#!/usr/bin/env python
"""Gradient-synchronisation bandwidth of mxnet_tpu_torch's kvstore: the
float32 legs of tools/bandwidth/measure.py, in its JSON schema.

- ``--transport device``: a ``device`` kvstore pushes ``--size-mb`` of
  float32 from every card (one value a card) and pulls the sum back into
  every card, a round at a time. GB/s/device counts ``2 (n - 1) / n`` of
  the buffer a round, as measure.py does for its ring all-reduce. With
  one card there is no traffic: the leg prints measure.py's note and
  value 0.0.
- ``--transport dist``: ``--workers`` processes started by
  tools/torch_launch.py each all-reduce ``--size-mb`` of float32 through
  the dist_sync store's route (``KVStore._all_reduce``:
  ``torch.distributed.all_reduce``, through host memory under gloo);
  rank 0 prints GB/s/rank over the same ``2 (n - 1) / n`` and the
  backend the store's rule chose.

Every leg prints one JSON line: the median of ``--repeats`` windows of
``--iters`` rounds, with min, max and spread. The int8 legs wait for the
port's quantized wire. ``--ctx cpu`` rehearses on the host (the device
leg over ``--num-devices`` host contexts); otherwise the legs need CUDA
and raise without it.

    python3 tools/torch_bandwidth.py --transport device --size-mb 64
    python3 tools/torch_bandwidth.py --transport dist --workers 2
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _emit(metric, unit, rates, extra=None):
    """measure.py's record: the median and the spread of the windows."""
    med = statistics.median(rates)
    rec = {
        "metric": metric,
        "value": round(med, 3),
        "unit": unit,
        "min": round(min(rates), 3),
        "median": round(med, 3),
        "max": round(max(rates), 3),
        "spread_pct": round(
            100.0 * (max(rates) - min(rates)) / med, 2) if med else 0.0,
        "repeats": len(rates),
    }
    rec.update(extra or {})
    _say(rec)
    return rec


def _say(rec):
    """One JSON line in one write: the dist leg's ranks share the
    launcher's stdout, and a write of under PIPE_BUF bytes to a pipe is
    never interleaved."""
    sys.stdout.write(json.dumps(rec) + "\n")
    sys.stdout.flush()


def _sync(ctxs):
    import torch

    for c in ctxs:
        if c.device_type == "gpu":
            torch.cuda.synchronize(c.device_id)


def _windows(fn, ctxs, args):
    """Seconds a round, one value a window, after ``--warmup`` rounds."""
    for _ in range(args.warmup):
        fn()
    _sync(ctxs)
    out = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        for _ in range(args.iters):
            fn()
        _sync(ctxs)
        out.append((time.perf_counter() - t0) / args.iters)
    return out


def _need_cuda(args):
    import torch

    if args.ctx == "gpu" and not torch.cuda.is_available():
        raise RuntimeError("--ctx gpu: no CUDA device is visible "
                           "(--ctx cpu rehearses on the host)")


def run_device(args):
    """The device leg: push from every card, pull into every card."""
    import mxnet_tpu_torch as mx

    _need_cuda(args)
    if args.ctx == "gpu":
        ctxs = [mx.gpu(i) for i in range(mx.context.num_devices("gpu"))]
    else:
        ctxs = [mx.cpu(i) for i in range(args.num_devices)]
    n = len(ctxs)
    if n == 1:
        rec = {"metric": "comm_allreduce_fp32", "value": 0.0,
               "unit": "GB/s/device",
               "note": "1 device: no collective traffic exists"}
        _say(rec)
        return rec
    elems = int(args.size_mb * 1e6 / 4)
    size_mb = elems * 4 / 1e6
    kv = mx.kvstore.create("device")
    kv.init(0, mx.nd.zeros((elems,), ctxs[0]))
    grads = [mx.nd.ones((elems,), c) for c in ctxs]
    outs = [mx.nd.zeros((elems,), c) for c in ctxs]

    def one_round():
        kv.push(0, grads)
        kv.pull(0, out=outs)

    ring = 2.0 * (n - 1) / n
    secs = _windows(one_round, ctxs, args)
    if not (outs[-1].asnumpy() == n).all():
        raise AssertionError("device leg: the pulled sum is not %d" % n)
    return _emit("comm_allreduce_fp32", "GB/s/device",
                 [size_mb / 1e3 * ring / s for s in secs],
                 extra={"devices": n, "contexts": [str(c) for c in ctxs],
                        "size_mb": round(size_mb, 1),
                        "logical_bytes_per_round": int(ring * elems * 4),
                        "transport": "kvstore-device"})


def _dist_worker(args):
    """One rank of the dist leg (started by the launcher)."""
    import torch

    import mxnet_tpu_torch as mx

    _need_cuda(args)
    kv = mx.kvstore.create("dist_sync")
    rank, n = kv.rank, kv.num_workers
    ctx = mx.cpu() if args.ctx == "cpu" else \
        mx.gpu(rank % torch.cuda.device_count())
    elems = int(args.size_mb * 1e6 / 4)
    size_mb = elems * 4 / 1e6
    buf = mx.nd.zeros((elems,), ctx)._data
    kv.barrier()
    secs = _windows(lambda: mx.kvstore.KVStore._all_reduce(buf), [ctx], args)
    ring = 2.0 * (n - 1) / n
    backend = mx.kvstore.backend()
    if rank == 0:
        _emit("comm_dist_allreduce_fp32", "GB/s/rank",
              [size_mb / 1e3 * ring / s for s in secs],
              extra={"workers": n, "size_mb": round(size_mb, 1),
                     "logical_bytes_per_round": int(ring * elems * 4),
                     "backend": backend, "ctx": str(ctx),
                     "host_staged": ctx.device_type == "gpu"
                     and backend == "gloo",
                     "transport": "torch.distributed"})
    kv.barrier()
    return 0


def run_dist(args):
    """The dist leg: ``--workers`` ranks through tools/torch_launch.py."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import torch_launch

    cmd = [sys.executable, os.path.abspath(__file__), "--dist-worker",
           "--ctx", args.ctx, "--size-mb", str(args.size_mb),
           "--iters", str(args.iters), "--warmup", str(args.warmup),
           "--repeats", str(args.repeats)]
    return torch_launch.launch(cmd, args.workers, timeout=args.timeout)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--transport", choices=["device", "dist", "all"],
                   default="all")
    p.add_argument("--size-mb", type=float, default=64,
                   help="gradient bytes a device/rank (f32)")
    p.add_argument("--iters", type=int, default=10,
                   help="timed rounds a window")
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--repeats", type=int, default=3,
                   help="windows (the median is the headline)")
    p.add_argument("--workers", type=int, default=4,
                   help="dist: worker processes")
    p.add_argument("--ctx", choices=["gpu", "cpu"], default="gpu")
    p.add_argument("--num-devices", type=int, default=2,
                   help="device leg with --ctx cpu: host contexts")
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("--dist-worker", action="store_true",
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.dist_worker:
        return _dist_worker(args)
    if args.transport in ("device", "all"):
        run_device(args)
    if args.transport in ("dist", "all"):
        return run_dist(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
