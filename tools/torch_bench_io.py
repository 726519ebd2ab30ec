#!/usr/bin/env python3
"""The RecordIO image pipeline's throughput on this host, for
mxnet_tpu_torch: the counterpart of tools/bench_io.py.

    python3 tools/torch_bench_io.py [--images 2048] [--device cpu]

Makes a seeded folder of ImageNet-like JPEGs (``chip_smoke.
make_image_folder``: 300-500 px a side, 4 classes of stripes) in a
temporary directory, packs it with tools/torch_im2rec.py ``--resize
256`` (train_imagenet.py's packing) and prints the card's name and power
limit (``nvidia-smi``), then one JSON line:

- ``scan``: records/s and MB/s of a sequential read of the ``.rec``
  through ``recordio.MXRecordIO`` (the file in the page cache: warm),
  and of ``record_index``'s header-only scan;
- ``iterator``: img/s of ``io.ImageRecordIter`` at train_imagenet.py's
  training settings (rand crop, mirror, HLS jitter 36/50/50, the
  ImageNet mean, 3x224x224, batch 256) at 1, 4 and the host's core
  count of ``preprocess_threads``, over one pass after a warm batch;
- ``h2d``: ms and GB/s of one batch's host-to-card copy, from pageable
  memory and through pinned memory as the scanned fit stages it (CUDA
  events; with ``--device cpu`` not measured).

Without CUDA it exits 2 and prints no result unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def scan(path):
    """(records/s, MB/s) of a full sequential read, and records/s of
    ``record_index``'s scan (no cache)."""
    from mxnet_tpu_torch import recordio

    t0 = time.perf_counter()
    r = recordio.MXRecordIO(path, "r")
    n = 0
    while r.read() is not None:
        n += 1
    r.close()
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx = recordio.record_index(path, cache=False)
    index_s = time.perf_counter() - t0
    assert len(idx) == n
    return {"records": n, "records_per_s": n / read_s,
            "mb_per_s": os.path.getsize(path) / 1e6 / read_s,
            "index_records_per_s": n / index_s}


def iterator_img_per_s(path, threads, batch):
    """img/s of a bare ImageRecordIter at train_imagenet.py's training
    settings, one pass after a warm batch."""
    import mxnet_tpu_torch as mx

    it = mx.io.ImageRecordIter(
        path_imgrec=path, mean_r=123.68, mean_g=116.779, mean_b=103.939,
        data_shape=(3, 224, 224), batch_size=batch, rand_crop=True,
        rand_mirror=True, random_h=36, random_s=50, random_l=50,
        preprocess_threads=threads)
    it.next()
    it.reset()
    n, t0 = 0, time.perf_counter()
    for b in it:
        n += b.data[0].shape[0]
    return n / (time.perf_counter() - t0)


def h2d(batch, iters=10):
    """ms of one [batch, 3, 224, 224] f32 host-to-card copy, pageable and
    pinned (pin + copy, as ``fit_trainer._to_device`` stages a chunk)."""
    import torch

    x = torch.rand(batch, 3, 224, 224)
    out = {}
    for name, fn in (("pageable", lambda: x.to("cuda")),
                     ("pinned", lambda: x.pin_memory().to(
                         "cuda", non_blocking=True))):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / iters
        out[name] = {"ms": ms, "event_ms": start.elapsed_time(end) / iters,
                     "gb_per_s": x.numel() * 4 / 1e9 / (ms * 1e-3)}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--images", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=256)
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_bench_io: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke

    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(), flush=True)
    cores = os.cpu_count()
    tmp = tempfile.mkdtemp(prefix="mx_bench_io_")
    try:
        t0 = time.perf_counter()
        chip_smoke.make_image_folder(os.path.join(tmp, "images"),
                                     args.images, seed=3)
        make_s = time.perf_counter() - t0
        prefix = os.path.join(tmp, "train")
        _, pack_s = chip_smoke.pack_image_folder(prefix,
                                                 os.path.join(tmp, "images"))
        rec = prefix + ".rec"
        threads = sorted({1, 4, cores})
        out = {"metric": "torch_image_pipeline", "images": args.images,
               "batch": args.batch, "cores": cores,
               "rec_mb": os.path.getsize(rec) / 1e6,
               "make_s": make_s, "pack_s": pack_s,
               "pack_img_per_s": args.images / pack_s,
               "scan": scan(rec),
               "iterator": {"img_per_s_by_threads": {
                   str(t): iterator_img_per_s(rec, t, args.batch)
                   for t in threads}},
               "h2d": (h2d(args.batch) if args.device == "cuda"
                       else "not measured")}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
