"""Run train_end2end.py several times and say whether the runs agree.

    python3 examples/rcnn_torch/repeat_runs.py [--ctx gpu|cpu] [--runs 3]
        [--seeds 0,1,...] [--parallel 3]

Each run is a process of its own running ``train_end2end.main`` at the
example's defaults, with TF32 off as ``chip_smoke.py`` runs it. With
``--seeds`` the example's three seeds (numpy's global one, ``mx.random``
and ``DetectionIter``'s) are each moved by the run's seed, one run a
seed; without it every run keeps the example's seeds. Each run prints
one JSON line: its seed, the example's train metrics, mean IoU and VOC07
mAP, whether its asserts held, and a hash of the parameters at each
read (``Module.get_params``: one an epoch, then the example's own). The
last line is a JSON summary: the mAPs, how many runs failed an assert,
and the first read at which two runs' parameters differ (null when they
never do). ``MXNET_ENFORCE_DETERMINISM`` passes through to the runs. On
``gpu`` the card's name and power limit are printed first; without CUDA
the script exits 2.
"""
import argparse
import hashlib
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def child(seed, ctx):
    import contextlib
    import io

    import numpy as np
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, HERE)
    import train_end2end as te

    mx = te.mx
    hashes = []
    real_get = mx.module.Module.get_params

    def get_params(self):
        arg, aux = real_get(self)
        h = hashlib.sha1()
        for k in sorted(arg):
            h.update(arg[k].asnumpy().tobytes())
        hashes.append(h.hexdigest()[:16])
        return arg, aux

    mx.module.Module.get_params = get_params
    if seed is not None:
        np_seed, mx_seed = np.random.seed, mx.random.seed
        it = te.DetectionIter
        np.random.seed = lambda s: np_seed(s + seed)
        mx.random.seed = lambda s: mx_seed(s + seed)
        te.DetectionIter = lambda n, seed0=0: it(n, seed=seed0 + seed)
    sys.argv = ["train_end2end.py", "--ctx", ctx]
    buf, failed = io.StringIO(), None
    with contextlib.redirect_stdout(buf):
        try:
            te.main()
        except AssertionError as e:
            failed = str(e)
    out = buf.getvalue()

    def num(pattern):
        m = re.search(pattern, out)
        return float(m.group(1)) if m else None

    m = re.search(r"train metrics: (\{.*\})", out)
    print(json.dumps({
        "seed": seed, "train_metrics": m.group(1) if m else None,
        "mean_iou": num(r"mean-IoU\(top1\)=([0-9.]+)"),
        "map": num(r"VOC07 mAP=([0-9.]+)"), "assert_failed": failed,
        "param_hashes": hashes}))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ctx", default="gpu", choices=("gpu", "cpu"))
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--seeds", default=None)
    ap.add_argument("--parallel", type=int, default=3)
    ap.add_argument("--child-seed", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child_seed is not None:
        seed = None if args.child_seed == "none" else int(args.child_seed)
        return child(seed, args.ctx)

    import torch

    if args.ctx == "gpu":
        if not torch.cuda.is_available():
            print("repeat_runs: no CUDA device", file=sys.stderr)
            return 2
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    seeds = (["none"] * args.runs if args.seeds is None
             else args.seeds.split(","))
    env = dict(os.environ)
    if args.ctx == "cpu":   # no more threads than cores across the runs
        env["OMP_NUM_THREADS"] = str(max(
            1, (os.cpu_count() or 1) // args.parallel))
    runs = []
    for i in range(0, len(seeds), args.parallel):
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--ctx", args.ctx,
             "--child-seed", s], stdout=subprocess.PIPE, text=True, env=env)
            for s in seeds[i:i + args.parallel]]
        for p in procs:
            out, _ = p.communicate()
            if p.returncode != 0:
                raise SystemExit("a run exited with %d" % p.returncode)
            rec = json.loads(out.strip().splitlines()[-1])
            print(json.dumps(rec), flush=True)
            runs.append(rec)
    parted = None
    width = min(len(r["param_hashes"]) for r in runs)
    for k in range(width):
        if len({r["param_hashes"][k] for r in runs}) > 1:
            parted = k
            break
    print(json.dumps({
        "runs": len(runs), "maps": [r["map"] for r in runs],
        "assert_failed": sum(r["assert_failed"] is not None for r in runs),
        "first_parted_read": parted, "reads": width,
        "enforce_determinism": os.environ.get(
            "MXNET_ENFORCE_DETERMINISM")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
