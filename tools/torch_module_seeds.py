#!/usr/bin/env python3
"""How examples/module/mnist_mlp.py's workflows depend on the seed.

    python3 tools/torch_module_seeds.py [--device cuda|cpu] [--seeds N]
                                        [--workflows python_loss,...]

For each seed 0..N-1 it seeds ``mx.random`` (the weights) and numpy's
global generator (the training iterators' shuffles) and runs each named
workflow of ``chip_smoke.py`` (``mnist_explicit``, ``mnist_sequential``,
``mnist_python_loss``) at the example's defaults (2000/1000 synthetic
digits, batch 100, 3 epochs), printing one JSON line with every
validation accuracy, then their minimum and how many fall under 0.9.
On ``cuda`` it also prints the card's name and power limit; without
CUDA and without ``--device cpu`` it exits 2.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seeds", type=int, default=20)
    ap.add_argument("--workflows", default="python_loss")
    args = ap.parse_args()

    import numpy as np
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_module_seeds: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    import mxnet_tpu_torch as mx

    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(), flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ctx = mx.gpu(0) if args.device == "cuda" else mx.cpu()
    out = {}
    for name in args.workflows.split(","):
        run = getattr(chip_smoke, "mnist_" + name)
        accs = []
        for seed in range(args.seeds):
            mx.random.seed(seed)
            np.random.seed(seed)
            accs.append(float(run(ctx)))
        out[name] = {"val_acc": accs, "min": min(accs),
                     "under_0.9": int(sum(a <= 0.9 for a in accs))}
    print(json.dumps({"device": (torch.cuda.get_device_name(0)
                                 if args.device == "cuda" else "cpu"),
                      "seeds": args.seeds, "workflows": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
