"""Gradient-checkpoint ("mirror") memory-cost demo.

Counterpart of example/memcost/inception_memcost.py and
example/image-classification/train_cifar10_mirroring.py in the reference:
nodes tagged with ``force_mirroring`` (or everything, via
MXNET_BACKWARD_DO_MIRROR=1) are rematerialized in the backward pass
instead of having their activations stored — the executor groups
consecutive mirrored nodes into torch.utils.checkpoint segments, chunked
by MXNET_BACKWARD_MIRROR_STEP (default: sqrt(N) schedule)
(ref: static_graph.cc:404-422).

On mxnet_tpu_torch: examples/memcost/lstm_memcost.py with its imports
rewritten. The JAX example lists the residuals that jax saves for the
backward pass (``jax.ad_checkpoint.print_saved_residuals``); this one
counts the bytes of the tensors that autograd saves for the backward of
one training forward, through ``torch.autograd.graph.saved_tensors_hooks``,
leaving out the arguments (parameters and inputs) as the JAX example
does. ``--device`` is ``gpu`` (``gpu(0)``, with no fallback to the CPU)
or ``cpu``.

Run:  python3 examples/memcost_torch/lstm_memcost.py
Reports the bytes saved for the backward pass of a deeply unrolled LSTM
— the reference's motivating workload (§5.7) — with and without
mirroring.
"""
import argparse
import contextlib
import os
import sys

import numpy as np
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch.models import lstm_unroll  # noqa: E402


def build(seq_len, mirror):
    scope = (mx.AttrScope(force_mirroring="True") if mirror
             else contextlib.nullcontext())
    with scope:
        return lstm_unroll(
            num_lstm_layer=2, seq_len=seq_len, input_size=128,
            num_hidden=256, num_embed=128, num_label=128)


def residual_bytes(net, seq_len, batch=32, ctx=None):
    """Total bytes of activations saved for backward (what mirroring
    cuts): every distinct storage autograd packs during one training
    forward, the arguments' own left out."""
    ctx = ctx or mx.cpu()
    shapes = {"data": (batch, seq_len), "softmax_label": (batch, seq_len)}
    for layer in range(2):
        shapes["l%d_init_c" % layer] = (batch, 256)
        shapes["l%d_init_h" % layer] = (batch, 256)
    exe = net.simple_bind(ctx, grad_req="write", **shapes)
    rng = np.random.RandomState(0)
    for k, a in exe.arg_dict.items():
        if k not in shapes:
            a[:] = rng.normal(0, 0.05, a.shape)

    gidx = set(exe._grad_idx)
    vals = [a._data.detach().requires_grad_(i in gidx)
            for i, a in enumerate(exe.arg_arrays)]
    args = {v.untyped_storage().data_ptr() for v in vals}
    saved = {}

    def pack(t):
        ptr = t.untyped_storage().data_ptr()
        if ptr not in args:
            saved[ptr] = t.untyped_storage().nbytes()
        return t

    with torch.enable_grad(), \
            torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        outs, _ = exe._run(vals, exe._aux_vals(), True)
    del outs
    total = sum(saved.values())
    nseg = sum(1 for it in exe._plan if it[0] == "seg")
    return total, nseg


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--device", default="gpu", choices=["gpu", "cpu"])
    args = ap.parse_args()
    ctx = mx.gpu(0) if args.device == "gpu" else mx.cpu()

    base = None
    for mirror in (False, True):
        net = build(args.seq_len, mirror)
        total, nseg = residual_bytes(net, args.seq_len, ctx=ctx)
        if base is None:
            base = total
        if base == 0:
            raise SystemExit("no saved tensors counted")
        print("mirror=%-5s remat_segments=%-3d saved_residual_MB=%.1f (%.0f%%)"
              % (mirror, nseg, total / 1e6, 100.0 * total / base))


if __name__ == "__main__":
    main()
