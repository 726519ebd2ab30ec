"""LeNet trained with a dist_sync kvstore, one worker of a multi-process
job: the counterpart of tests/nightly/dist_lenet.py for mxnet_tpu_torch.

    python3 tools/torch_launch.py -n 2 -- \\
        python3 tests/torch_nightly/dist_lenet.py --ctx cpu

Each worker reads its rank's shard of the synthetic MNIST set
(``MNISTIter(num_parts=workers, part_index=rank)``), fits LeNet for 3
epochs through ``FeedForward.fit(kvstore=kv)`` (the store sums the
gradients of every worker and runs the optimizer, ``rescale_grad`` one
over the workers' whole batch), and must score > 0.9 on the validation
set; every worker's ``fc2_weight`` must equal rank 0's (rtol 1e-4).
``--ctx gpu`` trains on the card ``rank % device_count``.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import mxnet_tpu_torch as mx  # noqa: E402


def say(obj):
    """One JSON line in one write: the ranks share the launcher's stdout,
    and a write of under PIPE_BUF bytes to a pipe is never interleaved."""
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ctx", choices=["cpu", "gpu"], default="gpu")
    p.add_argument("--num-epochs", type=int, default=3)
    args = p.parse_args(argv)
    import torch
    import torch.distributed as dist

    kv = mx.kvstore.create("dist_sync")
    rank, nworker = kv.rank, kv.num_workers
    ctx = mx.cpu() if args.ctx == "cpu" else \
        mx.gpu(rank % torch.cuda.device_count())
    mx.random.seed(0)
    train = mx.io.MNISTIter(batch_size=50, num_synthetic=1200, seed=3,
                            num_parts=nworker, part_index=rank)
    val = mx.io.MNISTIter(batch_size=50, num_synthetic=400, seed=4,
                          shuffle=False)
    with ctx:
        model = mx.FeedForward(
            mx.models.get_lenet(), ctx=ctx, num_epoch=args.num_epochs,
            learning_rate=0.1, momentum=0.9,
            initializer=mx.initializer.Xavier())
        t0 = time.perf_counter()
        model.fit(X=train, kvstore=kv)
        fit_s = time.perf_counter() - t0
        acc = model.score(val)
    if not acc > 0.9:
        raise AssertionError("rank %d: accuracy %.3f below 0.9" % (rank, acc))
    w = model.arg_params["fc2_weight"].asnumpy()
    gathered = [None] * nworker
    dist.all_gather_object(gathered, w)
    for r in range(1, nworker):
        np.testing.assert_allclose(gathered[r], gathered[0], rtol=1e-4)
    say({"dist_lenet": {
        "rank": rank, "workers": nworker, "backend": mx.kvstore.backend(),
        "ctx": str(ctx), "accuracy": float(acc), "fit_s": fit_s,
        "weights_replicated": True}})


if __name__ == "__main__":
    main()
