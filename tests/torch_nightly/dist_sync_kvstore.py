"""The dist_sync kvstore's arithmetic, run as one worker of a
multi-process job: the counterpart of tests/nightly/dist_sync_kvstore.py
for mxnet_tpu_torch.

    python3 tools/torch_launch.py -n 3 -- \\
        python3 tests/torch_nightly/dist_sync_kvstore.py --ctx cpu

Each of ``nworker`` workers pushes ``ones * (rank + 1)`` for ``nrepeat``
rounds through a ``dist_sync`` store whose optimizer is ``Test`` (weight
+= rescale_grad * grad). Every pulled value must equal

    (nworker + 1) * nworker / 2 * rate * nrepeat + 1

exactly (the sums are of small integers), on a (3, 3) key, a (1200, 1200)
key, and six keys pushed together under a 4096-byte bucket, which the
store fuses into float32 buckets (one all-reduce a bucket: the count is
printed). ``--ctx gpu`` works on the card ``rank % device_count``.
Prints the backend the store's rule chose.
"""
import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import mxnet_tpu_torch as mx  # noqa: E402

shape = (3, 3)
big_shape = (1200, 1200)
keys = ["3", "99"]
rate = 2.0
nrepeat = 4


def context(kind, rank):
    if kind == "cpu":
        return mx.cpu()
    import torch

    return mx.gpu(rank % torch.cuda.device_count())


def check(kv, key, shp, ctx, expect, what):
    out = mx.nd.zeros(shp, ctx)
    kv.pull(key, out=out)
    got = out.asnumpy()
    if not np.array_equal(got, np.full(shp, expect, np.float32)):
        raise AssertionError("rank %d %s key %s: expect %s, max err %s"
                             % (kv.rank, what, key, expect,
                                np.abs(got - expect).max()))


def say(obj):
    """One JSON line in one write: the ranks share the launcher's stdout,
    and a write of under PIPE_BUF bytes to a pipe is never interleaved."""
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ctx", choices=["cpu", "gpu"], default="gpu")
    args = p.parse_args(argv)
    kv = mx.kvstore.create("dist_sync")
    rank, nworker = kv.rank, kv.num_workers
    ctx = context(args.ctx, rank)
    kv.init(keys[0], mx.nd.ones(shape, ctx))
    kv.init(keys[1], mx.nd.ones(big_shape, ctx))
    kv.set_optimizer(mx.optimizer.create("test", rescale_grad=rate))
    kv.barrier()
    for _ in range(nrepeat):
        kv.push(keys[0], mx.nd.ones(shape, ctx) * (rank + 1))
        kv.push(keys[1], mx.nd.ones(big_shape, ctx) * (rank + 1))
    kv.barrier()
    expect = (nworker + 1) * nworker / 2 * rate * nrepeat + 1
    for key, shp in zip(keys, (shape, big_shape)):
        check(kv, key, shp, ctx, expect, "")

    # six keys in one push under a tiny bucket: several fused collectives
    # (the class's bucket size and reduce are restored afterwards, so a
    # caller in the same process keeps the store's defaults)
    cls = mx.kvstore.KVStore
    saved = cls.__dict__["_BUCKET_BYTES"], cls.__dict__["_all_reduce"]
    calls = [0]

    def counted(t):
        calls[0] += 1
        return saved[1].__func__(t)

    cls._BUCKET_BYTES = 4096
    cls._all_reduce = staticmethod(counted)
    try:
        bkeys = [str(200 + i) for i in range(6)]
        bshapes = [(17,), (33, 3), (5, 5), (1200, 40), (7,), (64, 64)]
        for k, shp in zip(bkeys, bshapes):
            kv.init(k, mx.nd.ones(shp, ctx))
        kv.barrier()
        for _ in range(nrepeat):
            kv.push(bkeys, [mx.nd.ones(shp, ctx) * (rank + 1)
                            for shp in bshapes])
        kv.barrier()
        for k, shp in zip(bkeys, bshapes):
            check(kv, k, shp, ctx, expect, "bucketed")
    finally:
        cls._BUCKET_BYTES, cls._all_reduce = saved
    say({"dist_sync_kvstore": {
        "rank": rank, "workers": nworker, "backend": mx.kvstore.backend(),
        "ctx": str(ctx), "value": expect,
        "all_reduces_per_bucketed_push": calls[0] / nrepeat}})


if __name__ == "__main__":
    main()
