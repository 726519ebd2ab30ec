"""Torch layers and criteria as first-class symbols in a training loop.

TPU-native counterpart of the reference's example/torch/
(torch_module.py: an MLP whose layers are `TorchModule` ops wrapping
torch.nn modules, trained by mxnet; torch_function.py: `mx.th.*`
imperative calls). Same here: torch.nn.Linear layers run as graph nodes
(host callbacks with torch.autograd providing the vjp), an
mxnet-native softmax head trains them, and mx.th functions operate on
NDArrays directly.

examples/torch/torch_module_mnist.py on mxnet_tpu_torch: its imports
rewritten and ``--ctx`` taking ``gpu`` (the default: ``gpu(0)``, no
fallback to the CPU) or ``cpu``. There the torch layer runs on the
graph's device with the graph's parameters, with no host bridge.

Run: python3 examples/torch_torch/torch_module_mnist.py [--ctx cpu]
"""
import argparse
import os
import sys

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import symbol as sym  # noqa: E402


def torch_mlp(hidden):
    # ONE torch layer + native head: multi-callback programs can still
    # wedge the CPU backend's runtime intermittently (see the async
    # dispatch note in mxnet_tpu/base.py); single-callback graphs are
    # stable, and one foreign layer already proves the bridge
    data = sym.Variable("data")
    h = sym.TorchModule(data, module_string="torch.nn.Linear(784, %d)" % hidden,
                        num_data=1, num_params=2, num_outputs=1, name="tfc1")
    h = sym.Activation(h, act_type="relu")
    h = sym.FullyConnected(h, num_hidden=10, name="fc2")
    return sym.SoftmaxOutput(h, name="softmax")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch-size", type=int, default=100)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--ctx", type=str, default="gpu", choices=["gpu", "cpu"])
    args = ap.parse_args()
    ctx = mx.cpu() if args.ctx == "cpu" else mx.gpu()
    with ctx:   # the example's arrays are made on the current context
        _run(args, ctx)


def _run(args, ctx):

    mx.random.seed(0)
    # mx.th imperative functions on NDArrays (torch_function.py role)
    a = mx.nd.array(np.arange(6, dtype="f").reshape(2, 3))
    assert np.allclose(mx.th.exp(a).asnumpy(), np.exp(a.asnumpy()))
    assert mx.th.mm(a, mx.nd.ones((3, 2))).shape == (2, 2)

    train = mx.io.MNISTIter(batch_size=args.batch_size, num_synthetic=2000,
                            seed=1, flat=True)
    val = mx.io.MNISTIter(batch_size=args.batch_size, num_synthetic=1000,
                          seed=2, flat=True, shuffle=False)
    model = mx.FeedForward(torch_mlp(args.hidden), ctx=ctx,
                           num_epoch=args.epochs, learning_rate=0.1,
                           momentum=0.9,
                           initializer=mx.initializer.Xavier())
    model.fit(X=train, eval_data=val)
    acc = model.score(val)
    print("val accuracy %.3f (torch.nn.Linear layers inside the graph)" % acc)
    if not os.environ.get("MXNET_EXAMPLE_SMOKE"):
        assert acc > 0.9, "torch-layer MLP failed to train"
    print("ok")


if __name__ == "__main__":
    main()
