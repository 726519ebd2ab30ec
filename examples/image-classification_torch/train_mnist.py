"""Train MLP / LeNet on MNIST — baseline config #1.

Mirrors the reference example/image-classification/train_mnist.py
(get_mlp:39, get_lenet:52, parser:84). Falls back to a
synthetic MNIST-shaped dataset when the idx files are absent (air-gapped).

On mxnet_tpu_torch: examples/image-classification/train_mnist.py with its
imports rewritten and ``--ctx`` taking ``auto`` (``gpu(0)``, with no
fallback to the CPU when there is no card), ``gpu`` or ``cpu``:

    python3 examples/image-classification_torch/train_mnist.py [--network lenet]
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
import train_model  # noqa: E402


def get_mlp():
    """Multi-layer perceptron (ref train_mnist.py:39-50)."""
    data = mx.symbol.Variable('data')
    fc1 = mx.symbol.FullyConnected(data=data, name='fc1', num_hidden=128)
    act1 = mx.symbol.Activation(data=fc1, name='relu1', act_type="relu")
    fc2 = mx.symbol.FullyConnected(data=act1, name='fc2', num_hidden=64)
    act2 = mx.symbol.Activation(data=fc2, name='relu2', act_type="relu")
    fc3 = mx.symbol.FullyConnected(data=act2, name='fc3', num_hidden=10)
    return mx.symbol.SoftmaxOutput(data=fc3, name='softmax')


def get_lenet():
    """LeNet (ref train_mnist.py:52-83)."""
    data = mx.symbol.Variable('data')
    conv1 = mx.symbol.Convolution(data=data, kernel=(5, 5), num_filter=20)
    tanh1 = mx.symbol.Activation(data=conv1, act_type="tanh")
    pool1 = mx.symbol.Pooling(data=tanh1, pool_type="max", kernel=(2, 2), stride=(2, 2))
    conv2 = mx.symbol.Convolution(data=pool1, kernel=(5, 5), num_filter=50)
    tanh2 = mx.symbol.Activation(data=conv2, act_type="tanh")
    pool2 = mx.symbol.Pooling(data=tanh2, pool_type="max", kernel=(2, 2), stride=(2, 2))
    flatten = mx.symbol.Flatten(data=pool2)
    fc1 = mx.symbol.FullyConnected(data=flatten, num_hidden=500)
    tanh3 = mx.symbol.Activation(data=fc1, act_type="tanh")
    fc2 = mx.symbol.FullyConnected(data=tanh3, num_hidden=10)
    return mx.symbol.SoftmaxOutput(data=fc2, name='softmax')


def _synthetic(flat, n_train=4096, n_val=1024):
    rng = np.random.RandomState(0)
    shape = (784,) if flat else (1, 28, 28)

    def mk(n):
        y = rng.randint(0, 10, n).astype("f")
        x = rng.rand(n, *shape).astype("f") * 0.1
        # plant a learnable class signal
        flat_x = x.reshape(n, -1)
        for i in range(n):
            flat_x[i, int(y[i]) * 8:(int(y[i]) + 1) * 8] += 1.0
        return flat_x.reshape(n, *shape), y

    return mk(n_train), mk(n_val)


def get_iterator(data_shape):
    def _impl(args, kv):
        data_dir = args.data_dir
        flat = len(data_shape) == 1
        have_real = os.path.exists(os.path.join(data_dir, "train-images-idx3-ubyte"))
        if have_real and not args.synthetic:
            train = mx.io.MNISTIter(
                image=os.path.join(data_dir, "train-images-idx3-ubyte"),
                label=os.path.join(data_dir, "train-labels-idx1-ubyte"),
                batch_size=args.batch_size, shuffle=True, flat=flat,
                num_parts=kv.num_workers, part_index=kv.rank)
            val = mx.io.MNISTIter(
                image=os.path.join(data_dir, "t10k-images-idx3-ubyte"),
                label=os.path.join(data_dir, "t10k-labels-idx1-ubyte"),
                batch_size=args.batch_size, shuffle=False, flat=flat,
                num_parts=kv.num_workers, part_index=kv.rank)
        else:
            (xt, yt), (xv, yv) = _synthetic(flat)
            args.num_examples = len(xt)
            train = mx.io.NDArrayIter(xt, yt, batch_size=args.batch_size, shuffle=True)
            val = mx.io.NDArrayIter(xv, yv, batch_size=args.batch_size)
        return (train, val)
    return _impl


def parse_args():
    parser = argparse.ArgumentParser(description='train an image classifier on mnist')
    parser.add_argument('--network', type=str, default='mlp', choices=['mlp', 'lenet'])
    parser.add_argument('--data-dir', type=str, default='mnist/')
    parser.add_argument('--synthetic', action='store_true',
                        help='force synthetic data (default when files absent)')
    parser.add_argument('--ctx', type=str, default='auto', choices=['auto', 'cpu', 'gpu'])
    parser.add_argument('--num-devices', type=int, default=1,
                        help='data-parallel device count (ref: --gpus)')
    parser.add_argument('--num-examples', type=int, default=60000)
    parser.add_argument('--batch-size', type=int, default=128)
    parser.add_argument('--lr', type=float, default=0.1)
    parser.add_argument('--lr-factor', type=float, default=None)
    parser.add_argument('--lr-factor-epoch', type=float, default=1)
    parser.add_argument('--model-prefix', type=str, default=None)
    parser.add_argument('--load-epoch', type=int, default=None)
    parser.add_argument('--num-epochs', type=int, default=10)
    parser.add_argument('--kv-store', type=str, default='local')
    return parser.parse_args()


if __name__ == '__main__':
    args = parse_args()
    if args.network == 'mlp':
        data_shape = (784,)
        net = get_mlp()
    else:
        data_shape = (1, 28, 28)
        net = get_lenet()
    train_model.fit(args, net, get_iterator(data_shape))
