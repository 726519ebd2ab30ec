"""Train Inception-BN-28-small / ResNet on CIFAR-10 — the reference's
CIFAR throughput config (example/image-classification/train_cifar10.py;
baseline 842→2943 img/s on 1→4 GTX 980, README.md:206).

Data: RecordIO packs made by tools/im2rec.py (cifar/train.rec), or
synthetic 32x32 data when absent.

On mxnet_tpu_torch: examples/image-classification/train_cifar10.py with its
imports rewritten and ``--ctx`` taking ``auto`` (``gpu(0)``, with no
fallback to the CPU when there is no card), ``gpu`` or ``cpu``. Its
RecordIO branch reads ``train.rec``, ``test.rec`` and ``mean.bin`` in
``--data-dir`` (packs made with tools/torch_im2rec.py):

    python3 examples/image-classification_torch/train_cifar10.py --synthetic
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


def _synthetic(args):
    rng = np.random.RandomState(0)

    def mk(n):
        y = rng.randint(0, 10, n).astype("f")
        x = rng.rand(n, 3, 28, 28).astype("f") * 0.1
        for i in range(n):
            x[i, 0, int(y[i]) * 2:(int(y[i]) + 1) * 2, :] += 1.0
        return x, y

    xt, yt = mk(4096)
    xv, yv = mk(1024)
    args.num_examples = len(xt)
    return (mx.io.NDArrayIter(xt, yt, batch_size=args.batch_size, shuffle=True),
            mx.io.NDArrayIter(xv, yv, batch_size=args.batch_size))


def get_iterator(args, kv):
    train_rec = os.path.join(args.data_dir, "train.rec")
    if not os.path.exists(train_rec) or args.synthetic:
        return _synthetic(args)
    data_shape = (3, 28, 28)
    train = mx.io.ImageRecordIter(
        path_imgrec=train_rec, mean_img=os.path.join(args.data_dir, "mean.bin"),
        data_shape=data_shape, batch_size=args.batch_size,
        rand_crop=True, rand_mirror=True,
        num_parts=kv.num_workers, part_index=kv.rank)
    val = mx.io.ImageRecordIter(
        path_imgrec=os.path.join(args.data_dir, "test.rec"),
        mean_img=os.path.join(args.data_dir, "mean.bin"),
        data_shape=data_shape, batch_size=args.batch_size,
        num_parts=kv.num_workers, part_index=kv.rank)
    return (train, val)


def parse_args():
    parser = argparse.ArgumentParser(description='train an image classifier on cifar10')
    parser.add_argument('--network', type=str, default='inception-bn-28-small',
                        choices=['inception-bn-28-small', 'resnet-28-small'])
    parser.add_argument('--data-dir', type=str, default='cifar10/')
    parser.add_argument('--synthetic', action='store_true')
    parser.add_argument('--ctx', type=str, default='auto', choices=['auto', 'cpu', 'gpu'])
    parser.add_argument('--num-devices', type=int, default=1)
    parser.add_argument('--num-examples', type=int, default=60000)
    parser.add_argument('--batch-size', type=int, default=128)
    parser.add_argument('--lr', type=float, default=0.05)
    parser.add_argument('--lr-factor', type=float, default=None)
    parser.add_argument('--lr-factor-epoch', type=float, default=1)
    parser.add_argument('--model-prefix', type=str, default=None)
    parser.add_argument('--load-epoch', type=int, default=None)
    parser.add_argument('--num-epochs', type=int, default=10)
    parser.add_argument('--kv-store', type=str, default='local')
    parser.add_argument('--mirror', action='store_true',
                        help='recompute cheap activations in the backward '
                        'to cut activation memory (the reference\'s '
                        'train_cifar10_mirroring.py memonger config; '
                        'sets MXNET_BACKWARD_DO_MIRROR=1)')
    return parser.parse_args()


if __name__ == '__main__':
    args = parse_args()
    if args.mirror:
        os.environ['MXNET_BACKWARD_DO_MIRROR'] = '1'
    if args.network == 'resnet-28-small':
        from mxnet_tpu_torch.models.resnet import get_resnet_small
        net = get_resnet_small(num_classes=10, n=3)
    else:
        from mxnet_tpu_torch.models import get_inception_bn_small
        net = get_inception_bn_small(num_classes=10)
    train_model.fit(args, net, get_iterator)
