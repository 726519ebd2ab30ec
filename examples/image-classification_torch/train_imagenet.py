"""Train ResNet-50 / Inception-BN on ImageNet — baseline config #2.

Mirrors the reference example/image-classification/train_imagenet.py:
network from symbol_resnet.py / symbol_inception-bn.py, data via
ImageRecordIter over RecordIO packs (tools/im2rec.py), kvstore per
README.md:150-176. Synthetic fallback generates ImageNet-shaped batches.

On mxnet_tpu_torch: examples/image-classification/train_imagenet.py with its
imports rewritten and ``--ctx`` taking ``auto`` (``gpu(0)``, with no
fallback to the CPU when there is no card), ``gpu`` or ``cpu``. It reads
``train.rec`` (and ``val.rec``) in ``--data-dir``, packed with
tools/torch_im2rec.py, through ``ImageRecordIter`` and ``PrefetchingIter``;
without them, or with ``--synthetic``, it makes seeded batches:

    python3 tools/torch_im2rec.py --list --recursive imagenet/train <image folder>
    python3 tools/torch_im2rec.py --resize 256 imagenet/train <image folder>
    python3 examples/image-classification_torch/train_imagenet.py --data-dir imagenet/
    python3 examples/image-classification_torch/train_imagenet.py --synthetic [--network inception-bn]
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
    n = 2048
    x = rng.rand(n, 3, 224, 224).astype("f")
    y = rng.randint(0, args.num_classes, n).astype("f")
    args.num_examples = n
    return (mx.io.NDArrayIter(x, y, batch_size=args.batch_size, shuffle=True),
            None)


def get_iterator(args, kv):
    train_rec = os.path.join(args.data_dir, "train.rec")
    if not os.path.exists(train_rec) or args.synthetic:
        return _synthetic(args)
    data_shape = (3, 224, 224)
    train = mx.io.ImageRecordIter(
        path_imgrec=train_rec, mean_r=123.68, mean_g=116.779, mean_b=103.939,
        data_shape=data_shape, batch_size=args.batch_size,
        rand_crop=True, rand_mirror=True,
        random_h=36, random_s=50, random_l=50,
        num_parts=kv.num_workers, part_index=kv.rank)
    # overlap decode/augment with device compute: the pipeline runs on a
    # background thread while the accelerator steps (the reference's
    # PrefetcherIter role, iter_prefetcher.h; measured necessary on this
    # host — full augmentation costs ~3.5 ms/img/core, tools/bench_io.py)
    train = mx.io.PrefetchingIter(train)
    val_rec = os.path.join(args.data_dir, "val.rec")
    val = None
    if os.path.exists(val_rec):
        val = mx.io.ImageRecordIter(
            path_imgrec=val_rec, mean_r=123.68, mean_g=116.779, mean_b=103.939,
            data_shape=data_shape, batch_size=args.batch_size,
            num_parts=kv.num_workers, part_index=kv.rank)
    return (train, val)


def parse_args():
    parser = argparse.ArgumentParser(description='train an image classifier on imagenet')
    parser.add_argument('--network', type=str, default='resnet',
                        choices=['resnet', 'resnet-101', 'resnet-152',
                                 'inception-bn'])
    parser.add_argument('--data-dir', type=str, default='imagenet/')
    parser.add_argument('--synthetic', action='store_true')
    parser.add_argument('--ctx', type=str, default='auto', choices=['auto', 'cpu', 'gpu'])
    parser.add_argument('--num-devices', type=int, default=1)
    parser.add_argument('--num-classes', type=int, default=1000)
    parser.add_argument('--num-examples', type=int, default=1281167)
    parser.add_argument('--batch-size', type=int, default=256)
    parser.add_argument('--lr', type=float, default=0.1)
    parser.add_argument('--lr-factor', type=float, default=0.1)
    parser.add_argument('--lr-factor-epoch', type=float, default=30)
    parser.add_argument('--model-prefix', type=str, default=None)
    parser.add_argument('--load-epoch', type=int, default=None)
    parser.add_argument('--num-epochs', type=int, default=90)
    parser.add_argument('--kv-store', type=str, default='device')
    return parser.parse_args()


if __name__ == '__main__':
    args = parse_args()
    if args.network == 'inception-bn':
        # the reference's flagship baseline net (symbol_inception-bn.py);
        # --num-classes 21841 gives the full-ImageNet-21k config
        # (symbol_inception-bn-full.py, imagenet_full.md)
        from mxnet_tpu_torch.models import get_inception_bn
        net = get_inception_bn(num_classes=args.num_classes)
    else:
        from mxnet_tpu_torch.models import get_resnet
        layers = {'resnet': 50, 'resnet-101': 101,
                  'resnet-152': 152}[args.network]
        net = get_resnet(num_classes=args.num_classes, num_layers=layers)
    train_model.fit(args, net, get_iterator)
