"""Inception-BN: the reference's flagship ImageNet baseline network.

Two variants, matching the reference's symbol files:
- ``get_inception_bn_small`` — the 28x28 CIFAR throughput model (ref:
  example/image-classification/symbol_inception-bn-28-small.py,
  BASELINE.md row 1: 842→2943 img/s on 1→4 GTX 980);
- ``get_inception_bn`` — the full 224x224 model behind the headline
  ImageNet epoch times (ref: symbol_inception-bn.py; BASELINE.md:
  2,495 s/epoch at bs=512 on 4x Titan X, the bench.py baseline), and
  with ``num_classes=21841`` the full-ImageNet-21k config
  (symbol_inception-bn-full.py, imagenet_full.md).
Ioffe & Szegedy 2015 (arXiv:1502.03167)."""
from __future__ import annotations

from .. import symbol as sym


def _conv_factory(data, num_filter, kernel, stride=(1, 1), pad=(0, 0), name=None):
    conv = sym.Convolution(
        data=data, num_filter=num_filter, kernel=kernel, stride=stride, pad=pad,
        name="conv_%s" % name,
    )
    bn = sym.BatchNorm(data=conv, name="bn_%s" % name)
    act = sym.Activation(data=bn, act_type="relu", name="relu_%s" % name)
    return act


def _downsample_factory(data, ch_3x3, name):
    conv = _conv_factory(data, ch_3x3, (3, 3), (2, 2), (1, 1), "%s_3x3" % name)
    pool = sym.Pooling(
        data=data, kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max",
        name="max_pool_%s" % name,
    )
    concat = sym.Concat(conv, pool, num_args=2, name="concat_%s" % name)
    return concat


def _simple_factory(data, ch_1x1, ch_3x3, name):
    conv1x1 = _conv_factory(data, ch_1x1, (1, 1), (1, 1), (0, 0), "%s_1x1" % name)
    conv3x3 = _conv_factory(data, ch_3x3, (3, 3), (1, 1), (1, 1), "%s_3x3" % name)
    concat = sym.Concat(conv1x1, conv3x3, num_args=2, name="concat_%s" % name)
    return concat


def get_inception_bn_small(num_classes=10):
    data = sym.Variable("data")
    conv1 = _conv_factory(data, 96, (3, 3), (1, 1), (1, 1), "1")
    in3a = _simple_factory(conv1, 32, 32, "3a")
    in3b = _simple_factory(in3a, 32, 48, "3b")
    in3c = _downsample_factory(in3b, 80, "3c")
    in4a = _simple_factory(in3c, 112, 48, "4a")
    in4b = _simple_factory(in4a, 96, 64, "4b")
    in4c = _simple_factory(in4b, 80, 80, "4c")
    in4d = _simple_factory(in4c, 48, 96, "4d")
    in4e = _downsample_factory(in4d, 96, "4e")
    in5a = _simple_factory(in4e, 176, 160, "5a")
    in5b = _simple_factory(in5a, 176, 160, "5b")
    pool = sym.Pooling(
        data=in5b, kernel=(7, 7), stride=(1, 1), pool_type="avg", global_pool=True,
        name="global_pool",
    )
    flatten = sym.Flatten(data=pool, name="flatten1")
    fc = sym.FullyConnected(data=flatten, num_hidden=num_classes, name="fc1")
    softmax = sym.SoftmaxOutput(data=fc, name="softmax")
    return softmax


def _inception_a(data, n1x1, n3x3r, n3x3, nd3x3r, nd3x3, pool, proj, name):
    """Spatial-preserving block: four towers concatenated on channels
    (ref: symbol_inception-bn.py InceptionFactoryA)."""
    c1x1 = _conv_factory(data, n1x1, (1, 1), name="%s_1x1" % name)
    c3x3 = _conv_factory(
        _conv_factory(data, n3x3r, (1, 1), name="%s_3x3_reduce" % name),
        n3x3, (3, 3), pad=(1, 1), name="%s_3x3" % name)
    cd = _conv_factory(data, nd3x3r, (1, 1),
                       name="%s_double_3x3_reduce" % name)
    cd = _conv_factory(cd, nd3x3, (3, 3), pad=(1, 1),
                       name="%s_double_3x3_0" % name)
    cd = _conv_factory(cd, nd3x3, (3, 3), pad=(1, 1),
                       name="%s_double_3x3_1" % name)
    pooling = sym.Pooling(data=data, kernel=(3, 3), stride=(1, 1),
                          pad=(1, 1), pool_type=pool,
                          name="%s_pool_%s_pool" % (pool, name))
    cproj = _conv_factory(pooling, proj, (1, 1), name="%s_proj" % name)
    return sym.Concat(c1x1, c3x3, cd, cproj, num_args=4,
                      name="ch_concat_%s_chconcat" % name)


def _inception_b(data, n3x3r, n3x3, nd3x3r, nd3x3, name):
    """Stride-2 downsampling block: two conv towers beside a max pool
    (ref: symbol_inception-bn.py InceptionFactoryB)."""
    c3x3 = _conv_factory(
        _conv_factory(data, n3x3r, (1, 1), name="%s_3x3_reduce" % name),
        n3x3, (3, 3), stride=(2, 2), pad=(1, 1), name="%s_3x3" % name)
    cd = _conv_factory(data, nd3x3r, (1, 1),
                       name="%s_double_3x3_reduce" % name)
    cd = _conv_factory(cd, nd3x3, (3, 3), pad=(1, 1),
                       name="%s_double_3x3_0" % name)
    cd = _conv_factory(cd, nd3x3, (3, 3), stride=(2, 2), pad=(1, 1),
                       name="%s_double_3x3_1" % name)
    pooling = sym.Pooling(data=data, kernel=(3, 3), stride=(2, 2),
                          pad=(1, 1), pool_type="max",
                          name="max_pool_%s_pool" % name)
    return sym.Concat(c3x3, cd, pooling, num_args=3,
                      name="ch_concat_%s_chconcat" % name)


def get_inception_bn(num_classes=1000):
    """Full Inception-BN for 224x224 inputs (ref: symbol_inception-bn.py
    get_symbol). num_classes=21841 gives the full-ImageNet-21k variant
    (ref: symbol_inception-bn-full.py)."""
    data = sym.Variable("data")
    # stem
    conv1 = _conv_factory(data, 64, (7, 7), stride=(2, 2), pad=(3, 3),
                          name="1")
    pool1 = sym.Pooling(data=conv1, kernel=(3, 3), stride=(2, 2),
                        pool_type="max", name="pool_1")
    conv2 = _conv_factory(
        _conv_factory(pool1, 64, (1, 1), name="2_red"),
        192, (3, 3), pad=(1, 1), name="2")
    pool2 = sym.Pooling(data=conv2, kernel=(3, 3), stride=(2, 2),
                        pool_type="max", name="pool_2")
    # stage 3
    body = _inception_a(pool2, 64, 64, 64, 64, 96, "avg", 32, "3a")
    body = _inception_a(body, 64, 64, 96, 64, 96, "avg", 64, "3b")
    body = _inception_b(body, 128, 160, 64, 96, "3c")
    # stage 4
    body = _inception_a(body, 224, 64, 96, 96, 128, "avg", 128, "4a")
    body = _inception_a(body, 192, 96, 128, 96, 128, "avg", 128, "4b")
    body = _inception_a(body, 160, 128, 160, 128, 160, "avg", 128, "4c")
    body = _inception_a(body, 96, 128, 192, 160, 192, "avg", 128, "4d")
    body = _inception_b(body, 128, 192, 192, 256, "4e")
    # stage 5
    body = _inception_a(body, 352, 192, 320, 160, 224, "avg", 128, "5a")
    body = _inception_a(body, 352, 192, 320, 192, 224, "max", 128, "5b")
    pool = sym.Pooling(data=body, kernel=(7, 7), stride=(1, 1),
                       pool_type="avg", global_pool=True,
                       name="global_pool")
    flatten = sym.Flatten(data=pool, name="flatten")
    fc1 = sym.FullyConnected(data=flatten, num_hidden=num_classes,
                             name="fc1")
    return sym.SoftmaxOutput(data=fc1, name="softmax")
