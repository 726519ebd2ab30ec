"""ResNet (v1): the JAX package's ``models/resnet.py``, copied.

``get_resnet`` builds the same graph (and so the same JSON) as the JAX
package with the 7x7 ``conv7`` stem; the ``s2d`` stem needs Pad,
Reshape and transpose, which are not ported yet, and raises.
"""
from __future__ import annotations

from .. import symbol as sym
from ..base import MXNetError


def _conv_bn(data, num_filter, kernel, stride, pad, name, act=True):
    conv = sym.Convolution(
        data=data, num_filter=num_filter, kernel=kernel, stride=stride, pad=pad,
        no_bias=True, name=name + "_conv",
    )
    bn = sym.BatchNorm(data=conv, fix_gamma=False, eps=2e-5, momentum=0.9,
                       name=name + "_bn")
    if act:
        return sym.Activation(data=bn, act_type="relu", name=name + "_relu")
    return bn


def _bottleneck(data, num_filter, stride, dim_match, name):
    b1 = _conv_bn(data, num_filter // 4, (1, 1), (1, 1), (0, 0), name + "_branch2a")
    b2 = _conv_bn(b1, num_filter // 4, (3, 3), stride, (1, 1), name + "_branch2b")
    b3 = _conv_bn(b2, num_filter, (1, 1), (1, 1), (0, 0), name + "_branch2c", act=False)
    if dim_match:
        shortcut = data
    else:
        shortcut = _conv_bn(
            data, num_filter, (1, 1), stride, (0, 0), name + "_branch1", act=False
        )
    fused = b3 + shortcut
    return sym.Activation(data=fused, act_type="relu", name=name + "_relu")


def get_resnet(num_classes=1000, num_layers=50, stem="conv7", image=224):
    """ResNet-50/101/152 v1 for 224x224 input.

    stem: "conv7" = the reference's 7x7/s2 stem; "s2d" (the JAX package's
    space-to-depth stem) raises until its ops are ported. ``image`` is
    accepted for the JAX package's signature.
    """
    if stem not in ("conv7", "s2d"):
        raise ValueError("unknown stem %r (choose 'conv7' or 's2d')" % (stem,))
    if stem == "s2d":
        raise MXNetError("stem='s2d' needs Pad, Reshape and transpose, which "
                         "mxnet_tpu_torch does not port yet; use 'conv7'")
    if num_layers == 50:
        units = [3, 4, 6, 3]
    elif num_layers == 101:
        units = [3, 4, 23, 3]
    elif num_layers == 152:
        units = [3, 8, 36, 3]
    else:
        raise ValueError("unsupported num_layers %d" % num_layers)
    filters = [256, 512, 1024, 2048]

    data = sym.Variable("data")
    body = _conv_bn(data, 64, (7, 7), (2, 2), (3, 3), "conv0")
    body = sym.Pooling(
        data=body, kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max",
        name="pool0",
    )
    for stage, (n, f) in enumerate(zip(units, filters)):
        stride = (1, 1) if stage == 0 else (2, 2)
        body = _bottleneck(body, f, stride, False, "stage%d_unit1" % (stage + 1))
        for i in range(2, n + 1):
            body = _bottleneck(body, f, (1, 1), True, "stage%d_unit%d" % (stage + 1, i))
    pool = sym.Pooling(data=body, global_pool=True, kernel=(7, 7), pool_type="avg",
                       name="pool1")
    flat = sym.Flatten(data=pool)
    fc = sym.FullyConnected(data=flat, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=fc, name="softmax")


def _basic_unit(data, num_filter, dim_match, name):
    """Basic (two 3x3) residual unit for the CIFAR-size net
    (ref: example/image-classification/symbol_resnet-28-small.py
    residual_factory)."""
    stride = (1, 1) if dim_match else (2, 2)
    c1 = _conv_bn(data, num_filter, (3, 3), stride, (1, 1), name + "_a")
    c2 = _conv_bn(c1, num_filter, (3, 3), (1, 1), (1, 1), name + "_b", act=False)
    if dim_match:
        shortcut = data
    else:
        shortcut = _conv_bn(data, num_filter, (1, 1), stride, (0, 0),
                            name + "_sc", act=False)
    return sym.Activation(data=c2 + shortcut, act_type="relu", name=name + "_relu")


def get_resnet_small(num_classes=10, n=3):
    """ResNet-(6n+2) for 28x28/32x32 inputs — CIFAR baseline config
    (ref: symbol_resnet-28-small.py get_symbol; n=3 → 20 layers)."""
    data = sym.Variable("data")
    body = _conv_bn(data, 16, (3, 3), (1, 1), (1, 1), "conv0")
    for stage, f in enumerate([16, 32, 64]):
        for i in range(n):
            dim_match = not (stage > 0 and i == 0)
            body = _basic_unit(body, f, dim_match,
                               "stage%d_unit%d" % (stage + 1, i + 1))
    pool = sym.Pooling(data=body, global_pool=True, kernel=(7, 7),
                       pool_type="avg", name="pool1")
    flat = sym.Flatten(data=pool)
    fc = sym.FullyConnected(data=flat, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=fc, name="softmax")
