"""ResNet (v1) — baseline config 2, the bench.py flagship
(ref: example/image-classification/symbol_resnet.py; arch per He et al.).
Built bf16-friendly: BN statistics in f32; conv accumulation follows the
backend default (f32 on TPU MXU).
"""
from __future__ import annotations

from .. import symbol as sym


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


def _s2d_stem(data, name="conv0", image=224):
    """Space-to-depth stem: the 7x7/s2/p3 stem conv re-expressed as a
    dense 4x4/s1 conv over a 2x2-packed input. The 7x7 conv on C=3 wastes
    MXU lanes (3/128 input channels) and halves systolic utilization with
    its stride; packing 2x2 spatial blocks into channels yields an
    equivalent conv with C=12, stride 1 (the MLPerf-TPU ResNet trick).
    Exact arithmetic equivalence to the 7x7 form holds under the weight
    fold in ``fold_stem_weights`` (tested in test_models.py).

    Pipeline: Pad(3) -> [N,3,230,230] -> s2d pack -> [N,12,115,115]
    -> Convolution(4x4, stride 1, valid) -> [N,64,112,112].
    """
    if image % 2 != 0:
        raise ValueError("s2d stem requires an even image size, got %d" % image)
    h = (image + 6) // 2  # padded size / 2
    x = sym.Pad(data=data, mode="constant",
                pad_width=(0, 0, 0, 0, 3, 3, 3, 3), name=name + "_pad")
    # [N,3,2h,2h] -> [N,3,h,2,h,2] -> [N,3,2,2,h,h] -> [N,12,h,h]
    x = sym.Reshape(data=x, shape=(0, 0, h, 2, h, 2),
                    name=name + "_s2d_split")
    x = sym.transpose(data=x, axes=(0, 1, 3, 5, 2, 4), name=name + "_s2d_t")
    x = sym.Reshape(data=x, shape=(0, 12, h, h), name=name + "_s2d_merge")
    return sym.Convolution(
        data=x, num_filter=64, kernel=(4, 4), stride=(1, 1), pad=(0, 0),
        no_bias=True, name=name + "_conv")


def fold_stem_weights(w7):
    """Fold a [64,3,7,7] stem-conv weight into the [64,12,4,4] weight of
    the s2d stem (see _s2d_stem): W4[co,(ci,p,q),da,db] = W7[co,ci,2da+p,2db+q]
    with taps beyond 6 zero. Accepts/returns numpy arrays."""
    import numpy as np

    co = w7.shape[0]
    w8 = np.zeros((co, 3, 8, 8), w7.dtype)
    w8[:, :, :7, :7] = w7
    # [co,ci,da,p,db,q] <- w8[co,ci,2da+p,2db+q]
    w6 = w8.reshape(co, 3, 4, 2, 4, 2)
    # target channel order (ci,p,q) must match the s2d pack's
    # [N, ci, p, q, u, v] -> [N, ci*4+2p+q, u, v] merge
    return np.ascontiguousarray(
        w6.transpose(0, 1, 3, 5, 2, 4).reshape(co, 12, 4, 4))


def get_resnet(num_classes=1000, num_layers=50, stem="conv7", image=224):
    """ResNet-50/101/152 v1 for 224x224 input.

    stem: "conv7" = the reference's 7x7/s2 stem; "s2d" = the arithmetically
    equivalent space-to-depth stem (TPU fast path, see _s2d_stem).
    """
    if stem not in ("conv7", "s2d"):
        raise ValueError("unknown stem %r (choose 'conv7' or 's2d')" % (stem,))
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
    if stem == "s2d":
        conv = _s2d_stem(data, "conv0", image=image)
        bn = sym.BatchNorm(data=conv, fix_gamma=False, eps=2e-5, momentum=0.9,
                           name="conv0_bn")
        body = sym.Activation(data=bn, act_type="relu", name="conv0_relu")
    else:
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
