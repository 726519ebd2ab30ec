"""U-Net encoder/decoder for dense prediction.

TPU-native counterpart of the reference's
example/image-classification/symbol_unet.R (Ronneberger et al. 2015:
contracting conv/pool path, expanding deconv path, Crop-aligned skip
concatenations, per-pixel softmax head) — the R symbol rebuilt in this
Python Symbol API with same-padding convs so input sizes divisible by
2^depth need no crops beyond identity.
"""
from __future__ import annotations

from .. import symbol as sym

__all__ = ["get_unet"]


def _double_conv(x, num_filter, name):
    for i in (1, 2):
        x = sym.Convolution(x, kernel=(3, 3), pad=(1, 1),
                            num_filter=num_filter,
                            name="%s_conv%d" % (name, i))
        x = sym.BatchNorm(x, name="%s_bn%d" % (name, i))
        x = sym.Activation(x, act_type="relu")
    return x


def get_unet(num_classes=2, base_filter=32, depth=3):
    """Returns a multi_output SoftmaxOutput over (N, num_classes, H, W).

    depth pool/unpool levels; input H, W must be divisible by 2**depth."""
    data = sym.Variable("data")
    skips = []
    x = data
    f = base_filter
    for d in range(depth):
        x = _double_conv(x, f, "enc%d" % d)
        skips.append((x, f))
        x = sym.Pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="max")
        f *= 2
    x = _double_conv(x, f, "bridge")
    for d in reversed(range(depth)):
        skip, sf = skips[d]
        x = sym.Deconvolution(x, kernel=(2, 2), stride=(2, 2), num_filter=sf,
                              no_bias=True, name="up%d" % d)
        x = sym.Concat(sym.Crop(x, skip, num_args=2, name="crop%d" % d),
                       skip, num_args=2, dim=1)
        x = _double_conv(x, sf, "dec%d" % d)
    x = sym.Convolution(x, kernel=(1, 1), num_filter=num_classes,
                        name="score")
    return sym.SoftmaxOutput(x, multi_output=True, name="softmax")
