"""Neural-network layer ops: the subset LeNet, ResNet, the bucketing
graphs of the Module tests and the recurrent model zoo run.

Counterpart of ``mxnet_tpu/ops/nn.py``: ``Activation`` (:57),
``FullyConnected`` (:148), ``Convolution`` (:230), ``Pooling`` (:403),
``BatchNorm`` (:555), ``Dropout`` (:664), ``Embedding`` (:684),
``Reshape`` (:713), ``Flatten`` (:773), ``Concat`` (:786),
``SliceChannel`` (:836), ``SwapAxis`` (:905), ``SoftmaxActivation``
(:929; ``instance`` over each sample flattened, ``channel`` over axis 1)
and ``Pad`` (:946), with
the same parameter
fields, defaults, inputs, outputs, aux states and shape inference
(copied; ``Reshape``'s target shape too), so graphs serialise to the
same JSON. ``Reshape``, ``SliceChannel`` and ``SwapAxis`` may return
views: the executor's graph is functional and autograd handles them.
``Dropout`` draws its mask with the JAX op's bits: ``bernoulli(key, 1 -
p, x.shape)`` of :mod:`..threefry` under the node's key, and ``x / (1 -
p)`` where it keeps. The forwards are torch: the
convolution is ``F.conv*d`` and the FC product ``torch.matmul``, as the
JAX package leaves them to XLA outside any Pallas kernel. Gradients come
from autograd, and BatchNorm's training-mode normalisation is a
``torch.autograd.Function`` carrying the JAX package's custom backward
formula.

Semantics kept from the JAX package where torch's own ops differ:

- ``Pooling``: ``avg`` divides by the full kernel area, padding
  included; ``pooling_convention="full"`` (ceil output size) pads the
  high side so every window is whole, with -inf for ``max`` and 0
  otherwise, rather than torch's ``ceil_mode``, which shrinks the
  divisor of overhanging windows.
- ``Pad``: ``pad_width`` lists (before, after) pairs from the first
  axis to the last, as ``jnp.pad`` takes them; ``F.pad`` takes them
  from the last axis back, and pads only trailing axes of 3-5-D inputs
  in its ``replicate``/``reflect`` modes, so ``edge`` and ``reflect``
  (numpy's: the end element is not repeated) gather each padded axis
  by index instead.
- ``BatchNorm``: statistics in f32 with the biased variance
  ``max(E[x^2] - E[x]^2, 0)``; moving stats update as
  ``moving * momentum + stat * (1 - momentum)`` (torch's running stats
  use the unbiased variance and the opposite momentum);
  ``fix_gamma`` uses ones for gamma and gives it no gradient.

Not carried over: the env knobs ``MXNET_BN_STATS_SAMPLE`` and
``MXNET_BN_AUTODIFF``, and the JAX package's other layers (a later
slice).
"""
from __future__ import annotations

import math

import numpy as _np
import torch
import torch.nn.functional as F

from .. import threefry
from ..base import MXNetError
from .registry import Field, OpDef, register


def _pair(v, n=2):
    v = tuple(v) if isinstance(v, (tuple, list)) else (v,)
    if len(v) == 1:
        v = v * n
    return v


# -- Activation ----------------------------------------------------------------
_ACTS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": lambda x: torch.log1p(torch.exp(-torch.abs(x)))
    + torch.clamp(x, min=0),
}


def _activation_fwd(params, inputs, aux, is_train, rng):
    return [_ACTS[params["act_type"]](inputs[0])], []


register(
    OpDef(
        "Activation",
        _activation_fwd,
        params={"act_type": Field("str", required=True, enum=list(_ACTS))},
    )
)


# -- FullyConnected ------------------------------------------------------------
def _fc_fwd(params, inputs, aux, is_train, rng):
    data, w = inputs[0], inputs[1]
    x = data.reshape(data.shape[0], -1)
    out = torch.matmul(x, w.to(x.dtype).t())
    if not params["no_bias"]:
        out = out + inputs[2].to(out.dtype)
    return [out], []


def _fc_args(params):
    return ["data", "weight"] if params.get("no_bias") else ["data", "weight", "bias"]


def _fc_shape(params, in_shapes):
    if in_shapes[0] is None:
        raise MXNetError("FullyConnected: data shape unknown")
    n = in_shapes[0][0]
    flat = int(_np.prod(in_shapes[0][1:]))
    nh = params["num_hidden"]
    ins = [in_shapes[0], (nh, flat)] + ([] if params["no_bias"] else [(nh,)])
    return ins, [(n, nh)], []


register(
    OpDef(
        "FullyConnected",
        _fc_fwd,
        params={
            "num_hidden": Field("int", required=True),
            "no_bias": Field("bool", default=False),
        },
        arguments=_fc_args,
        infer_shape=_fc_shape,
    )
)


# -- Convolution ---------------------------------------------------------------
_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _conv_fwd(params, inputs, aux, is_train, rng):
    data, weight = inputs[0], inputs[1]
    # the output follows data's dtype, as in the JAX op
    if weight.dtype != data.dtype:
        weight = weight.to(data.dtype)
    nsp = data.dim() - 2
    stride = _pair(params["stride"] or (1,) * nsp, nsp)
    pad = _pair(params["pad"] or (0,) * nsp, nsp)
    dilate = _pair(params["dilate"] or (1,) * nsp, nsp)
    bias = None if params["no_bias"] else inputs[2].to(data.dtype)
    out = _CONV[nsp](data, weight, bias, stride=stride, padding=pad,
                     dilation=dilate, groups=params["num_group"])
    return [out], []


def _conv_out_dim(d, p, k, dil, s):
    return (d + 2 * p - (dil * (k - 1) + 1)) // s + 1


def _conv_shape(params, in_shapes):
    if in_shapes[0] is None:
        raise MXNetError("Convolution: data shape unknown")
    dshape = in_shapes[0]
    nsp = len(dshape) - 2
    k = _pair(params["kernel"], nsp)
    stride = _pair(params["stride"] or (1,) * nsp, nsp)
    pad = _pair(params["pad"] or (0,) * nsp, nsp)
    dilate = _pair(params["dilate"] or (1,) * nsp, nsp)
    nf, ng = params["num_filter"], params["num_group"]
    wshape = (nf, dshape[1] // ng) + k
    out_sp = tuple(
        _conv_out_dim(dshape[2 + i], pad[i], k[i], dilate[i], stride[i])
        for i in range(nsp)
    )
    oshape = (dshape[0], nf) + out_sp
    ins = [dshape, wshape] + ([] if params["no_bias"] else [(nf,)])
    return ins, [oshape], []


_CONV_PARAMS = {
    "kernel": Field("shape", required=True),
    "stride": Field("shape", default=None),
    "dilate": Field("shape", default=None),
    "pad": Field("shape", default=None),
    "num_filter": Field("int", required=True),
    "num_group": Field("int", default=1),
    "workspace": Field("int", default=1024),  # accepted & ignored
    "no_bias": Field("bool", default=False),
    "cudnn_tune": Field("any", default=None),  # accepted & ignored
    "cudnn_off": Field("bool", default=False),
}

register(
    OpDef(
        "Convolution",
        _conv_fwd,
        params=dict(_CONV_PARAMS),
        arguments=_fc_args,
        infer_shape=_conv_shape,
    )
)


# -- Pooling -------------------------------------------------------------------
_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _pool_fwd(params, inputs, aux, is_train, rng):
    x = inputs[0]
    nsp = x.dim() - 2
    pt = params["pool_type"]
    if params["global_pool"]:
        dims = tuple(range(2, x.dim()))
        if pt == "max":
            return [x.amax(dim=dims, keepdim=True)], []
        out = x.sum(dim=dims, keepdim=True)
        if pt == "avg":
            out = out / float(_np.prod(x.shape[2:]))
        return [out], []
    k = _pair(params["kernel"], nsp)
    stride = _pair(params["stride"] or (1,) * nsp, nsp)
    pad = _pair(params["pad"] or (0,) * nsp, nsp)
    # 'full' convention (ceil output dims): extra high-side padding so
    # the floor formula of an unpadded pool hits the ceil size
    hi_pad = list(pad)
    if params["pooling_convention"] == "full":
        for i in range(nsp):
            out_d = _pool_out_dim(x.shape[2 + i], pad[i], k[i], stride[i], "full")
            need = (out_d - 1) * stride[i] + k[i] - (x.shape[2 + i] + 2 * pad[i])
            hi_pad[i] = pad[i] + max(0, need)
    native = tuple(hi_pad) == tuple(pad) and all(
        p <= kk // 2 for p, kk in zip(pad, k))
    if pt == "max":
        if native:   # torch pads with -inf itself
            return [_MAX_POOL[nsp](x, k, stride, pad)], []
        x = F.pad(x, _pad_arg(pad, hi_pad), value=-math.inf)
        return [_MAX_POOL[nsp](x, k, stride)], []
    # avg/sum: zero padding counted in the window, divisor the full area
    if not native:
        x = F.pad(x, _pad_arg(pad, hi_pad))
        pad = (0,) * nsp
    out = _AVG_POOL[nsp](x, k, stride, pad, count_include_pad=True)
    if pt == "sum":
        out = out * float(_np.prod(k))
    return [out], []


def _pad_arg(pad, hi_pad):
    """F.pad's argument: (lo, hi) pairs from the last axis back."""
    out = []
    for lo, hi in reversed(list(zip(pad, hi_pad))):
        out += [lo, hi]
    return out


def _pool_out_dim(d, p, k, s, convention):
    if convention == "full":
        return 1 + int(math.ceil((d + 2 * p - k) / float(s)))
    return 1 + (d + 2 * p - k) // s


def _pool_shape(params, in_shapes):
    if in_shapes[0] is None:
        raise MXNetError("Pooling: data shape unknown")
    dshape = in_shapes[0]
    nsp = len(dshape) - 2
    if params["global_pool"]:
        oshape = dshape[:2] + (1,) * nsp
        return [dshape], [oshape], []
    k = _pair(params["kernel"], nsp)
    stride = _pair(params["stride"] or (1,) * nsp, nsp)
    pad = _pair(params["pad"] or (0,) * nsp, nsp)
    out_sp = tuple(
        _pool_out_dim(dshape[2 + i], pad[i], k[i], stride[i], params["pooling_convention"])
        for i in range(nsp)
    )
    return [dshape], [dshape[:2] + out_sp], []


register(
    OpDef(
        "Pooling",
        _pool_fwd,
        params={
            "kernel": Field("shape", required=True),
            "pool_type": Field("str", required=True, enum=["max", "avg", "sum"]),
            "global_pool": Field("bool", default=False),
            "pooling_convention": Field("str", default="valid", enum=["valid", "full"]),
            "stride": Field("shape", default=None),
            "pad": Field("shape", default=None),
        },
        infer_shape=_pool_shape,
    )
)


# -- BatchNorm -----------------------------------------------------------------
def _bn_norm_fwd_impl(x, gamma, beta, eps, axes, bshape):
    """y, batch mean, biased batch variance and rsqrt(var + eps), in
    f32 with y cast to x's dtype: E[x^2] - E[x]^2 (one read for both
    sums), clamped at 0 where cancellation leaves a small negative."""
    x32 = x.float()
    mean = x32.mean(dim=axes)
    sqmean = x32.square().mean(dim=axes)
    var = torch.clamp(sqmean - mean.square(), min=0.0)
    inv = torch.rsqrt(var.reshape(bshape) + eps)
    y32 = (x32 - mean.reshape(bshape)) * inv
    y = (y32 * gamma.reshape(bshape) + beta.reshape(bshape)).to(x.dtype)
    return y, mean, var, inv


class _BNTrainNorm(torch.autograd.Function):
    """Training-mode normalisation with the JAX package's backward
    (``_bn_train_norm_bwd``, the reference's BatchNormBackward in the
    two-reduction form). It saves the activation in its own dtype and
    per-channel f32 stats, rather than autograd's full-size f32
    intermediates, and recomputes x_hat in the backward."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, axes, bshape):
        y, mean, var, inv = _bn_norm_fwd_impl(x, gamma, beta, eps, axes, bshape)
        ctx.save_for_backward(x, mean, inv, gamma)
        ctx.axes, ctx.bshape = axes, bshape
        ctx.set_materialize_grads(False)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, dmean_ct, dvar_ct):
        x, mean, inv, gamma = ctx.saved_tensors
        axes, bshape = ctx.axes, ctx.bshape
        n = 1.0
        for a in axes:
            n *= x.shape[a]
        x32 = x.float()
        xc = x32 - mean.reshape(bshape)
        if dy is None:
            dx32 = torch.zeros_like(x32)
            dgamma = torch.zeros_like(gamma)
            dbeta = torch.zeros_like(gamma)
        else:
            dy32 = dy.float()
            xhat = xc * inv
            dbeta = dy32.sum(dim=axes)
            dgamma = (dy32 * xhat).sum(dim=axes)
            g = gamma.reshape(bshape) * inv
            dx32 = g * (dy32 - (xhat * dgamma.reshape(bshape)
                                + dbeta.reshape(bshape)) / n)
        # cotangents of the mean/var outputs: none in the training path
        # (the moving-average update detaches them), exact otherwise
        if dmean_ct is not None:
            dx32 = dx32 + dmean_ct.reshape(bshape) / n
        if dvar_ct is not None:
            dx32 = dx32 + 2.0 * xc * dvar_ct.reshape(bshape) / n
        return dx32.to(x.dtype), dgamma, dbeta, None, None, None


def _bn_fwd(params, inputs, aux, is_train, rng):
    data, gamma, beta = inputs
    moving_mean, moving_var = aux
    eps, momentum = params["eps"], params["momentum"]
    if params["fix_gamma"]:
        gamma = torch.ones_like(gamma.detach())
    axes = (0,) + tuple(range(2, data.dim()))
    bshape = (1, -1) + (1,) * (data.dim() - 2)
    if is_train and not params["use_global_stats"]:
        out, mean, var = _BNTrainNorm.apply(
            data, gamma.float(), beta.float(), eps, axes, bshape)
        new_mm = moving_mean * momentum + mean.detach() * (1 - momentum)
        new_mv = moving_var * momentum + var.detach() * (1 - momentum)
        return [out], [new_mm, new_mv]
    mean = moving_mean.detach().float()
    var = moving_var.detach().float()
    inv = torch.rsqrt(var.reshape(bshape) + eps)
    out = (data.float() - mean.reshape(bshape)) * inv
    out = out * gamma.float().reshape(bshape) + beta.float().reshape(bshape)
    return [out.to(data.dtype)], [moving_mean, moving_var]


def _bn_shape(params, in_shapes):
    if in_shapes[0] is None:
        raise MXNetError("BatchNorm: data shape unknown")
    c = (in_shapes[0][1],)
    return [in_shapes[0], c, c], [in_shapes[0]], [c, c]


def _bn_init_aux(params, aux_shapes):
    return [_np.zeros(aux_shapes[0], _np.float32), _np.ones(aux_shapes[1], _np.float32)]


register(
    OpDef(
        "BatchNorm",
        _bn_fwd,
        params={
            "eps": Field("float", default=1e-3),
            "momentum": Field("float", default=0.9),
            "fix_gamma": Field("bool", default=True),
            "use_global_stats": Field("bool", default=False),
        },
        arguments=("data", "gamma", "beta"),
        aux=("moving_mean", "moving_var"),
        infer_shape=_bn_shape,
        init_aux=_bn_init_aux,
    )
)


# -- Embedding -----------------------------------------------------------------
def _embedding_fwd(params, inputs, aux, is_train, rng):
    data, weight = inputs
    # float indices truncate toward zero, as the JAX package's astype
    return [F.embedding(data.to(torch.int64), weight)], []


def _embedding_shape(params, in_shapes):
    if in_shapes[0] is None:
        raise MXNetError("Embedding: data shape unknown")
    d, o = params["input_dim"], params["output_dim"]
    return [in_shapes[0], (d, o)], [tuple(in_shapes[0]) + (o,)], []


register(
    OpDef(
        "Embedding",
        _embedding_fwd,
        params={
            "input_dim": Field("int", required=True),
            "output_dim": Field("int", required=True),
        },
        arguments=("data", "weight"),
        infer_shape=_embedding_shape,
    )
)


# -- Flatten -------------------------------------------------------------------
def _flatten_fwd(params, inputs, aux, is_train, rng):
    x = inputs[0]
    return [x.reshape(x.shape[0], -1)], []


register(
    OpDef(
        "Flatten",
        _flatten_fwd,
        infer_shape=lambda p, s: (
            [s[0]],
            [(s[0][0], int(_np.prod(s[0][1:])))],
            [],
        ),
    )
)


# -- Dropout -------------------------------------------------------------------
def _dropout_fwd(params, inputs, aux, is_train, rng):
    x = inputs[0]
    p = params["p"]
    if not is_train or p <= 0.0:
        return [x], []
    keep = 1.0 - p
    mask = threefry.bernoulli(rng, keep, x.shape)
    # a true division by a device tensor: torch turns the division of a
    # CUDA tensor by a Python number into a product with its reciprocal,
    # whose bits differ from the JAX op's x / keep
    keep_t = torch.tensor(keep, dtype=x.dtype, device=x.device)
    return [torch.where(mask, x / keep_t, torch.zeros_like(x))], []


register(
    OpDef(
        "Dropout",
        _dropout_fwd,
        params={"p": Field("float", default=0.5)},
        need_rng=True,
    )
)


# -- Reshape -------------------------------------------------------------------
def _target_shape(params, in_shape):
    shape = params.get("shape") or ()
    if not shape and params.get("target_shape"):
        # legacy target_shape: (0, d1, d2, ...) with 0 = batch passthrough
        tgt = list(params["target_shape"])
        if tgt and tgt[0] == 0:
            tgt[0] = in_shape[0]
        return tuple(tgt)
    src = list(in_shape)
    if params.get("reverse"):
        src = src[::-1]
        shape = tuple(reversed(shape))
    out = []
    src_i = 0
    neg = -1
    for s in shape:
        if s == 0:  # copy corresponding input dim
            out.append(src[src_i])
            src_i += 1
        elif s == -1:
            neg = len(out)
            out.append(-1)
            src_i += 1
        else:
            out.append(s)
            src_i += 1
    total = int(_np.prod(in_shape))
    if neg >= 0:
        known = int(_np.prod([d for d in out if d != -1])) or 1
        out[neg] = total // known
    if params.get("reverse"):
        out = out[::-1]
    return tuple(out)


def _reshape_fwd(params, inputs, aux, is_train, rng):
    return [inputs[0].reshape(_target_shape(params, inputs[0].shape))], []


register(
    OpDef(
        "Reshape",
        _reshape_fwd,
        params={
            "shape": Field("shape", default=()),
            "target_shape": Field("shape", default=()),
            "keep_highest": Field("bool", default=False),
            "reverse": Field("bool", default=False),
        },
        infer_shape=lambda p, s: ([s[0]], [_target_shape(p, s[0])], []),
    )
)


# -- Concat --------------------------------------------------------------------
def _concat_fwd(params, inputs, aux, is_train, rng):
    return [torch.cat(list(inputs), dim=params["dim"])], []


def _concat_shape(params, in_shapes):
    known = [s for s in in_shapes if s is not None]
    if not known:
        raise MXNetError("Concat: no input shape known")
    dim = params["dim"]
    out = list(known[0])
    out[dim] = sum(s[dim] for s in known)
    if len(known) != len(in_shapes):
        raise MXNetError("Concat: all input shapes must be known")
    return list(in_shapes), [tuple(out)], []


register(
    OpDef(
        "Concat",
        _concat_fwd,
        params={
            "num_args": Field("int", required=True),
            "dim": Field("int", default=1),
        },
        key_var_num_args="num_args",
        infer_shape=_concat_shape,
    )
)


# -- SliceChannel --------------------------------------------------------------
def _slice_channel_fwd(params, inputs, aux, is_train, rng):
    x = inputs[0]
    n = params["num_outputs"]
    axis = params["axis"]
    if x.shape[axis] % n:
        raise MXNetError("SliceChannel: axis %d size %d not divisible by %d"
                         % (axis, x.shape[axis], n))
    outs = torch.split(x, x.shape[axis] // n, dim=axis)
    if params["squeeze_axis"]:
        outs = [o.squeeze(axis) for o in outs]
    return list(outs), []


def _slice_channel_shape(params, in_shapes):
    if in_shapes[0] is None:
        raise MXNetError("SliceChannel: data shape unknown")
    n, axis = params["num_outputs"], params["axis"]
    s = list(in_shapes[0])
    if s[axis] % n != 0:
        raise MXNetError("SliceChannel: axis %d size %d not divisible by %d" % (axis, s[axis], n))
    s[axis] //= n
    if params["squeeze_axis"] and s[axis] == 1:
        s = s[:axis] + s[axis + 1:]
    return [in_shapes[0]], [tuple(s)] * n, []


register(
    OpDef(
        "SliceChannel",
        _slice_channel_fwd,
        params={
            "num_outputs": Field("int", required=True),
            "axis": Field("int", default=1),
            "squeeze_axis": Field("bool", default=False),
        },
        outputs=lambda p: ["output%d" % i for i in range(p.get("num_outputs") or 1)],
        infer_shape=_slice_channel_shape,
    )
)


# -- SwapAxis ------------------------------------------------------------------
def _swapaxis_fwd(params, inputs, aux, is_train, rng):
    return [torch.swapaxes(inputs[0], params["dim1"], params["dim2"])], []


def _swapaxis_shape(params, in_shapes):
    if in_shapes[0] is None:
        raise MXNetError("SwapAxis: data shape unknown")
    s = list(in_shapes[0])
    d1, d2 = params["dim1"], params["dim2"]
    s[d1], s[d2] = s[d2], s[d1]
    return [in_shapes[0]], [tuple(s)], []


register(
    OpDef(
        "SwapAxis",
        _swapaxis_fwd,
        params={"dim1": Field("int", default=0), "dim2": Field("int", default=0)},
        infer_shape=_swapaxis_shape,
    )
)


# -- SoftmaxActivation ---------------------------------------------------------
def _softmax_act_fwd(params, inputs, aux, is_train, rng):
    x = inputs[0]
    if params["mode"] == "channel":
        return [torch.softmax(x, dim=1)], []
    n = x.shape[0]
    return [torch.softmax(x.reshape(n, -1), dim=-1).reshape(x.shape)], []


register(
    OpDef(
        "SoftmaxActivation",
        _softmax_act_fwd,
        params={"mode": Field("str", default="instance", enum=["instance", "channel"])},
    )
)


# -- Pad -----------------------------------------------------------------------
def _pad_index(n, lo, hi, mode, device):
    """Source indices of one padded axis of length ``n``: numpy's
    ``edge`` (clamped) or ``reflect`` (mirrored about the end elements,
    which are not repeated; pads longer than the axis fold again)."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "edge" or n == 1:
        return i.clamp(0, n - 1)
    period = 2 * (n - 1)
    i = i.abs() % period
    return torch.where(i >= n, period - i, i)


def _pad_fwd(params, inputs, aux, is_train, rng):
    x = inputs[0]
    pw = params["pad_width"]
    pads = [(pw[2 * i], pw[2 * i + 1]) for i in range(x.dim())]
    if params["mode"] == "constant":
        return [F.pad(x, _pad_arg([lo for lo, _ in pads],
                                  [hi for _, hi in pads]),
                      value=params["constant_value"])], []
    # F.pad's edge/reflect modes cover trailing axes of 3-5-D inputs
    # only: gather each padded axis instead, as jnp.pad pads any axis
    for axis, (lo, hi) in enumerate(pads):
        if lo or hi:
            idx = _pad_index(x.shape[axis], lo, hi, params["mode"], x.device)
            x = torch.index_select(x, axis, idx)
    return [x], []


def _pad_shape(params, in_shapes):
    if in_shapes[0] is None:
        raise MXNetError("Pad: data shape unknown")
    pw = params["pad_width"]
    s = tuple(
        d + pw[2 * i] + pw[2 * i + 1] for i, d in enumerate(in_shapes[0])
    )
    return [in_shapes[0]], [s], []


register(
    OpDef(
        "Pad",
        _pad_fwd,
        params={
            "mode": Field("str", required=True, enum=["constant", "edge", "reflect"]),
            "pad_width": Field("shape", required=True),
            "constant_value": Field("float", default=0.0),
        },
        infer_shape=_pad_shape,
    )
)
