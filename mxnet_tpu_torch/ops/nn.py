"""Neural-network layer ops: the whole of the JAX package's
``mxnet_tpu/ops/nn.py``.

Counterpart of ``mxnet_tpu/ops/nn.py``: ``Activation`` (:57),
``LeakyReLU`` (:106), ``FullyConnected`` (:148), ``Convolution``
(:230), ``Deconvolution`` (:327), ``Pooling`` (:403), ``BatchNorm``
(:555), ``InstanceNorm`` (:585), ``L2Normalization`` (:615), ``LRN``
(:650), ``Dropout`` (:675), ``Embedding`` (:699), ``Reshape`` (:753),
``Flatten`` (:773), ``Concat`` (:803), ``ElementWiseSum`` (:825),
``SliceChannel`` (:859), ``Cast`` (:884), ``BlockGrad`` (:901),
``SwapAxis`` (:919), ``SoftmaxActivation`` (:938; ``instance`` over
each sample flattened, ``channel`` over axis 1), ``Pad`` (:968),
``UpSampling`` (:1029), ``Crop`` (:1079) and
``IdentityAttachKLSparseReg`` (:1119), with the same parameter
fields, defaults, inputs, outputs, aux states and shape inference
(copied; ``Reshape``'s target shape too), so graphs serialise to the
same JSON. ``Reshape``, ``SliceChannel`` and ``SwapAxis`` may return
views: the executor's graph is functional and autograd handles them.
``Dropout`` draws its mask with the JAX op's bits: ``bernoulli(key, 1 -
p, x.shape)`` of :mod:`..threefry` under the node's key, and ``x / (1 -
p)`` where it keeps; ``LeakyReLU``'s ``rrelu`` draws its training
slopes as ``uniform(key, x.shape, lower_bound, upper_bound)`` the same
way. The forwards are torch: the convolution is ``F.conv*d``, the
deconvolution ``F.conv_transpose*d`` and the FC product
``torch.matmul``, as the JAX package leaves them to XLA outside any
Pallas kernel. Gradients come from autograd; BatchNorm's training-mode
normalisation and the KL regulariser are ``torch.autograd.Function``s
carrying the JAX package's custom backward formulas.

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
- ``LRN``: the window sum over ``nsize`` channels, zero-padded by
  ``nsize // 2`` on both sides, scaled by ``alpha / nsize``:
  ``x / (knorm + alpha / nsize * sum) ** beta`` (``F.local_response_norm``
  averages over the window in the same way, but pads unevenly for an
  even ``nsize``; the JAX op's form is kept as it is).
- ``Deconvolution``: with ``target_shape`` the pad is
  ``(excess + 1) // 2`` and the adj ``excess % 2``, on the high side
  only, which torch's ``output_padding`` is; where that adj is not below
  the stride (torch refuses it) the output is the unpadded transposed
  convolution cropped by the pad and extended by zeros. ``dilate`` is a
  field only, as in the JAX op.
- ``UpSampling``: ``nearest`` repeats every input by the same
  ``scale``; ``bilinear`` resizes by ``scale`` with half-pixel centres
  and clamped edges, as ``jax.image.resize(..., "bilinear")`` does, and
  ignores its ``weight`` argument (whose gradient is zero), as the JAX
  op does where the reference runs a deconvolution with it.
- ``IdentityAttachKLSparseReg``: the KL penalty's gradient is added in
  the backward from the batch's mean activation; ``momentum`` is a field
  only, as in the JAX op.

Not carried over: the env knobs ``MXNET_BN_STATS_SAMPLE`` and
``MXNET_BN_AUTODIFF``.
"""
from __future__ import annotations

import math

import numpy as _np
import torch
import torch.nn.functional as F

from .. import threefry
from ..base import MXNetError, torch_dtype
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
    if not x.is_floating_point():   # jax.nn.softmax's float32
        x = x.float()
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


# -- LeakyReLU -----------------------------------------------------------------
def _leaky_relu_fwd(params, inputs, aux, is_train, rng):
    x = inputs[0]
    at = params["act_type"]
    slope = params["slope"]
    if at == "leaky":
        out = torch.where(x > 0, x, slope * x)
    elif at == "elu":
        out = torch.where(x > 0, x, slope * (torch.exp(x) - 1.0))
    elif at == "prelu":
        gamma = inputs[1].reshape((1, -1) + (1,) * (x.dim() - 2))
        out = torch.where(x > 0, x, gamma * x)
    elif at == "rrelu":
        lo, hi = params["lower_bound"], params["upper_bound"]
        if is_train and rng is not None:
            s = threefry.uniform(rng, x.numel(), lo, hi).reshape(
                x.shape).to(x.dtype)
        else:
            s = torch.tensor((lo + hi) / 2.0, dtype=x.dtype, device=x.device)
        out = torch.where(x > 0, x, s * x)
    else:
        raise MXNetError("unknown LeakyReLU act_type %s" % at)
    return [out], []


def _leaky_relu_args(params):
    return ["data", "gamma"] if params.get("act_type") == "prelu" else ["data"]


def _leaky_relu_shape(params, in_shapes):
    if in_shapes[0] is None:
        raise MXNetError("LeakyReLU: data shape unknown")
    s = in_shapes[0]
    if params.get("act_type") == "prelu":
        return [s, (s[1],)], [s], []
    return [s], [s], []


# need_rng for every act_type, as in the JAX op: each LeakyReLU node
# takes its key, so the keys of the random nodes after it stay aligned
register(
    OpDef(
        "LeakyReLU",
        _leaky_relu_fwd,
        params={
            "act_type": Field("str", default="leaky", enum=["leaky", "elu", "prelu", "rrelu"]),
            "slope": Field("float", default=0.25),
            "lower_bound": Field("float", default=0.125),
            "upper_bound": Field("float", default=0.334),
        },
        arguments=_leaky_relu_args,
        infer_shape=_leaky_relu_shape,
        need_rng=True,
    )
)


# -- Deconvolution -------------------------------------------------------------
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _deconv_pad_adj(params, in_sp):
    """Effective (pad, adj) per spatial dim. With target_shape set, pad
    and adj are deduced so the output hits the target exactly and the
    explicit pad/adj params are ignored."""
    nsp = len(in_sp)
    k = _pair(params["kernel"], nsp)
    stride = _pair(params["stride"] or (1,) * nsp, nsp)
    target = params.get("target_shape") or ()
    if any(target):
        target = _pair(target, nsp)
        pad, adj = [], []
        for i in range(nsp):
            total = stride[i] * (in_sp[i] - 1) + k[i]
            if total < target[i]:
                raise MXNetError(
                    "Deconvolution: target_shape %s too big (max %d on "
                    "axis %d)" % (target, total, i))
            excess = total - target[i]
            adj.append(excess % 2)
            pad.append((excess + 1) // 2)
        return tuple(pad), tuple(adj)
    pad = _pair(params["pad"] or (0,) * nsp, nsp)
    adj = _pair(params.get("adj") or (0,) * nsp, nsp)
    for i in range(nsp):
        if adj[i] >= max(stride[i], 1) and adj[i] != 0:
            raise MXNetError("Deconvolution: adj must be < stride")
    return pad, adj


def _deconv_fwd(params, inputs, aux, is_train, rng):
    data, weight = inputs[0], inputs[1]
    if weight.dtype != data.dtype:
        weight = weight.to(data.dtype)
    nsp = data.dim() - 2
    stride = _pair(params["stride"] or (1,) * nsp, nsp)
    pad, adj = _deconv_pad_adj(params, data.shape[2:])
    bias = None if params["no_bias"] else inputs[2].to(data.dtype)
    conv_t = _CONV_T[nsp]
    if all(a < s or a == 0 for a, s in zip(adj, stride)):
        out = conv_t(data, weight, bias, stride=stride, padding=pad,
                     output_padding=adj, groups=params["num_group"])
        return [out], []
    # an adj torch refuses (not below the stride, from target_shape):
    # the unpadded output cropped by pad, extended by zeros to its size
    out = conv_t(data, weight, None, stride=stride,
                 groups=params["num_group"])
    k = _pair(params["kernel"], nsp)
    for i in range(nsp):
        size = stride[i] * (data.shape[2 + i] - 1) + k[i] - 2 * pad[i] + adj[i]
        out = out.narrow(2 + i, pad[i], min(size, out.shape[2 + i] - pad[i]))
        short = size - out.shape[2 + i]
        if short:
            zshape = list(out.shape)
            zshape[2 + i] = short
            out = torch.cat([out, out.new_zeros(zshape)], dim=2 + i)
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * nsp)
    return [out], []


def _deconv_shape(params, in_shapes):
    if in_shapes[0] is None:
        raise MXNetError("Deconvolution: data shape unknown")
    dshape = in_shapes[0]
    nsp = len(dshape) - 2
    k = _pair(params["kernel"], nsp)
    stride = _pair(params["stride"] or (1,) * nsp, nsp)
    pad, adj = _deconv_pad_adj(params, dshape[2:])
    nf, ng = params["num_filter"], params["num_group"]
    wshape = (dshape[1], nf // ng) + k
    out_sp = tuple(
        stride[i] * (dshape[2 + i] - 1) + k[i] - 2 * pad[i] + adj[i]
        for i in range(nsp)
    )
    oshape = (dshape[0], nf) + out_sp
    ins = [dshape, wshape] + ([] if params["no_bias"] else [(nf,)])
    return ins, [oshape], []


_DECONV_PARAMS = dict(_CONV_PARAMS)
_DECONV_PARAMS.update({
    "adj": Field("shape", default=None),
    "target_shape": Field("shape", default=None),
})

register(
    OpDef(
        "Deconvolution",
        _deconv_fwd,
        params=_DECONV_PARAMS,
        arguments=_fc_args,
        infer_shape=_deconv_shape,
    )
)


# -- InstanceNorm --------------------------------------------------------------
def _in_fwd(params, inputs, aux, is_train, rng):
    data, gamma, beta = inputs
    if not data.is_floating_point():   # jnp.mean/var's float32
        data = data.float()
    eps = params["eps"]
    axes = tuple(range(2, data.dim()))
    mean = data.mean(dim=axes, keepdim=True)
    var = torch.square(data - mean).mean(dim=axes, keepdim=True)
    bshape = (1, -1) + (1,) * (data.dim() - 2)
    out = (data - mean) / torch.sqrt(var + eps)
    return [out * gamma.reshape(bshape) + beta.reshape(bshape)], []


register(
    OpDef(
        "InstanceNorm",
        _in_fwd,
        params={"eps": Field("float", default=1e-3)},
        arguments=("data", "gamma", "beta"),
        infer_shape=lambda p, s: (
            [s[0], (s[0][1],), (s[0][1],)],
            [s[0]],
            [],
        ),
    )
)


# -- L2Normalization -----------------------------------------------------------
def _l2norm_fwd(params, inputs, aux, is_train, rng):
    x = inputs[0]
    mode = params["mode"]
    if mode == "instance":
        axes = tuple(range(1, x.dim()))
    elif mode == "channel":
        axes = (1,)
    else:  # spatial
        axes = tuple(range(2, x.dim()))
    norm = torch.sqrt(torch.square(x).sum(dim=axes, keepdim=True)
                      + params["eps"])
    return [x / norm], []


register(
    OpDef(
        "L2Normalization",
        _l2norm_fwd,
        params={
            "eps": Field("float", default=1e-10),
            "mode": Field("str", default="instance", enum=["instance", "channel", "spatial"]),
        },
    )
)


# -- LRN -----------------------------------------------------------------------
def _lrn_fwd(params, inputs, aux, is_train, rng):
    x = inputs[0]
    alpha, beta, knorm, nsize = (params["alpha"], params["beta"],
                                 params["knorm"], params["nsize"])
    sq = torch.square(x)
    half = nsize // 2
    zshape = list(sq.shape)
    zshape[1] = half
    sq = torch.cat([sq.new_zeros(zshape), sq, sq.new_zeros(zshape)], dim=1)
    c_out = sq.shape[1] - nsize + 1
    ssum = sq.narrow(1, 0, c_out)
    for k in range(1, nsize):
        ssum = ssum + sq.narrow(1, k, c_out)
    return [x / torch.pow(knorm + alpha / nsize * ssum, beta)], []


register(
    OpDef(
        "LRN",
        _lrn_fwd,
        params={
            "alpha": Field("float", default=1e-4),
            "beta": Field("float", default=0.75),
            "knorm": Field("float", default=2.0),
            "nsize": Field("int", required=True),
        },
    )
)


# -- ElementWiseSum ------------------------------------------------------------
def _ewsum_fwd(params, inputs, aux, is_train, rng):
    out = inputs[0]
    for x in inputs[1:]:
        out = out + x
    return [out], []


register(
    OpDef(
        "ElementWiseSum",
        _ewsum_fwd,
        params={"num_args": Field("int", required=True)},
        key_var_num_args="num_args",
    )
)


# -- Cast ----------------------------------------------------------------------
def _cast_fwd(params, inputs, aux, is_train, rng):
    return [inputs[0].to(torch_dtype(params["dtype"]))], []


def _cast_type(params, in_types):
    t = _np.dtype(params["dtype"])
    return [in_types[0] or _np.dtype("float32")], [t], []


register(
    OpDef(
        "Cast",
        _cast_fwd,
        params={"dtype": Field("str", required=True)},
        infer_type=_cast_type,
    )
)


# -- BlockGrad -----------------------------------------------------------------
def _blockgrad_fwd(params, inputs, aux, is_train, rng):
    return [inputs[0].detach()], []


# no_head_grad: a BlockGrad head never propagates a cotangent, so
# backward() must not demand an out_grad for it
register(OpDef("BlockGrad", _blockgrad_fwd, no_head_grad=True))


# -- UpSampling ----------------------------------------------------------------
def _upsampling_fwd(params, inputs, aux, is_train, rng):
    scale = params["scale"]
    if params["sample_type"] == "bilinear":
        # half-pixel centres, edges clamped: jax.image.resize's bilinear
        # for an integer upscale; the weight argument is not read
        return [F.interpolate(inputs[0], scale_factor=scale,
                              mode="bilinear", align_corners=False)], []
    outs = [x.repeat_interleave(scale, dim=2).repeat_interleave(scale, dim=3)
            for x in inputs]
    if len(outs) == 1:
        return [outs[0]], []
    if params["multi_input_mode"] == "sum":
        out = outs[0]
        for o in outs[1:]:
            out = out + o
        return [out], []
    return [torch.cat(outs, dim=1)], []


def _upsampling_shape(params, in_shapes):
    if in_shapes[0] is None:
        raise MXNetError("UpSampling: data shape unknown")
    scale = params["scale"]
    s0 = in_shapes[0]
    oh, ow = s0[2] * scale, s0[3] * scale
    if params["sample_type"] == "bilinear":
        k = 2 * scale - scale % 2
        ws = (s0[1], 1, k, k)
        return [s0, ws], [(s0[0], s0[1], oh, ow)], []
    c = sum((s[1] if s else s0[1]) for s in in_shapes)
    if params["multi_input_mode"] == "sum":
        c = s0[1]
    return list(in_shapes), [(s0[0], c, oh, ow)], []


def _upsampling_args(params):
    if params.get("sample_type") == "bilinear":
        return ["data", "weight"]
    n = params.get("num_args") or 1
    return ["arg%d" % i for i in range(n)] if n > 1 else ["data"]


register(
    OpDef(
        "UpSampling",
        _upsampling_fwd,
        params={
            "scale": Field("int", required=True),
            "num_filter": Field("int", default=0),
            "sample_type": Field("str", required=True, enum=["nearest", "bilinear"]),
            "multi_input_mode": Field("str", default="concat", enum=["concat", "sum"]),
            "num_args": Field("int", default=1),
            "workspace": Field("int", default=512),
        },
        arguments=_upsampling_args,
        infer_shape=_upsampling_shape,
    )
)


# -- Crop ----------------------------------------------------------------------
def _crop_fwd(params, inputs, aux, is_train, rng):
    x = inputs[0]
    if params["num_args"] == 2:
        th, tw = inputs[1].shape[2], inputs[1].shape[3]
    else:
        th, tw = params["h_w"]
    if params["center_crop"]:
        y0 = (x.shape[2] - th) // 2
        x0 = (x.shape[3] - tw) // 2
    else:
        y0, x0 = params["offset"]
    return [x[:, :, y0:y0 + th, x0:x0 + tw]], []


def _crop_shape(params, in_shapes):
    if in_shapes[0] is None:
        raise MXNetError("Crop: data shape unknown")
    s0 = in_shapes[0]
    if params["num_args"] == 2:
        if in_shapes[1] is None:
            raise MXNetError("Crop: crop_like shape unknown")
        th, tw = in_shapes[1][2], in_shapes[1][3]
    else:
        th, tw = params["h_w"]
    return list(in_shapes), [(s0[0], s0[1], th, tw)], []


def _crop_args(params):
    return ["data", "crop_like"] if params.get("num_args") == 2 else ["data"]


register(
    OpDef(
        "Crop",
        _crop_fwd,
        params={
            "num_args": Field("int", required=True),
            "offset": Field("shape", default=(0, 0)),
            "h_w": Field("shape", default=(0, 0)),
            "center_crop": Field("bool", default=False),
        },
        arguments=_crop_args,
        infer_shape=_crop_shape,
    )
)


# -- IdentityAttachKLSparseReg -------------------------------------------------
class _KLSparseReg(torch.autograd.Function):
    """The identity forward; the backward adds the KL sparseness
    penalty's gradient, from the mean sigmoid activation of each unit
    over the batch (the JAX op's ``bwd``)."""

    @staticmethod
    def forward(ctx, x, target, penalty):
        ctx.save_for_backward(x)
        ctx.target, ctx.penalty = target, penalty
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        t, penalty = ctx.target, ctx.penalty
        sig = torch.sigmoid(x)
        rho_hat = sig.mean(dim=0)
        # true divisions by the tensors: a Python number over a tensor
        # is a reciprocal and a product in torch
        grad_kl = penalty * (torch.full_like(rho_hat, -t) / (rho_hat + 1e-8)
                             + torch.full_like(rho_hat, 1 - t)
                             / (1 - rho_hat + 1e-8))
        return g + grad_kl[None] * sig * (1 - sig), None, None


def _kl_sparse_fwd(params, inputs, aux, is_train, rng):
    # momentum is a field only: the JAX op applies the penalty of this
    # batch, not a moving average
    return [_KLSparseReg.apply(inputs[0], params["sparseness_target"],
                               params["penalty"])], []


register(
    OpDef(
        "IdentityAttachKLSparseReg",
        _kl_sparse_fwd,
        params={
            "sparseness_target": Field("float", default=0.1),
            "penalty": Field("float", default=0.001),
            "momentum": Field("float", default=0.9),
        },
    )
)
