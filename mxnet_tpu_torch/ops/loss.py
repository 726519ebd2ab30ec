"""SoftmaxOutput: the output layer with loss-layer backward semantics.

Counterpart of ``mxnet_tpu/ops/loss.py:22-140``. The forward is a
softmax: over the last axis of ``data`` flattened to ``[N, -1]`` in the
plain mode, through :func:`~mxnet_tpu_torch.ops.softmax.fused_softmax`
(K1, the hand-written kernel on CUDA tensors) as the JAX op calls its
Pallas ``fused_softmax``; over axis 1 with ``multi_output`` and over the
last axis with ``preserve_shape``, with a plain softmax, as the JAX op
does. The backward ignores the incoming gradient and returns
``(prob - onehot(label)) * valid * grad_scale / denom``, with
``ignore_label``/``use_ignore`` and ``normalization`` null, batch or
valid as in the JAX op. It reuses the forward's probabilities (saved
with the label) where the JAX op recomputes the softmax from ``data``;
the two differ by rounding only. Labels are float and are cast to int
here.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError
from .registry import Field, OpDef, register
from .softmax import fused_softmax


def _forward(params, data):
    if params["multi_output"]:
        return torch.softmax(data.float(), dim=1).to(data.dtype)
    if params["preserve_shape"]:
        return torch.softmax(data.float(), dim=-1).to(data.dtype)
    n = data.shape[0]
    return fused_softmax(data.reshape(n, -1).contiguous()).reshape(data.shape)


def _onehot(lab, c, axis, dtype):
    """One-hot along ``axis``; an out-of-range label (``ignore_label``)
    gives a zero row, as ``jax.nn.one_hot`` does."""
    shape = [1] * (lab.dim() + 1)
    shape[axis] = c
    classes = torch.arange(c, device=lab.device).reshape(shape)
    return (lab.unsqueeze(axis) == classes).to(dtype)


class _SoftmaxOutputFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, data, label, params):
        prob = _forward(params, data)
        ctx.save_for_backward(prob, label)
        ctx.params = params
        return prob

    @staticmethod
    def backward(ctx, g):
        del g  # loss-layer semantics: the head gradient is ignored
        prob, label = ctx.saved_tensors
        p = ctx.params
        dtype = prob.dtype
        if p["multi_output"]:
            c = prob.shape[1]
            lab = label.to(torch.int64)
            grad = prob - _onehot(lab, c, 1, dtype)
            valid = label != p["ignore_label"]
            if p["use_ignore"]:
                grad = grad * valid.to(dtype).unsqueeze(1)
            denom = 1.0
            if p["normalization"] == "batch":
                denom = float(_np.prod(label.shape))
            elif p["normalization"] == "valid":
                denom = torch.clamp(valid.to(dtype).sum(), min=1.0)
            grad = grad * (p["grad_scale"] / denom)
        else:
            n = int(_np.prod(prob.shape[:-1])) if p["preserve_shape"] \
                else prob.shape[0]
            flat = prob.reshape(n, -1)
            c = flat.shape[1]
            lab = label.reshape(n).to(torch.int64)
            grad = flat - _onehot(lab, c, 1, dtype)
            valid = label.reshape(n) != p["ignore_label"]
            if p["use_ignore"]:
                grad = grad * valid.to(dtype)[:, None]
            denom = 1.0
            if p["normalization"] == "batch":
                denom = float(n)
            elif p["normalization"] == "valid":
                denom = torch.clamp(valid.to(dtype).sum(), min=1.0)
            grad = (grad * (p["grad_scale"] / denom)).reshape(prob.shape)
        return grad, None, None


def _softmax_output_fwd(params, inputs, aux, is_train, rng):
    return [_SoftmaxOutputFn.apply(inputs[0], inputs[1], params)], []


def _softmax_output_shape(params, in_shapes):
    if in_shapes[0] is None:
        raise MXNetError("SoftmaxOutput: data shape unknown")
    d = in_shapes[0]
    if params["multi_output"]:
        lshape = (d[0],) + d[2:]
    elif params["preserve_shape"]:
        lshape = d[:-1]
    else:
        lshape = (d[0],)
    return [d, lshape], [d], []


_SOFTMAX_PARAMS = {
    "grad_scale": Field("float", default=1.0),
    "ignore_label": Field("float", default=-1.0),
    "multi_output": Field("bool", default=False),
    "use_ignore": Field("bool", default=False),
    "preserve_shape": Field("bool", default=False),
    "normalization": Field("str", default="null", enum=["null", "batch", "valid"]),
    "out_grad": Field("bool", default=False),
}

register(
    OpDef(
        "SoftmaxOutput",
        _softmax_output_fwd,
        params=dict(_SOFTMAX_PARAMS),
        arguments=("data", "label"),
        infer_shape=_softmax_output_shape,
        no_head_grad=True,
    )
)

# deprecated alias, as in the JAX package
from .registry import REGISTRY as _R  # noqa: E402

_R["Softmax"] = _R["SoftmaxOutput"]
