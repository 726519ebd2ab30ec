"""Output and loss ops with loss-layer backward semantics.

Counterpart of ``mxnet_tpu/ops/loss.py``. Each op's backward ignores the
incoming gradient (the executor seeds loss heads with ones) and writes
the loss gradient itself, as a ``torch.autograd.Function`` where the JAX
package uses ``jax.custom_vjp``. Labels are float and are cast to int
where an index is needed; a label gets no gradient.

- ``SoftmaxOutput`` (``:22-140``): a softmax over the last axis of
  ``data`` flattened to ``[N, -1]`` in the plain mode, through
  :func:`~mxnet_tpu_torch.ops.softmax.fused_softmax` (K1, the
  hand-written kernel on CUDA tensors) as the JAX op calls its Pallas
  ``fused_softmax``; over axis 1 with ``multi_output`` and over the last
  axis with ``preserve_shape``, with a plain softmax, as the JAX op
  does. The backward returns ``(prob - onehot(label)) * valid *
  grad_scale / denom``, with ``ignore_label``/``use_ignore`` and
  ``normalization`` null, batch or valid. It reuses the forward's
  probabilities where the JAX op recomputes the softmax from ``data``;
  the two differ by rounding only.
- ``LinearRegressionOutput``, ``MAERegressionOutput`` and
  ``LogisticRegressionOutput`` (``:142-196``), from one factory: the
  output is ``act(data)`` (identity or sigmoid), the gradient
  ``(out - label)`` or ``sign(out - label)``, times ``grad_scale``.
- ``MakeLoss`` (``:199-243``): the identity, whose gradient is
  ``grad_scale / denom`` everywhere: ``denom`` is the count of inputs
  above ``valid_thresh`` (at least 1) for ``normalization="valid"``, the
  batch size for ``"batch"``, else 1.
- ``SVMOutput`` (``:246-290``): the identity, with the L1 hinge's
  (``use_linear``) or the squared hinge's gradient, times
  ``regularization_coefficient``.
- ``WarpCTC`` (``:298-437``): a softmax over the alphabet forward; the
  backward is the gradient of :func:`ctc_loss` summed over the batch,
  taken by ``torch.autograd`` through the alpha recursion (a loop over
  time), as the JAX op takes ``jax.grad`` through its ``lax.scan``.
"""
from __future__ import annotations

import numpy as _np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from .registry import Field, OpDef, register
from .softmax import fused_softmax


def _forward(params, data):
    if not data.is_floating_point():
        # integer data gives float32 probabilities, as the JAX op does;
        # K1 reads the converted rows
        data = data.float()
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


# -- regression outputs --------------------------------------------------------
class _RegressionFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, data, label, act_fn, grad_fn, grad_scale):
        out = act_fn(data)
        ctx.save_for_backward(out, label)
        ctx.grad_fn, ctx.grad_scale = grad_fn, grad_scale
        return out

    @staticmethod
    def backward(ctx, g):
        del g
        out, label = ctx.saved_tensors
        grad = ctx.grad_fn(out, label.reshape(out.shape)) * ctx.grad_scale
        return grad.to(out.dtype), None, None, None, None


def _make_regression(name, act_fn, grad_fn):
    def op_fwd(params, inputs, aux, is_train, rng):
        return [_RegressionFn.apply(inputs[0], inputs[1], act_fn, grad_fn,
                                    params["grad_scale"])], []

    def ishape(params, in_shapes):
        if in_shapes[0] is None:
            raise MXNetError("%s: data shape unknown" % name)
        return [in_shapes[0], in_shapes[0]], [in_shapes[0]], []

    register(
        OpDef(
            name,
            op_fwd,
            params={"grad_scale": Field("float", default=1.0)},
            arguments=("data", "label"),
            infer_shape=ishape,
            no_head_grad=True,
        )
    )


_make_regression(
    "LinearRegressionOutput", lambda x: x, lambda out, label: out - label)
_make_regression(
    "MAERegressionOutput", lambda x: x,
    lambda out, label: torch.sign(out - label))
_make_regression(
    "LogisticRegressionOutput", torch.sigmoid,
    lambda out, label: out - label)


# -- MakeLoss ------------------------------------------------------------------
class _MakeLossFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, params):
        ctx.save_for_backward(x)
        ctx.params = params
        return x

    @staticmethod
    def backward(ctx, g):
        del g
        (x,) = ctx.saved_tensors
        p = ctx.params
        if p["normalization"] == "valid":
            denom = torch.clamp(
                (x > p["valid_thresh"]).to(x.dtype).sum(), min=1.0)
        elif p["normalization"] == "batch":
            denom = float(x.shape[0])
        else:
            denom = 1.0
        return torch.full_like(x, p["grad_scale"]) / denom, None


def _make_loss_fwd(params, inputs, aux, is_train, rng):
    return [_MakeLossFn.apply(inputs[0], params)], []


register(
    OpDef(
        "MakeLoss",
        _make_loss_fwd,
        params={
            "grad_scale": Field("float", default=1.0),
            "valid_thresh": Field("float", default=0.0),
            "normalization": Field("str", default="null", enum=["null", "batch", "valid"]),
        },
        no_head_grad=True,
    )
)


# -- SVMOutput -----------------------------------------------------------------
class _SVMOutputFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, data, label, params):
        ctx.save_for_backward(data, label)
        ctx.params = params
        return data

    @staticmethod
    def backward(ctx, g):
        del g
        data, label = ctx.saved_tensors
        p = ctx.params
        n, c = data.shape[0], data.shape[1]
        onehot = _onehot(label.reshape(n).to(torch.int64), c, 1, data.dtype)
        score_correct = (data * onehot).sum(dim=1, keepdim=True)
        if p["use_linear"]:   # L1-SVM hinge
            viol = ((data - score_correct + p["margin"]) > 0).to(
                data.dtype) * (1 - onehot)
            grad = viol - onehot * viol.sum(dim=1, keepdim=True)
        else:                 # L2-SVM squared hinge
            m = torch.clamp(data - score_correct + p["margin"], min=0.0) \
                * (1 - onehot)
            grad = 2.0 * m - onehot * (2.0 * m).sum(dim=1, keepdim=True)
        return (p["regularization_coefficient"] * grad).to(data.dtype), \
            None, None


def _svm_output_fwd(params, inputs, aux, is_train, rng):
    return [_SVMOutputFn.apply(inputs[0], inputs[1], params)], []


register(
    OpDef(
        "SVMOutput",
        _svm_output_fwd,
        params={
            "margin": Field("float", default=1.0),
            "regularization_coefficient": Field("float", default=1.0),
            "use_linear": Field("bool", default=False),
        },
        arguments=("data", "label"),
        infer_shape=lambda p, s: ([s[0], (s[0][0],)], [s[0]], []),
        no_head_grad=True,
    )
)


# -- WarpCTC -------------------------------------------------------------------
def ctc_loss(log_probs, labels):
    """Batched CTC negative log-likelihood in log space, as
    ``mxnet_tpu/ops/loss.py:298`` computes it: the alpha recursion over
    the blank-extended label sequence, a loop over time.

    log_probs: (T, B, A) log-softmax activations, blank index 0.
    labels: (B, L) int labels, 0 = padding, wherever it stands: each
    row's nonzero labels are left-packed in order first.
    Returns (B,) positive costs.
    """
    T, B, A = log_probs.shape
    L = labels.shape[1]
    dev = log_probs.device
    labels = labels.to(torch.int64)

    nonblank = labels != 0
    order = torch.argsort((~nonblank).to(torch.int8), dim=1, stable=True)
    packed = torch.gather(labels, 1, order)
    label_len = nonblank.sum(dim=1)

    # blank-extended sequence z = [0, l1, 0, l2, ..., lL, 0], S = 2L+1
    S = 2 * L + 1
    ext = torch.zeros((B, S), dtype=torch.int64, device=dev)
    ext[:, 1::2] = packed
    s_len = 2 * label_len + 1

    neg_inf = torch.tensor(-1e30, dtype=log_probs.dtype, device=dev)
    pos = torch.arange(S, device=dev)
    ext_m2 = F.pad(ext, (2, 0), value=-1)[:, :S]
    allow_skip = (ext != 0) & (ext != ext_m2)
    in_seq = pos[None, :] < s_len[:, None]

    def emit(logp_t):
        return torch.gather(logp_t, 1, ext)  # (B, S)

    alpha = torch.where(pos[None, :] < 2, emit(log_probs[0]), neg_inf)
    alpha = torch.where(in_seq, alpha, neg_inf)
    # a label_len of 0 leaves only the blank state
    alpha = torch.where((pos[None, :] == 1) & (label_len[:, None] == 0),
                        neg_inf, alpha)
    for t in range(1, T):
        shift1 = F.pad(alpha, (1, 0), value=-1e30)[:, :S]
        shift2 = F.pad(alpha, (2, 0), value=-1e30)[:, :S]
        a = torch.logaddexp(alpha, shift1)
        a = torch.where(allow_skip, torch.logaddexp(a, shift2), a)
        a = a + emit(log_probs[t])
        alpha = torch.where(in_seq, a, neg_inf)
    last = torch.gather(alpha, 1, (s_len - 1)[:, None])[:, 0]
    prev = torch.gather(alpha, 1, torch.clamp(s_len - 2, min=0)[:, None])[:, 0]
    prev = torch.where(s_len > 1, prev, neg_inf)
    return -torch.logaddexp(last, prev)


class _WarpCTCFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, data, label, T, label_length):
        ctx.save_for_backward(data, label)
        ctx.T, ctx.label_length = T, label_length
        return torch.softmax(data, dim=-1)

    @staticmethod
    def backward(ctx, g):
        del g  # loss head: the gradient is written directly
        data, label = ctx.saved_tensors
        T = ctx.T
        B, A = data.shape[0] // T, data.shape[1]
        with torch.enable_grad():
            d = data.detach().to(torch.float32).requires_grad_()
            logp = torch.log_softmax(d.reshape(T, B, A), dim=-1)
            cost = ctc_loss(logp, label.reshape(B, ctx.label_length)).sum()
            (gd,) = torch.autograd.grad(cost, d)
        return gd.to(data.dtype), None, None, None


def _warpctc_fwd(params, inputs, aux, is_train, rng):
    input_length = int(params["input_length"])
    label_length = int(params["label_length"])
    if input_length <= 0 or label_length <= 0:
        raise MXNetError("WarpCTC requires input_length and label_length > 0")
    data, label = inputs[0], inputs[1]
    if data.dim() != 2:
        raise MXNetError("WarpCTC input data shape should be 2: (t*n, p)")
    if data.shape[0] % input_length != 0:
        raise MXNetError(
            "WarpCTC: data rows %d not divisible by input_length %d"
            % (data.shape[0], input_length))
    return [_WarpCTCFn.apply(data, label, input_length, label_length)], []


def _warpctc_infer_shape(params, in_shapes):
    d = in_shapes[0]
    if d is None:
        raise MXNetError("WarpCTC: data shape required")
    T = int(params["input_length"])
    if T <= 0 or int(params["label_length"]) <= 0:
        raise MXNetError("WarpCTC requires input_length and label_length > 0")
    if d[0] % T != 0:
        raise MXNetError(
            "WarpCTC: data rows %d not divisible by input_length %d"
            % (d[0], T))
    B = d[0] // T
    label = in_shapes[1] if in_shapes[1] is not None else (
        B * int(params["label_length"]),)
    return [tuple(d), tuple(label)], [tuple(d)], []


register(
    OpDef(
        "WarpCTC",
        _warpctc_fwd,
        params={
            "label_length": Field("int", default=0),
            "input_length": Field("int", default=0),
        },
        arguments=("data", "label"),
        infer_shape=_warpctc_infer_shape,
        no_head_grad=True,
        doc="CTC loss layer (ref: plugin/warpctc/warpctc-inl.h); "
            "forward = softmax over the alphabet, backward = CTC gradient "
            "wrt activations, blank index 0.",
    )
)
