"""Flash attention: the hand-written Hopper kernels and their plain
versions.

Counterpart of ``flash_attention`` in ``mxnet_tpu/ops/pallas_kernels.py``:
the Pallas forward ``_flash_fwd_kernel`` (K2, ``csrc/flash_fwd.cu``) and
the backward ``_flash_bwd_dq_kernel`` (K3) and ``_flash_bwd_dkv_kernel``
(K4), both in ``csrc/flash_bwd.cu``. Layout ``[B, H, T, D]``.

- On CPU tensors the forward is :func:`attention_reference` and the
  backward :func:`attention_bwd_reference`, the plain PyTorch versions.
- On CUDA tensors the kernels are launched and nothing else: a shape or
  dtype the kernels do not take raises, and so does a failed build or
  launch. The bf16 kernels read q, k, v (and the backward dO) through
  their strides (:func:`tma_strides`), copying only a view that rule
  refuses; the f32 kernels read contiguous copies.
- :class:`FlashAttention` wires forward and backward as one
  ``torch.autograd.Function``, as the JAX ``custom_vjp`` does;
  :func:`flash_attention` goes through it when grad is enabled and an
  input requires grad, and launches the forward alone otherwise.

Each kernel wrapper counts its launches in a plain int bumped where the
kernel is launched and nowhere else: ``flash_attention.launches`` (K2),
``flash_bwd_dq.launches`` (K3), ``flash_bwd_dkv.launches`` (K4).
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError, env_int

__all__ = ["attention_reference", "attention_bwd_reference",
           "flash_attention", "flash_attention_fwd", "flash_attention_bwd",
           "flash_bwd_dq", "flash_bwd_dkv", "FlashAttention",
           "flash_kernel_usable", "tma_strides", "SUPPORTED_HEAD_DIMS"]

SUPPORTED_HEAD_DIMS = (64, 128)
_NEG = -1e30


def attention_reference(q, k, v, causal=True, scale=None):
    """Plain attention; returns ``(o, lse)`` with ``lse`` f32
    ``[B, H, Tq]``.

    The port of ``_attention_reference`` extended to return the
    log-sum-exp. It repeats the kernel's arithmetic: scores are formed
    from f32 copies of q and k (for f32 inputs exactly the JAX
    function), masked to -1e30 with the top-left causal rule, softmaxed
    in f32 and applied to f32 v; o is cast back to q's dtype.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    scores = _scores(q, k, causal, scale)
    lse = torch.logsumexp(scores, dim=-1)
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return o.to(q.dtype), lse


def _scores(q, k, causal, scale):
    """f32 scale * Q K^T, masked to -1e30 with the top-left causal rule."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        tq, tk = scores.shape[-2], scores.shape[-1]
        iq = torch.arange(tq, device=q.device)[:, None]
        ik = torch.arange(tk, device=q.device)[None, :]
        scores = torch.where(ik <= iq, scores,
                             torch.full((), _NEG, device=q.device))
    return scores


def attention_bwd_reference(q, k, v, o, lse, do, causal=True, scale=None):
    """Plain attention backward; returns ``(dq, dk, dv)`` in the inputs'
    dtypes.

    The plain version of ``_flash_attention_bwd_pallas``: a dense f32
    recompute from the saved ``lse`` (``[B, H, Tq]`` f32), with
    P = exp(S - lse), dV = P^T dO, D = rowsum(dO * O),
    dS = P * (dO V^T - D), dQ = scale dS K, dK = scale dS^T Q.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(_scores(q, k, causal, scale) - lse[..., None])
    dof = do.float()
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, v.float())
    dcap = (dof * o.float()).sum(-1, keepdim=True)
    ds = p * (dp - dcap)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_kernel_usable(tq, tk, d, dv):
    """True iff the kernel takes ``[.., tq, d] x [.., tk, d] ->
    [.., tk, dv]`` and the ``MXNET_FLASH_MIN_T`` crossover (default 0)
    sends it there: head_dim 64 or 128 with ``dv == d``. Composers (the
    Ulysses local attention) check it to choose between
    :func:`flash_attention` and their own blockwise path. The TPU rules
    (128-multiple lengths, the VMEM budget, ``MXNET_PALLAS``) do not
    apply here: the kernel masks any ragged length."""
    return (d in SUPPORTED_HEAD_DIMS and dv == d and tq > 0 and tk > 0
            and tk >= env_int("MXNET_FLASH_MIN_T", 0))


def flash_attention_fwd(q, k, v, causal=True, scale=None, variant=0):
    """Launch the forward kernel on CUDA tensors; returns ``(o, lse)``
    with o a contiguous ``[B, H, Tq, D]`` and ``lse`` f32 ``[B, H, Tq]``.
    Counterpart of ``_flash_attention_pallas``.

    bf16 q, k, v are read in place through their strides wherever
    :func:`tma_strides` takes them (the transformer's heads of one qkv
    product, Ulysses' local views); an operand it refuses is copied
    into a contiguous tensor first, a change of layout and not of path.
    The f32 kernel reads contiguous operands. ``variant`` picks the bf16
    kernel's block shape: 0 by the grid's size, 1 for 128 query rows a
    block, 2 for 64 (``csrc/flash_fwd.cu``)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    _check_kernel_operands(q, k, v)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if q.dtype == torch.bfloat16:
        ops = _tma_operands(q, k, v)
        strides = [tma_strides(t) for t in ops]
    else:
        ops = _aligned(q, k, v)
        strides = [t.stride()[:3] for t in ops]
    o = torch.empty((b, h, tq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    from . import _build

    lib = _build.library("flash_fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mx_flash_fwd(
            ops[0].data_ptr(), ops[1].data_ptr(), ops[2].data_ptr(),
            o.data_ptr(), lse.data_ptr(), b, h, tq, tk, d,
            *strides[0], *strides[1], *strides[2], float(scale),
            int(causal), int(q.dtype == torch.bfloat16), int(variant),
            stream)
        flash_attention.launches += 1
    if err != 0:
        raise MXNetError("flash_fwd kernel launch failed: %s"
                         % _launch_error(err))
    return o, lse


def _launch_error(err):
    if err == 1999:
        return "libcuda's cuTensorMapEncodeTiled was not found"
    if err >= 2000:
        return "cuTensorMapEncodeTiled returned CUresult %d" % (err - 2000)
    return "cudaError %d" % err


def tma_strides(t):
    """The (B, H, T) strides, in elements, through which the bf16
    kernels' TMA tensor maps read the ``[B, H, T, D]`` view ``t``; None
    when ``t`` has to be copied first.

    A map needs the last dimension contiguous, the start 16-byte aligned
    and every other stride a positive multiple of 16 bytes below 2^40
    bytes. A dimension of extent 1 is never stepped, so its stride (which
    torch leaves free) is given as the view's span rounded up to 16
    bytes."""
    strides, shape = t.stride(), t.shape
    if strides[3] != 1 or t.data_ptr() % 16:
        return None
    es = t.element_size()
    out = strides[:3]
    if 1 in shape[:3]:
        unit = 16 // es
        span = 1 + sum((n - 1) * st for n, st in zip(shape, strides))
        span = -(-span // unit) * unit
        out = tuple(span if n == 1 else st for n, st in zip(shape, out))
    for st in out:
        if st <= 0 or (st * es) % 16 or st * es >= 1 << 40:
            return None
    return out


def _check_kernel_operands(q, k, v):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise MXNetError("flash kernel: q, k, v must be CUDA tensors")
    if not (q.device == k.device == v.device):
        raise MXNetError("flash kernel: q, k, v on different devices")
    if q.dtype not in (torch.bfloat16, torch.float32) or not (
            q.dtype == k.dtype == v.dtype):
        raise MXNetError("flash kernel: q, k, v must share dtype bf16 or "
                         "f32, got %s/%s/%s" % (q.dtype, k.dtype, v.dtype))
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise MXNetError("flash kernel: q, k, v must be [B, H, T, D]")
    b, h, tq, d = q.shape
    if (k.shape[:2] != (b, h) or v.shape[:3] != k.shape[:3]
            or k.shape[3] != d):
        raise MXNetError("flash kernel: shapes q %s k %s v %s do not match"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    if not flash_kernel_usable(tq, k.shape[2], d, v.shape[3]):
        raise MXNetError(
            "flash kernel: head_dim %d / dv %d / T %d not taken (head_dim "
            "%s with dv == head_dim, tk >= MXNET_FLASH_MIN_T)"
            % (d, v.shape[3], k.shape[2], SUPPORTED_HEAD_DIMS))


def _aligned(*ts):
    """Contiguous tensors with 16-byte aligned starts: what the f32
    kernels read, and what a bf16 view :func:`tma_strides` refuses
    becomes."""
    ts = (t.detach().contiguous() for t in ts)
    return tuple(t.clone() if t.data_ptr() % 16 else t for t in ts)


def _tma_operands(*ts):
    """The bf16 views as the kernels read them: each as it is where
    :func:`tma_strides` takes it, else a contiguous copy (a change of
    layout, not of path)."""
    return tuple(t if tma_strides(t) is not None else _aligned(t)[0]
                 for t in ts)


def _check_ready(q, k, v, do, lse, dcap):
    """What K3/K4 read: the operands of :func:`_check_kernel_operands`,
    do like q, lse and D contiguous f32 ``[B, H, Tq]``, all on one card;
    bf16 q, k, v, do through strides that :func:`tma_strides` takes, f32
    ones contiguous and 16-byte aligned. Returns the (B, H, T) strides
    of q, k, v and do, in that order."""
    _check_kernel_operands(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise MXNetError("flash backward: do %s %s, q %s %s"
                         % (tuple(do.shape), do.dtype, tuple(q.shape),
                            q.dtype))
    for t in (lse, dcap):
        if t.shape != q.shape[:3] or t.dtype != torch.float32:
            raise MXNetError("flash backward: lse and D must be f32 %s, "
                             "got %s %s" % (tuple(q.shape[:3]), t.dtype,
                                            tuple(t.shape)))
    if any(t.device != q.device for t in (do, lse, dcap)):
        raise MXNetError("flash backward: operands on different devices")
    if not (lse.is_contiguous() and dcap.is_contiguous()):
        raise MXNetError("flash backward: lse and D must be contiguous")
    ops = (q, k, v, do)
    if q.dtype == torch.bfloat16:
        strides = [tma_strides(t) for t in ops]
        if None in strides:
            raise MXNetError("flash backward: a bf16 operand's strides are "
                             "not ones the tensor maps read (tma_strides)")
        return strides
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in ops):
        raise MXNetError("flash backward: f32 operands must be contiguous "
                         "and 16-byte aligned")
    return [t.stride()[:3] for t in ops]


def _launch_check(name, err):
    if err != 0:
        raise MXNetError("%s kernel launch failed: %s"
                         % (name, _launch_error(err)))


def flash_bwd_dq(q, k, v, do, lse, dcap, causal, scale):
    """Launch K3 on CUDA operands; returns dq, a contiguous
    ``[B, H, Tq, D]``. ``dcap`` is D = rowsum(dO * O), f32
    ``[B, H, Tq]``. bf16 q, k, v, do are read through their strides; the
    bf16 kernel takes 128 query rows a block where the grid has at least
    as many such tiles as the card has SMs, else 64."""
    strides = _check_ready(q, k, v, do, lse, dcap)
    b, h, tq, d = q.shape
    dq = torch.empty((b, h, tq, d), dtype=q.dtype, device=q.device)
    from . import _build

    lib = _build.library("flash_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mx_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dcap.data_ptr(), dq.data_ptr(), b, h, tq,
            k.shape[2], d, *(s for st in strides for s in st),
            float(scale), int(causal), int(q.dtype == torch.bfloat16),
            stream)
        flash_bwd_dq.launches += 1
    _launch_check("flash_bwd_dq", err)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, dcap, causal, scale):
    """Launch K4 on CUDA operands; returns ``(dk, dv)``, contiguous
    ``[B, H, Tk, D]``. Operands as for :func:`flash_bwd_dq`."""
    strides = _check_ready(q, k, v, do, lse, dcap)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    dk = torch.empty((b, h, tk, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, h, tk, d), dtype=v.dtype, device=v.device)
    from . import _build

    lib = _build.library("flash_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mx_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dcap.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, tq, tk, d, *(s for st in strides for s in st),
            float(scale), int(causal), int(q.dtype == torch.bfloat16),
            stream)
        flash_bwd_dkv.launches += 1
    _launch_check("flash_bwd_dkv", err)
    return dk, dv


flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, causal=True, scale=None):
    """The backward on CUDA tensors; returns ``(dq, dk, dv)``.
    Counterpart of ``_flash_attention_bwd_pallas``: D = rowsum(dO * O)
    in f32 with torch (the JAX package does it in XLA), then K3 and K4,
    one launch each. bf16 q, k, v and do are read in place where
    :func:`tma_strides` takes them (the LM's head views, the transposed
    gradient of its attention output) and copied otherwise; f32 ones
    are copied to contiguous tensors."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if o.shape != q.shape or o.dtype != q.dtype or do.shape != q.shape:
        raise MXNetError("flash backward: o %s %s and do %s must match q "
                         "%s %s" % (tuple(o.shape), o.dtype, tuple(do.shape),
                                    tuple(q.shape), q.dtype))
    if q.dtype == torch.bfloat16:
        q, k, v, do = _tma_operands(q, k, v, do)
    else:
        q, k, v, do = _aligned(q, k, v, do)
    lse = lse.detach().contiguous()
    dcap = (do.float() * o.float()).sum(-1)
    dq = flash_bwd_dq(q, k, v, do, lse, dcap, causal, scale)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, dcap, causal, scale)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """K2 forward and K3/K4 backward as one autograd function (the plain
    versions on CPU tensors). Saves q, k, v as given, o and lse: the
    bf16 kernels read the views through their strides."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        if q.is_cuda:
            o, lse = flash_attention_fwd(q, k, v, causal=causal,
                                         scale=scale)
        else:
            o, lse = attention_reference(q, k, v, causal=causal,
                                         scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = flash_attention_bwd if q.is_cuda else attention_bwd_reference
        dq, dk, dv = bwd(q, k, v, o, lse, do, causal=ctx.causal,
                         scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=True, scale=None):
    """Blockwise-softmax attention, q,k,v ``[batch, heads, time, d]``.

    With grad enabled and an input that requires grad it goes through
    :class:`FlashAttention`; otherwise CPU tensors take
    :func:`attention_reference` and CUDA tensors launch the forward
    kernel alone. On CUDA tensors the kernels raise where they do not
    apply."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, scale)
    if q.is_cuda:
        return flash_attention_fwd(q, k, v, causal=causal, scale=scale)[0]
    return attention_reference(q, k, v, causal=causal, scale=scale)[0]


flash_attention.launches = 0
