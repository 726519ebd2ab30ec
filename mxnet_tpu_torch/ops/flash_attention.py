"""Flash-attention forward: the hand-written Hopper kernel and its plain
version.

Counterpart of ``flash_attention`` in ``mxnet_tpu/ops/pallas_kernels.py``
(the Pallas forward ``_flash_fwd_kernel``). Layout ``[B, H, T, D]``.

- On CPU tensors ``flash_attention`` computes :func:`attention_reference`,
  the plain PyTorch version.
- On CUDA tensors it launches the kernel in ``csrc/flash_fwd.cu`` and
  nothing else: a shape or dtype the kernel does not take raises, and so
  does a failed build or launch.

This slice is forward-only (serving): a CUDA tensor that requires grad
raises, because the backward kernels belong to the training slice.

``flash_attention.launches`` counts kernel launches (a plain int, bumped
where the kernel is launched and nowhere else).
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError, env_int

__all__ = ["attention_reference", "flash_attention", "flash_attention_fwd",
           "flash_kernel_usable", "SUPPORTED_HEAD_DIMS"]

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
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        tq, tk = scores.shape[-2], scores.shape[-1]
        iq = torch.arange(tq, device=q.device)[:, None]
        ik = torch.arange(tk, device=q.device)[None, :]
        scores = torch.where(ik <= iq, scores,
                             torch.full((), _NEG, device=q.device))
    lse = torch.logsumexp(scores, dim=-1)
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return o.to(q.dtype), lse


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


def flash_attention_fwd(q, k, v, causal=True, scale=None):
    """Launch the forward kernel on CUDA tensors; returns ``(o, lse)``
    with ``lse`` f32 ``[B, H, Tq]``. Counterpart of
    ``_flash_attention_pallas``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    _check_kernel_operands(q, k, v)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    # the kernel reads 16-byte vectors: contiguous, 16-byte aligned rows
    q, k, v = (t.contiguous() for t in (q, k, v))
    q, k, v = (t.clone() if t.data_ptr() % 16 else t for t in (q, k, v))
    o = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    from . import _build

    lib = _build.library("flash_fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mx_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b * h, tq, tk, d, float(scale), int(causal),
            int(q.dtype == torch.bfloat16), stream)
        flash_attention.launches += 1
    if err != 0:
        raise MXNetError("flash_fwd kernel launch failed: cudaError %d"
                         % err)
    return o, lse


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
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise MXNetError("flash kernel: forward only in this release "
                         "(backward kernels come with the training port)")


def flash_attention(q, k, v, causal=True, scale=None):
    """Blockwise-softmax attention, q,k,v ``[batch, heads, time, d]``.

    CPU tensors take :func:`attention_reference`; CUDA tensors launch
    the Hopper kernel (and raise where it does not apply)."""
    if q.is_cuda:
        return flash_attention_fwd(q, k, v, causal=causal, scale=scale)[0]
    return attention_reference(q, k, v, causal=causal, scale=scale)[0]


flash_attention.launches = 0
