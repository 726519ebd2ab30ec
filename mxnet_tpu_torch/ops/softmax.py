"""Row softmax: the hand-written Hopper kernel (K1) and its plain
version.

Counterpart of ``fused_softmax`` in ``mxnet_tpu/ops/pallas_kernels.py``
(the Pallas ``_softmax_kernel``), whose one caller is SoftmaxOutput's
forward. The kernel is ``csrc/softmax.cu``.

- On a CPU tensor :func:`fused_softmax` is :func:`softmax_reference`.
- On a CUDA tensor it launches the kernel and nothing else: a tensor the
  kernel does not take (not 2-D, not contiguous, a dtype other than
  f32/bf16/f16, an empty axis) raises, and so do a failed build and a
  failed launch. Unlike the TPU kernel it has no row-size limit and no
  fallback.

``fused_softmax.launches`` counts kernel launches, bumped where the
kernel is launched and nowhere else.
"""
from __future__ import annotations

import torch

from ..base import MXNetError

__all__ = ["fused_softmax", "softmax_reference"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def softmax_reference(x):
    """Plain softmax over the last axis: the TPU kernel's arithmetic
    (f32 max, exp(x - max), sum, divide), output in x's dtype."""
    x32 = x.float()
    e = torch.exp(x32 - x32.amax(dim=-1, keepdim=True))
    return (e / e.sum(dim=-1, keepdim=True)).to(x.dtype)


def fused_softmax(x):
    """Softmax over the last axis of a 2-D ``[N, C]`` tensor: the kernel
    on CUDA, :func:`softmax_reference` on the CPU."""
    if not x.is_cuda:
        return softmax_reference(x)
    if x.dim() != 2 or x.dtype not in _DTYPE_CODE or not x.is_contiguous() \
            or x.shape[0] < 1 or x.shape[1] < 1:
        raise MXNetError(
            "fused_softmax kernel: needs a contiguous 2-D [N >= 1, C >= 1] "
            "f32/bf16/f16 tensor, got %s %s%s"
            % (tuple(x.shape), x.dtype,
               "" if x.is_contiguous() else " (non-contiguous)"))
    from . import _build

    lib = _build.library("softmax")
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.mx_softmax(x.data_ptr(), y.data_ptr(), x.shape[0],
                             x.shape[1], _DTYPE_CODE[x.dtype], stream)
        fused_softmax.launches += 1
    if err != 0:
        raise MXNetError("softmax kernel launch failed: cudaError %d" % err)
    return y


fused_softmax.launches = 0
