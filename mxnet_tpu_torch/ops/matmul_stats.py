"""Matmul with per-column statistics: the hand-written Hopper kernel (K6)
and its plain version.

Counterpart of ``make_pallas`` in ``tools/probe_matmul_stats.py`` (the
Pallas matmul whose epilogue also sums each output column and its
square), the feasibility probe for folding BatchNorm's statistics pass
into ResNet-50's 1x1 convolutions. Nothing of the executor calls it; its
entry point is ``tools/torch_probe_matmul_stats.py``. The kernel is
``csrc/matmul_stats.cu``.

- On CPU tensors :func:`matmul_stats` is :func:`matmul_stats_reference`.
- On CUDA tensors it launches the kernel and nothing else: inputs the
  kernel does not take (not both bf16, 2-D, contiguous and on one card;
  K not a multiple of 16; N not a multiple of 8 in [8, 256]) raise, and
  so do a failed build and a failed launch. Any M >= 1 works.

``matmul_stats.launches`` counts kernel launches, bumped where the
kernel is launched and nowhere else. One launch runs two CUDA kernels:
the row tiles, then the fixed-order sum of their column partials.
"""
from __future__ import annotations

import torch

from ..base import MXNetError

__all__ = ["matmul_stats", "matmul_stats_reference", "ROW_TILE"]

ROW_TILE = 64   # rows of one block's tile: the partials are [2, ceil(M/64), N]


def matmul_stats_reference(x, w):
    """The Pallas kernel's arithmetic in plain torch: ``acc = x @ w`` in
    f32 (products of bf16 values are exact in f32), ``y = bf16(acc)``
    [M, N], and the column sums of ``acc`` and ``acc**2``, each [1, N]
    f32."""
    acc = x.float() @ w.float()
    return (acc.to(torch.bfloat16), acc.sum(0, keepdim=True),
            acc.square().sum(0, keepdim=True))


def _check(x, w):
    ok = (x.is_cuda and w.is_cuda and x.device == w.device
          and x.dtype == torch.bfloat16 and w.dtype == torch.bfloat16
          and x.dim() == 2 and w.dim() == 2
          and x.is_contiguous() and w.is_contiguous()
          and x.shape[1] == w.shape[0])
    if ok:
        m, k = x.shape
        n = w.shape[1]
        ok = (1 <= m < 2 ** 31 and k >= 16 and k % 16 == 0
              and 8 <= n <= 256 and n % 8 == 0)
    if not ok:
        raise MXNetError(
            "matmul_stats kernel: needs contiguous bf16 x [M >= 1, K] and "
            "w [K, N] on one CUDA device, K a multiple of 16, N a multiple "
            "of 8 in [8, 256]; got x %s %s %s%s, w %s %s %s%s"
            % (tuple(x.shape), x.dtype, x.device,
               "" if x.is_contiguous() else " (non-contiguous)",
               tuple(w.shape), w.dtype, w.device,
               "" if w.is_contiguous() else " (non-contiguous)"))


def matmul_stats(x, w):
    """``(y, s, s2)`` for ``x`` [M, K] and ``w`` [K, N]: the kernel when
    either lies on a card, :func:`matmul_stats_reference` on the CPU."""
    if not (x.is_cuda or w.is_cuda):
        return matmul_stats_reference(x, w)
    _check(x, w)
    from . import _build

    lib = _build.library("matmul_stats")
    m, k = x.shape
    n = w.shape[1]
    y = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    s = torch.empty((1, n), dtype=torch.float32, device=x.device)
    s2 = torch.empty((1, n), dtype=torch.float32, device=x.device)
    partials = torch.empty((2, -(-m // ROW_TILE), n), dtype=torch.float32,
                           device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.mx_matmul_stats(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                                  s.data_ptr(), s2.data_ptr(),
                                  partials.data_ptr(), m, k, n, stream)
        matmul_stats.launches += 1
    if err != 0:
        raise MXNetError("matmul_stats kernel launch failed: cudaError %d"
                         % err)
    return y, s, s2


matmul_stats.launches = 0
