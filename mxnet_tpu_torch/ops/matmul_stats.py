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
  kernel does not take (not both bf16, 2-D, contiguous, 16-byte aligned
  and on one card; K not a multiple of 16; N not a multiple of 8 in
  [8, 256]) raise, and so do a failed build and a failed launch. Any
  M >= 1 works.

``matmul_stats.launches`` counts kernel launches, bumped where the
kernel is launched and nowhere else. One launch runs two CUDA kernels:
the persistent row-tile kernel, then the fixed-order sum of its blocks'
column partials. :func:`plan` is the host's half of the kernel: the
persistent grid, from the shape and the SM count; the kernel picks its
ring's depth itself.
"""
from __future__ import annotations

import functools

import torch

from ..base import MXNetError

__all__ = ["matmul_stats", "matmul_stats_reference", "plan", "ROW_TILE"]

ROW_TILE = 64        # rows of a tile: the kernel's one consumer warpgroup
H100_SMS = 132


def plan(m, k, n, sms=H100_SMS):
    """The kernel's launch plan for x [m, k] and w [k, n] on a card with
    ``sms`` SMs, a dict of ``np``, the wgmma width (n rounded up to 64,
    128 or 256), ``tiles`` of ROW_TILE rows and ``grid`` = min(sms,
    tiles) persistent blocks (the partials are [2, 1 + grid, n])."""
    np_ = 64 if n <= 64 else 128 if n <= 128 else 256
    tiles = -(-m // ROW_TILE)
    return {"np": np_, "tiles": tiles, "grid": min(sms, tiles)}


_plan = functools.lru_cache(maxsize=256)(plan)


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
          and x.shape[1] == w.shape[0]
          and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
    if ok:
        m, k = x.shape
        n = w.shape[1]
        ok = (1 <= m < 2 ** 31 and k >= 16 and k % 16 == 0
              and 8 <= n <= 256 and n % 8 == 0)
    if not ok:
        raise MXNetError(
            "matmul_stats kernel: needs contiguous, 16-byte aligned bf16 x "
            "[M >= 1, K] and w [K, N] on one CUDA device, K a multiple of "
            "16, N a multiple of 8 in [8, 256]; got x %s %s %s%s, w %s %s "
            "%s%s"
            % (tuple(x.shape), x.dtype, x.device,
               "" if x.is_contiguous() else " (non-contiguous)",
               tuple(w.shape), w.dtype, w.device,
               "" if w.is_contiguous() else " (non-contiguous)"))


_SMS = {}   # device index -> SM count


def sm_count(device):
    """The SM count of a CUDA device (one query a device)."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    n = _SMS.get(idx)
    if n is None:
        n = _SMS[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return n


def matmul_stats(x, w):
    """``(y, s, s2)`` for ``x`` [M, K] and ``w`` [K, N]: the kernel when
    either lies on a card, :func:`matmul_stats_reference` on the CPU."""
    if not (x.is_cuda or w.is_cuda):
        return matmul_stats_reference(x, w)
    _check(x, w)
    return _launch(x, w, _plan(x.shape[0], x.shape[1], w.shape[1],
                               sm_count(x.device)))


def _launch(x, w, p):
    """Run the kernel on checked inputs under the plan ``p``. s and s2 are
    rows 0 of one [2, 1 + grid, N] f32 buffer whose rows 1 .. grid hold
    the blocks' partials."""
    from . import _build

    lib = _build.library("matmul_stats")
    m, k = x.shape
    n = w.shape[1]
    y = x.new_empty((m, n))
    stats = x.new_empty((2, 1 + p["grid"], n), dtype=torch.float32)
    args = (x.data_ptr(), w.data_ptr(), y.data_ptr(), stats.data_ptr(), m,
            k, n, p["grid"])
    dev = x.get_device()
    if dev == torch.cuda.current_device():
        err = lib.mx_matmul_stats(*args, _build.raw_stream(dev))
    else:
        with torch.cuda.device(dev):
            err = lib.mx_matmul_stats(*args, _build.raw_stream(dev))
    matmul_stats.launches += 1
    if err != 0:
        raise MXNetError("matmul_stats kernel launch failed: error %d" % err)
    s, s2 = stats[:, :1].unbind(0)
    return y, s, s2


matmul_stats.launches = 0
