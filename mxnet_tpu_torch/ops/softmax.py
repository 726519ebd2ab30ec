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
kernel is launched and nowhere else. :func:`variant` is the host's half
of the kernel: which of its variants (the table in ``csrc/softmax.cu``)
a row width takes.

:func:`fused_softmax` calls the custom op ``mxnet_tpu_torch::fused_softmax``
(``torch.library``): its CUDA kernel is the launch above, its CPU kernel
:func:`softmax_reference`, its fake an empty tensor of the input's
shape. So a program traced by ``torch.export`` (the Predictor's
``export_compiled``) holds the op itself, and running the exported
program on a CUDA tensor launches the kernel, in a process that imports
only this module's package.
"""
from __future__ import annotations

import functools

import torch

from ..base import MXNetError

__all__ = ["fused_softmax", "softmax_reference", "variant"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# row capacity of the kernel's variant 1 (elements: 8 lanes a row, 4
# slots a lane) and 2-3 (16-byte vectors: a warp a row, a block of 512
# threads a row, 8 vectors a thread); the kernel's launch refuses a row
# past its variant's capacity
SCALAR_CAPACITY = (32,)
VECTOR_CAPACITY = (256, 4096)


@functools.lru_cache(maxsize=256)
def variant(c, elem_size):
    """The kernel variant for rows of ``c`` elements of ``elem_size``
    bytes: the first that holds the row in registers, else 0 (two passes,
    any width)."""
    if c <= SCALAR_CAPACITY[-1]:
        return 1 + next(i for i, cap in enumerate(SCALAR_CAPACITY)
                        if c <= cap)
    vectors = c // (16 // elem_size)
    for i, cap in enumerate(VECTOR_CAPACITY):
        if vectors <= cap:
            return 1 + len(SCALAR_CAPACITY) + i
    return 0


def softmax_reference(x):
    """Plain softmax over the last axis: the TPU kernel's arithmetic
    (f32 max, exp(x - max), sum, divide), output in x's dtype."""
    x32 = x.float()
    e = torch.exp(x32 - x32.amax(dim=-1, keepdim=True))
    return (e / e.sum(dim=-1, keepdim=True)).to(x.dtype)


def fused_softmax(x):
    """Softmax over the last axis of a 2-D ``[N, C]`` tensor: the kernel
    on CUDA, :func:`softmax_reference` on the CPU (through the custom op,
    which dispatches on the tensor's device)."""
    return torch.ops.mxnet_tpu_torch.fused_softmax(x)


fused_softmax.launches = 0


@torch.library.custom_op("mxnet_tpu_torch::fused_softmax", mutates_args=(),
                         device_types="cpu")
def _fused_softmax_op(x: torch.Tensor) -> torch.Tensor:
    return softmax_reference(x)


@_fused_softmax_op.register_fake
def _(x):
    return torch.empty_like(x)


@_fused_softmax_op.register_kernel("cuda")
def _launch(x):
    """The kernel on a CUDA tensor, or a raise: never a fallback."""
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
    n, c = x.shape
    dev = x.get_device()
    args = (x.data_ptr(), y.data_ptr(), n, c, _DTYPE_CODE[x.dtype],
            variant(c, x.element_size()))
    if dev == torch.cuda.current_device():
        err = lib.mx_softmax(*args, _build.raw_stream(dev))
    else:
        with torch.cuda.device(dev):
            err = lib.mx_softmax(*args, _build.raw_stream(dev))
    fused_softmax.launches += 1
    if err != 0:
        raise MXNetError("softmax kernel launch failed: cudaError %d" % err)
    return y
