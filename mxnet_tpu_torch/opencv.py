"""OpenCV plugin facade: mx.cv-style image ops without OpenCV.

Re-design of plugin/opencv/cv_api.cc (SURVEY §2.21): the reference
exposes ``MXCVImdecode``, ``MXCVResize`` and ``MXCVcopyMakeBorder`` as a
C-API plugin backed by OpenCV.

mxnet_tpu_torch's counterpart of ``mxnet_tpu/opencv.py``:

- ``imdecode`` — JPEG/PNG decode via PIL, raising a clear gate error
  when PIL is missing; the array lands on the current context;
- ``resize`` — the JAX package's ``jax.image.resize`` rewritten in torch
  on the image's device: one weight matrix an axis (nearest, or a
  triangle/Keys-cubic/Lanczos-3 kernel widened when it downsamples, as
  ``jax.image.scale_and_translate`` builds it) contracted with the
  image;
- ``copyMakeBorder`` — ``torch.nn.functional.pad`` with OpenCV
  border-type semantics.

Images are HWC uint8/float arrays, matching cv_api's layout.
"""
from __future__ import annotations

import math

import numpy as _np
import torch

from .base import MXNetError
from .ndarray import NDArray

__all__ = ["imdecode", "resize", "copyMakeBorder",
           "BORDER_CONSTANT", "BORDER_REPLICATE", "BORDER_REFLECT",
           "BORDER_WRAP", "IMREAD_COLOR", "IMREAD_GRAYSCALE"]

# OpenCV constants (plugin/opencv/cv_api.h values)
BORDER_CONSTANT = 0
BORDER_REPLICATE = 1
BORDER_REFLECT = 2
BORDER_WRAP = 3
IMREAD_GRAYSCALE = 0
IMREAD_COLOR = 1

_INTERP = {0: "nearest", 1: "linear", 2: "cubic", 3: "cubic", 4: "lanczos3"}


def imdecode(buf, flag=IMREAD_COLOR, to_rgb=True):
    """Decode a compressed image buffer to an HWC uint8 NDArray
    (ref: MXCVImdecode, plugin/opencv/cv_api.cc)."""
    try:
        import io as _io

        from PIL import Image
    except ImportError as e:
        raise MXNetError(
            "opencv.imdecode requires PIL (the data pipeline's decoder "
            "is mxnet_tpu_torch.io.ImageRecordIter)") from e
    try:
        img = Image.open(_io.BytesIO(bytes(buf)))
        img = img.convert("L" if flag == IMREAD_GRAYSCALE else "RGB")
    except Exception as e:
        raise MXNetError("imdecode: cannot decode image buffer: %s" % e) from e
    arr = _np.asarray(img, dtype=_np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    elif not to_rgb:
        arr = arr[:, :, ::-1]  # BGR like OpenCV default
    return NDArray(_np.ascontiguousarray(arr))


def _kernel(name, x):
    """``jax.image``'s interpolation kernels (``_fill_*_kernel``)."""
    if name == "linear":
        return torch.clamp(1 - x.abs(), min=0)
    if name == "cubic":   # Keys, a = -0.5
        out = ((1.5 * x - 2.5) * x) * x + 1.0
        out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0,
                          out)
        return torch.where(x >= 2.0, torch.zeros_like(x), out)
    radius = 3.0   # lanczos3
    y = radius * torch.sin(math.pi * x) * torch.sin(math.pi * x / radius)
    safe = torch.where(x != 0, math.pi ** 2 * x ** 2, torch.ones_like(x))
    out = torch.where(x > 1e-3, y / safe, torch.ones_like(x))
    return torch.where(x > radius, torch.zeros_like(x), out)


def _weights(m, n, name, device):
    """[m, n] weights from input positions to output positions of one
    axis, as ``jax.image.compute_weight_mat`` builds them (f32, the
    kernel widened by the downscale factor)."""
    f32 = torch.float32
    inv_scale = torch.tensor(1.0 / (n / m), dtype=f32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = (torch.arange(n, dtype=f32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(m, dtype=f32)[:, None]).abs() \
        / kernel_scale
    w = _kernel(name, x)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(_np.finfo(_np.float32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
    w = torch.where(inside[None, :], w, torch.zeros_like(w))
    return w.to(device)


def _resize_hw(data, h, w, method):
    """``jax.image.resize(data, (h, w, C), method)`` of an HWC float
    tensor; an axis whose size does not change is left alone."""
    H, W = data.shape[0], data.shape[1]
    if method == "nearest":
        for axis, (m, n) in enumerate(((H, h), (W, w))):
            if m == n:
                continue
            off = (torch.arange(n, dtype=torch.float32) + 0.5) * m / n
            idx = torch.floor(off).to(torch.int64).to(data.device)
            data = data.index_select(axis, idx)
        return data
    if H != h:
        data = torch.einsum("hwc,hy->ywc", data,
                            _weights(H, h, method, data.device))
    if W != w:
        data = torch.einsum("hwc,wx->hxc", data,
                            _weights(W, w, method, data.device))
    return data


def resize(src, size, interp=1):
    """Resize HWC image to ``size=(w, h)``
    (ref: MXCVResize; interp codes follow cv2: 0=nearest 1=linear
    2/3=cubic 4=lanczos)."""
    if interp not in _INTERP:
        raise MXNetError("resize: unknown interp %r" % (interp,))
    data = src._data if isinstance(src, NDArray) else torch.as_tensor(
        _np.asarray(src))
    if data.dim() != 3:
        raise MXNetError("resize expects an HWC image")
    w, h = int(size[0]), int(size[1])
    orig_dtype = data.dtype
    out = _resize_hw(data.to(torch.float32), h, w, _INTERP[interp])
    if not orig_dtype.is_floating_point:
        info = torch.iinfo(orig_dtype)
        out = torch.clamp(torch.round(out), info.min, info.max)
    return NDArray(out.to(orig_dtype),
                   src.context if isinstance(src, NDArray) else None)


def copyMakeBorder(src, top, bot, left, right, border_type=BORDER_CONSTANT,
                   value=0.0):
    """Pad an HWC image (ref: MXCVcopyMakeBorder)."""
    import torch.nn.functional as F

    data = src._data if isinstance(src, NDArray) else torch.as_tensor(
        _np.asarray(src))
    if data.dim() != 3:
        raise MXNetError("copyMakeBorder expects an HWC image")
    if border_type == BORDER_CONSTANT:
        out = F.pad(data, (0, 0, left, right, top, bot), value=value)
    elif border_type in (BORDER_REPLICATE, BORDER_REFLECT, BORDER_WRAP):
        # F.pad's edge modes pad only the trailing axes of a batched
        # float tensor: pad a [1, C, H, W] float copy, cast back
        mode = {BORDER_REPLICATE: "replicate", BORDER_REFLECT: "reflect",
                BORDER_WRAP: "circular"}[border_type]
        chw = data.permute(2, 0, 1)[None].to(torch.float64)
        out = F.pad(chw, (left, right, top, bot), mode=mode)
        out = out[0].permute(1, 2, 0).to(data.dtype)
    else:
        raise MXNetError("copyMakeBorder: unknown border_type %r"
                         % (border_type,))
    return NDArray(out.contiguous(),
                   src.context if isinstance(src, NDArray) else None)
