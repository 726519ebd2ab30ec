"""Vision ops: ROIPooling, SpatialTransformer, Correlation, the SSD
MultiBox ops, and the ``CuDNNBatchNorm`` and ``_CrossDeviceCopy`` names.

Counterpart of ``mxnet_tpu/ops/vision.py``, with the same parameter
fields, inputs, outputs, shape inference and error messages. The JAX
package maps each op over the batch with ``jax.vmap``; here every op is
written over the batch axis with tensor ops, and runs on the device of
its inputs. Gradients come from autograd.

- ``ROIPooling`` (``:19-77``): each ROI's corners scaled and rounded
  half to even, then for each output bin the max over the bin's rows and
  columns (an empty bin gives 0); the ROI's image is gathered by its
  batch index (negative indices wrap once, then clamp, as JAX's gather
  does), and the gather's backward sums each image's ROI gradients by a
  one-hot product, in the same order on every run (``index_put_``
  accumulates with atomics on the CPU, ``index_add_`` on CUDA). The max
  uses ``amax``, which, like ``jnp.max``'s gradient, shares the gradient
  evenly between equal maxima.
- ``SpatialTransformer`` (``:82-147``): an affine grid over
  ``linspace(-1, 1)`` and bilinear sampling with zeros outside the image.
- ``Correlation`` (``:151-236``): for each displacement, the product (or
  absolute difference) of two shifted slices of the padded inputs,
  summed over the window and channels by one convolution with a kernel
  of ones.
- ``MultiBoxPrior`` (``:298-353``): anchors in the reference's order
  (every size at ratio 1, then ``ratios[1:]`` at ``sizes[0]``); the
  half-extents are Python doubles cast to f32 once, as the JAX op does;
  computed on the host (they depend on shapes only) and moved once.
- ``MultiBoxTarget`` (``:355-523``): L rounds of greedy bipartite
  matching (the first maximum of the flattened [A, L] IoU
  matrix a round), threshold matching, hard-negative mining by the best
  non-background softmax probability (a stable descending sort), then
  the regression targets. Nothing reads the device on the host: the
  rounds always run L times and every count stays a tensor, so a fit
  can queue many steps. The outputs are targets, not differentiable
  outputs: they are detached.
- ``MultiBoxDetection`` (``:525-622``): the best foreground class of
  each anchor, the decoded boxes, a stable sort by score, and A rounds
  of suppression (each round one box against every later box).
"""
from __future__ import annotations

import ast
import math

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .registry import REGISTRY, Field, OpDef, register


# -- ROIPooling ----------------------------------------------------------------
class _GatherImages(torch.autograd.Function):
    """``data[idx]`` over the batch axis; the backward sums the rows of
    each image as ``one_hot(idx).T @ grad``, in a fixed order."""

    @staticmethod
    def forward(ctx, data, idx):
        ctx.save_for_backward(idx)
        ctx.n = data.shape[0]
        return data.index_select(0, idx)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        hot = F.one_hot(idx, ctx.n).to(grad.dtype)          # (R, N)
        g = hot.t() @ grad.reshape(grad.shape[0], -1)
        return g.reshape((ctx.n,) + grad.shape[1:]), None


def _roi_pooling_fwd(params, inputs, aux, is_train, rng):
    data, rois = inputs
    ph, pw = params["pooled_size"]
    scale = params["spatial_scale"]
    N, _, H, W = data.shape
    dev = data.device
    idx = rois[:, 0].to(torch.int64)
    idx = torch.where(idx < 0, idx + N, idx).clamp(0, N - 1)
    x1, y1, x2, y2 = (torch.round(rois[:, k] * scale).to(torch.int32)
                      for k in range(1, 5))
    rh = torch.clamp(y2 - y1 + 1, min=1)[:, None]
    rw = torch.clamp(x2 - x1 + 1, min=1)[:, None]
    y1, x1 = y1[:, None], x1[:, None]
    img = _GatherImages.apply(data, idx)  # (R, C, H, W)
    ys = torch.arange(H, device=dev)[None, :]
    xs = torch.arange(W, device=dev)[None, :]
    bins = []
    for i in range(ph):
        hstart = y1 + torch.div(i * rh, ph, rounding_mode="floor")
        hend = y1 + torch.div((i + 1) * rh + ph - 1, ph,
                              rounding_mode="floor")
        row_mask = (ys >= hstart) & (ys < torch.maximum(hend, hstart + 1))
        row = []
        for j in range(pw):
            wstart = x1 + torch.div(j * rw, pw, rounding_mode="floor")
            wend = x1 + torch.div((j + 1) * rw + pw - 1, pw,
                                  rounding_mode="floor")
            col_mask = (xs >= wstart) & (xs < torch.maximum(wend, wstart + 1))
            mask = row_mask[:, :, None] & col_mask[:, None, :]  # (R, H, W)
            masked = torch.where(mask[:, None], img, -math.inf)
            v = torch.amax(masked, dim=(2, 3))
            row.append(torch.where(torch.isfinite(v), v, 0.0))
        bins.append(torch.stack(row, dim=-1))
    out = torch.stack(bins, dim=-2)  # (R, C, ph, pw)
    return [out.to(data.dtype)], []


def _roi_pooling_shape(params, in_shapes):
    if in_shapes[0] is None or in_shapes[1] is None:
        raise MXNetError("ROIPooling: input shapes unknown")
    ph, pw = params["pooled_size"]
    nroi = in_shapes[1][0]
    return list(in_shapes), [(nroi, in_shapes[0][1], ph, pw)], []


register(
    OpDef(
        "ROIPooling",
        _roi_pooling_fwd,
        params={
            "pooled_size": Field("shape", required=True),
            "spatial_scale": Field("float", required=True),
        },
        arguments=("data", "rois"),
        infer_shape=_roi_pooling_shape,
    )
)


# -- SpatialTransformer --------------------------------------------------------
def _bilinear_sample(img, gx, gy):
    """img (N, C, H, W); gx, gy (N, Ho, Wo) in pixel coordinates ->
    (N, C, Ho, Wo), zeros outside the image."""
    N, C, H, W = img.shape
    Ho, Wo = gx.shape[1], gx.shape[2]
    flat = img.reshape(N, C, H * W)
    x0 = torch.floor(gx).to(torch.int64)
    y0 = torch.floor(gy).to(torch.int64)
    x1, y1 = x0 + 1, y0 + 1
    wx1 = gx - x0
    wy1 = gy - y0
    wx0, wy0 = 1 - wx1, 1 - wy1

    def at(yy, xx):
        valid = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        lin = (yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)).reshape(N, 1, -1)
        v = torch.gather(flat, 2, lin.expand(N, C, Ho * Wo))
        return torch.where(valid[:, None], v.reshape(N, C, Ho, Wo), 0.0)

    return (at(y0, x0) * (wy0 * wx0)[:, None]
            + at(y0, x1) * (wy0 * wx1)[:, None]
            + at(y1, x0) * (wy1 * wx0)[:, None]
            + at(y1, x1) * (wy1 * wx1)[:, None])


def _spatial_transformer_fwd(params, inputs, aux, is_train, rng):
    data, loc = inputs
    Ho, Wo = params["target_shape"]
    H, W = data.shape[2], data.shape[3]
    dev = data.device
    theta = loc.reshape(-1, 2, 3).to(torch.float32)
    ys = torch.linspace(-1.0, 1.0, Ho, device=dev)
    xs = torch.linspace(-1.0, 1.0, Wo, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    grid = torch.stack([gx.reshape(-1), gy.reshape(-1),
                        torch.ones(Ho * Wo, device=dev)], dim=0)  # (3, HoWo)
    src = theta @ grid  # (N, 2, HoWo) normalized coordinates
    sx = (src[:, 0].reshape(-1, Ho, Wo) + 1.0) * (W - 1) / 2.0
    sy = (src[:, 1].reshape(-1, Ho, Wo) + 1.0) * (H - 1) / 2.0
    out = _bilinear_sample(data, sx, sy)
    return [out.to(data.dtype)], []


def _st_shape(params, in_shapes):
    if in_shapes[0] is None:
        raise MXNetError("SpatialTransformer: data shape unknown")
    Ho, Wo = params["target_shape"]
    s = in_shapes[0]
    return [s, (s[0], 6)], [(s[0], s[1], Ho, Wo)], []


register(
    OpDef(
        "SpatialTransformer",
        _spatial_transformer_fwd,
        params={
            "target_shape": Field("shape", required=True),
            "transform_type": Field("str", default="affine", enum=["affine"]),
            "sampler_type": Field("str", default="bilinear", enum=["bilinear"]),
        },
        arguments=("data", "loc"),
        infer_shape=_st_shape,
    )
)


# -- Correlation ---------------------------------------------------------------
def _corr_geom(params, dshape):
    """The output geometry, checked as the JAX op checks it."""
    pad, ks = params["pad_size"], params["kernel_size"]
    if ks < 1 or ks % 2 == 0:
        raise MXNetError("Correlation: kernel_size must be odd, got %d" % ks)
    md, s1, s2 = params["max_displacement"], params["stride1"], params["stride2"]
    ph, pw = dshape[2] + 2 * pad, dshape[3] + 2 * pad
    kr = (ks - 1) // 2
    border = md + kr
    top_h = int(math.ceil(float(ph - 2 * border) / s1))
    top_w = int(math.ceil(float(pw - 2 * border) / s1))
    ngr = md // s2
    ngw = 2 * ngr + 1
    if top_h < 1 or top_w < 1:
        raise MXNetError(
            "Correlation cannot be done with current settings. "
            "Neighborhood and kernel don't fit in blob"
        )
    return ph, pw, kr, top_h, top_w, ngr, ngw


def _correlation_fwd(params, inputs, aux, is_train, rng):
    data1, data2 = inputs
    pad, ks = params["pad_size"], params["kernel_size"]
    md, s1, s2 = params["max_displacement"], params["stride1"], params["stride2"]
    _, _, _, top_h, top_w, ngr, ngw = _corr_geom(params, data1.shape)
    C = data1.shape[1]
    p1 = F.pad(data1.to(torch.float32), (pad, pad, pad, pad))
    p2 = F.pad(data2.to(torch.float32), (pad, pad, pad, pad))
    sumelems = float(ks * ks * C)
    span_h = (top_h - 1) * s1 + ks
    span_w = (top_w - 1) * s1 + ks
    a = p1[:, :, md:md + span_h, md:md + span_w]
    ones_k = torch.ones((1, C, ks, ks), dtype=torch.float32,
                        device=data1.device)
    chans = []
    for tc in range(ngw * ngw):
        s2o = (tc % ngw - ngr) * s2
        s2p = (tc // ngw - ngr) * s2
        b = p2[:, :, md + s2p:md + s2p + span_h, md + s2o:md + s2o + span_w]
        prod = a * b if params["is_multiply"] else torch.abs(a - b)
        corr = F.conv2d(prod, ones_k, stride=(s1, s1))
        chans.append(corr[:, 0] / sumelems)
    out = torch.stack(chans, dim=1)
    return [out.to(data1.dtype)], []


def _correlation_shape(params, in_shapes):
    if in_shapes[0] is None:
        raise MXNetError("Correlation: data shape unknown")
    d = in_shapes[0]
    if len(d) != 4:
        raise MXNetError("Correlation: data should be a 4D tensor")
    _, _, _, top_h, top_w, _, ngw = _corr_geom(params, d)
    return [d, d], [(d[0], ngw * ngw, top_h, top_w)], []


register(
    OpDef(
        "Correlation",
        _correlation_fwd,
        params={
            "kernel_size": Field("int", default=1),
            "max_displacement": Field("int", default=1),
            "stride1": Field("int", default=1),
            "stride2": Field("int", default=1),
            "pad_size": Field("int", default=0),
            "is_multiply": Field("bool", default=True),
        },
        arguments=("data1", "data2"),
        infer_shape=_correlation_shape,
    )
)


# -- name aliases --------------------------------------------------------------
# CuDNNBatchNorm is the reference's cuDNN path of BatchNorm: one
# implementation here, so the name aliases it. _CrossDeviceCopy is a
# graph-visible identity.
REGISTRY["CuDNNBatchNorm"] = REGISTRY["BatchNorm"]


def _cross_device_copy_fwd(params, inputs, aux, is_train, rng):
    return [inputs[0]], []


register(
    OpDef(
        "_CrossDeviceCopy",
        _cross_device_copy_fwd,
        arguments=("data",),
        imperative=False,
    )
)


# -- SSD MultiBox ops ----------------------------------------------------------
def _parse_floats(v, default):
    if v is None:
        return tuple(default)
    if isinstance(v, (int, float)):
        return (float(v),)
    if isinstance(v, str):
        v = ast.literal_eval(v)
        if isinstance(v, (int, float)):
            return (float(v),)
    return tuple(float(x) for x in v)


def _multibox_prior_fwd(params, inputs, aux, is_train, rng):
    data = inputs[0]
    sizes = _parse_floats(params["sizes"], (1.0,))
    ratios = _parse_floats(params["ratios"], (1.0,))
    in_h, in_w = data.shape[2], data.shape[3]
    # the anchors depend on shapes and parameters only: computed on the
    # host and moved once, without waiting for the device
    step_x, step_y = 1.0 / in_w, 1.0 / in_h
    cy = (torch.arange(in_h, dtype=torch.float32) + 0.5) * step_y
    cx = (torch.arange(in_w, dtype=torch.float32) + 0.5) * step_x
    # half-extents in Python doubles, cast to f32 once
    hw = [s / 2.0 for s in sizes]
    hh = [s / 2.0 for s in sizes]
    for r in ratios[1:]:
        sr = float(r) ** 0.5
        hw.append(sizes[0] * sr / 2.0)
        hh.append(sizes[0] / sr / 2.0)
    hw = torch.tensor(hw, dtype=torch.float32)  # (K,)
    hh = torch.tensor(hh, dtype=torch.float32)
    gy, gx = torch.meshgrid(cy, cx, indexing="ij")  # (H, W)
    cxx = gx[:, :, None]
    cyy = gy[:, :, None]
    boxes = torch.stack([cxx - hw, cyy - hh, cxx + hw, cyy + hh], dim=-1)
    out = boxes.reshape(1, in_h * in_w * hw.shape[0], 4)
    if params["clip"]:
        out = torch.clamp(out, 0.0, 1.0)
    return [out.to(data.device, data.dtype, non_blocking=True)], []


def _multibox_prior_shape(params, in_shapes):
    if in_shapes[0] is None:
        raise MXNetError("MultiBoxPrior: data shape unknown")
    d = in_shapes[0]
    if len(d) < 4:
        raise MXNetError("MultiBoxPrior: input must be 4D (NCHW)")
    k = (len(_parse_floats(params["sizes"], (1.0,)))
         + len(_parse_floats(params["ratios"], (1.0,))) - 1)
    return list(in_shapes), [(1, d[2] * d[3] * k, 4)], []


register(
    OpDef(
        "MultiBoxPrior",
        _multibox_prior_fwd,
        params={
            "sizes": Field("any", default=(1.0,)),
            "ratios": Field("any", default=(1.0,)),
            "clip": Field("bool", default=False),
        },
        arguments=("data",),
        infer_shape=_multibox_prior_shape,
    )
)


def _box_iou(a, g):
    """Corner boxes a (..., A, 4) against g (..., L, 4) -> IoU (..., A, L),
    with the JAX op's arithmetic in its order."""
    ax1, ay1, ax2, ay2 = (a[..., :, i:i + 1] for i in range(4))
    gx1, gy1, gx2, gy2 = (g[..., None, :, i] for i in range(4))
    iw = torch.clamp(torch.minimum(ax2, gx2) - torch.maximum(ax1, gx1), min=0.0)
    ih = torch.clamp(torch.minimum(ay2, gy2) - torch.maximum(ay1, gy1), min=0.0)
    inter = iw * ih
    area_a = (ax2 - ax1) * (ay2 - ay1)
    area_g = (gx2 - gx1) * (gy2 - gy1)
    union = area_a + area_g - inter
    return torch.where(union > 0, inter / union, 0.0)


def _encode_loc(anchors, gt, variances):
    """Corner anchors (A, 4) and matched gt corners (B, A, 4) -> regression
    targets (B, A, 4), using the anchor height for the y offset as the
    reference does."""
    vx, vy, vw, vh = variances
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    ax = (anchors[:, 0] + anchors[:, 2]) * 0.5
    ay = (anchors[:, 1] + anchors[:, 3]) * 0.5
    gw = gt[..., 2] - gt[..., 0]
    gh = gt[..., 3] - gt[..., 1]
    gx = (gt[..., 0] + gt[..., 2]) * 0.5
    gy = (gt[..., 1] + gt[..., 3]) * 0.5

    def safe(x):
        return torch.clamp(x, min=1e-12)

    return torch.stack([
        (gx - ax) / safe(aw) / vx,
        (gy - ay) / safe(ah) / vy,
        torch.log(safe(gw) / safe(aw)) / vw,
        torch.log(safe(gh) / safe(ah)) / vh,
    ], dim=-1)


def _multibox_target(anchors, labels, cls_pred, overlap_threshold,
                     ignore_label, neg_ratio, neg_thresh, min_neg, variances):
    """anchors (A, 4), labels (B, L, 5), cls_pred (B, C, A), all f32 ->
    loc_target (B, A*4), loc_mask (B, A*4), cls_target (B, A)."""
    B, L = labels.shape[0], labels.shape[1]
    A = anchors.shape[0]
    dev = anchors.device
    a_idx = torch.arange(A, device=dev)
    l_idx = torch.arange(L, device=dev)
    valid_gt = labels[:, :, 0] >= 0   # (B, L); id -1 marks padding
    any_gt = valid_gt.any(dim=1)      # (B,)
    iou = _box_iou(anchors, labels[:, :, 1:5])  # (B, A, L)
    iou = torch.where(valid_gt[:, None, :], iou, -1.0)

    # stage 1: greedy bipartite matching, L rounds
    match_gt = torch.full((B, A), -1, dtype=torch.int64, device=dev)
    anchor_used = torch.zeros((B, A), dtype=torch.bool, device=dev)
    gt_used = torch.zeros((B, L), dtype=torch.bool, device=dev)
    for _ in range(L):
        m = torch.where(anchor_used[:, :, None] | gt_used[:, None, :], -1.0,
                        iou)
        flat = torch.argmax(m.reshape(B, A * L), dim=1)   # first maximum
        ai = torch.div(flat, L, rounding_mode="floor")
        gi = flat % L
        best = torch.gather(m.reshape(B, A * L), 1, flat[:, None])[:, 0]
        ok = best > 1e-6
        sel = (a_idx[None, :] == ai[:, None]) & ok[:, None]   # (B, A)
        match_gt = torch.where(sel, gi[:, None], match_gt)
        anchor_used = anchor_used | sel
        gt_used = gt_used | ((l_idx[None, :] == gi[:, None]) & ok[:, None])
    anchor_pos = anchor_used

    # stage 2: threshold matching for the remaining anchors
    best_iou = torch.amax(iou, dim=2)     # (B, A)
    best_gt = torch.argmax(iou, dim=2)    # the first maximum
    if overlap_threshold > 0:
        thr_pos = (~anchor_pos) & (best_iou > overlap_threshold)
        match_gt = torch.where(thr_pos, best_gt, match_gt)
        anchor_pos = anchor_pos | thr_pos
    num_positive = anchor_pos.sum(dim=1)   # (B,)

    # stage 3: negatives
    if neg_ratio > 0:
        # hard-negative mining by the best non-background softmax prob
        mx = torch.amax(cls_pred, dim=1)            # (B, A)
        e = torch.exp(cls_pred - mx[:, None, :])
        prob_pos = torch.amax(e[:, 1:], dim=1) / e.sum(dim=1)
        cand = (~anchor_pos) & (best_iou < neg_thresh) & (best_iou >= 0)
        num_negative = torch.minimum(
            torch.clamp((num_positive * neg_ratio).to(torch.int32),
                        min=int(min_neg)),
            A - num_positive)
        score = torch.where(cand, prob_pos, -math.inf)
        order = torch.argsort(-score, dim=1, stable=True)   # descending
        rank = torch.empty_like(order).scatter_(
            1, order, a_idx.expand(B, A).contiguous())
        neg = cand & (rank < num_negative[:, None])
    else:
        neg = ~anchor_pos

    gidx = match_gt.clamp(0, L - 1)   # (B, A)
    matched = torch.gather(labels, 1, gidx[:, :, None].expand(B, A, 5))
    neither = torch.where(neg, 0.0, ignore_label)
    cls_target = torch.where(anchor_pos, matched[:, :, 0] + 1.0, neither)
    loc_t = _encode_loc(anchors, matched[:, :, 1:5], variances)
    pos4 = anchor_pos[:, :, None]
    loc_target = torch.where(pos4, loc_t, 0.0).reshape(B, -1)
    loc_mask = pos4.expand(B, A, 4).to(torch.float32).reshape(B, -1)
    # an item with no valid gt keeps the initial values
    cls_target = torch.where(any_gt[:, None], cls_target, ignore_label)
    loc_target = torch.where(any_gt[:, None], loc_target, 0.0)
    loc_mask = torch.where(any_gt[:, None], loc_mask, 0.0)
    return loc_target, loc_mask, cls_target


def _multibox_target_fwd(params, inputs, aux, is_train, rng):
    anchors, labels, cls_preds = inputs
    variances = _parse_floats(params["variances"], (0.1, 0.1, 0.2, 0.2))
    f32 = torch.float32
    with torch.no_grad():
        outs = _multibox_target(
            anchors.detach().reshape(-1, 4).to(f32), labels.detach().to(f32),
            cls_preds.detach().to(f32), params["overlap_threshold"],
            params["ignore_label"], params["negative_mining_ratio"],
            params["negative_mining_thresh"],
            params["minimum_negative_samples"], variances)
    # targets are labels, not differentiable outputs: without the cut the
    # loc loss would reach cls_preds through the mining sort
    return [o.to(anchors.dtype) for o in outs], []


def _multibox_target_shape(params, in_shapes):
    a, l, p = in_shapes
    if a is None or l is None or p is None:
        raise MXNetError("MultiBoxTarget: input shapes unknown")
    if len(a) != 3 or a[0] != 1 or a[2] != 4:
        raise MXNetError("MultiBoxTarget: anchor must be (1, A, 4), got %s" % (a,))
    if len(l) != 3 or l[2] != 5:
        raise MXNetError("MultiBoxTarget: label must be (B, L, 5), got %s" % (l,))
    if len(p) != 3 or p[2] != a[1]:
        raise MXNetError("MultiBoxTarget: cls_pred must be (B, C, A), got %s" % (p,))
    B, A = l[0], a[1]
    return list(in_shapes), [(B, A * 4), (B, A * 4), (B, A)], []


register(
    OpDef(
        "MultiBoxTarget",
        _multibox_target_fwd,
        params={
            "overlap_threshold": Field("float", default=0.5),
            "ignore_label": Field("float", default=-1.0),
            "negative_mining_ratio": Field("float", default=-1.0),
            "negative_mining_thresh": Field("float", default=0.5),
            "minimum_negative_samples": Field("int", default=0),
            "variances": Field("any", default=(0.1, 0.1, 0.2, 0.2)),
        },
        arguments=("anchor", "label", "cls_pred"),
        outputs=("loc_target", "loc_mask", "cls_target"),
        infer_shape=_multibox_target_shape,
        no_head_grad=True,
    )
)


def _decode_boxes(anchors, loc_pred, variances, clip):
    """(A, 4) corner anchors and (B, A, 4) offsets -> (B, A, 4) corner
    boxes."""
    vx, vy, vw, vh = variances
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    ax = (anchors[:, 0] + anchors[:, 2]) * 0.5
    ay = (anchors[:, 1] + anchors[:, 3]) * 0.5
    ox = loc_pred[..., 0] * vx * aw + ax
    oy = loc_pred[..., 1] * vy * ah + ay
    ow = torch.exp(loc_pred[..., 2] * vw) * aw * 0.5
    oh = torch.exp(loc_pred[..., 3] * vh) * ah * 0.5
    boxes = torch.stack([ox - ow, oy - oh, ox + ow, oy + oh], dim=-1)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    return boxes


def _multibox_detection(cls_prob, loc_pred, anchors, threshold, clip,
                        variances, nms_threshold, force_suppress,
                        background_id):
    """cls_prob (B, C, A), loc_pred (B, A*4), anchors (A, 4), all f32 ->
    (B, A, 6) rows [id, score, x1, y1, x2, y2]."""
    B, C, A = cls_prob.shape
    dev = cls_prob.device
    fg = torch.arange(C, device=dev) != background_id
    masked = torch.where(fg[None, :, None], cls_prob, -math.inf)
    score = torch.amax(masked, dim=1)
    best_row = torch.argmax(masked, dim=1)   # the first maximum
    # the output id counts foreground classes only
    best = torch.where(best_row > background_id, best_row - 1, best_row)
    keep = score >= threshold
    boxes = _decode_boxes(anchors, loc_pred.reshape(B, A, 4), variances, clip)
    cls_id = torch.where(keep, best.to(torch.float32), -1.0)
    score = torch.where(keep, score, -1.0)
    # by confidence, descending; rows below the threshold sink to the end
    order = torch.argsort(-torch.where(keep, score, -math.inf), dim=1,
                          stable=True)
    cls_id = torch.gather(cls_id, 1, order)
    score = torch.gather(score, 1, order)
    boxes = torch.gather(boxes, 1, order[:, :, None].expand(B, A, 4))

    if 0 < nms_threshold <= 1:
        # A rounds: box i suppresses the later boxes it overlaps
        a_idx = torch.arange(A, device=dev)
        for i in range(A):
            iou = _box_iou(boxes[:, i:i + 1], boxes)[:, 0]   # (B, A)
            cur = cls_id[:, i:i + 1]
            kill = (a_idx > i) & (iou >= nms_threshold)
            if not force_suppress:
                kill = kill & (cls_id == cur)
            cls_id = torch.where((cur >= 0) & kill, -1.0, cls_id)
    return torch.cat([cls_id[:, :, None], score[:, :, None], boxes], dim=2)


def _multibox_detection_fwd(params, inputs, aux, is_train, rng):
    cls_prob, loc_pred, anchors = inputs
    variances = _parse_floats(params["variances"], (0.1, 0.1, 0.2, 0.2))
    f32 = torch.float32
    out = _multibox_detection(
        cls_prob.to(f32), loc_pred.to(f32), anchors.reshape(-1, 4).to(f32),
        params["threshold"], params["clip"], variances,
        params["nms_threshold"], params["force_suppress"],
        params["background_id"])
    return [out.to(cls_prob.dtype)], []


def _multibox_detection_shape(params, in_shapes):
    c, l, a = in_shapes
    if c is None or l is None or a is None:
        raise MXNetError("MultiBoxDetection: input shapes unknown")
    if len(c) != 3 or len(l) != 2 or len(a) != 3 or a[2] != 4:
        raise MXNetError(
            "MultiBoxDetection: want cls_prob (B,C,A), loc_pred (B,A*4), "
            "anchor (1,A,4); got %s %s %s" % (c, l, a))
    if c[2] != a[1] or l[1] != 4 * a[1]:
        raise MXNetError("MultiBoxDetection: anchor count mismatch")
    return list(in_shapes), [(c[0], a[1], 6)], []


register(
    OpDef(
        "MultiBoxDetection",
        _multibox_detection_fwd,
        params={
            "clip": Field("bool", default=True),
            "threshold": Field("float", default=0.01),
            "background_id": Field("int", default=0),
            "nms_threshold": Field("float", default=0.5),
            "force_suppress": Field("bool", default=False),
            "variances": Field("any", default=(0.1, 0.1, 0.2, 0.2)),
        },
        arguments=("cls_prob", "loc_pred", "anchor"),
        infer_shape=_multibox_detection_shape,
        no_head_grad=True,
    )
)
