"""Shared Faster R-CNN host utilities: overlaps, box encoding, RPN
anchor targets (ref: example/rcnn/rcnn/processing/bbox_transform.py,
bbox_regression.py and minibatch.py assign_anchor — re-derived, not
transcribed: the math is the standard Faster R-CNN formulation).

Everything here is host-side numpy invoked by CustomOps or the data
iterator; device work stays in the Symbol graph. A byte copy of
examples/rcnn/rcnn_utils.py below this docstring.
"""
import numpy as np

from proposal import bbox_pred, generate_anchors, nms  # noqa: F401 (re-export)


def bbox_overlaps(boxes, query):
    """IoU matrix [N, K] between boxes [N,4] and query [K,4] (x1y1x2y2)."""
    n, k = boxes.shape[0], query.shape[0]
    if n == 0 or k == 0:
        return np.zeros((n, k), np.float32)
    b_area = ((boxes[:, 2] - boxes[:, 0] + 1)
              * (boxes[:, 3] - boxes[:, 1] + 1))[:, None]
    q_area = ((query[:, 2] - query[:, 0] + 1)
              * (query[:, 3] - query[:, 1] + 1))[None, :]
    iw = (np.minimum(boxes[:, 2][:, None], query[:, 2][None, :])
          - np.maximum(boxes[:, 0][:, None], query[:, 0][None, :]) + 1)
    ih = (np.minimum(boxes[:, 3][:, None], query[:, 3][None, :])
          - np.maximum(boxes[:, 1][:, None], query[:, 1][None, :]) + 1)
    iw = np.maximum(iw, 0)
    ih = np.maximum(ih, 0)
    inter = iw * ih
    return (inter / (b_area + q_area - inter)).astype(np.float32)


def bbox_transform(ex_rois, gt_rois):
    """Encode gt boxes relative to example rois -> regression targets
    (dx, dy, dw, dh) — inverse of proposal.bbox_pred."""
    ew = ex_rois[:, 2] - ex_rois[:, 0] + 1.0
    eh = ex_rois[:, 3] - ex_rois[:, 1] + 1.0
    ecx = ex_rois[:, 0] + 0.5 * (ew - 1.0)
    ecy = ex_rois[:, 1] + 0.5 * (eh - 1.0)
    gw = gt_rois[:, 2] - gt_rois[:, 0] + 1.0
    gh = gt_rois[:, 3] - gt_rois[:, 1] + 1.0
    gcx = gt_rois[:, 0] + 0.5 * (gw - 1.0)
    gcy = gt_rois[:, 1] + 0.5 * (gh - 1.0)
    return np.stack([
        (gcx - ecx) / (ew + 1e-14),
        (gcy - ecy) / (eh + 1e-14),
        np.log(gw / ew),
        np.log(gh / eh),
    ], axis=1).astype(np.float32)


def valid_gt(gt_boxes):
    """Rows of the padded [G,5] gt array holding real boxes."""
    return gt_boxes[(gt_boxes[:, 2] > gt_boxes[:, 0])
                    & (gt_boxes[:, 3] > gt_boxes[:, 1])]


def anchor_target(feat_shape, gt_boxes, im_info, feat_stride=16,
                  scales=(2, 4), ratios=(0.5, 1, 2), allowed_border=0,
                  num_samples=64, fg_fraction=0.5, pos_iou=0.7, neg_iou=0.3,
                  rng=None):
    """RPN training targets for one image (the reference's AnchorLoader /
    assign_anchor role, computed in the data pipeline).

    Returns (label [A*H*W], bbox_target [A*4, H, W], bbox_weight
    [A*4, H, W]) with label in {-1 ignore, 0 bg, 1 fg}.
    """
    if rng is None:
        rng = np.random
    h, w = feat_shape
    base = generate_anchors(base_size=feat_stride, ratios=list(ratios),
                            scales=np.array(scales))
    a = base.shape[0]
    shift_x = np.arange(w) * feat_stride
    shift_y = np.arange(h) * feat_stride
    sx, sy = np.meshgrid(shift_x, shift_y)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], 1)
    anchors = (base[None, :, :] + shifts[:, None, :]).reshape(-1, 4)
    total = anchors.shape[0]

    inside = np.where(
        (anchors[:, 0] >= -allowed_border)
        & (anchors[:, 1] >= -allowed_border)
        & (anchors[:, 2] < im_info[1] + allowed_border)
        & (anchors[:, 3] < im_info[0] + allowed_border))[0]
    label = np.full((total,), -1, np.float32)
    bbox_target = np.zeros((total, 4), np.float32)
    bbox_weight = np.zeros((total, 4), np.float32)

    gt = valid_gt(gt_boxes)
    if inside.size and len(gt):
        ov = bbox_overlaps(anchors[inside].astype(np.float32), gt[:, :4])
        argmax = ov.argmax(axis=1)
        maxov = ov[np.arange(len(inside)), argmax]
        label[inside[maxov < neg_iou]] = 0
        # anchors with highest IoU per gt are positive even below pos_iou
        gt_argmax = ov.argmax(axis=0)
        label[inside[gt_argmax]] = 1
        label[inside[maxov >= pos_iou]] = 1

        fg_inds = np.where(label == 1)[0]
        max_fg = int(fg_fraction * num_samples)
        if len(fg_inds) > max_fg:
            label[rng.choice(fg_inds, len(fg_inds) - max_fg, replace=False)] = -1
        bg_inds = np.where(label == 0)[0]
        max_bg = num_samples - int((label == 1).sum())
        if len(bg_inds) > max_bg:
            label[rng.choice(bg_inds, len(bg_inds) - max_bg, replace=False)] = -1

        pos = np.where(label == 1)[0]
        if pos.size:
            pos_in_inside = np.searchsorted(inside, pos)
            tgt_gt = gt[argmax[pos_in_inside], :4]
            bbox_target[pos] = bbox_transform(anchors[pos], tgt_gt)
            bbox_weight[pos] = 1.0
    elif inside.size:
        label[inside] = 0  # no gt: everything inside is background

    # [K*A, x] -> [H, W, A, x] -> channel-major conv layouts
    label = label.reshape(h, w, a).transpose(2, 0, 1).reshape(-1)
    bbox_target = (bbox_target.reshape(h, w, a * 4).transpose(2, 0, 1))
    bbox_weight = (bbox_weight.reshape(h, w, a * 4).transpose(2, 0, 1))
    return label, bbox_target, bbox_weight
