"""proposal_target CustomOp: sample RPN proposals against ground truth
into fixed-size RCNN head training batches (ref:
example/rcnn/rcnn/rpn/proposal_target.py role — re-designed with static
shapes throughout for the XLA compiler: every output is padded/sampled
to `num_rois`). examples/rcnn/proposal_target.py with its import
rewritten for mxnet_tpu_torch.

Outputs per image:
  rois        [num_rois, 5]            (batch_idx, x1, y1, x2, y2)
  label       [num_rois]               0 = background, else gt class id
  bbox_target [num_rois, 4*num_classes] per-class encoded targets
  bbox_weight [num_rois, 4*num_classes] 1 where the target is valid
"""
import numpy as np

import mxnet_tpu_torch as mx

from rcnn_utils import bbox_overlaps, bbox_transform, valid_gt


class ProposalTargetOperator(mx.operator.CustomOp):
    def __init__(self, num_classes, num_rois, fg_fraction=0.25,
                 fg_iou=0.5, bg_iou_lo=0.0, bg_iou_hi=0.5, seed=0):
        super().__init__()
        self._nc = num_classes
        self._nr = num_rois
        self._fg = int(round(fg_fraction * num_rois))
        self._fg_iou = fg_iou
        self._bg = (bg_iou_lo, bg_iou_hi)
        self._rng = np.random.RandomState(seed)

    def forward(self, is_train, req, in_data, out_data, aux):
        rois = in_data[0].asnumpy()  # [N,5] from Proposal (batch_idx + box)
        gt_padded = in_data[1].asnumpy()[0]  # [G,5] x1y1x2y2,cls (0-padded)
        gt = valid_gt(gt_padded)

        boxes = rois[:, 1:5]
        if len(gt):
            # gt boxes join the candidate pool (guarantees fg samples
            # exist early in training when RPN proposals are noise)
            boxes = np.vstack([boxes, gt[:, :4]])
        n = boxes.shape[0]

        if len(gt):
            ov = bbox_overlaps(boxes.astype(np.float32), gt[:, :4])
            gt_assign = ov.argmax(axis=1)
            maxov = ov[np.arange(n), gt_assign]
        else:
            gt_assign = np.zeros((n,), np.int64)
            maxov = np.zeros((n,), np.float32)

        fg_inds = np.where(maxov >= self._fg_iou)[0]
        bg_inds = np.where((maxov < self._bg[1]) & (maxov >= self._bg[0]))[0]
        if len(fg_inds) > self._fg:
            fg_inds = self._rng.choice(fg_inds, self._fg, replace=False)
        n_bg = self._nr - len(fg_inds)
        if len(bg_inds) > n_bg:
            bg_inds = self._rng.choice(bg_inds, n_bg, replace=False)
        elif len(bg_inds) < n_bg and len(bg_inds):
            bg_inds = self._rng.choice(bg_inds, n_bg, replace=True)
        keep = np.concatenate([fg_inds, bg_inds]).astype(np.int64)
        # degenerate start-of-training case: not enough candidates at all
        while len(keep) < self._nr:
            keep = np.concatenate([keep, keep])[: self._nr]

        sampled = boxes[keep]
        label = np.zeros((self._nr,), np.float32)
        bbox_target = np.zeros((self._nr, 4 * self._nc), np.float32)
        bbox_weight = np.zeros((self._nr, 4 * self._nc), np.float32)
        if len(gt):
            is_fg = maxov[keep] >= self._fg_iou
            cls = gt[gt_assign[keep], 4].astype(np.int64)
            label[is_fg] = cls[is_fg].astype(np.float32)
            t = bbox_transform(sampled, gt[gt_assign[keep], :4])
            for i in np.where(is_fg)[0]:
                c = cls[i]
                bbox_target[i, 4 * c:4 * c + 4] = t[i]
                bbox_weight[i, 4 * c:4 * c + 4] = 1.0

        out_rois = np.zeros((self._nr, 5), np.float32)
        out_rois[:, 1:] = sampled
        self.assign(out_data[0], req[0], mx.nd.array(out_rois))
        self.assign(out_data[1], req[1], mx.nd.array(label))
        self.assign(out_data[2], req[2], mx.nd.array(bbox_target))
        self.assign(out_data[3], req[3], mx.nd.array(bbox_weight))

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        for g in in_grad:
            self.assign(g, "write", mx.nd.zeros(g.shape))


@mx.operator.register("proposal_target")
class ProposalTargetProp(mx.operator.CustomOpProp):
    def __init__(self, num_classes="3", num_rois="32", fg_fraction="0.25",
                 seed="0", **kwargs):
        super().__init__(need_top_grad=False)
        self._nc = int(num_classes)
        self._nr = int(num_rois)
        self._ff = float(fg_fraction)
        self._seed = int(seed)

    def list_arguments(self):
        return ["rois", "gt_boxes"]

    def list_outputs(self):
        return ["rois_output", "label", "bbox_target", "bbox_weight"]

    def infer_shape(self, in_shape):
        return in_shape, [
            (self._nr, 5), (self._nr,),
            (self._nr, 4 * self._nc), (self._nr, 4 * self._nc),
        ]

    def create_operator(self, ctx, shapes, dtypes):
        return ProposalTargetOperator(self._nc, self._nr, self._ff,
                                      seed=self._seed)
