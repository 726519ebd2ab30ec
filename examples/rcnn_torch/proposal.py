"""RPN Proposal as a Python CustomOp — proof of the custom-op escape hatch
used by the reference Faster R-CNN example, on mxnet_tpu_torch.

examples/rcnn/proposal.py with its import rewritten; its smoke run takes
``--ctx gpu`` (the default) or ``--ctx cpu``:

    python3 examples/rcnn_torch/proposal.py [--ctx cpu]

Mirrors example/rcnn/rcnn/rpn/proposal.py:19-164 (ProposalOperator /
ProposalProp): generate shifted anchors over the score map, decode bbox
deltas, clip, filter small boxes, sort by score, NMS, pad to a fixed count.
Host-side numpy inside the graph — exactly the CustomOp contract
(python/mxnet/operator.py:394-533).
"""
import numpy as np

import mxnet_tpu_torch as mx


def generate_anchors(base_size=16, ratios=(0.5, 1, 2), scales=(8, 16, 32)):
    """(ref: example/rcnn/rcnn/rpn/generate_anchor.py)"""
    base = np.array([1, 1, base_size, base_size]) - 1
    w, h = base[2] - base[0] + 1, base[3] - base[1] + 1
    cx, cy = base[0] + 0.5 * (w - 1), base[1] + 0.5 * (h - 1)
    anchors = []
    for r in ratios:
        size = w * h
        ws = np.round(np.sqrt(size / r))
        hs = np.round(ws * r)
        for s in scales:
            wss, hss = ws * s, hs * s
            anchors.append([cx - 0.5 * (wss - 1), cy - 0.5 * (hss - 1),
                            cx + 0.5 * (wss - 1), cy + 0.5 * (hss - 1)])
    return np.array(anchors)


def bbox_pred(boxes, deltas):
    """(ref: example/rcnn/rcnn/processing/bbox_transform.py)"""
    if boxes.shape[0] == 0:
        return np.zeros((0, deltas.shape[1]))
    w = boxes[:, 2] - boxes[:, 0] + 1.0
    h = boxes[:, 3] - boxes[:, 1] + 1.0
    cx = boxes[:, 0] + 0.5 * (w - 1.0)
    cy = boxes[:, 1] + 0.5 * (h - 1.0)
    dx, dy, dw, dh = deltas[:, 0::4], deltas[:, 1::4], deltas[:, 2::4], deltas[:, 3::4]
    pcx = dx * w[:, None] + cx[:, None]
    pcy = dy * h[:, None] + cy[:, None]
    pw = np.exp(dw) * w[:, None]
    ph = np.exp(dh) * h[:, None]
    pred = np.zeros(deltas.shape)
    pred[:, 0::4] = pcx - 0.5 * (pw - 1.0)
    pred[:, 1::4] = pcy - 0.5 * (ph - 1.0)
    pred[:, 2::4] = pcx + 0.5 * (pw - 1.0)
    pred[:, 3::4] = pcy + 0.5 * (ph - 1.0)
    return pred


def nms(dets, thresh):
    x1, y1, x2, y2, scores = dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3], dets[:, 4]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(i)
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        ovr = w * h / (areas[i] + areas[order[1:]] - w * h)
        order = order[1:][ovr <= thresh]
    return keep


class ProposalOperator(mx.operator.CustomOp):
    def __init__(self, feat_stride=16, scales=(8, 16, 32), ratios=(0.5, 1, 2),
                 rpn_pre_nms_top_n=6000, rpn_post_nms_top_n=300,
                 rpn_nms_thresh=0.7, rpn_min_size=16):
        super().__init__()
        self._feat_stride = float(feat_stride)
        self._anchors = generate_anchors(base_size=int(feat_stride),
                                         ratios=list(ratios),
                                         scales=np.array(scales))
        self._num_anchors = self._anchors.shape[0]
        self._pre = rpn_pre_nms_top_n
        self._post = rpn_post_nms_top_n
        self._thresh = rpn_nms_thresh
        self._min_size = rpn_min_size

    def forward(self, is_train, req, in_data, out_data, aux):
        scores = in_data[0].asnumpy()[:, self._num_anchors:, :, :]
        bbox_deltas = in_data[1].asnumpy()
        im_info = in_data[2].asnumpy()[0, :]

        height, width = scores.shape[-2:]
        shift_x = np.arange(0, width) * self._feat_stride
        shift_y = np.arange(0, height) * self._feat_stride
        sx, sy = np.meshgrid(shift_x, shift_y)
        shifts = np.vstack((sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel())).T
        A, K = self._num_anchors, shifts.shape[0]
        anchors = (self._anchors.reshape(1, A, 4)
                   + shifts.reshape(1, K, 4).transpose(1, 0, 2)).reshape(K * A, 4)

        bbox_deltas = bbox_deltas.transpose(0, 2, 3, 1).reshape(-1, 4)
        scores = scores.transpose(0, 2, 3, 1).reshape(-1, 1)

        proposals = bbox_pred(anchors, bbox_deltas)
        proposals[:, 0::2] = np.clip(proposals[:, 0::2], 0, im_info[1] - 1)
        proposals[:, 1::2] = np.clip(proposals[:, 1::2], 0, im_info[0] - 1)
        ws = proposals[:, 2] - proposals[:, 0] + 1
        hs = proposals[:, 3] - proposals[:, 1] + 1
        keep = np.where((ws >= self._min_size * im_info[2])
                        & (hs >= self._min_size * im_info[2]))[0]
        proposals, scores = proposals[keep], scores[keep]

        order = scores.ravel().argsort()[::-1][: self._pre]
        proposals, scores = proposals[order], scores[order]
        keep = nms(np.hstack((proposals, scores)), self._thresh)[: self._post]
        proposals, scores = proposals[keep], scores[keep]

        # pad to fixed count (static output shape for the compiler)
        n = self._post
        batch_inds = np.zeros((n, 1), np.float32)
        blob = np.zeros((n, 5), np.float32)
        blob[:len(proposals), 1:] = proposals[:n]
        blob[:, 0:1] = batch_inds
        self.assign(out_data[0], req[0], mx.nd.array(blob))

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        for g in in_grad:
            self.assign(g, 'write', mx.nd.zeros(g.shape))


@mx.operator.register("proposal")
class ProposalProp(mx.operator.CustomOpProp):
    def __init__(self, feat_stride='16', scales='(8, 16, 32)',
                 ratios='(0.5, 1, 2)', rpn_post_nms_top_n='300', **kwargs):
        super().__init__(need_top_grad=False)
        import ast
        self._kw = dict(
            feat_stride=int(feat_stride), scales=ast.literal_eval(scales),
            ratios=ast.literal_eval(ratios),
            rpn_post_nms_top_n=int(rpn_post_nms_top_n))

    def list_arguments(self):
        return ['cls_prob', 'bbox_pred', 'im_info']

    def list_outputs(self):
        return ['output']

    def infer_shape(self, in_shape):
        return in_shape, [(self._kw['rpn_post_nms_top_n'], 5)]

    def create_operator(self, ctx, shapes, dtypes):
        return ProposalOperator(**self._kw)


if __name__ == '__main__':
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument('--ctx', type=str, default='gpu', choices=['gpu', 'cpu'])
    ctx = mx.cpu() if p.parse_args().ctx == 'cpu' else mx.gpu()
    # smoke run: random score/delta maps through the proposal op
    rng = np.random.RandomState(0)
    H = W = 14
    sym = mx.symbol.Custom(
        cls_prob=mx.symbol.Variable('cls_prob'),
        bbox_pred=mx.symbol.Variable('bbox_pred'),
        im_info=mx.symbol.Variable('im_info'),
        op_type='proposal', rpn_post_nms_top_n='50')
    exe = sym.bind(ctx, {
        'cls_prob': mx.nd.array(rng.rand(1, 18, H, W), ctx),
        'bbox_pred': mx.nd.array(rng.randn(1, 36, H, W) * 0.1, ctx),
        'im_info': mx.nd.array([[H * 16.0, W * 16.0, 1.0]], ctx),
    })
    exe.forward(is_train=False)
    rois = exe.outputs[0].asnumpy()
    print('proposal output', rois.shape, 'first rois:\n', rois[:3])
    assert rois.shape == (50, 5)
