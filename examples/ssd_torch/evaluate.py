"""SSD evaluation on mxnet_tpu_torch: examples/ssd/evaluate.py with the
import in ``evaluate_detections`` rewritten. VOC-style mean average
precision over detection outputs (ref: example/ssd/evaluate/eval_voc.py
voc_eval + evaluate_net.py roles — the standard VOC07 11-point AP, recomputed from scratch).

`MApMetric.update(gt_batch, det_batch)` accumulates per-class matches;
`get()` returns ('mAP', value). Detections use MultiBoxDetection's
output rows [cls_id, score, x1, y1, x2, y2] (cls_id -1 = suppressed);
ground truth uses the training label rows [cls, x1, y1, x2, y2] padded
with -1.
"""
import numpy as np


def _iou(box, boxes):
    ix1 = np.maximum(box[0], boxes[:, 0])
    iy1 = np.maximum(box[1], boxes[:, 1])
    ix2 = np.minimum(box[2], boxes[:, 2])
    iy2 = np.minimum(box[3], boxes[:, 3])
    iw = np.maximum(ix2 - ix1, 0)
    ih = np.maximum(iy2 - iy1, 0)
    inter = iw * ih
    a1 = (box[2] - box[0]) * (box[3] - box[1])
    a2 = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return inter / np.maximum(a1 + a2 - inter, 1e-12)


class MApMetric:
    """Accumulating VOC07 mAP (11-point interpolation)."""

    def __init__(self, num_classes, iou_thresh=0.5):
        self.nc = num_classes
        self.thresh = iou_thresh
        self.reset()

    def reset(self):
        self._dets = [[] for _ in range(self.nc)]  # (score, img, box)
        self._gts = [{} for _ in range(self.nc)]   # img -> [boxes]
        self._img = 0

    def update(self, gt_batch, det_batch):
        """gt_batch [B, L, 5] (cls,x1,y1,x2,y2; -1 pad); det_batch
        [B, N, 6] (cls, score, box; cls -1 = suppressed)."""
        for b in range(len(gt_batch)):
            img = self._img
            self._img += 1
            gt = gt_batch[b]
            for row in gt[gt[:, 0] >= 0]:
                c = int(row[0])
                self._gts[c].setdefault(img, []).append(row[1:5])
            det = det_batch[b]
            for row in det[det[:, 0] >= 0]:
                self._dets[int(row[0])].append((float(row[1]), img, row[2:6]))

    def _ap(self, c):
        gts = {k: np.array(v, np.float32) for k, v in self._gts[c].items()}
        npos = sum(len(v) for v in gts.values())
        if npos == 0:
            return None
        dets = sorted(self._dets[c], key=lambda d: -d[0])
        matched = {k: np.zeros(len(v), bool) for k, v in gts.items()}
        tp = np.zeros(len(dets))
        fp = np.zeros(len(dets))
        for i, (score, img, box) in enumerate(dets):
            g = gts.get(img)
            if g is None or not len(g):
                fp[i] = 1
                continue
            ious = _iou(box, g)
            j = int(ious.argmax())
            if ious[j] >= self.thresh and not matched[img][j]:
                matched[img][j] = True
                tp[i] = 1
            else:
                fp[i] = 1
        rec = np.cumsum(tp) / npos
        prec = np.cumsum(tp) / np.maximum(np.cumsum(tp) + np.cumsum(fp), 1e-12)
        ap = 0.0
        for t in np.arange(0.0, 1.01, 0.1):  # VOC07 11-point
            p = prec[rec >= t].max() if np.any(rec >= t) else 0.0
            ap += p / 11.0
        return ap

    def get(self):
        aps = [self._ap(c) for c in range(self.nc)]
        aps = [a for a in aps if a is not None]
        return "mAP", float(np.mean(aps)) if aps else 0.0


def evaluate_detections(det_module, X, Y, batch_size, num_classes,
                        score_thresh=0.1):
    """Run the detection module over (X, Y) and return mAP — the
    evaluate_net.py role."""
    import mxnet_tpu_torch as mx

    metric = MApMetric(num_classes)
    n = (len(X) // batch_size) * batch_size
    for lo in range(0, n, batch_size):
        batch = mx.io.DataBatch(
            data=[mx.nd.array(X[lo:lo + batch_size])], label=None)
        det_module.forward(batch, is_train=False)
        out = det_module.get_outputs()[0].asnumpy()
        out = out.copy()
        out[out[:, :, 1] < score_thresh, 0] = -1  # drop low-confidence rows
        metric.update(Y[lo:lo + batch_size], out)
    return metric.get()[1]
