"""End-to-end Faster R-CNN training on synthetic detection data
(ref: example/rcnn/train_end2end.py + rcnn/tester.py roles).

The synthetic task: images contain 1-2 axis-aligned bright/dark squares
on a noise background; class 1 = bright, class 2 = dark. The script
trains the joint RPN+RCNN graph through the Module API (CustomOps
proposal + proposal_target, ROIPooling, MakeLoss and ignore-label
SoftmaxOutput all in one program), then runs detection with the shared
weights and reports mean IoU of the top detection against ground truth.

Exercises the full reference pipeline: anchor targets in the data layer,
two-stage sampling in-graph, twin losses, weight sharing between train
and test symbols, and host-side per-class NMS decode.

examples/rcnn/train_end2end.py on mxnet_tpu_torch: its imports rewritten
and ``--ctx`` taking ``gpu`` (the default: ``gpu(0)``, with no fallback
to the CPU when there is no card) or ``cpu``; the chosen context is the
current one for the run, so the arrays the example and its CustomOps
make are made there. The two CustomOps run on the host between the
card's ops (``Module.fit`` takes its per-batch loop for such a graph):

    python3 examples/rcnn_torch/train_end2end.py [--epochs 30 ...]
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

import mxnet_tpu_torch as mx  # noqa: E402

import symbol_rcnn  # noqa: E402
from rcnn_utils import anchor_target, bbox_overlaps, bbox_pred, nms  # noqa: E402

IMAGE = 128
FEAT = IMAGE // symbol_rcnn.FEAT_STRIDE
NUM_CLASSES = 3  # bg + bright + dark
MAX_GT = 3


def make_image(rng):
    """One synthetic image + its gt boxes."""
    img = rng.rand(3, IMAGE, IMAGE).astype(np.float32) * 0.2
    n_obj = rng.randint(1, 3)
    gt = np.zeros((MAX_GT, 5), np.float32)
    for i in range(n_obj):
        size = rng.randint(32, 64)
        x = rng.randint(0, IMAGE - size)
        y = rng.randint(0, IMAGE - size)
        cls = rng.randint(1, NUM_CLASSES)
        val = 0.9 if cls == 1 else -0.6
        img[:, y:y + size, x:x + size] = val + rng.rand(3, size, size) * 0.1
        gt[i] = (x, y, x + size - 1, y + size - 1, cls)
    return img, gt


class DetectionIter(mx.io.DataIter):
    """AnchorLoader role: serves image + im_info + gt boxes as data and
    the RPN anchor targets as labels (ref: rcnn/data_iter.py)."""

    def __init__(self, num_images, seed=0):
        super().__init__()
        rng = np.random.RandomState(seed)
        self.batch_size = 1
        self._items = []
        trng = np.random.RandomState(seed + 1)
        for _ in range(num_images):
            img, gt = make_image(rng)
            label, bt, bw = anchor_target(
                (FEAT, FEAT), gt, (IMAGE, IMAGE, 1.0),
                feat_stride=symbol_rcnn.FEAT_STRIDE,
                scales=symbol_rcnn.SCALES, ratios=symbol_rcnn.RATIOS,
                allowed_border=8, rng=trng)
            self._items.append((img, gt, label, bt, bw))
        self.provide_data = [
            ("data", (1, 3, IMAGE, IMAGE)),
            ("im_info", (1, 3)),
            ("gt_boxes", (1, MAX_GT, 5)),
        ]
        self.provide_label = [
            ("label", (1, len(label))),
            ("bbox_target", (1,) + bt.shape),
            ("bbox_weight", (1,) + bw.shape),
        ]
        self._i = 0

    def reset(self):
        self._i = 0

    def next(self):
        if self._i >= len(self._items):
            raise StopIteration
        img, gt, label, bt, bw = self._items[self._i]
        self._i += 1
        return mx.io.DataBatch(
            data=[mx.nd.array(img[None]),
                  mx.nd.array(np.array([[IMAGE, IMAGE, 1.0]], np.float32)),
                  mx.nd.array(gt[None])],
            label=[mx.nd.array(label[None]), mx.nd.array(bt[None]),
                   mx.nd.array(bw[None])],
            pad=0, index=None)


class RPNAccuracy(mx.metric.EvalMetric):
    """Anchor classification accuracy over non-ignored anchors."""

    def __init__(self):
        super().__init__("rpn_acc")

    def update(self, labels, preds):
        prob = preds[0].asnumpy()  # [1, 2, A*H*W]
        label = labels[0].asnumpy().ravel()
        pred = prob[0].argmax(axis=0)
        keep = label != -1
        self.sum_metric += (pred[keep] == label[keep]).sum()
        self.num_inst += int(keep.sum())


class RCNNAccuracy(mx.metric.EvalMetric):
    """Head classification accuracy over the sampled rois (the sampled
    label comes back through the BlockGrad head)."""

    def __init__(self):
        super().__init__("rcnn_acc")

    def update(self, labels, preds):
        prob = preds[2].asnumpy()   # [R, C]
        label = preds[4].asnumpy().ravel()
        pred = prob.argmax(axis=1)
        self.sum_metric += (pred == label).sum()
        self.num_inst += len(label)


def detect(test_mod, img, num_classes=NUM_CLASSES, thresh=0.25):
    """Run the detection symbol and decode per-class boxes + NMS
    (ref: rcnn/tester.py pred_eval / im_detect)."""
    batch = mx.io.DataBatch(
        data=[mx.nd.array(img[None]),
              mx.nd.array(np.array([[IMAGE, IMAGE, 1.0]], np.float32))],
        label=[], pad=0, index=None)
    test_mod.forward(batch, is_train=False)
    rois, cls_prob, deltas = [o.asnumpy() for o in test_mod.get_outputs()]
    boxes = rois[:, 1:]
    dets = []
    for c in range(1, num_classes):
        decoded = bbox_pred(boxes, deltas[:, 4 * c:4 * c + 4])
        decoded[:, 0::2] = np.clip(decoded[:, 0::2], 0, IMAGE - 1)
        decoded[:, 1::2] = np.clip(decoded[:, 1::2], 0, IMAGE - 1)
        scores = cls_prob[:, c]
        keep = np.where(scores > thresh)[0]
        if keep.size == 0:
            continue
        cdets = np.hstack([decoded[keep], scores[keep, None]])
        for i in nms(cdets, 0.3):
            dets.append((c, cdets[i]))
    dets.sort(key=lambda d: -d[1][4])
    return dets


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--num-images", type=int, default=16)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--ctx", type=str, default="gpu", choices=["gpu", "cpu"])
    args = p.parse_args()
    smoke = os.environ.get("MXNET_EXAMPLE_SMOKE") == "1"
    if smoke:
        args.num_images, args.epochs = 12, 22
    ctx = mx.cpu() if args.ctx == "cpu" else mx.gpu()
    with ctx:   # the example's arrays are made on the current context
        _run(args, ctx)


def _run(args, ctx):
    np.random.seed(0)
    mx.random.seed(0)
    train_sym = symbol_rcnn.get_train(num_classes=NUM_CLASSES)
    it = DetectionIter(args.num_images)

    mod = mx.module.Module(
        train_sym, context=ctx,
        data_names=("data", "im_info", "gt_boxes"),
        label_names=("label", "bbox_target", "bbox_weight"))
    metric = mx.metric.CompositeEvalMetric()
    metric.add(RPNAccuracy())
    metric.add(RCNNAccuracy())
    mod.fit(it, num_epoch=args.epochs, optimizer="sgd",
            optimizer_params={"learning_rate": args.lr, "momentum": 0.9,
                              "wd": 5e-4},
            initializer=mx.initializer.Xavier(), eval_metric=metric)
    names_vals = dict(zip(*metric.get()))
    print("train metrics:", names_vals)

    # detection with shared weights through the test symbol
    test_sym = symbol_rcnn.get_test(num_classes=NUM_CLASSES)
    test_mod = mx.module.Module(test_sym, context=ctx,
                                data_names=("data", "im_info"),
                                label_names=())
    test_mod.bind(data_shapes=[("data", (1, 3, IMAGE, IMAGE)),
                               ("im_info", (1, 3))], for_training=False)
    arg_params, aux_params = mod.get_params()
    test_mod.set_params(arg_params, aux_params, allow_missing=False)

    rng = np.random.RandomState(123)
    ious, cls_hits, n_eval = [], 0, 6
    for _ in range(n_eval):
        img, gt = make_image(rng)
        dets = detect(test_mod, img)
        gt_valid = gt[gt[:, 2] > gt[:, 0]]
        if not dets:
            ious.append(0.0)
            continue
        c, best = dets[0]
        ov = bbox_overlaps(best[None, :4].astype(np.float32),
                           gt_valid[:, :4])
        j = int(ov.argmax())
        ious.append(float(ov.max()))
        cls_hits += int(c == int(gt_valid[j, 4]))
    miou = float(np.mean(ious))
    print("detect mean-IoU(top1)=%.3f cls-hit=%d/%d" % (miou, cls_hits, n_eval))

    # VOC07 mAP through the SSD example's MApMetric (shared eval code,
    # the reference's pred_eval/voc_eval protocol)
    from eval_map import evaluate_map

    mAP = evaluate_map(test_mod, make_image, detect, num_images=8,
                       num_classes=NUM_CLASSES)
    print("VOC07 mAP=%.3f" % mAP)

    assert names_vals["rpn_acc"] > 0.8, names_vals
    assert miou > 0.3, miou
    assert mAP > 0.2, mAP
    print("ok: rcnn end-to-end trained and detects (mean IoU %.2f, "
          "mAP %.2f)" % (miou, mAP))


if __name__ == "__main__":
    main()
