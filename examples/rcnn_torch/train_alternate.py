"""Alternating Faster R-CNN training (ref: the reference's
example/rcnn/train_alternate.py 4-phase schedule: train RPN -> generate
proposals -> train RCNN head on them -> finetune RPN -> finetune RCNN),
on the same synthetic detection set as train_end2end.py.

Phases here:
  1. RPN-only network (backbone + RPN losses) trains from scratch.
  2. The trained RPN generates fixed proposals per image (proposal op,
     host-side); the RCNN-only network (fresh head, backbone initialised
     from phase 1) trains on those rois with proposal_target sampling.
  3. RPN finetunes from the phase-2 backbone.
  4. RCNN head finetunes on phase-3 proposals.

Weight handoff between phases goes through set_params/arg_params exactly
like the reference's checkpoint handoff between its phases.

examples/rcnn/train_alternate.py on mxnet_tpu_torch: its imports
rewritten, ``mx.cpu(0)`` made the current context, and ``--ctx`` taking
``gpu`` (the default: ``gpu(0)``, no fallback) or ``cpu``:

    python3 examples/rcnn_torch/train_alternate.py [--ctx cpu]
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
from mxnet_tpu_torch import symbol as sym  # noqa: E402

import symbol_rcnn  # noqa: E402
from proposal import ProposalOperator  # noqa: E402
from proposal_target import ProposalTargetOperator  # noqa: E402
from train_end2end import (IMAGE, NUM_CLASSES, DetectionIter,  # noqa: E402
                           RPNAccuracy, make_image)

NUM_ROIS = 32


def get_rpn_train(image=128):
    """Backbone + RPN heads + RPN losses only (ref: get_vgg_rpn)."""
    data = sym.Variable("data")
    rpn_label = sym.Variable("label")
    rpn_bbox_target = sym.Variable("bbox_target")
    rpn_bbox_weight = sym.Variable("bbox_weight")
    feat = symbol_rcnn.get_backbone(data)
    cls_score, bbox_pred = symbol_rcnn._rpn_heads(feat)
    cls_reshape = sym.Reshape(data=cls_score, shape=(0, 2, -1),
                              name="rpn_cls_reshape")
    cls_prob = sym.SoftmaxOutput(
        data=cls_reshape, label=rpn_label, multi_output=True,
        use_ignore=True, ignore_label=-1, normalization="valid",
        name="rpn_cls_prob")
    bbox_loss_t = sym.smooth_l1(
        data=(bbox_pred - rpn_bbox_target) * rpn_bbox_weight,
        scalar=3.0, name="rpn_bbox_smooth_l1")
    bbox_loss = sym.MakeLoss(data=bbox_loss_t, grad_scale=1.0 / 64.0,
                             name="rpn_bbox_loss")
    return sym.Group([cls_prob, bbox_loss])


def get_rcnn_train(num_classes=NUM_CLASSES, num_rois=NUM_ROIS):
    """RCNN head trained on externally supplied rois (ref:
    get_vgg_rcnn): data + rois in, head losses out."""
    data = sym.Variable("data")
    rois = sym.Variable("rois")
    label = sym.Variable("rcnn_label")
    bbox_target = sym.Variable("rcnn_bbox_target")
    bbox_weight = sym.Variable("rcnn_bbox_weight")
    feat = symbol_rcnn.get_backbone(data)
    pooled = sym.ROIPooling(data=feat, rois=rois, pooled_size=(4, 4),
                            spatial_scale=1.0 / symbol_rcnn.FEAT_STRIDE,
                            name="roi_pool")
    flat = sym.Flatten(data=pooled)
    fc = sym.FullyConnected(data=flat, num_hidden=128, name="rcnn_fc")
    fc = sym.Activation(data=fc, act_type="relu", name="rcnn_fc_relu")
    cls_score = sym.FullyConnected(data=fc, num_hidden=num_classes,
                                   name="rcnn_cls_score")
    cls_prob = sym.SoftmaxOutput(data=cls_score, label=label,
                                 normalization="batch", name="rcnn_cls_prob")
    bbox_pred_s = sym.FullyConnected(data=fc, num_hidden=4 * num_classes,
                                     name="rcnn_bbox_pred")
    bbox_loss_t = sym.smooth_l1(
        data=(bbox_pred_s - bbox_target) * bbox_weight, scalar=1.0,
        name="rcnn_bbox_smooth_l1")
    bbox_loss = sym.MakeLoss(data=bbox_loss_t, grad_scale=1.0 / num_rois,
                             name="rcnn_bbox_loss")
    return sym.Group([cls_prob, bbox_loss])


class RCNNRoiIter(mx.io.DataIter):
    """Phase-2/4 iterator: images + fixed RPN proposals + sampled head
    targets (the reference materialises these as .pkl proposal files;
    here they are generated in memory)."""

    def __init__(self, images, rois, labels, targets, weights):
        super().__init__()
        self.batch_size = 1
        self._data = list(zip(images, rois, labels, targets, weights))
        self._i = 0

    @property
    def provide_data(self):
        return [("data", (1, 3, IMAGE, IMAGE)), ("rois", (NUM_ROIS, 5))]

    @property
    def provide_label(self):
        return [("rcnn_label", (NUM_ROIS,)),
                ("rcnn_bbox_target", (NUM_ROIS, 4 * NUM_CLASSES)),
                ("rcnn_bbox_weight", (NUM_ROIS, 4 * NUM_CLASSES))]

    def reset(self):
        self._i = 0

    def next(self):
        if self._i >= len(self._data):
            raise StopIteration
        img, rois, lab, tgt, wgt = self._data[self._i]
        self._i += 1
        return mx.io.DataBatch(
            data=[mx.nd.array(img[None]), mx.nd.array(rois)],
            label=[mx.nd.array(lab), mx.nd.array(tgt), mx.nd.array(wgt)],
            pad=0, index=None)


def generate_proposals(rpn_params, images):
    """Run the trained RPN + proposal op over images (the reference's
    rpn/generate.py role) and sample head targets per image."""
    test_sym = _rpn_test_symbol()
    mod = mx.module.Module(test_sym, context=mx.current_context(),
                           data_names=("data", "im_info"), label_names=())
    mod.bind(data_shapes=[("data", (1, 3, IMAGE, IMAGE)),
                          ("im_info", (1, 3))], for_training=False)
    mod.set_params(*rpn_params, allow_missing=False)
    out = []
    for img, gt in images:
        batch = mx.io.DataBatch(
            data=[mx.nd.array(img[None]),
                  mx.nd.array(np.array([[IMAGE, IMAGE, 1.0]], np.float32))],
            label=[], pad=0, index=None)
        mod.forward(batch, is_train=False)
        rois = mod.get_outputs()[0].asnumpy()
        # sample fixed-size head targets from the proposals
        op = ProposalTargetOperator(NUM_CLASSES, NUM_ROIS, seed=0)
        outs = [mx.nd.zeros((NUM_ROIS, 5), mx.current_context()),
                mx.nd.zeros((NUM_ROIS,), mx.current_context()),
                mx.nd.zeros((NUM_ROIS, 4 * NUM_CLASSES), mx.current_context()),
                mx.nd.zeros((NUM_ROIS, 4 * NUM_CLASSES), mx.current_context())]
        op.forward(True, ["write"] * 4,
                   [mx.nd.array(rois), mx.nd.array(gt[None])], outs, [])
        out.append((img, outs[0].asnumpy(), outs[1].asnumpy(),
                    outs[2].asnumpy(), outs[3].asnumpy()))
    return out


def _rpn_test_symbol(rpn_post_nms=NUM_ROIS):
    data = sym.Variable("data")
    im_info = sym.Variable("im_info")
    feat = symbol_rcnn.get_backbone(data)
    cls_score, bbox_pred = symbol_rcnn._rpn_heads(feat)
    cls_reshape = sym.Reshape(data=cls_score, shape=(0, 2, -1),
                              name="rpn_cls_reshape")
    cls_act = sym.SoftmaxActivation(data=cls_reshape, mode="channel",
                                    name="rpn_cls_act")
    f = IMAGE // symbol_rcnn.FEAT_STRIDE
    prob_reshape = sym.Reshape(
        data=cls_act, shape=(0, 2 * symbol_rcnn.NUM_ANCHORS, f, f),
        name="rpn_prob_reshape")
    rois = sym.Custom(
        cls_prob=prob_reshape, bbox_pred=bbox_pred, im_info=im_info,
        op_type="proposal", feat_stride=str(symbol_rcnn.FEAT_STRIDE),
        scales=str(symbol_rcnn.SCALES), ratios=str(symbol_rcnn.RATIOS),
        rpn_post_nms_top_n=str(rpn_post_nms), name="rois")
    return sym.BlockGrad(data=rois, name="rois_out")


class RPNIter(mx.io.DataIter):
    """Strip DetectionIter down to the RPN-only inputs (no im_info /
    gt_boxes — those feed the proposal/proposal_target ops that the
    phase-1 network does not contain)."""

    def __init__(self, det_iter):
        super().__init__()
        self._it = det_iter
        self.batch_size = det_iter.batch_size
        self.provide_data = det_iter.provide_data[:1]
        self.provide_label = det_iter.provide_label

    def reset(self):
        self._it.reset()

    def next(self):
        b = self._it.next()
        return mx.io.DataBatch(data=b.data[:1], label=b.label, pad=b.pad,
                               index=b.index)


def train_rpn(it, epochs, lr, arg_params=None, aux_params=None):
    mod = mx.module.Module(get_rpn_train(), context=mx.current_context(),
                           data_names=("data",),
                           label_names=("label", "bbox_target",
                                        "bbox_weight"))
    metric = RPNAccuracy()
    mod.fit(RPNIter(it), num_epoch=epochs, optimizer="sgd",
            optimizer_params={"learning_rate": lr, "momentum": 0.9,
                              "wd": 5e-4},
            initializer=mx.initializer.Xavier(), eval_metric=metric,
            arg_params=arg_params, aux_params=aux_params,
            allow_missing=True)
    name, val = metric.get()
    return mod.get_params(), {name: val}


class HeadAccuracy(mx.metric.EvalMetric):
    """RCNN head classification accuracy over the sampled rois."""

    def __init__(self):
        super().__init__("rcnn_acc")

    def update(self, labels, preds):
        prob = preds[0].asnumpy()            # [R, C]
        label = labels[0].asnumpy().ravel()  # [R]
        self.sum_metric += (prob.argmax(axis=1) == label).sum()
        self.num_inst += len(label)


def train_rcnn(roi_iter, epochs, lr, arg_params, aux_params):
    mod = mx.module.Module(
        get_rcnn_train(), context=mx.current_context(),
        data_names=("data", "rois"),
        label_names=("rcnn_label", "rcnn_bbox_target", "rcnn_bbox_weight"))
    metric = HeadAccuracy()
    mod.fit(roi_iter, num_epoch=epochs, optimizer="sgd",
            optimizer_params={"learning_rate": lr, "momentum": 0.9,
                              "wd": 5e-4},
            initializer=mx.initializer.Xavier(), eval_metric=metric,
            arg_params=arg_params, aux_params=aux_params,
            allow_missing=True)
    name, val = metric.get()
    return mod.get_params(), {name: val}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--num-images", type=int, default=12)
    p.add_argument("--rpn-epochs", type=int, default=16)
    p.add_argument("--rcnn-epochs", type=int, default=12)
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--ctx", type=str, default="gpu", choices=["gpu", "cpu"])
    args = p.parse_args()
    if os.environ.get("MXNET_EXAMPLE_SMOKE") == "1":
        args.num_images = 8
        args.rpn_epochs, args.rcnn_epochs = 12, 10
    with (mx.cpu() if args.ctx == "cpu" else mx.gpu()):
        _run(args)


def _run(args):
    np.random.seed(0)
    mx.random.seed(0)
    it = DetectionIter(args.num_images)
    rng = np.random.RandomState(0)
    dataset = [make_image(rng) for _ in range(args.num_images)]

    print("phase 1: train RPN")
    rpn_params, acc1 = train_rpn(it, args.rpn_epochs, args.lr)
    print("  rpn metrics:", acc1)

    print("phase 2: generate proposals, train RCNN head")
    samples = generate_proposals(rpn_params, dataset)
    roi_iter = RCNNRoiIter(*zip(*samples))
    # backbone handoff from phase 1 (the reference loads the phase-1
    # checkpoint's shared conv weights)
    bb = {k: v for k, v in rpn_params[0].items() if k.startswith("bb_")}
    rcnn_params, acc2 = train_rcnn(roi_iter, args.rcnn_epochs, args.lr,
                                   bb, rpn_params[1])
    print("  rcnn metrics:", acc2)

    print("phase 3: finetune RPN from phase-2 backbone")
    bb3 = {k: v for k, v in rcnn_params[0].items() if k.startswith("bb_")}
    it.reset()
    rpn_params3, acc3 = train_rpn(it, args.rpn_epochs // 2, args.lr / 2,
                                  arg_params=dict(rpn_params[0], **bb3),
                                  aux_params=rcnn_params[1])
    print("  rpn metrics:", acc3)

    print("phase 4: finetune RCNN on phase-3 proposals")
    samples4 = generate_proposals(rpn_params3, dataset)
    roi_iter4 = RCNNRoiIter(*zip(*samples4))
    rcnn_params4, acc4 = train_rcnn(
        roi_iter4, args.rcnn_epochs // 2, args.lr / 2,
        dict(rcnn_params[0]), rcnn_params[1])
    print("  rcnn metrics:", acc4)

    rpn_acc = list(acc3.values())[0]
    rcnn_acc = list(acc4.values())[0]
    assert rpn_acc > 0.8, acc3
    assert rcnn_acc > 0.6, acc4
    print("ok: alternating training converged (rpn %.2f, rcnn %.2f)"
          % (rpn_acc, rcnn_acc))


if __name__ == "__main__":
    main()
