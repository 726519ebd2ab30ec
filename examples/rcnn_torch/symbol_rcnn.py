"""Faster R-CNN network symbols (ref: example/rcnn/rcnn/symbol.py
get_vgg_train/get_vgg_test structure, scaled to a small conv backbone so
the synthetic e2e run trains in CI; the graph structure — RPN heads,
Proposal, ProposalTarget, ROIPooling, twin RCNN heads — is the full
reference pipeline).

Layout conventions (match proposal.py / rcnn_utils.anchor_target):
  rpn_cls_score  [1, 2A, H, W]  channels = A background then A foreground
  rpn_bbox_pred  [1, 4A, H, W]  channels = anchor-major groups of 4

examples/rcnn/symbol_rcnn.py with its imports rewritten for
mxnet_tpu_torch.
"""
import mxnet_tpu_torch as mx  # noqa: F401
from mxnet_tpu_torch import symbol as sym

import proposal  # noqa: F401 — registers the "proposal" CustomOp
import proposal_target  # noqa: F401 — registers "proposal_target"

FEAT_STRIDE = 16
SCALES = (2, 4)
RATIOS = (0.5, 1, 2)
NUM_ANCHORS = len(SCALES) * len(RATIOS)


def get_backbone(data):
    """Tiny conv net with total stride 16 (the reference uses VGG16
    conv5; any stride-16 feature extractor slots in)."""
    x = sym.Convolution(data=data, num_filter=16, kernel=(3, 3), pad=(1, 1),
                        name="bb_conv1")
    x = sym.Activation(data=x, act_type="relu", name="bb_relu1")
    x = sym.Pooling(data=x, kernel=(2, 2), stride=(2, 2), pool_type="max",
                    name="bb_pool1")
    for i, nf in enumerate([32, 48, 64]):
        x = sym.Convolution(data=x, num_filter=nf, kernel=(3, 3),
                            stride=(2, 2), pad=(1, 1),
                            name="bb_conv%d" % (i + 2))
        x = sym.Activation(data=x, act_type="relu", name="bb_relu%d" % (i + 2))
    return x


def _rpn_heads(feat):
    conv = sym.Convolution(data=feat, num_filter=64, kernel=(3, 3),
                           pad=(1, 1), name="rpn_conv_3x3")
    conv = sym.Activation(data=conv, act_type="relu", name="rpn_relu")
    cls_score = sym.Convolution(data=conv, num_filter=2 * NUM_ANCHORS,
                                kernel=(1, 1), name="rpn_cls_score")
    bbox_pred = sym.Convolution(data=conv, num_filter=4 * NUM_ANCHORS,
                                kernel=(1, 1), name="rpn_bbox_pred")
    return cls_score, bbox_pred


def get_train(num_classes=3, num_rois=32, rpn_post_nms=64, image=128):
    """End-to-end training symbol: joint RPN + RCNN losses
    (ref: example/rcnn/train_end2end.py get_vgg_train)."""
    data = sym.Variable("data")
    im_info = sym.Variable("im_info")
    gt_boxes = sym.Variable("gt_boxes")
    rpn_label = sym.Variable("label")
    rpn_bbox_target = sym.Variable("bbox_target")
    rpn_bbox_weight = sym.Variable("bbox_weight")

    feat = get_backbone(data)
    rpn_cls_score, rpn_bbox_pred = _rpn_heads(feat)

    # RPN classification loss (bg/fg per anchor, ignore -1)
    cls_reshape = sym.Reshape(data=rpn_cls_score, shape=(0, 2, -1),
                              name="rpn_cls_reshape")
    rpn_cls_prob = sym.SoftmaxOutput(
        data=cls_reshape, label=rpn_label, multi_output=True,
        use_ignore=True, ignore_label=-1, normalization="valid",
        name="rpn_cls_prob")

    # RPN bbox regression: smooth_l1 over positive anchors
    rpn_bbox_loss_t = sym.smooth_l1(
        data=(rpn_bbox_pred - rpn_bbox_target) * rpn_bbox_weight,
        scalar=3.0, name="rpn_bbox_smooth_l1")
    rpn_bbox_loss = sym.MakeLoss(
        data=rpn_bbox_loss_t, grad_scale=1.0 / 64.0, name="rpn_bbox_loss")

    # proposals from the softmax probabilities (2A channel layout)
    f = image // FEAT_STRIDE
    prob_reshape = sym.Reshape(data=rpn_cls_prob,
                               shape=(0, 2 * NUM_ANCHORS, f, f),
                               name="rpn_prob_reshape")
    rois = sym.Custom(
        cls_prob=prob_reshape, bbox_pred=rpn_bbox_pred, im_info=im_info,
        op_type="proposal", feat_stride=str(FEAT_STRIDE),
        scales=str(SCALES), ratios=str(RATIOS),
        rpn_post_nms_top_n=str(rpn_post_nms), name="rois")

    # sample proposals into the head batch
    group = sym.Custom(
        rois=rois, gt_boxes=gt_boxes, op_type="proposal_target",
        num_classes=str(num_classes), num_rois=str(num_rois),
        name="ptarget")
    sampled_rois = group[0]
    rcnn_label = group[1]
    rcnn_bbox_target = group[2]
    rcnn_bbox_weight = group[3]

    pooled = sym.ROIPooling(data=feat, rois=sampled_rois,
                            pooled_size=(4, 4),
                            spatial_scale=1.0 / FEAT_STRIDE, name="roi_pool")
    flat = sym.Flatten(data=pooled)
    fc = sym.FullyConnected(data=flat, num_hidden=128, name="rcnn_fc")
    fc = sym.Activation(data=fc, act_type="relu", name="rcnn_fc_relu")
    cls_score = sym.FullyConnected(data=fc, num_hidden=num_classes,
                                   name="rcnn_cls_score")
    cls_prob = sym.SoftmaxOutput(data=cls_score, label=rcnn_label,
                                 normalization="batch", name="rcnn_cls_prob")
    bbox_pred_s = sym.FullyConnected(data=fc, num_hidden=4 * num_classes,
                                     name="rcnn_bbox_pred")
    bbox_loss_t = sym.smooth_l1(
        data=(bbox_pred_s - rcnn_bbox_target) * rcnn_bbox_weight,
        scalar=1.0, name="rcnn_bbox_smooth_l1")
    bbox_loss = sym.MakeLoss(data=bbox_loss_t,
                             grad_scale=1.0 / num_rois, name="rcnn_bbox_loss")

    # BlockGrad'd heads expose targets to metrics without gradients
    return sym.Group([
        rpn_cls_prob, rpn_bbox_loss, cls_prob, bbox_loss,
        sym.BlockGrad(data=rcnn_label, name="rcnn_label_out"),
    ])


def get_test(num_classes=3, rpn_post_nms=16, image=128):
    """Detection symbol: proposals -> head scores + per-class deltas
    (ref: example/rcnn/rcnn/symbol.py get_vgg_test)."""
    data = sym.Variable("data")
    im_info = sym.Variable("im_info")

    feat = get_backbone(data)
    rpn_cls_score, rpn_bbox_pred = _rpn_heads(feat)
    cls_reshape = sym.Reshape(data=rpn_cls_score, shape=(0, 2, -1),
                              name="rpn_cls_reshape")
    cls_act = sym.SoftmaxActivation(data=cls_reshape, mode="channel",
                                    name="rpn_cls_act")
    f = image // FEAT_STRIDE
    prob_reshape = sym.Reshape(data=cls_act,
                               shape=(0, 2 * NUM_ANCHORS, f, f),
                               name="rpn_prob_reshape")
    rois = sym.Custom(
        cls_prob=prob_reshape, bbox_pred=rpn_bbox_pred, im_info=im_info,
        op_type="proposal", feat_stride=str(FEAT_STRIDE),
        scales=str(SCALES), ratios=str(RATIOS),
        rpn_post_nms_top_n=str(rpn_post_nms), name="rois")

    pooled = sym.ROIPooling(data=feat, rois=rois, pooled_size=(4, 4),
                            spatial_scale=1.0 / FEAT_STRIDE, name="roi_pool")
    flat = sym.Flatten(data=pooled)
    fc = sym.FullyConnected(data=flat, num_hidden=128, name="rcnn_fc")
    fc = sym.Activation(data=fc, act_type="relu", name="rcnn_fc_relu")
    cls_score = sym.FullyConnected(data=fc, num_hidden=num_classes,
                                   name="rcnn_cls_score")
    cls_prob = sym.SoftmaxActivation(data=cls_score, name="rcnn_cls_prob")
    bbox_pred_s = sym.FullyConnected(data=fc, num_hidden=4 * num_classes,
                                     name="rcnn_bbox_pred")
    return sym.Group([sym.BlockGrad(data=rois, name="rois_out"),
                      cls_prob, bbox_pred_s])
