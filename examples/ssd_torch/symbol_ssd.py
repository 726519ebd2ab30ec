"""The compact SSD symbols — baseline config #5, on mxnet_tpu_torch.

examples/ssd/symbol_ssd.py with its import rewritten. Mirrors the
reference example/ssd/symbol/common.py multibox_layer:41-185 and
symbol_vgg16_reduced.py get_symbol_train:121-145 / get_symbol:165-176, with a
smaller conv body so it trains on modest inputs. The multibox ops are
first-class framework ops (mxnet_tpu_torch/ops/vision.py).
"""
import mxnet_tpu_torch as mx


def conv_act_layer(from_layer, name, num_filter, kernel=(3, 3), pad=(1, 1),
                   stride=(1, 1)):
    conv = mx.symbol.Convolution(data=from_layer, kernel=kernel, pad=pad,
                                 stride=stride, num_filter=num_filter,
                                 name="conv{}".format(name))
    return mx.symbol.Activation(data=conv, act_type="relu",
                                name="relu{}".format(name))


def multibox_layer(from_layers, num_classes, sizes, ratios, clip=True):
    """(ref: example/ssd/symbol/common.py:41-185)"""
    loc_pred_layers, cls_pred_layers, anchor_layers = [], [], []
    num_classes += 1  # background class 0
    for k, from_layer in enumerate(from_layers):
        from_name = from_layer.name
        size, ratio = sizes[k], ratios[k]
        num_anchors = len(size) + len(ratio) - 1

        loc_pred = mx.symbol.Convolution(
            data=from_layer, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
            num_filter=num_anchors * 4,
            name="{}_loc_pred_conv".format(from_name))
        loc_pred = mx.symbol.transpose(loc_pred, axes=(0, 2, 3, 1))
        loc_pred_layers.append(mx.symbol.Flatten(data=loc_pred))

        cls_pred = mx.symbol.Convolution(
            data=from_layer, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
            num_filter=num_anchors * num_classes,
            name="{}_cls_pred_conv".format(from_name))
        cls_pred = mx.symbol.transpose(cls_pred, axes=(0, 2, 3, 1))
        cls_pred_layers.append(mx.symbol.Flatten(data=cls_pred))

        anchors = mx.symbol.MultiBoxPrior(
            from_layer, sizes=tuple(size), ratios=tuple(ratio), clip=clip,
            name="{}_anchors".format(from_name))
        anchor_layers.append(mx.symbol.Flatten(data=anchors))

    loc_preds = mx.symbol.Concat(*loc_pred_layers,
                                 num_args=len(loc_pred_layers), dim=1,
                                 name="multibox_loc_pred")
    cls_preds = mx.symbol.Concat(*cls_pred_layers,
                                 num_args=len(cls_pred_layers), dim=1)
    cls_preds = mx.symbol.Reshape(data=cls_preds, shape=(0, -1, num_classes))
    cls_preds = mx.symbol.transpose(cls_preds, axes=(0, 2, 1),
                                    name="multibox_cls_pred")
    anchor_boxes = mx.symbol.Concat(*anchor_layers,
                                    num_args=len(anchor_layers), dim=1)
    anchor_boxes = mx.symbol.Reshape(data=anchor_boxes, shape=(0, -1, 4),
                                     name="multibox_anchors")
    return [loc_preds, cls_preds, anchor_boxes]


def _body(data):
    """Small conv body with two multibox source scales."""
    b1 = conv_act_layer(data, "1_1", 32)
    b1 = mx.symbol.Pooling(data=b1, kernel=(2, 2), stride=(2, 2),
                           pool_type="max", name="pool1")
    b2 = conv_act_layer(b1, "2_1", 64)
    scale1 = mx.symbol.Pooling(data=b2, kernel=(2, 2), stride=(2, 2),
                               pool_type="max", name="pool2")
    scale2 = conv_act_layer(scale1, "3_1", 64, stride=(2, 2))
    return [scale1, scale2]


SIZES = [[.2, .35], [.5, .7]]
RATIOS = [[1, 2, .5], [1, 2, .5]]


def get_symbol_train(num_classes=3):
    """(ref: symbol_vgg16_reduced.py get_symbol_train:121-145)"""
    data = mx.symbol.Variable("data")
    label = mx.symbol.Variable("label")
    from_layers = _body(data)
    loc_preds, cls_preds, anchor_boxes = multibox_layer(
        from_layers, num_classes, SIZES, RATIOS, clip=True)

    tmp = mx.symbol.MultiBoxTarget(
        anchor_boxes, label, cls_preds, overlap_threshold=.5,
        ignore_label=-1, negative_mining_ratio=3,
        negative_mining_thresh=.5, variances=(0.1, 0.1, 0.2, 0.2),
        name="multibox_target")
    loc_target, loc_target_mask, cls_target = tmp[0], tmp[1], tmp[2]

    cls_prob = mx.symbol.SoftmaxOutput(
        data=cls_preds, label=cls_target, ignore_label=-1, use_ignore=True,
        grad_scale=3., multi_output=True, normalization='valid',
        name="cls_prob")
    loc_loss_ = mx.symbol.smooth_l1(
        data=loc_target_mask * (loc_preds - loc_target), scalar=1.0,
        name="loc_loss_")
    loc_loss = mx.symbol.MakeLoss(loc_loss_, grad_scale=1.,
                                  normalization='valid', name="loc_loss")
    cls_label = mx.symbol.MakeLoss(data=cls_target, grad_scale=0,
                                   name="cls_label")
    return mx.symbol.Group([cls_prob, loc_loss, cls_label])


def get_symbol(num_classes=3, nms_thresh=0.5, force_suppress=True):
    """Detection (inference) network (ref: get_symbol:165-176)."""
    net = get_symbol_train(num_classes)
    internals = net.get_internals()
    cls_preds = internals["multibox_cls_pred_output"]
    loc_preds = internals["multibox_loc_pred_output"]
    anchor_boxes = internals["multibox_anchors_output"]
    cls_prob = mx.symbol.SoftmaxActivation(data=cls_preds, mode='channel',
                                           name='cls_prob')
    return mx.symbol.MultiBoxDetection(
        cls_prob, loc_preds, anchor_boxes, name="detection",
        nms_threshold=nms_thresh, force_suppress=force_suppress,
        variances=(0.1, 0.1, 0.2, 0.2))
