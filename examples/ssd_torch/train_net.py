"""Train SSD on a synthetic detection dataset — baseline config #5, on
mxnet_tpu_torch.

examples/ssd/train_net.py with its imports rewritten and ``--ctx``
taking ``gpu`` (the default: ``gpu(0)``, with no fallback to the CPU
when there is no card) or ``cpu``; the chosen context is the current
one for the run, so the arrays the example makes are made there:

    python3 examples/ssd_torch/train_net.py [--num-epochs 25 ...]

Mirrors the reference example/ssd/train/train_net.py:232 (Module API fit
with the multibox training symbol). The synthetic dataset draws colored
rectangles on a background; labels are (B, L, 5) [cls, x1, y1, x2, y2]
normalized, padded with -1 rows — the exact label layout MultiBoxTarget
expects (example/ssd/dataset/iterator.py).
"""
import argparse
import logging
import os
import sys

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

import mxnet_tpu_torch as mx  # noqa: E402
from symbol_ssd import get_symbol_train, get_symbol  # noqa: E402
from evaluate import evaluate_detections  # noqa: E402


def synthetic_detection_set(n, image=64, num_classes=3, max_obj=3, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, 3, image, image).astype('f') * 0.05
    Y = -np.ones((n, max_obj, 5), 'f')
    for i in range(n):
        for j in range(rng.randint(1, max_obj + 1)):
            cls = rng.randint(0, num_classes)
            w, h = rng.uniform(0.2, 0.5, 2)
            x1, y1 = rng.uniform(0, 1 - w), rng.uniform(0, 1 - h)
            x2, y2 = x1 + w, y1 + h
            px = slice(int(y1 * image), max(int(y2 * image), int(y1 * image) + 1))
            py = slice(int(x1 * image), max(int(x2 * image), int(x1 * image) + 1))
            X[i, cls % 3, px, py] += 0.8  # class-colored rectangle
            Y[i, j] = [cls, x1, y1, x2, y2]
    return X, Y


class MultiBoxMetric(mx.metric.EvalMetric):
    """Cls cross-entropy + smooth-l1 monitor
    (ref: example/ssd/train/metric.py MultiBoxMetric)."""

    def __init__(self):
        super().__init__('MultiBox')
        self.num = 2
        self.reset()

    def reset(self):
        self.sum_metric = [0.0, 0.0]
        self.num_inst = [0, 0]

    def update(self, labels, preds):
        cls_prob = preds[0].asnumpy()  # (B, C, A)
        loc_loss = preds[1].asnumpy()
        cls_label = preds[2].asnumpy()  # (B, A)
        valid = cls_label >= 0
        prob = np.take_along_axis(
            cls_prob, np.clip(cls_label[:, None, :].astype(int), 0, None), 1
        )[:, 0, :]
        self.sum_metric[0] += -np.log(np.maximum(prob[valid], 1e-10)).sum()
        self.num_inst[0] += int(valid.sum())
        self.sum_metric[1] += float(loc_loss.sum())
        self.num_inst[1] += int(valid.sum())

    def get(self):
        return (['CrossEntropy', 'SmoothL1'],
                [s / max(1, n) for s, n in zip(self.sum_metric, self.num_inst)])


def parse_args():
    p = argparse.ArgumentParser(description='train an SSD detector')
    p.add_argument('--num-classes', type=int, default=3)
    p.add_argument('--image', type=int, default=64)
    p.add_argument('--num-examples', type=int, default=512)
    p.add_argument('--batch-size', type=int, default=32)
    p.add_argument('--num-epochs', type=int, default=25)
    p.add_argument('--lr', type=float, default=0.1)
    p.add_argument('--ctx', type=str, default='gpu', choices=['gpu', 'cpu'])
    return p.parse_args()


def main():
    args = parse_args()
    logging.basicConfig(level=logging.INFO)
    smoke = os.environ.get("MXNET_EXAMPLE_SMOKE") == "1"
    if smoke:
        args.num_examples, args.num_epochs = 256, 15
    ctx = mx.cpu() if args.ctx == 'cpu' else mx.gpu()
    with ctx:   # the example's arrays are made on the current context
        X, Y = synthetic_detection_set(args.num_examples, args.image,
                                       args.num_classes)
        train = mx.io.NDArrayIter(X, Y, batch_size=args.batch_size, shuffle=True,
                                  label_name='label')

        net = get_symbol_train(args.num_classes)
        mod = mx.module.Module(net, data_names=('data',), label_names=('label',),
                               context=ctx)
        mod.fit(train,
                eval_metric=MultiBoxMetric(),
                optimizer='sgd',
                optimizer_params={'learning_rate': args.lr, 'momentum': 0.9,
                                  'wd': 5e-4},
                initializer=mx.initializer.Xavier(),
                batch_end_callback=mx.callback.Speedometer(args.batch_size, 10),
                num_epoch=args.num_epochs)

        # inference pass with the detection symbol sharing trained weights
        det_sym = get_symbol(args.num_classes, nms_thresh=0.5)
        arg_params, aux_params = mod.get_params()
        det = mx.module.Module(det_sym, data_names=('data',), label_names=None,
                               context=ctx)
        det.bind(data_shapes=[('data', (args.batch_size, 3, args.image, args.image))],
                 for_training=False)
        det.set_params(arg_params, aux_params, allow_missing=False)
        from mxnet_tpu_torch.io import DataBatch
        det.forward(DataBatch(data=[mx.nd.array(X[:args.batch_size])], label=None),
                    is_train=False)
        out = det.get_outputs()[0].asnumpy()
        kept = (out[:, :, 0] >= 0).sum(axis=1)
        logging.info('detections per image (first 8): %s', kept[:8].tolist())

        # evaluate: mAP on a held-out synthetic set through the SAME decode
        # pipeline (ref: example/ssd/evaluate/evaluate_net.py role)
        Xe, Ye = synthetic_detection_set(
            max(args.batch_size * 4, 64), args.image, args.num_classes, seed=99)
        mean_ap = evaluate_detections(det, Xe, Ye, args.batch_size,
                                      args.num_classes)
        logging.info('held-out mAP@0.5 = %.3f', mean_ap)
        assert mean_ap > 0.25, "SSD stopped converging: mAP=%.3f" % mean_ap
        print('ok: ssd train->detect->eval mAP=%.3f' % mean_ap)


if __name__ == '__main__':
    main()
