"""NumpyOp escape hatch demo — train an MLP whose loss head is a
user-defined numpy log-softmax operator.

The point of the exercise: a NumpyOp written against the reference's
host-numpy operator contract migrates to the TPU-native runtime
unmodified — the hybrid executor runs the numpy body eagerly between
jitted device segments (the role _Native/NumpyOp's io_callback plays,
ref: src/operator/native_op-inl.h, python/mxnet/operator.py:124-222).

The op here is a numerically-stable log-softmax over a configurable
axis, used as an NLL loss head:

    forward:  y = x - max(x) - log(sum(exp(x - max(x))))   (log p)
    backward: dx = exp(y) - onehot(label)                  (d NLL/dx)

Shifting by the row max keeps exp() in [0, 1] — large logits cannot
overflow — and returning *log* probabilities keeps tiny ones exactly
representable (log p, not log(p) of an underflowed p). Accuracy metrics
read argmax, which log-softmax preserves.

examples/numpy-ops/numpy_softmax.py on mxnet_tpu_torch: its import
rewritten and ``--ctx`` taking ``gpu`` (the default: ``gpu(0)``, no
fallback to the CPU) or ``cpu``; on the card the numpy body runs on the
host between the card's ops:

    python3 examples/numpy-ops_torch/numpy_softmax.py [--ctx cpu]
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


class NumpyLogSoftmax(mx.operator.NumpyOp):
    """Log-softmax + NLL gradient over ``axis`` of the input."""

    def __init__(self, axis=1):
        # need_top_grad=False: this is a loss head — backward produces
        # input gradients from the label, ignoring out_grad
        super(NumpyLogSoftmax, self).__init__(False)
        self.axis = int(axis)

    def list_arguments(self):
        return ['data', 'label']

    def list_outputs(self):
        return ['output']

    def infer_shape(self, in_shape):
        data_shape = in_shape[0]
        axis = self.axis % len(data_shape)
        # label indexes the class axis; it keeps every other dim
        label_shape = tuple(d for i, d in enumerate(data_shape) if i != axis)
        return [data_shape, label_shape], [data_shape]

    def forward(self, in_data, out_data):
        x = in_data[0]
        y = out_data[0]
        shifted = x - x.max(axis=self.axis, keepdims=True)
        lse = np.log(np.exp(shifted).sum(axis=self.axis, keepdims=True))
        y[:] = shifted - lse

    def backward(self, out_grad, in_data, out_data, in_grad):
        label = in_data[1].astype(int)
        y = out_data[0]
        dx = in_grad[0]
        axis = self.axis % y.ndim
        dx[:] = np.exp(y)  # softmax(x), recovered from the log-probs
        onehot = np.expand_dims(label, axis)
        # per-example gradients, as loss ops emit them — the optimizer's
        # rescale_grad (1/batch in FeedForward) owns batch normalization
        np.put_along_axis(dx, onehot, np.take_along_axis(dx, onehot, axis)
                          - 1.0, axis)


def main():
    p = argparse.ArgumentParser()
    p.add_argument('--ctx', type=str, default='gpu', choices=['gpu', 'cpu'])
    ctx = mx.cpu() if p.parse_args().ctx == 'cpu' else mx.gpu()
    with ctx:   # the example's arrays are made on the current context
        _run(ctx)


def _run(ctx):
    smoke = bool(os.environ.get("MXNET_EXAMPLE_SMOKE"))
    data = mx.symbol.Variable('data')
    fc1 = mx.symbol.FullyConnected(data=data, name='fc1', num_hidden=128)
    act1 = mx.symbol.Activation(data=fc1, name='relu1', act_type="relu")
    fc2 = mx.symbol.FullyConnected(data=act1, name='fc2', num_hidden=64)
    act2 = mx.symbol.Activation(data=fc2, name='relu2', act_type="relu")
    fc3 = mx.symbol.FullyConnected(data=act2, name='fc3', num_hidden=10)
    logsoftmax = NumpyLogSoftmax(axis=1)
    mlp = logsoftmax(data=fc3, label=mx.symbol.Variable('softmax_label'),
                     name='softmax')

    train = mx.io.MNISTIter(batch_size=100, flat=True)
    val = mx.io.MNISTIter(batch_size=100, flat=True, shuffle=False, seed=7)

    logging.basicConfig(level=logging.INFO)
    model = mx.model.FeedForward(
        ctx=ctx, symbol=mlp, num_epoch=1 if smoke else 5,
        learning_rate=0.1, momentum=0.9, wd=0.00001,
        initializer=mx.initializer.Xavier())
    model.fit(X=train, eval_data=val,
              batch_end_callback=mx.callback.Speedometer(100, 50))
    acc = model.score(val)
    print("NumpyLogSoftmax MLP: val acc %.3f" % acc)
    if not smoke:
        assert acc > 0.9, "log-softmax MLP failed to converge (acc=%.3f)" % acc


if __name__ == '__main__':
    main()
