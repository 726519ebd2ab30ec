"""Model-parallel LSTM on mxnet_tpu_torch — baseline config #4.

examples/model-parallel-lstm/lstm_ptb.py for the PyTorch port, with the
same command line and defaults (4 layers, 200 hidden, 128 embed, seq 32,
batch 32, lr 0.5, 2 epochs) over examples/rnn_torch/bucket_io.py: each
LSTM layer, the embedding and the decoder are tagged with
``AttrScope(ctx_group=...)`` (``models.lstm.lstm_unroll(group2ctx_layers
=True)``), the symbol is bound with ``group2ctx`` (``lstm_group2ctx``:
the embedding on the first device, layer i on device ``min(1 + i,
last)``, the decoder on the last) and ``grad_req="add"``, and a plain
SGD loop drives it. Uses PTB text (``ptb.train.txt`` in ``--data-dir``)
when present, else the synthetic Markov corpus.

``--ctx`` is ``auto`` or ``gpu`` (the cards ``gpu(i)`` for ``i <
min(--num-devices, device_count)``; no fallback to the CPU when there is
no card) or ``cpu`` (``cpu(i)`` for ``i < --num-devices``, all the one
host device). The group map is logged.

    python3 examples/model-parallel-lstm_torch/lstm_ptb.py [--num-epochs 2 ...]
"""
import argparse
import logging
import os
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(os.path.dirname(_HERE))
sys.path[:0] = [os.path.join(_ROOT, 'examples', 'rnn_torch'), _ROOT]

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch.models.lstm import lstm_unroll, lstm_group2ctx  # noqa: E402
from bucket_io import BucketSentenceIter  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--data-dir', type=str, default='ptb/')
    p.add_argument('--seq-len', type=int, default=32)
    p.add_argument('--num-hidden', type=int, default=200)
    p.add_argument('--num-embed', type=int, default=128)
    p.add_argument('--num-lstm-layer', type=int, default=4)
    p.add_argument('--num-devices', type=int, default=4)
    p.add_argument('--num-epochs', type=int, default=2)
    p.add_argument('--batch-size', type=int, default=32)
    p.add_argument('--lr', type=float, default=0.5)
    p.add_argument('--ctx', type=str, default='auto', choices=['auto', 'gpu', 'cpu'])
    return p.parse_args(argv)


def devices(args):
    if args.ctx == 'cpu':
        return [mx.cpu(i) for i in range(args.num_devices)]
    n = mx.context.num_devices('gpu')
    if n == 0:
        raise mx.MXNetError("--ctx %s: no CUDA device is visible" % args.ctx)
    return [mx.gpu(i) for i in range(min(args.num_devices, n))]


def main(argv=None):
    """Train; returns ``{"perplexity": [...], "samples_per_s": [...],
    "group2ctx": {group: context}, "batches": n}``."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    devs = devices(args)
    # the iterator's batches are made on the current context: the
    # embedding's, where the data goes
    with devs[0]:
        return train(args, devs)


def train(args, devs):
    init_states = (
        [('l%d_init_c' % l, (args.batch_size, args.num_hidden))
         for l in range(args.num_lstm_layer)]
        + [('l%d_init_h' % l, (args.batch_size, args.num_hidden))
           for l in range(args.num_lstm_layer)])
    train_path = os.path.join(args.data_dir, 'ptb.train.txt')
    data_train = BucketSentenceIter(
        train_path if os.path.exists(train_path) else None, None,
        [args.seq_len], args.batch_size, init_states)

    # ctx_group-tagged symbol (ref model-parallel-lstm/lstm.py:48-99)
    sym = lstm_unroll(args.num_lstm_layer, args.seq_len, data_train.vocab_size,
                      num_hidden=args.num_hidden, num_embed=args.num_embed,
                      num_label=data_train.vocab_size, group2ctx_layers=True,
                      ignore_label=0)
    group2ctx = lstm_group2ctx(args.num_lstm_layer, devs)
    logging.info('group2ctx: %s', group2ctx)

    # bind with group placement (ref lstm.py setup_rnn_model → simple_bind
    # with group2ctx; lstm_ptb.py:79-90)
    input_shapes = dict(
        [('data', (args.batch_size, args.seq_len)),
         ('softmax_label', (args.batch_size, args.seq_len))]
        + [(n, s) for n, s in init_states])
    exe = sym.simple_bind(ctx=devs[0], grad_req='add', group2ctx=group2ctx,
                          **input_shapes)

    initializer = mx.initializer.Xavier()
    for name, arr in zip(sym.list_arguments(), exe.arg_arrays):
        if name not in input_shapes or name.endswith(('init_c', 'init_h')):
            if not name.endswith(('_c', '_h')) and name not in ('data', 'softmax_label'):
                initializer(name, arr)

    param_names = [n for n in sym.list_arguments()
                   if n not in ('data', 'softmax_label')
                   and not n.endswith(('init_c', 'init_h'))]
    name2idx = {n: i for i, n in enumerate(sym.list_arguments())}
    metric = mx.metric.Perplexity(ignore_label=0)

    result = {"perplexity": [], "samples_per_s": [], "batches": 0,
              "group2ctx": {k: str(v) for k, v in group2ctx.items()}}
    for epoch in range(args.num_epochs):
        data_train.reset()
        metric.reset()
        tic = time.time()
        nbatch = 0
        for batch in data_train:
            arg_dict = dict(zip(sym.list_arguments(), exe.arg_arrays))
            arg_dict['data'][:] = batch.data[0]
            arg_dict['softmax_label'][:] = batch.label[0]
            for g in exe.grad_arrays:
                if g is not None:
                    g[:] = 0.0
            exe.forward(is_train=True)
            exe.backward()
            for n in param_names:
                i = name2idx[n]
                w, g = exe.arg_arrays[i], exe.grad_arrays[i]
                w[:] = w - (args.lr / args.batch_size) * g
            metric.update([batch.label[0]], [exe.outputs[0]])
            nbatch += 1
        name, val = metric.get()
        rate = nbatch * args.batch_size / (time.time() - tic)
        logging.info('Epoch[%d] %s=%f  (%.1f samples/s)', epoch, name, val,
                     rate)
        result["perplexity"].append(float(val))
        result["samples_per_s"].append(rate)
        result["batches"] += nbatch
    return result


if __name__ == '__main__':
    main()
