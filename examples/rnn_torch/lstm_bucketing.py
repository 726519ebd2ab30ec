"""PTB LSTM LM with bucketing on mxnet_tpu_torch — baseline config #3.

examples/rnn/lstm_bucketing.py for the PyTorch port, with the same
command line and defaults: sym_gen per bucket key + BucketSentenceIter,
trained with FeedForward on the current context (``gpu(0)``). Uses PTB
text (ptb.train.txt) when present, else the synthetic Markov corpus.

    python3 examples/rnn_torch/lstm_bucketing.py [--num-epochs 5 ...]
"""
import argparse
import logging
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_HERE, os.path.dirname(os.path.dirname(_HERE))]

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch.models.lstm import lstm_unroll  # noqa: E402
from bucket_io import BucketSentenceIter, default_build_vocab  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--data-dir', type=str, default='ptb/')
    p.add_argument('--num-hidden', type=int, default=200)
    p.add_argument('--num-embed', type=int, default=200)
    p.add_argument('--num-lstm-layer', type=int, default=2)
    p.add_argument('--num-epochs', type=int, default=5)
    p.add_argument('--batch-size', type=int, default=32)
    p.add_argument('--lr', type=float, default=0.1)
    p.add_argument('--kv-store', type=str, default='local')
    p.add_argument('--buckets', type=int, nargs='+', default=[10, 20, 30, 40, 60])
    return p.parse_args(argv)


def build(args, ctx=None):
    """The example's iterator, symbol generator and model:
    ``(data_train, sym_gen, model)``."""
    batch_size = args.batch_size
    init_c = [('l%d_init_c' % l, (batch_size, args.num_hidden))
              for l in range(args.num_lstm_layer)]
    init_h = [('l%d_init_h' % l, (batch_size, args.num_hidden))
              for l in range(args.num_lstm_layer)]
    init_states = init_c + init_h

    train_path = os.path.join(args.data_dir, 'ptb.train.txt')
    if os.path.exists(train_path):
        vocab = default_build_vocab(train_path)
        data_train = BucketSentenceIter(train_path, vocab, args.buckets,
                                        batch_size, init_states)
    else:
        data_train = BucketSentenceIter(None, None, args.buckets, batch_size,
                                        init_states)
    vocab_size = data_train.vocab_size

    def sym_gen(seq_len):
        # (ref lstm_bucketing.py:53-56)
        return lstm_unroll(args.num_lstm_layer, seq_len, vocab_size,
                           num_hidden=args.num_hidden, num_embed=args.num_embed,
                           num_label=vocab_size, ignore_label=0)

    model = mx.FeedForward(
        ctx=ctx or mx.context.current_context(),
        symbol=sym_gen,
        num_epoch=args.num_epochs,
        learning_rate=args.lr,
        momentum=0.9,
        wd=0.00001,
        initializer=mx.initializer.Xavier(factor_type="in", magnitude=2.34))
    return data_train, sym_gen, model


if __name__ == '__main__':
    args = parse_args()
    data_train, _, model = build(args)
    logging.basicConfig(level=logging.DEBUG)
    model.fit(X=data_train,
              eval_metric=mx.metric.Perplexity(ignore_label=0),
              batch_end_callback=mx.callback.Speedometer(args.batch_size, 50),
              kvstore=args.kv_store)
