"""Explicitly-unrolled vanilla (Elman) RNN language model
(ref: example/rnn/rnn.py).

The simplest recurrence the reference's rnn() cell implements:
``h_t = act(W x_t + U h_{t-1} + b)`` with an optional BatchNorm on the
hidden state — kept here because the reference exposes it and it
exercises BatchNorm inside a recurrence (per-timestep batch statistics).
Interface-identical to lstm_unroll/gru_unroll for bucketing reuse.

The port's copy of ``mxnet_tpu/models/rnn.py``, on this package's
``symbol``; ``tojson()`` of its graphs is the JAX package's, byte for
byte.
"""
from __future__ import annotations

from collections import namedtuple

from .. import symbol as sym

RNNState = namedtuple("RNNState", ["h"])
RNNParam = namedtuple(
    "RNNParam", ["i2h_weight", "i2h_bias", "h2h_weight", "h2h_bias"]
)


def rnn_cell(num_hidden, indata, prev_state, param, seqidx, layeridx,
             dropout=0.0, act_type="tanh", batch_norm=False):
    """One Elman step (ref: example/rnn/rnn.py rnn())."""
    if dropout > 0.0:
        indata = sym.Dropout(data=indata, p=dropout)
    hidden = sym.FullyConnected(
        data=indata, weight=param.i2h_weight, bias=param.i2h_bias,
        num_hidden=num_hidden, name="t%d_l%d_i2h" % (seqidx, layeridx),
    ) + sym.FullyConnected(
        data=prev_state.h, weight=param.h2h_weight, bias=param.h2h_bias,
        num_hidden=num_hidden, name="t%d_l%d_h2h" % (seqidx, layeridx),
    )
    hidden = sym.Activation(data=hidden, act_type=act_type)
    if batch_norm:
        hidden = sym.BatchNorm(data=hidden,
                               name="t%d_l%d_bn" % (seqidx, layeridx))
    return RNNState(h=hidden)


def rnn_unroll(num_rnn_layer, seq_len, input_size, num_hidden, num_embed,
               num_label, dropout=0.0, act_type="tanh", batch_norm=False,
               ignore_label=None):
    """Unrolled Elman-RNN LM symbol (ref: example/rnn/rnn.py
    rnn_unroll). ignore_label: exclude padding rows from the loss —
    without a gate structure the padding class otherwise dominates the
    sum-CE gradient on bucketed data (see examples/rnn/rnn_cell_demo)."""
    import functools

    from ._unroll import unroll_lm

    def make_params(i):
        return RNNParam(
            i2h_weight=sym.Variable("l%d_i2h_weight" % i),
            i2h_bias=sym.Variable("l%d_i2h_bias" % i),
            h2h_weight=sym.Variable("l%d_h2h_weight" % i),
            h2h_bias=sym.Variable("l%d_h2h_bias" % i),
        )

    cell = functools.partial(rnn_cell, act_type=act_type,
                             batch_norm=batch_norm)
    return unroll_lm(num_rnn_layer, seq_len, input_size, num_hidden,
                     num_embed, num_label, make_params,
                     lambda i: RNNState(h=sym.Variable("l%d_init_h" % i)),
                     cell, dropout=dropout, ignore_label=ignore_label)
