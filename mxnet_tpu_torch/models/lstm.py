"""Explicitly-unrolled LSTM language model — baseline configs 3 & 4
(ref: example/rnn/lstm.py:17-41 lstm(), example/model-parallel-lstm/lstm.py:48-99).

Same construction as the reference: per-timestep weight sharing via shared
Variables, SliceChannel over the embedded sequence, gates as one 4*H
FullyConnected. For the model-parallel variant, layers are tagged with
AttrScope(ctx_group=...) exactly like the reference.

The port's copy of ``mxnet_tpu/models/lstm.py``, on this package's
``symbol`` and ``attribute``; ``tojson()`` of its graphs is the JAX
package's, byte for byte. ``lstm_group2ctx`` builds the map that
``simple_bind(group2ctx=...)`` places the groups by (``executor.py``:
each group's arrays and nodes on its context, copies at the
boundaries), as examples/model-parallel-lstm_torch/lstm_ptb.py binds it.
"""
from __future__ import annotations

from collections import namedtuple

from .. import symbol as sym
from ..attribute import AttrScope

LSTMState = namedtuple("LSTMState", ["c", "h"])
LSTMParam = namedtuple(
    "LSTMParam", ["i2h_weight", "i2h_bias", "h2h_weight", "h2h_bias"]
)


def lstm_cell(num_hidden, indata, prev_state, param, seqidx, layeridx, dropout=0.0):
    """One LSTM step (ref: example/rnn/lstm.py:17-41)."""
    if dropout > 0.0:
        indata = sym.Dropout(data=indata, p=dropout)
    i2h = sym.FullyConnected(
        data=indata, weight=param.i2h_weight, bias=param.i2h_bias,
        num_hidden=num_hidden * 4, name="t%d_l%d_i2h" % (seqidx, layeridx),
    )
    h2h = sym.FullyConnected(
        data=prev_state.h, weight=param.h2h_weight, bias=param.h2h_bias,
        num_hidden=num_hidden * 4, name="t%d_l%d_h2h" % (seqidx, layeridx),
    )
    gates = i2h + h2h
    slice_gates = sym.SliceChannel(
        gates, num_outputs=4, name="t%d_l%d_slice" % (seqidx, layeridx)
    )
    in_gate = sym.Activation(slice_gates[0], act_type="sigmoid")
    in_transform = sym.Activation(slice_gates[1], act_type="tanh")
    forget_gate = sym.Activation(slice_gates[2], act_type="sigmoid")
    out_gate = sym.Activation(slice_gates[3], act_type="sigmoid")
    next_c = (forget_gate * prev_state.c) + (in_gate * in_transform)
    next_h = out_gate * sym.Activation(next_c, act_type="tanh")
    return LSTMState(c=next_c, h=next_h)


def lstm_unroll(num_lstm_layer, seq_len, input_size, num_hidden, num_embed,
                num_label, dropout=0.0, group2ctx_layers=False,
                ignore_label=None):
    """Unrolled LSTM LM symbol (ref: example/rnn/lstm.py lstm_unroll:44).
    With group2ctx_layers=True, tags embed/layers/decode with ctx_group
    attrs like example/model-parallel-lstm/lstm.py:48-99.
    ignore_label: exclude padding rows from the loss — on padded
    sequence data the un-ignored label-0 positions otherwise teach the
    model to smear probability onto the padding class, monotonically
    worsening real-token perplexity while the optimized loss still
    falls (r5 finding, examples/rnn)."""

    def scoped(group):
        if group2ctx_layers:
            return AttrScope(ctx_group=group)
        return AttrScope()

    with scoped("embed"):
        embed_weight = sym.Variable("embed_weight")
    with scoped("decode"):
        cls_weight = sym.Variable("cls_weight")
        cls_bias = sym.Variable("cls_bias")
    param_cells = []
    last_states = []
    for i in range(num_lstm_layer):
        with scoped("layer%d" % i):
            param_cells.append(LSTMParam(
                i2h_weight=sym.Variable("l%d_i2h_weight" % i),
                i2h_bias=sym.Variable("l%d_i2h_bias" % i),
                h2h_weight=sym.Variable("l%d_h2h_weight" % i),
                h2h_bias=sym.Variable("l%d_h2h_bias" % i),
            ))
            last_states.append(LSTMState(
                c=sym.Variable("l%d_init_c" % i), h=sym.Variable("l%d_init_h" % i)
            ))

    with scoped("embed"):
        data = sym.Variable("data")
        embed = sym.Embedding(
            data=data, input_dim=input_size, weight=embed_weight,
            output_dim=num_embed, name="embed",
        )
        wordvec = sym.SliceChannel(
            data=embed, num_outputs=seq_len, axis=1, squeeze_axis=True, name="wordvec"
        )

    hidden_all = []
    for seqidx in range(seq_len):
        hidden = wordvec[seqidx]
        for i in range(num_lstm_layer):
            with scoped("layer%d" % i):
                next_state = lstm_cell(
                    num_hidden, indata=hidden, prev_state=last_states[i],
                    param=param_cells[i], seqidx=seqidx, layeridx=i,
                    dropout=dropout if i > 0 else 0.0,
                )
                hidden = next_state.h
                last_states[i] = next_state
        hidden_all.append(hidden)

    with scoped("decode"):
        # N-major rows so pred row (n, t) pairs with label[n, t] under
        # the metric's plain reshape(-1) — see models/_unroll.py for the
        # r5 finding behind this layout
        steps = [sym.Reshape(data=h, shape=(0, 1, -1)) for h in hidden_all]
        hidden_concat = sym.Concat(*steps, dim=1, num_args=len(steps))
        hidden_concat = sym.Reshape(data=hidden_concat,
                                    shape=(-1, num_hidden))
        if dropout > 0.0:
            hidden_concat = sym.Dropout(data=hidden_concat, p=dropout)
        pred = sym.FullyConnected(
            data=hidden_concat, num_hidden=num_label, weight=cls_weight,
            bias=cls_bias, name="pred",
        )
        label = sym.Variable("softmax_label")
        label = sym.Reshape(data=label, shape=(-1,))
        if ignore_label is not None:
            loss = sym.SoftmaxOutput(data=pred, label=label, name="softmax",
                                     use_ignore=True,
                                     ignore_label=ignore_label)
        else:
            loss = sym.SoftmaxOutput(data=pred, label=label, name="softmax")
    return loss


def lstm_group2ctx(num_lstm_layer, contexts):
    """Build the group2ctx map for model-parallel binding
    (ref: example/model-parallel-lstm/lstm_ptb.py:79-90)."""
    group2ctx = {"embed": contexts[0], "decode": contexts[-1]}
    for i in range(num_lstm_layer):
        group2ctx["layer%d" % i] = contexts[min(1 + i, len(contexts) - 1)]
    return group2ctx
