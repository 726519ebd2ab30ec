"""Explicitly-unrolled GRU language model (ref: example/rnn/gru.py).

Same construction discipline as models/lstm.py: per-timestep weight
sharing through shared Variables, SliceChannel over the embedded
sequence, the two gates (update, reset) as one 2*H FullyConnected and
the candidate transform as its own pair of projections — the reset gate
multiplies the PREVIOUS hidden state before the h2h transform (Chung et
al. 2014, the formulation the reference's gru() cell uses,
ref: example/rnn/gru.py:17-57).

The port's copy of ``mxnet_tpu/models/gru.py``, on this package's
``symbol``; ``tojson()`` of its graphs is the JAX package's, byte for
byte.
"""
from __future__ import annotations

from collections import namedtuple

from .. import symbol as sym

GRUState = namedtuple("GRUState", ["h"])
GRUParam = namedtuple(
    "GRUParam",
    ["gates_i2h_weight", "gates_i2h_bias", "gates_h2h_weight",
     "gates_h2h_bias", "trans_i2h_weight", "trans_i2h_bias",
     "trans_h2h_weight", "trans_h2h_bias"],
)


def gru_cell(num_hidden, indata, prev_state, param, seqidx, layeridx,
             dropout=0.0):
    """One GRU step: z/r gates from a fused 2*H projection, candidate
    from the reset-scaled previous state, convex blend for the output."""
    if dropout > 0.0:
        indata = sym.Dropout(data=indata, p=dropout)
    gates = sym.FullyConnected(
        data=indata, weight=param.gates_i2h_weight,
        bias=param.gates_i2h_bias, num_hidden=num_hidden * 2,
        name="t%d_l%d_gates_i2h" % (seqidx, layeridx),
    ) + sym.FullyConnected(
        data=prev_state.h, weight=param.gates_h2h_weight,
        bias=param.gates_h2h_bias, num_hidden=num_hidden * 2,
        name="t%d_l%d_gates_h2h" % (seqidx, layeridx),
    )
    zr = sym.SliceChannel(gates, num_outputs=2,
                          name="t%d_l%d_slice" % (seqidx, layeridx))
    update = sym.Activation(zr[0], act_type="sigmoid")
    reset = sym.Activation(zr[1], act_type="sigmoid")
    cand = sym.FullyConnected(
        data=indata, weight=param.trans_i2h_weight,
        bias=param.trans_i2h_bias, num_hidden=num_hidden,
        name="t%d_l%d_trans_i2h" % (seqidx, layeridx),
    ) + sym.FullyConnected(
        data=prev_state.h * reset, weight=param.trans_h2h_weight,
        bias=param.trans_h2h_bias, num_hidden=num_hidden,
        name="t%d_l%d_trans_h2h" % (seqidx, layeridx),
    )
    cand = sym.Activation(cand, act_type="tanh")
    # next_h = (1 - z) * h + z * cand, written as h + z*(cand - h) so the
    # update gate literally gates the state CHANGE
    next_h = prev_state.h + update * (cand - prev_state.h)
    return GRUState(h=next_h)


def gru_unroll(num_gru_layer, seq_len, input_size, num_hidden, num_embed,
               num_label, dropout=0.0, ignore_label=None):
    """Unrolled GRU LM symbol; interface-identical to lstm_unroll so the
    bucketing example can swap cells (init states: h only, no c).
    ignore_label: exclude padding rows from the loss (see models/rnn.py)."""
    from ._unroll import unroll_lm

    def make_params(i):
        return GRUParam(
            gates_i2h_weight=sym.Variable("l%d_i2h_gates_weight" % i),
            gates_i2h_bias=sym.Variable("l%d_i2h_gates_bias" % i),
            gates_h2h_weight=sym.Variable("l%d_h2h_gates_weight" % i),
            gates_h2h_bias=sym.Variable("l%d_h2h_gates_bias" % i),
            trans_i2h_weight=sym.Variable("l%d_i2h_trans_weight" % i),
            trans_i2h_bias=sym.Variable("l%d_i2h_trans_bias" % i),
            trans_h2h_weight=sym.Variable("l%d_h2h_trans_weight" % i),
            trans_h2h_bias=sym.Variable("l%d_h2h_trans_bias" % i),
        )

    return unroll_lm(num_gru_layer, seq_len, input_size, num_hidden,
                     num_embed, num_label, make_params,
                     lambda i: GRUState(h=sym.Variable("l%d_init_h" % i)),
                     gru_cell, dropout=dropout, ignore_label=ignore_label)
