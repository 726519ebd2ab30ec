"""Shared explicit-unroll LM scaffold for the recurrent model zoo.

lstm/gru/rnn unrolls differ only in their per-layer parameter bundles
and cell step; the embedding -> SliceChannel -> timestep loop ->
Concat -> decoder -> SoftmaxOutput scaffold lives here once
(lstm_unroll keeps its own copy because it additionally tags layers
with AttrScope(ctx_group=...) for the model-parallel variant).

The port's copy of ``mxnet_tpu/models/_unroll.py``, on this package's
``symbol``; ``tojson()`` of its graphs is the JAX package's, byte for
byte.
"""
from __future__ import annotations

from .. import symbol as sym


def unroll_lm(num_layers, seq_len, input_size, num_hidden, num_embed,
              num_label, make_params, make_state, cell, dropout=0.0,
              ignore_label=None):
    """Build an unrolled LM symbol.

    make_params(layer_idx) -> per-layer parameter bundle;
    make_state(layer_idx) -> initial state (Variables named l%d_init_*);
    cell(num_hidden, indata, prev_state, param, seqidx, layeridx,
    dropout) -> next state with ``.h``.
    """
    embed_weight = sym.Variable("embed_weight")
    cls_weight = sym.Variable("cls_weight")
    cls_bias = sym.Variable("cls_bias")
    param_cells = [make_params(i) for i in range(num_layers)]
    last_states = [make_state(i) for i in range(num_layers)]

    data = sym.Variable("data")
    embed = sym.Embedding(data=data, input_dim=input_size,
                          weight=embed_weight, output_dim=num_embed,
                          name="embed")
    wordvec = sym.SliceChannel(data=embed, num_outputs=seq_len, axis=1,
                               squeeze_axis=True, name="wordvec")

    hidden_all = []
    for seqidx in range(seq_len):
        hidden = wordvec[seqidx]
        for i in range(num_layers):
            next_state = cell(
                num_hidden, indata=hidden, prev_state=last_states[i],
                param=param_cells[i], seqidx=seqidx, layeridx=i,
                dropout=dropout if i > 0 else 0.0,
            )
            hidden = next_state.h
            last_states[i] = next_state
        hidden_all.append(hidden)

    # N-major prediction rows: [N, 1, H] per step -> [N, T, H] ->
    # [N*T, H], pairing row (n, t) with label[n, t].reshape(-1) — the
    # SAME flattening EvalMetric applies to the batch label, so the
    # in-graph loss and the reported metric read identical pairings.
    # (The t-major Concat(dim=0) + label-transpose form the reference's
    # lstm.py uses trains the same loss but scrambles every metric
    # reading against [T*N]-ordered predictions — r5 finding: measured
    # train perplexity could not beat the unigram floor on a corpus
    # whose true bigram perplexity was 4.3.)
    steps = [sym.Reshape(data=h, shape=(0, 1, -1)) for h in hidden_all]
    hidden_concat = sym.Concat(*steps, dim=1, num_args=len(steps))
    hidden_concat = sym.Reshape(data=hidden_concat, shape=(-1, num_hidden))
    if dropout > 0.0:
        hidden_concat = sym.Dropout(data=hidden_concat, p=dropout)
    pred = sym.FullyConnected(data=hidden_concat, num_hidden=num_label,
                              weight=cls_weight, bias=cls_bias, name="pred")
    label = sym.Variable("softmax_label")
    label = sym.Reshape(data=label, shape=(-1,))
    if ignore_label is not None:
        return sym.SoftmaxOutput(data=pred, label=label, name="softmax",
                                 use_ignore=True, ignore_label=ignore_label)
    return sym.SoftmaxOutput(data=pred, label=label, name="softmax")
