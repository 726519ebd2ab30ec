"""Sequence ops and the fused RNN op.

Counterpart of ``mxnet_tpu/ops/sequence.py``: ``SequenceLast``,
``SequenceMask`` and ``SequenceReverse`` (:28-125) and ``RNN``
(:129-296), with the same parameter fields, inputs, outputs and shape
inference (copied), so graphs serialise to the same JSON.

Layout follows the JAX op: time-major ``(seq_len, batch, feature)``;
``parameters`` is one flat vector holding, per layer and direction,
W_ih (G*H, I), W_hh (G*H, H), b_ih and b_hh, gates in the order i, f,
g, o for LSTM and r, z, n for GRU (``rnn_param_size`` and
``_slice_layer_params``, copied). The JAX op runs the recurrence as a
``lax.scan``, not a Pallas kernel; here it is a loop of torch ops over
time with the input projection of every step computed first, as the JAX
op does, and autograd through the loop gives BPTT. Between layers (after
every layer but the last) a training forward with ``p > 0`` drops
activations with the JAX op's bits: ``bernoulli(fold_in(key, layer),
1 - p, x.shape)`` of :mod:`..threefry` under the node's key, and
``x / (1 - p)`` where it keeps.
"""
from __future__ import annotations

import torch

from .. import threefry
from ..base import MXNetError
from .registry import Field, OpDef, register


# -- SequenceLast / SequenceMask / SequenceReverse ----------------------------
def _seq_args(params):
    if params.get("use_sequence_length"):
        return ["data", "sequence_length"]
    return ["data"]


def _lengths(t):
    # float lengths truncate toward zero, as the JAX op's astype(int32)
    return t.to(torch.int64)


def _seq_last_fwd(params, inputs, aux, is_train, rng):
    data = inputs[0]
    if not params["use_sequence_length"]:
        return [data[-1]], []
    idx = torch.clamp(_lengths(inputs[1]) - 1, min=0)
    cols = torch.arange(data.shape[1], device=data.device)
    return [data[idx, cols]], []


def _seq_last_shape(params, in_shapes):
    if in_shapes[0] is None:
        raise MXNetError("SequenceLast: data shape unknown")
    s = in_shapes[0]
    ins = [s] + ([(s[1],)] if params["use_sequence_length"] else [])
    return ins, [s[1:]], []


register(
    OpDef(
        "SequenceLast",
        _seq_last_fwd,
        params={"use_sequence_length": Field("bool", default=False)},
        arguments=_seq_args,
        infer_shape=_seq_last_shape,
    )
)


def _seq_mask_fwd(params, inputs, aux, is_train, rng):
    data = inputs[0]
    if not params["use_sequence_length"]:
        return [data], []
    lengths = _lengths(inputs[1])
    t = torch.arange(data.shape[0], device=data.device)
    mask = t[:, None] < lengths[None, :]  # (T, N)
    mask = mask.reshape(mask.shape + (1,) * (data.dim() - 2))
    value = torch.tensor(params["value"], dtype=data.dtype,
                         device=data.device)
    return [torch.where(mask, data, value)], []


def _seq_io_shape(params, in_shapes):
    if in_shapes[0] is None:
        raise MXNetError("sequence op: data shape unknown")
    s = in_shapes[0]
    ins = [s] + ([(s[1],)] if params["use_sequence_length"] else [])
    return ins, [s], []


register(
    OpDef(
        "SequenceMask",
        _seq_mask_fwd,
        params={
            "use_sequence_length": Field("bool", default=False),
            "value": Field("float", default=0.0),
        },
        arguments=_seq_args,
        infer_shape=_seq_io_shape,
    )
)


def _seq_reverse_fwd(params, inputs, aux, is_train, rng):
    data = inputs[0]
    if not params["use_sequence_length"]:
        return [torch.flip(data, dims=(0,))], []
    lengths = _lengths(inputs[1])[None, :]
    t = torch.arange(data.shape[0], device=data.device)[:, None]
    # source row of output row t in column n: len-1-t when t < len, else t
    src = torch.where(t < lengths, lengths - 1 - t, t)
    cols = torch.arange(data.shape[1], device=data.device)[None, :]
    return [data[src, cols]], []


register(
    OpDef(
        "SequenceReverse",
        _seq_reverse_fwd,
        params={"use_sequence_length": Field("bool", default=False)},
        arguments=_seq_args,
        infer_shape=_seq_io_shape,
    )
)


# -- RNN -----------------------------------------------------------------------
_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def rnn_param_size(mode, input_size, state_size, num_layers, bidirectional):
    """Total flat parameter count; layout in the module docstring."""
    G = _GATES[mode]
    D = 2 if bidirectional else 1
    total = 0
    for l in range(num_layers):
        isz = input_size if l == 0 else state_size * D
        total += D * (G * state_size * isz + G * state_size * state_size + 2 * G * state_size)
    return total


def _slice_layer_params(flat, mode, input_size, state_size, num_layers, bidirectional):
    G = _GATES[mode]
    H = state_size
    D = 2 if bidirectional else 1
    off = 0
    layers = []
    for l in range(num_layers):
        isz = input_size if l == 0 else H * D
        dirs = []
        for _ in range(D):
            w_ih = flat[off:off + G * H * isz].reshape(G * H, isz); off += G * H * isz
            w_hh = flat[off:off + G * H * H].reshape(G * H, H); off += G * H * H
            b_ih = flat[off:off + G * H]; off += G * H
            b_hh = flat[off:off + G * H]; off += G * H
            dirs.append((w_ih, w_hh, b_ih, b_hh))
        layers.append(dirs)
    return layers


def _cell_step(mode, H):
    """One step of the recurrence: (carry, input projection, w_hh,
    b_hh) -> (carry, h), the JAX op's ``_cell_step`` (:159)."""
    def step(carry, gates_x, w_hh, b_hh):
        if mode == "lstm":
            h, c = carry
            gates = gates_x + torch.matmul(h, w_hh.t()) + b_hh
            i, f, g, o = torch.chunk(gates, 4, dim=-1)
            i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
            g = torch.tanh(g)
            c2 = f * c + i * g
            h2 = o * torch.tanh(c2)
            return (h2, c2), h2
        if mode == "gru":
            h = carry[0]
            rz_x, n_x = gates_x[..., : 2 * H], gates_x[..., 2 * H:]
            hh = torch.matmul(h, w_hh.t()) + b_hh
            rz_h, n_h = hh[..., : 2 * H], hh[..., 2 * H:]
            r, z = torch.chunk(torch.sigmoid(rz_x + rz_h), 2, dim=-1)
            n = torch.tanh(n_x + r * n_h)
            h2 = (1 - z) * n + z * h
            return (h2,), h2
        h = carry[0]
        pre = gates_x + torch.matmul(h, w_hh.t()) + b_hh
        h2 = torch.relu(pre) if mode == "rnn_relu" else torch.tanh(pre)
        return (h2,), h2

    return step


def _run_direction(x, h0, c0, wparams, mode, H, reverse):
    w_ih, w_hh, b_ih, b_hh = wparams
    if reverse:
        x = torch.flip(x, dims=(0,))
    gates_x = torch.matmul(x, w_ih.t()) + b_ih   # every step's input projection
    step = _cell_step(mode, H)
    carry = (h0, c0) if mode == "lstm" else (h0,)
    ys = []
    for t in range(x.shape[0]):
        carry, y = step(carry, gates_x[t], w_hh, b_hh)
        ys.append(y)
    ys = torch.stack(ys)
    if reverse:
        ys = torch.flip(ys, dims=(0,))
    if mode == "lstm":
        return ys, carry[0], carry[1]
    return ys, carry[0], None


def _rnn_fwd(params, inputs, aux, is_train, rng):
    mode = params["mode"]
    H = params["state_size"]
    L = params["num_layers"]
    bidir = params["bidirectional"]
    D = 2 if bidir else 1
    data = inputs[0]
    flat = inputs[1]
    state = inputs[2]
    c_state = inputs[3] if mode == "lstm" else None
    T, N, I = data.shape
    layers = _slice_layer_params(flat, mode, I, H, L, bidir)
    x = data
    h_out, c_out = [], []
    for l, dirs in enumerate(layers):
        outs = []
        for d, wp in enumerate(dirs):
            h0 = state[l * D + d]
            c0 = c_state[l * D + d] if c_state is not None else None
            ys, hT, cT = _run_direction(x, h0, c0, wp, mode, H, reverse=(d == 1))
            outs.append(ys)
            h_out.append(hT)
            if cT is not None:
                c_out.append(cT)
        x = outs[0] if D == 1 else torch.cat(outs, dim=-1)
        if is_train and params["p"] > 0 and l < L - 1 and rng is not None:
            keep = 1.0 - params["p"]
            mask = threefry.bernoulli(threefry.fold_in(rng, l), keep, x.shape)
            keep_t = torch.tensor(keep, dtype=x.dtype, device=x.device)
            x = torch.where(mask, x / keep_t, torch.zeros_like(x))
    outputs = [x]
    if params["state_outputs"]:
        outputs.append(torch.stack(h_out))
        if mode == "lstm":
            outputs.append(torch.stack(c_out))
    return outputs, []


def _rnn_args(params):
    base = ["data", "parameters", "state"]
    if params.get("mode") == "lstm":
        base.append("state_cell")
    return base


def _rnn_outputs(params):
    outs = ["output"]
    if params.get("state_outputs"):
        outs.append("state")
        if params.get("mode") == "lstm":
            outs.append("state_cell")
    return outs


def _rnn_shape(params, in_shapes):
    if in_shapes[0] is None:
        raise MXNetError("RNN: data shape unknown")
    T, N, I = in_shapes[0]
    H, L = params["state_size"], params["num_layers"]
    D = 2 if params["bidirectional"] else 1
    psize = rnn_param_size(params["mode"], I, H, L, params["bidirectional"])
    sshape = (L * D, N, H)
    ins = [in_shapes[0], (psize,), sshape]
    if params["mode"] == "lstm":
        ins.append(sshape)
    outs = [(T, N, H * D)]
    if params["state_outputs"]:
        outs.append(sshape)
        if params["mode"] == "lstm":
            outs.append(sshape)
    return ins, outs, []


register(
    OpDef(
        "RNN",
        _rnn_fwd,
        params={
            "state_size": Field("int", required=True),
            "num_layers": Field("int", required=True),
            "mode": Field("str", required=True, enum=list(_GATES)),
            "bidirectional": Field("bool", default=False),
            "p": Field("float", default=0.0),
            "state_outputs": Field("bool", default=False),
            "pkeep_": Field("any", default=None),
        },
        arguments=_rnn_args,
        outputs=_rnn_outputs,
        infer_shape=_rnn_shape,
        need_rng=True,
    )
)
