"""The port's sequence ops and fused RNN op against the JAX package's ops,
on the CPU.

- ``SequenceLast``, ``SequenceMask`` (with a fill value) and
  ``SequenceReverse``, with and without ``sequence_length``: forward and
  the gradient of a random cotangent, rtol 1e-4, atol 1e-5 (f32);
- ``RNN`` in its four modes (``lstm``, ``gru``, ``rnn_tanh``,
  ``rnn_relu``), one and two directions, two layers, with and without
  ``state_outputs``: every output and the gradients of the data, the
  flat parameters and the initial states, with the same limits;
- the inter-layer dropout of a training forward (``p`` 0.5, three
  layers) under the same key: the same masks bit for bit, so the same
  outputs and gradients; inference and ``p`` 0 draw none;
- the shape inference and ``rnn_param_size`` equal to the JAX op's.
"""
import jax
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import registry as reg_j
from mxnet_tpu.ops import sequence as seq_j
from mxnet_tpu_torch import threefry
from mxnet_tpu_torch.ops import registry as reg_t
from mxnet_tpu_torch.ops import sequence as seq_t

RTOL, ATOL = 1e-4, 1e-5
T, N, I, H = 5, 3, 4, 6


@pytest.fixture(scope="module", autouse=True)
def _warm_cpu_math():
    """torch 2.13's CPU ``exp`` and ``tanh`` can err up to 1.5e-4 relative
    on their first multithreaded call in a process; one call of each on
    a large tensor first avoids it."""
    t = torch.randn(100000)
    torch.exp(t)
    torch.tanh(t)
    torch.sigmoid(t)


@pytest.fixture(scope="module", autouse=True)
def _quick_jax_compiles():
    """The JAX references are small programs that each run once or a few
    times, so XLA's optimisation passes cost more than they save: compile
    them without, and drop what was compiled so when the module ends."""
    prev = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", prev)
    jax.clear_caches()


def _pair(name, params, inputs, is_train=False, key_seed=None, float_ins=None):
    """JAX and port outputs and input gradients of one op; the inputs at
    ``float_ins`` are differentiated (default: all)."""
    oj, ot = reg_j.get(name), reg_t.get(name)
    pj, pt = oj.parse_params(dict(params)), ot.parse_params(dict(params))
    kj = kt = None
    if key_seed is not None:
        kj = jax.random.fold_in(jax.random.PRNGKey(key_seed), 2)
        kt = threefry.fold_in(threefry.prng_key(key_seed, device="cpu"), 2)
    diff = list(range(len(inputs))) if float_ins is None else float_ins

    def fj(*xs):
        full = list(inputs)
        for k, x in zip(diff, xs):
            full[k] = x
        return oj.apply(pj, [jax.numpy.asarray(v) for v in full], [],
                        is_train, kj)[0]

    outs_j, vjp = jax.vjp(jax.jit(fj),
                          *[jax.numpy.asarray(inputs[k]) for k in diff])
    cots = _cotangents([o.shape for o in outs_j])
    grads_j = vjp([jax.numpy.asarray(c) for c in cots])
    outs_t, grads_t = _port(ot, pt, inputs, is_train, kt, diff, cots)
    return ([np.asarray(o) for o in outs_j], [np.asarray(g) for g in grads_j],
            outs_t, grads_t)


def _cotangents(shapes):
    rng = np.random.RandomState(len(shapes))
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def _port(op, params, inputs, is_train, key, diff, cots=None):
    """The port's outputs and input gradients (``cots``: default, the
    cotangents ``_pair`` draws for these output shapes)."""
    xs = [torch.tensor(x, requires_grad=k in diff)
          for k, x in enumerate(inputs)]
    outs, _ = op.apply(params, xs, [], is_train, key)
    if cots is None:
        cots = _cotangents([tuple(o.shape) for o in outs])
    grads = torch.autograd.grad(outs, [xs[k] for k in diff],
                                [torch.tensor(c) for c in cots])
    return [o.detach().numpy() for o in outs], [g.numpy() for g in grads]


def _close(res):
    outs_j, grads_j, outs_t, grads_t = res
    assert len(outs_t) == len(outs_j) and len(grads_t) == len(grads_j)
    for a, b in zip(outs_t + grads_t, outs_j + grads_j):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def _x(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


LENGTHS = np.array([2.0, 5.0, 3.7], np.float32)   # 3.7 truncates to 3


@pytest.mark.parametrize("name", ["SequenceLast", "SequenceMask",
                                  "SequenceReverse"])
@pytest.mark.parametrize("use_len", [False, True])
def test_sequence_ops_match_jax(name, use_len):
    params = {"use_sequence_length": use_len}
    if name == "SequenceMask":
        params["value"] = -2.5
    inputs = [_x(T, N, 2)] + ([LENGTHS] if use_len else [])
    _close(_pair(name, params, inputs, float_ins=[0]))
    oj, ot = reg_j.get(name), reg_t.get(name)
    shapes = [(T, N, 2)] + ([(N,)] if use_len else [])
    assert ot.infer_shape(ot.parse_params(dict(params)), shapes) == \
        oj.infer_shape(oj.parse_params(dict(params)), shapes)


def _rnn_inputs(mode, layers, bidir, seed=0):
    D = 2 if bidir else 1
    size = seq_t.rnn_param_size(mode, I, H, layers, bidir)
    assert size == seq_j.rnn_param_size(mode, I, H, layers, bidir)
    ins = [_x(T, N, I, seed=seed), _x(size, seed=seed + 1, scale=0.4),
           _x(layers * D, N, H, seed=seed + 2, scale=0.5)]
    if mode == "lstm":
        ins.append(_x(layers * D, N, H, seed=seed + 3, scale=0.5))
    return ins


@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
@pytest.mark.parametrize("bidir", [False, True])
def test_rnn_matches_jax(mode, bidir):
    params = {"mode": mode, "state_size": H, "num_layers": 2,
              "bidirectional": bidir, "state_outputs": True}
    res = _pair("RNN", params, _rnn_inputs(mode, 2, bidir))
    _close(res)
    assert len(res[2]) == (3 if mode == "lstm" else 2)
    oj, ot = reg_j.get("RNN"), reg_t.get("RNN")
    shapes = [(T, N, I)]
    assert ot.infer_shape(ot.parse_params(dict(params)), shapes) == \
        oj.infer_shape(oj.parse_params(dict(params)), shapes)


def test_rnn_without_state_outputs_matches_jax():
    res = _pair("RNN", {"mode": "lstm", "state_size": H, "num_layers": 1},
                _rnn_inputs("lstm", 1, False))
    _close(res)
    assert len(res[2]) == 1


@pytest.mark.parametrize("mode,bidir", [("lstm", False), ("gru", True)])
def test_rnn_dropout_masks_match_jax(mode, bidir):
    """Training at p 0.5 over three layers: the two inter-layer masks are
    JAX's bits, so outputs and gradients agree as without dropout; the
    same call without training, or at p 0, gives the undropped result."""
    params = {"mode": mode, "state_size": H, "num_layers": 3,
              "bidirectional": bidir, "p": 0.5, "state_outputs": True}
    ins = _rnn_inputs(mode, 3, bidir, seed=4)
    train = _pair("RNN", params, ins, is_train=True, key_seed=9)
    _close(train)
    op = reg_t.get("RNN")
    key = threefry.fold_in(threefry.prng_key(9, device="cpu"), 2)
    every = list(range(len(ins)))
    plain = _port(op, op.parse_params(dict(params, p=0.0)), ins, True, key,
                  every)
    infer = _port(op, op.parse_params(dict(params)), ins, False, key, every)
    for a, b in zip(infer[0] + infer[1], plain[0] + plain[1]):
        np.testing.assert_array_equal(a, b)
    assert not np.allclose(train[2][0], plain[0][0])

