"""The recurrent LM path of the port against the JAX package's, on the CPU.

At a small size (2 layers, hidden 16, embed 8, vocabulary 20, batch 4,
buckets [4, 6]; f32 on both sides, so rtol 1e-4 and atol 1e-5 allow for
summation order only):

- the five ops ``Reshape`` (every code, ``reverse``, the legacy
  ``target_shape``), ``Concat`` (axes 0, 1, -1), ``SliceChannel``
  (``squeeze_axis``), ``SwapAxis`` and ``Dropout`` against the JAX ops,
  forward and the gradient of a random cotangent; ``Dropout``'s output
  bit-equal under the same key;
- ``threefry.split`` and ``bernoulli`` bit-equal to ``jax.random``; the
  key chain of ``random.next_key`` equal to the JAX package's, also
  across ``uniform``/``normal`` draws, a monitored forward and
  imperative random ops;
- ``tojson()`` of ``lstm_unroll``/``gru_unroll``/``rnn_unroll`` byte-equal
  to the JAX package's, and the topological order (the random nodes'
  serials) equal;
- one executor step of each unrolled model (labels with ``ignore_label``
  0 rows) with every gradient, the LSTM's as the first step of the fit
  below; at dropout 0.5 under ``random.seed`` in both packages, equal
  outputs and gradients and bit-equal masks;
- ``FeedForward(symbol=sym_gen)`` over ``BucketSentenceIter`` (the
  examples' own, the JAX one and the port's copy): 20 SGD-momentum steps
  across both buckets from the same numpy weights, on one batch order;
  each step's output and every final parameter within relative L2 1e-4,
  the Perplexity readings within 1e-5 relative; the buckets share
  parameter and gradient storage; ``predict`` and ``score`` afterwards
  behave as the JAX package's;
- ``backward(out_grads=...)`` after a training forward reuses the
  forward's masks in the port, where the JAX package's draws new ones
  under a fresh key (ROADMAP Queue 3).
"""
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu.ops import registry as reg_j
from mxnet_tpu_torch import threefry
from mxnet_tpu_torch.ops import registry as reg_t

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-4, 1e-5
LAYERS, HIDDEN, EMBED, VOCAB, BATCH = 2, 16, 8, 20, 4
BUCKETS = [4, 6]
UNROLLS = {"lstm": "lstm_unroll", "gru": "gru_unroll", "rnn": "rnn_unroll"}


@pytest.fixture(scope="module", autouse=True)
def _warm_cpu_math():
    """torch 2.13's CPU ``exp`` and ``tanh`` can err up to 1.5e-4 relative
    on their first multithreaded call in a process; one call of each on
    a large tensor first avoids it (ROADMAP, facts about the container)."""
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


# -- the five ops ----------------------------------------------------------
def _op_pair(name, params, inputs, is_train=False, key_seed=None, seed=0):
    """(JAX outputs, JAX input gradients, port outputs, port input
    gradients) of one op on numpy ``inputs`` under a random cotangent."""
    oj, ot = reg_j.get(name), reg_t.get(name)
    pj, pt = oj.parse_params(dict(params)), ot.parse_params(dict(params))
    kj = kt = None
    if key_seed is not None:
        kj = jax.random.fold_in(jax.random.PRNGKey(key_seed), 3)
        kt = threefry.fold_in(threefry.prng_key(key_seed, device="cpu"), 3)

    def fj(*xs):
        return oj.apply(pj, list(xs), [], is_train, kj)[0]

    outs_j, vjp = jax.vjp(fj, *[jax.numpy.asarray(x) for x in inputs])
    rng = np.random.RandomState(seed)
    cots = [rng.randn(*o.shape).astype(np.float32) for o in outs_j]
    grads_j = vjp([jax.numpy.asarray(c) for c in cots])
    xs = [torch.tensor(x, requires_grad=True) for x in inputs]
    outs_t, _ = ot.apply(pt, xs, [], is_train, kt)
    grads_t = torch.autograd.grad(outs_t, xs, [torch.tensor(c) for c in cots])
    return ([np.asarray(o) for o in outs_j], [np.asarray(g) for g in grads_j],
            [o.detach().numpy() for o in outs_t], [g.numpy() for g in grads_t])


def _check_pair(res, exact=False):
    outs_j, grads_j, outs_t, grads_t = res
    assert len(outs_j) == len(outs_t)
    for a, b in zip(outs_t + grads_t, outs_j + grads_j):
        assert a.shape == b.shape
        if exact:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def _x(*shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


RESHAPES = [
    ({"shape": (0, -1)}, (2, 3, 4)),
    ({"shape": (-1, 4)}, (2, 3, 4)),
    ({"shape": (0, 1, -1)}, (4, 16)),
    ({"shape": (2, 0, -1)}, (3, 6, 4)),
    ({"shape": (-1,)}, (2, 3, 4)),
    ({"shape": (2, -1), "reverse": True}, (3, 4, 2)),
    ({"shape": (0, -1), "reverse": True}, (2, 3, 4)),
    ({"target_shape": (0, 12)}, (2, 3, 4)),
    ({"target_shape": (6, 4)}, (2, 3, 4)),
    ({"shape": (0, -1), "keep_highest": True}, (2, 3, 4)),
]


@pytest.mark.parametrize("params,shape", RESHAPES,
                         ids=[str(i) for i in range(len(RESHAPES))])
def test_reshape_matches_jax(params, shape):
    _check_pair(_op_pair("Reshape", params, [_x(*shape)]))
    oj, ot = reg_j.get("Reshape"), reg_t.get("Reshape")
    assert ot.infer_shape(ot.parse_params(dict(params)), [shape]) == \
        oj.infer_shape(oj.parse_params(dict(params)), [shape])


@pytest.mark.parametrize("dim", [0, 1, -1])
def test_concat_matches_jax(dim):
    xs = [_x(2, 3, 4, seed=s) for s in range(3)]
    _check_pair(_op_pair("Concat", {"num_args": 3, "dim": dim}, xs))


@pytest.mark.parametrize("axis,squeeze", [(1, False), (1, True), (0, True),
                                          (2, False)])
def test_slice_channel_matches_jax(axis, squeeze):
    shape = [4, 6, 2]
    n = shape[axis] if squeeze else 2
    res = _op_pair("SliceChannel", {"num_outputs": n, "axis": axis,
                                    "squeeze_axis": squeeze}, [_x(*shape)])
    _check_pair(res)
    assert len(res[2]) == n


@pytest.mark.parametrize("dims", [(0, 1), (1, 2), (0, 2)])
def test_swapaxis_matches_jax(dims):
    _check_pair(_op_pair("SwapAxis", {"dim1": dims[0], "dim2": dims[1]},
                         [_x(2, 3, 4)]))


@pytest.mark.parametrize("p", [0.5, 0.3, 0.9])
def test_dropout_bits_match_jax(p):
    """Training: the same mask and the same x / keep, bit for bit."""
    res = _op_pair("Dropout", {"p": p}, [_x(16, 33)], is_train=True,
                   key_seed=11)
    _check_pair(res, exact=True)
    kept = (res[2][0] != 0).mean()
    assert abs(kept - (1 - p)) < 4 * np.sqrt(p * (1 - p) / (16 * 33))


@pytest.mark.parametrize("is_train,p", [(False, 0.5), (True, 0.0)])
def test_dropout_is_identity_off_training(is_train, p):
    res = _op_pair("Dropout", {"p": p}, [_x(4, 5)], is_train=is_train,
                   key_seed=1)
    _check_pair(res, exact=True)
    np.testing.assert_array_equal(res[2][0], _x(4, 5))


# -- threefry and the key chain -------------------------------------------
@pytest.mark.parametrize("seed,num", [(0, 2), (7, 3), (2 ** 31 + 5, 8)])
def test_split_bit_equal_to_jax(seed, num):
    want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), num))
    got = threefry.split(threefry.prng_key(seed, device="cpu"), num)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("p,shape", [(0.5, (3, 4, 5)), (0.7, (1000,)),
                                     (0.1, (2, 33)), (0.999, (7, 1, 9))])
def test_bernoulli_bit_equal_to_jax(p, shape):
    kj = jax.random.fold_in(jax.random.PRNGKey(4), 9)
    kt = threefry.fold_in(threefry.prng_key(4, device="cpu"), 9)
    want = np.asarray(jax.random.bernoulli(kj, p, shape))
    got = threefry.bernoulli(kt, p, shape)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


def _key(k):
    return np.asarray(jax.random.key_data(k) if jax.dtypes.issubdtype(
        k.dtype, jax.dtypes.prng_key) else k).astype(np.int64)


def test_next_key_chain_equals_jax():
    mj.random.seed(123)
    mt.random.seed(123)
    for _ in range(3):
        np.testing.assert_array_equal(mt.random.next_key().numpy(),
                                      _key(mj.random.next_key()))


def test_draws_and_imperative_random_ops_keep_the_chain_in_step():
    """uniform/normal values differ (torch generators), but each call
    takes one key, as the JAX package's; so does an imperative Dropout
    (an inference call, the identity)."""
    mj.random.seed(5)
    mt.random.seed(5)
    mj.random.uniform(0, 1, shape=(3,), ctx=mj.cpu())
    mt.random.uniform(0, 1, shape=(3,), ctx=mt.cpu())
    mj.random.normal(0, 1, shape=(2,), ctx=mj.cpu())
    mt.random.normal(0, 1, shape=(2,), ctx=mt.cpu())
    x = np.arange(6, dtype=np.float32)
    np.testing.assert_array_equal(
        mt.nd.Dropout(mt.nd.array(x, ctx=mt.cpu()), p=0.5).asnumpy(), x)
    mj.nd.Dropout(mj.nd.array(x, ctx=mj.cpu()), p=0.5)
    np.testing.assert_array_equal(mt.random.next_key().numpy(),
                                  _key(mj.random.next_key()))


# -- the unrolled models ---------------------------------------------------
def _unroll(pkg, kind, seq_len, **kw):
    with pkg.NameManager():
        return getattr(pkg.models, UNROLLS[kind])(
            LAYERS, seq_len, VOCAB, HIDDEN, EMBED, VOCAB, **kw)


GRAPHS = [("lstm", {}), ("lstm", {"dropout": 0.5, "ignore_label": 0}),
          ("lstm", {"group2ctx_layers": True}), ("gru", {"ignore_label": 0}),
          ("gru", {"dropout": 0.25}), ("rnn", {"act_type": "relu"}),
          ("rnn", {"batch_norm": True, "dropout": 0.5, "ignore_label": 0})]


@pytest.mark.parametrize("kind,kw", GRAPHS,
                         ids=["%s-%d" % (k, i) for i, (k, _) in
                              enumerate(GRAPHS)])
def test_unrolled_tojson_bytes_and_order_equal(kind, kw):
    sj, st = _unroll(mj, kind, 6, **kw), _unroll(mt, kind, 6, **kw)
    assert st.tojson() == sj.tojson()
    assert [n.name for n in st.nodes] == [n.name for n in sj.nodes]


def test_lstm_group2ctx_map_equal():
    got = mt.models.lstm.lstm_group2ctx(2, [mt.cpu(0), mt.cpu(1), mt.cpu(2)])
    want = mj.models.lstm.lstm_group2ctx(2, [mj.cpu(0), mj.cpu(1), mj.cpu(2)])
    assert {k: str(v) for k, v in got.items()} == \
        {k: str(v) for k, v in want.items()}


def _state_names(kind):
    names = ["l%d_init_h" % i for i in range(LAYERS)]
    if kind == "lstm":
        names += ["l%d_init_c" % i for i in range(LAYERS)]
    return names


def _shapes(kind, seq_len):
    shapes = {"data": (BATCH, seq_len), "softmax_label": (BATCH, seq_len)}
    shapes.update({n: (BATCH, HIDDEN) for n in _state_names(kind)})
    return shapes


def _lm_args(sym, shapes, seed):
    """Tokens 1..19 with the sentence tails padded by 0 (so label-0 rows
    are present), states and weights N(0, 0.3^2)."""
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    args = {}
    seq_len = shapes["data"][1]
    lengths = rng.randint(2, seq_len + 1, BATCH)
    tokens = rng.randint(1, VOCAB, (BATCH, seq_len + 1)).astype(np.float32)
    for n, ln in enumerate(lengths):
        tokens[n, ln:] = 0
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name == "data":
            args[name] = tokens[:, :-1].copy()
        elif name == "softmax_label":
            args[name] = tokens[:, 1:].copy()
        else:
            args[name] = (rng.randn(*shape) * 0.3).astype(np.float32)
    aux = {name: (rng.rand(*shape) + 0.5 if name.endswith("var")
                  else rng.randn(*shape) * 0.1).astype(np.float32)
           for name, shape in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _bind(pkg, sym, shapes, args, aux):
    req = {n: ("null" if n in ("data", "softmax_label") else "write")
           for n in sym.list_arguments()}
    exe = sym.simple_bind(pkg.cpu(), grad_req=req, **shapes)
    for name, value in args.items():
        exe.arg_dict[name][:] = value
    for name, value in aux.items():
        exe.aux_dict[name][:] = value
    return exe


def _step(pkg, sym, shapes, args, aux, seed=None):
    exe = _bind(pkg, sym, shapes, args, aux)
    if seed is not None:
        pkg.random.seed(seed)
    exe.forward(is_train=True)
    exe.backward()
    return ([o.asnumpy() for o in exe.outputs],
            {n: g.asnumpy() for n, g in exe.grad_dict.items()
             if g is not None})


# the LSTM without dropout is held by the first step of the fit below
STEPS = [("gru", {"ignore_label": 0}), ("rnn", {"ignore_label": 0}),
         ("lstm", {"dropout": 0.5, "ignore_label": 0})]


@pytest.fixture(scope="module")
def steps():
    """One training step of each STEPS model in both packages (dropout
    steps under ``random.seed(7)``)."""
    out = {}
    for i, (kind, kw) in enumerate(STEPS):
        shapes = _shapes(kind, 4)
        sj, st = _unroll(mj, kind, 4, **kw), _unroll(mt, kind, 4, **kw)
        args, aux = _lm_args(st, shapes, seed=i)
        seed = 7 if kw.get("dropout") else None
        out[i] = (_step(mj, sj, shapes, args, aux, seed),
                  _step(mt, st, shapes, args, aux, seed), args)
    return out


@pytest.mark.parametrize("i", range(len(STEPS)),
                         ids=["%s-%d" % (k, i) for i, (k, _) in
                              enumerate(STEPS)])
def test_executor_step_matches_jax(steps, i):
    (outs_j, grads_j), (outs_t, grads_t), args = steps[i]
    assert (args["softmax_label"] == 0).any()
    for got, want in zip(outs_t, outs_j):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert sorted(grads_t) == sorted(grads_j)
    for name, want in grads_j.items():
        np.testing.assert_allclose(grads_t[name], want, rtol=RTOL,
                                   atol=ATOL, err_msg=name)
        assert np.abs(want).max() > 0, name


def test_rnn_batch_norm_step_matches_jax():
    """The Elman model with a BatchNorm a step: per-timestep statistics
    over 4 rows amplify f32 rounding, so this case is judged by relative
    L2 per tensor (1e-4) against the JAX package and against the port in
    float64: elementwise, the JAX package's own f32 gradients of the
    first layer's weights lie further from the float64 ones than rtol
    1e-4, atol 1e-5 allow (2.8e-4 at 6 steps), the port's nearer."""
    kind, kw = "rnn", {"batch_norm": True}
    shapes = _shapes(kind, 4)
    st = _unroll(mt, kind, 4, **kw)
    args, aux = _lm_args(st, shapes, seed=3)
    outs_j, grads_j = _step(mj, _unroll(mj, kind, 4, **kw), shapes, args,
                            aux)
    outs_t, grads_t = _step(mt, st, shapes, args, aux)
    req = {n: ("null" if n in ("data", "softmax_label") else "write")
           for n in st.list_arguments()}
    exe = st.simple_bind(mt.cpu(), grad_req=req, type_dict={
        n: "float64" for n in st.list_arguments()}, **shapes)
    for name, value in list(args.items()) + list(aux.items()):
        arr = exe.arg_dict[name] if name in args else exe.aux_dict[name]
        arr[:] = value.astype(np.float64)
    exe.forward(is_train=True)
    exe.backward()
    np.testing.assert_allclose(outs_t[0], outs_j[0], rtol=RTOL, atol=ATOL)
    for name, want in grads_j.items():
        if not np.abs(want).max():
            np.testing.assert_array_equal(grads_t[name], want)
            continue
        assert _rel_l2(grads_t[name], want) <= 1e-4, name
        assert _rel_l2(grads_t[name],
                       exe.grad_dict[name].asnumpy()) <= 1e-4, name


def _dropout_heads(pkg, sym):
    """The loss and every Dropout node's output, as one Group: the first
    head is the whole graph, so the nodes keep their serials."""
    internals = sym.get_internals()
    names = [n for n in internals.list_outputs()
             if n.startswith("dropout")]
    return pkg.sym.Group([sym] + [internals[n] for n in names]), names


def test_dropout_masks_and_serials_equal_jax():
    kind, kw = "lstm", {"dropout": 0.5, "ignore_label": 0}
    shapes = _shapes(kind, 4)
    gj, names = _dropout_heads(mj, _unroll(mj, kind, 4, **kw))
    gt, names_t = _dropout_heads(mt, _unroll(mt, kind, 4, **kw))
    assert names == names_t and len(names) == 5   # 4 steps' layer 1, 1 head
    args, aux = _lm_args(gt, shapes, seed=3)
    ej, et = (_bind(pkg, g, shapes, args, aux)
              for pkg, g in ((mj, gj), (mt, gt)))
    assert [n.name for n in et._nodes] == [n.name for n in ej._nodes]
    serials_j = [s for s, n in enumerate(ej._nodes)
                 if not n.is_variable and n.op.need_rng]
    assert et._rng_serials == serials_j
    for seed in (7, 8):
        mj.random.seed(seed)
        mt.random.seed(seed)
        ej.forward(is_train=True)
        et.forward(is_train=True)
        for name, oj, ot in zip(["loss"] + names, ej.outputs, et.outputs):
            a, b = ot.asnumpy(), oj.asnumpy()
            if name != "loss":
                np.testing.assert_array_equal(a != 0, b != 0, err_msg=name)
                kept = (a != 0).mean()
                assert abs(kept - 0.5) < 4 * np.sqrt(0.25 / a.size), name
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                       err_msg=name)


def test_monitor_forward_keeps_the_chain_in_step():
    """A tapped training forward takes two keys in both packages (the
    JAX package's monitor replay's, then the forward's)."""
    x = np.random.RandomState(1).rand(4, 6).astype(np.float32)
    taps = [[], []]
    for pkg, seen in zip((mj, mt), taps):
        with pkg.NameManager():
            sym = pkg.sym.Dropout(pkg.sym.FullyConnected(
                pkg.sym.Variable("data"), num_hidden=5, name="fc"), p=0.5)
        exe = sym.simple_bind(pkg.cpu(), grad_req="write", data=x.shape)
        exe.arg_dict["data"][:] = x
        exe.set_monitor_callback(lambda name, arr, s=seen: s.append(name))
        pkg.random.seed(1)
        exe.forward(is_train=True)
    assert taps[0] == taps[1] == ["fc_output", "dropout0_output"]
    np.testing.assert_array_equal(mt.random.next_key().numpy(),
                                  _key(mj.random.next_key()))


def test_backward_with_out_grads_reuses_the_forward_masks():
    """ROADMAP Queue 3: the port's backward(out_grads) differentiates the
    forward it ran (gradient = mask / keep); the JAX package's re-runs the
    forward under a fresh key, so its gradient's mask is another, and the
    two key chains part after the call."""
    x = np.random.RandomState(0).rand(64, 32).astype(np.float32) + 0.5
    masks = {}
    for pkg in (mj, mt):
        sym = pkg.sym.Dropout(pkg.sym.Variable("x"), p=0.5)
        exe = sym.simple_bind(pkg.cpu(), grad_req="write", x=x.shape)
        exe.arg_dict["x"][:] = x
        pkg.random.seed(3)
        out = exe.forward(is_train=True)[0].asnumpy()
        exe.backward(out_grads=pkg.nd.ones(x.shape, ctx=pkg.cpu()))
        grad = exe.grad_dict["x"].asnumpy()
        masks[pkg.__name__] = (out != 0, grad != 0)
    fwd_t, bwd_t = masks["mxnet_tpu_torch"]
    fwd_j, bwd_j = masks["mxnet_tpu"]
    np.testing.assert_array_equal(fwd_t, fwd_j)     # the same forward key
    np.testing.assert_array_equal(bwd_t, fwd_t)     # the port: one mask
    assert (bwd_j != fwd_j).mean() > 0.3            # JAX: a second mask
    assert not np.array_equal(mt.random.next_key().numpy(),
                              _key(mj.random.next_key()))


# -- FeedForward over a sym_gen -------------------------------------------
def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sentences():
    """40 sentences for each bucket: 10 batches of each, 20 a pass."""
    rng = np.random.RandomState(9)
    out = [list(rng.randint(1, VOCAB, rng.randint(2, 5))) for _ in range(40)]
    out += [list(rng.randint(1, VOCAB, rng.randint(5, 7))) for _ in range(40)]
    out[0][0] = VOCAB - 1
    return out


def _iter(bio):
    init = [("l%d_init_c" % i, (BATCH, HIDDEN)) for i in range(LAYERS)] + \
        [("l%d_init_h" % i, (BATCH, HIDDEN)) for i in range(LAYERS)]
    return bio.BucketSentenceIter(None, None, BUCKETS, BATCH, init,
                                  sentences=_sentences())


def _fit(pkg, bio, params):
    np.random.seed(0)   # the iterator's shuffles: one batch order
    data = _iter(bio)
    assert data.vocab_size == VOCAB and len(data.batches) == 20

    def sym_gen(seq_len):
        return pkg.models.lstm_unroll(LAYERS, seq_len, VOCAB, HIDDEN, EMBED,
                                      VOCAB, ignore_label=0)

    record = {"outs": [], "ppl": [], "keys": []}

    def on_batch(param):
        exe = param.locals["executor_manager"].curr_execgrp.train_execs[0]
        if not record["outs"]:
            record["label"] = param.locals["data_batch"].label[0].asnumpy()
            record["grads"] = {n: g.asnumpy() for n, g in
                               exe.grad_dict.items() if g is not None}
        record["outs"].append(exe.outputs[0].asnumpy())
        record["ppl"].append(param.eval_metric.get()[1])
        record["keys"].append(param.locals["data_batch"].bucket_key)

    model = pkg.FeedForward(sym_gen, ctx=pkg.cpu(), num_epoch=1,
                            learning_rate=0.1, momentum=0.9, wd=1e-5,
                            arg_params=params)
    model.fit(X=data, eval_metric=pkg.metric.Perplexity(ignore_label=0),
              batch_end_callback=on_batch)
    return model, record


@pytest.fixture(scope="module")
def fits():
    sym = mt.models.lstm_unroll(LAYERS, 6, VOCAB, HIDDEN, EMBED, VOCAB)
    arg_shapes, _, _ = sym.infer_shape(**_shapes("lstm", 6))
    rng = np.random.RandomState(4)
    params = {n: (rng.uniform(-1, 1, s) * 0.3).astype(np.float32)
              for n, s in zip(sym.list_arguments(), arg_shapes)
              if n not in _shapes("lstm", 6)}
    bio_j = _load(ROOT / "examples" / "rnn" / "bucket_io.py", "_bio_jax")
    bio_t = _load(ROOT / "examples" / "rnn_torch" / "bucket_io.py",
                  "_bio_torch")
    jax_model, jax_rec = _fit(
        mj, bio_j, {k: mj.nd.array(v, ctx=mj.cpu()) for k, v in
                    params.items()})
    with mt.cpu():
        args, _ = mt.model.params_from_numpy(params, ctx=mt.cpu())
        torch_model, torch_rec = _fit(mt, bio_t, args)
    return jax_model, jax_rec, torch_model, torch_rec, bio_j, bio_t


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_sym_gen_fit_steps_match_jax(fits):
    _, jax_rec, _, torch_rec, _, _ = fits
    assert torch_rec["keys"] == jax_rec["keys"]
    assert sorted(set(torch_rec["keys"])) == BUCKETS
    assert len(torch_rec["outs"]) == 20
    for step, (got, want) in enumerate(zip(torch_rec["outs"],
                                           jax_rec["outs"])):
        assert got.shape == want.shape
        assert _rel_l2(got, want) <= 1e-4, step
    np.testing.assert_allclose(torch_rec["ppl"], jax_rec["ppl"], rtol=1e-5)


def test_sym_gen_fit_first_step_gradients_match_jax(fits):
    """The executor step of the LSTM without dropout: every gradient of
    the fit's first batch, labels with ``ignore_label`` rows among them,
    elementwise as in ``test_executor_step_matches_jax``."""
    _, jax_rec, _, torch_rec, _, _ = fits
    assert (torch_rec["label"] == 0).any()
    np.testing.assert_array_equal(torch_rec["label"], jax_rec["label"])
    grads_t, grads_j = torch_rec["grads"], jax_rec["grads"]
    assert sorted(grads_t) == sorted(grads_j)
    for name, want in grads_j.items():
        np.testing.assert_allclose(grads_t[name], want, rtol=RTOL,
                                   atol=ATOL, err_msg=name)
        assert np.abs(want).max() > 0, name


def test_sym_gen_fit_final_parameters_match_jax(fits):
    jax_model, _, torch_model, _, _, _ = fits
    assert sorted(torch_model.arg_params) == sorted(jax_model.arg_params)
    assert torch_model.symbol.list_arguments() == \
        jax_model.symbol.list_arguments()
    for name, want in jax_model.arg_params.items():
        got = torch_model.arg_params[name].asnumpy()
        assert _rel_l2(got, want.asnumpy()) <= 1e-4, name


def test_sym_gen_predict_and_score_as_jax(fits):
    """predict and score run the default bucket's symbol, bound at the
    iterator's data shapes, as the JAX package's do: over a
    BucketSentenceIter (no label shape among the data) both packages
    raise the same error from the label's Reshape; over an iterator that
    gives the label among its data, both predict the same."""
    jax_model, _, torch_model, _, bio_j, bio_t = fits
    init = [("l%d_init_c" % i, (BATCH, HIDDEN)) for i in range(LAYERS)] + \
        [("l%d_init_h" % i, (BATCH, HIDDEN)) for i in range(LAYERS)]
    sents = _sentences()[40:]
    rng = np.random.RandomState(2)
    arrays = {"data": rng.randint(1, VOCAB, (8, 6)).astype(np.float32),
              "softmax_label": rng.randint(0, VOCAB, (8, 6)).astype(
                  np.float32)}
    arrays.update({n: np.zeros((8, HIDDEN), np.float32) for n, _ in init})
    errors, preds = [], []
    for pkg, bio, model in ((mj, bio_j, jax_model), (mt, bio_t, torch_model)):
        with pkg.cpu():
            it = bio.BucketSentenceIter(None, None, [6], BATCH, init,
                                        sentences=sents)
            with pytest.raises(Exception) as err:
                model.score(it, pkg.metric.Perplexity(ignore_label=0))
            errors.append(err.type)
            it = pkg.io.NDArrayIter(dict(arrays), None, batch_size=BATCH)
            preds.append(model.predict(it))
    assert errors[0] is errors[1]
    assert preds[1].shape == preds[0].shape == (8, VOCAB)
    np.testing.assert_allclose(preds[1], preds[0], rtol=RTOL, atol=ATOL)


def test_buckets_share_parameter_and_gradient_storage():
    def sym_gen(seq_len):
        return mt.models.lstm_unroll(LAYERS, seq_len, VOCAB, HIDDEN, EMBED,
                                     VOCAB, ignore_label=0)

    with mt.cpu():
        bio = _load(ROOT / "examples" / "rnn_torch" / "bucket_io.py",
                    "_bio_torch_share")
        data = _iter(bio)
        names = sym_gen(6).list_arguments()
        params = [n for n in names if n not in _shapes("lstm", 6)]
        em = mt.executor_manager.DataParallelExecutorManager(
            sym_gen(6), [mt.cpu()], data, params, names,
            [], sym_gen=sym_gen)
        for batch in data:
            em.load_data_batch(batch)
        assert sorted(em.execgrp_bucket) == BUCKETS
        e6, e4 = (em.execgrp_bucket[k].train_execs[0] for k in (6, 4))
        for n in params:
            assert e4.arg_dict[n] is e6.arg_dict[n], n
            assert e4.grad_dict[n] is e6.grad_dict[n], n
            assert e4.arg_dict[n]._data.data_ptr() == \
                e6.arg_dict[n]._data.data_ptr()
        assert e4.arg_dict["data"].shape == (BATCH, 4)
        with pytest.raises(ValueError):
            em.install_monitor(mt.Monitor(1))
