"""Multi-device training in the port against the JAX package, on the CPU.

The JAX package runs on its 8 virtual CPU devices (``tests/conftest.py``),
the port on host contexts ``cpu(i)``, which are all the one CPU device:
these tests hold the arithmetic (the split, the reduce in the kvstore,
the update, the averaging) and the bookkeeping (each array's context),
not real copies between devices, which only the card runs
(tests/test_torch_kvstore_cuda.py, ``chip_smoke.py``).

- ``FeedForward.fit`` of the MLP of tests/unittest/test_multi_device.py
  over 2 and 4 contexts with ``kvstore="local"`` (the devices update) and
  ``"device"`` (the store updates), and over 2 with ``work_load_list``
  [1, 3] (slices of 8 and 24), from the same numpy parameters:
  every step's output (the contexts' slices concatenated) and the final
  parameters within relative L2 1e-4 of the JAX fit's;
- the port's 2-context fit against its 1-context fit on the same total
  batch (test_multi_device.py's ``multi_vs_single``): relative L2 1e-4
  (measured: ~1e-7, f32 summation order);
- after a 2-context fit through the store, each executor still holds the
  tensors it was bound with, and they hold the store's weights: a pull
  that rebound a tensor would leave an executor on stale weights;
- ``Module`` over 2 contexts (``local`` and ``device``, input gradients
  asked for) against the JAX ``Module``: each step's merged outputs and
  input gradients, the final parameters;
- the ``group2ctx`` executor of test_multi_device.py and the
  model-parallel LSTM against the JAX executors: outputs and gradients
  rtol 1e-4, atol 1e-5; each argument's context its group's;
  ``grad_req="add"`` accumulating; the same MLP with a Dropout, and the
  LSTM, with the executor's group-boundary copy branch forced on (the
  CPU's contexts never turn it on by themselves);
- examples/model-parallel-lstm_torch/lstm_ptb.py at a tiny size against
  examples/model-parallel-lstm/lstm_ptb.py from the same numpy weights
  on a small corpus: each epoch's perplexity rtol 1e-4.
"""
import importlib.util
import logging
import os
import sys
import zlib

import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as mj
import mxnet_tpu_torch as mt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL_L2 = 1e-4


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
    """The JAX references run once: compile them without XLA's
    optimisation passes, and drop what was compiled when the module
    ends."""
    prev = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", prev)
    jax.clear_caches()


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _mlp(pkg):
    s = pkg.sym
    with pkg.NameManager():
        fc1 = s.FullyConnected(data=s.Variable("data"), num_hidden=16,
                               name="fc1")
        act = s.Activation(data=fc1, act_type="relu")
        fc2 = s.FullyConnected(data=act, num_hidden=2, name="fc2")
        return s.SoftmaxOutput(data=fc2, name="softmax")


def _data(n=128, d=10, seed=1):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, d).astype(np.float32)
    return x, (x[:, 0] + 2 * x[:, 1] > 1.2).astype(np.float32)


def _params(d=10, seed=6):
    rng = np.random.RandomState(seed)
    return {"fc1_weight": rng.uniform(-0.3, 0.3, (16, d)).astype("f"),
            "fc1_bias": rng.uniform(-0.1, 0.1, (16,)).astype("f"),
            "fc2_weight": rng.uniform(-0.3, 0.3, (2, 16)).astype("f"),
            "fc2_bias": rng.uniform(-0.1, 0.1, (2,)).astype("f")}


def _fit(pkg, n_ctx, kvstore, batch=32, epochs=2, record=None,
         work_load_list=None):
    x, y = _data()
    params = {k: pkg.nd.array(v, ctx=pkg.cpu()) for k, v in
              _params().items()}
    it = pkg.io.NDArrayIter(x, y, batch_size=batch, shuffle=False)
    outs = []

    def on_batch(param):
        em = param.locals.get("executor_manager")
        if em is None:   # the port's scanned fit on one context
            return
        execs = em.curr_execgrp.train_execs
        outs.append(np.concatenate([e.outputs[0].asnumpy() for e in execs]))
        if record is not None:
            record(em)

    model = pkg.FeedForward(_mlp(pkg), ctx=[pkg.cpu(i) for i in
                                            range(n_ctx)],
                            num_epoch=epochs, learning_rate=0.1,
                            momentum=0.9, arg_params=params)
    model.fit(X=it, kvstore=kvstore, batch_end_callback=on_batch,
              work_load_list=work_load_list)
    return outs, {k: v.asnumpy() for k, v in model.arg_params.items()}


@pytest.mark.parametrize("n_ctx,kvstore,work_load_list", [
    (2, "local", None), (2, "device", None), (4, "local", None),
    (4, "device", None), (2, "device", [1, 3])])
def test_fit_over_contexts_matches_jax(n_ctx, kvstore, work_load_list):
    want_outs, want = _fit(mj, n_ctx, kvstore,
                           work_load_list=work_load_list)
    got_outs, got = _fit(mt, n_ctx, kvstore, work_load_list=work_load_list)
    assert len(got_outs) == len(want_outs) == 8
    for step, (a, b) in enumerate(zip(got_outs, want_outs)):
        assert _rel(a, b) <= REL_L2, step
    for k in want:
        assert _rel(got[k], want[k]) <= REL_L2, k


def test_two_contexts_match_one_on_the_same_batch():
    """test_multi_device.py's ``multi_vs_single`` in the port: summed
    gradients over two halves = one device's gradient of the whole
    batch, so the fits agree to f32 summation order."""
    p1 = _fit(mt, 1, "local")[1]
    p2 = _fit(mt, 2, "local")[1]
    rel = max(_rel(p2[k], p1[k]) for k in p1)
    assert rel <= REL_L2, rel


def test_pulls_write_the_bound_tensors():
    seen = []

    def record(em):
        seen.append([[(id(a._data), a._data.data_ptr()) for a in block]
                     for block in em.param_arrays])
        seen[-1].append([[a.asnumpy() for a in block]
                         for block in em.param_arrays])

    _, final = _fit(mt, 2, "device", record=record)
    first, last = seen[0], seen[-1]
    assert first[:-1] == last[:-1]      # the same tensors, every step
    for block in last[-1]:
        assert np.array_equal(block[0], block[1])
    assert any(not np.array_equal(a[0], b[0])
               for a, b in zip(first[-1], last[-1]))


def _module_run(pkg, kvstore, steps=6, batch=16):
    x, y = _data(n=batch * steps, seed=3)
    params = {k: pkg.nd.array(v, ctx=pkg.cpu()) for k, v in
              _params().items()}
    mod = pkg.module.Module(_mlp(pkg), context=[pkg.cpu(0), pkg.cpu(1)])
    mod.bind(data_shapes=[("data", (batch, 10))],
             label_shapes=[("softmax_label", (batch,))],
             inputs_need_grad=True)
    mod.init_params(arg_params=params)
    mod.init_optimizer(kvstore=kvstore, optimizer="sgd",
                       optimizer_params={"learning_rate": 0.2,
                                         "momentum": 0.9})
    it = pkg.io.NDArrayIter(x, y, batch_size=batch, shuffle=False)
    outs, igrads = [], []
    for b in it:
        mod.forward(b, is_train=True)
        mod.backward()
        mod.update()
        outs.append(mod.get_outputs()[0].asnumpy())
        igrads.append(mod.get_input_grads()[0].asnumpy())
    arg, _ = mod.get_params()
    return (outs, igrads, {k: v.asnumpy() for k, v in arg.items()},
            mod._update_on_kvstore)


@pytest.mark.parametrize("kvstore", ["local", "device"])
def test_module_over_two_contexts_matches_jax(kvstore):
    want = _module_run(mj, kvstore)
    got = _module_run(mt, kvstore)
    assert got[3] == want[3] == (kvstore == "device")
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert a.shape == b.shape and _rel(a, b) <= REL_L2
    for k in want[2]:
        assert _rel(got[2][k], want[2][k]) <= REL_L2, k


# -- group2ctx -------------------------------------------------------------------
def _check(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def _g2c_net(pkg):
    with pkg.NameManager():
        with pkg.AttrScope(ctx_group="dev1"):
            data = pkg.sym.Variable("data")
            fc1 = pkg.sym.FullyConnected(data=data, num_hidden=8, name="fc1")
        with pkg.AttrScope(ctx_group="dev2"):
            act = pkg.sym.Activation(data=fc1, act_type="relu")
            fc2 = pkg.sym.FullyConnected(data=act, num_hidden=4, name="fc2")
        return pkg.sym.SoftmaxOutput(data=fc2, name="softmax")


def test_group2ctx_executor_matches_jax():
    rng = np.random.RandomState(4)
    vals = {"data": rng.rand(4, 6).astype("f"),
            "fc1_weight": rng.uniform(-0.5, 0.5, (8, 6)).astype("f"),
            "fc1_bias": rng.uniform(-0.1, 0.1, (8,)).astype("f"),
            "fc2_weight": rng.uniform(-0.5, 0.5, (4, 8)).astype("f"),
            "fc2_bias": rng.uniform(-0.1, 0.1, (4,)).astype("f"),
            "softmax_label": np.array([0, 1, 2, 3], "f")}
    res = {}
    for pkg in (mj, mt):
        g2c = {"dev1": pkg.cpu(1), "dev2": pkg.cpu(2)}
        exe = _g2c_net(pkg).simple_bind(pkg.cpu(0), group2ctx=g2c,
                                        data=(4, 6), softmax_label=(4,))
        for k, v in exe.arg_dict.items():
            v[:] = vals[k]
        exe.forward(is_train=True)
        exe.backward()
        res[pkg] = (exe, exe.outputs[0].asnumpy(),
                    {k: g.asnumpy() for k, g in exe.grad_dict.items()
                     if g is not None})
    exe, out, grads = res[mt]
    _check(out, res[mj][1])
    assert sorted(grads) == sorted(res[mj][2])
    for k in grads:
        _check(grads[k], res[mj][2][k])
    want_ctx = {"data": mt.cpu(1), "fc1_weight": mt.cpu(1),
                "fc1_bias": mt.cpu(1), "fc2_weight": mt.cpu(2),
                "fc2_bias": mt.cpu(2), "softmax_label": mt.cpu(0)}
    assert {k: a.context for k, a in exe.arg_dict.items()} == want_ctx
    assert {k: g.context for k, g in exe.grad_dict.items()
            if g is not None} == {k: want_ctx[k] for k in grads}
    assert exe.outputs[0].context == mt.cpu(0)   # the head: no group
    assert exe.reshape(data=(2, 6), softmax_label=(2,)).arg_dict[
        "fc2_weight"] is exe.arg_dict["fc2_weight"]


def _lstm_pair(pkg, grad_req="write"):
    lstm = pkg.models.lstm
    net_mp = lstm.lstm_unroll(2, 4, 16, 8, 6, 10, group2ctx_layers=True)
    net_sp = lstm.lstm_unroll(2, 4, 16, 8, 6, 10, group2ctx_layers=False)
    shapes = {"data": (2, 4), "softmax_label": (2, 4),
              "l0_init_c": (2, 8), "l0_init_h": (2, 8),
              "l1_init_c": (2, 8), "l1_init_h": (2, 8)}
    g2c = lstm.lstm_group2ctx(2, [pkg.cpu(i) for i in range(4)])
    exe_mp = net_mp.simple_bind(pkg.cpu(0), group2ctx=g2c,
                                grad_req=grad_req, **shapes)
    exe_sp = net_sp.simple_bind(pkg.cpu(0), grad_req=grad_req, **shapes)
    rng = np.random.RandomState(5)
    vals = {k: rng.uniform(-0.1, 0.1, v.shape).astype("f")
            for k, v in exe_sp.arg_dict.items()}
    vals["data"] = rng.randint(0, 16, (2, 4)).astype("f")
    vals["softmax_label"] = rng.randint(0, 10, (2, 4)).astype("f")
    for exe in (exe_sp, exe_mp):
        for k, v in exe.arg_dict.items():
            v[:] = vals[k]
        exe.forward(is_train=True)
        exe.backward()
    return exe_mp, exe_sp, g2c


def test_model_parallel_lstm_gradients_match_single():
    """test_multi_device.py's case in both packages: the partitioned
    port against the JAX partitioned and unpartitioned executors."""
    jmp, jsp, _ = _lstm_pair(mj)
    tmp, tsp, g2c = _lstm_pair(mt)
    keys = ("l0_i2h_weight", "embed_weight", "cls_weight")
    for ref in (jmp, jsp):
        _check(tmp.outputs[0].asnumpy(), ref.outputs[0].asnumpy())
        for k in keys:
            _check(tmp.grad_dict[k].asnumpy(), ref.grad_dict[k].asnumpy())
    _check(tmp.outputs[0].asnumpy(), tsp.outputs[0].asnumpy())
    assert tmp.arg_dict["embed_weight"].context == g2c["embed"]
    assert tmp.arg_dict["l1_h2h_weight"].context == g2c["layer1"]
    assert tmp.arg_dict["cls_weight"].context == g2c["decode"]
    assert tmp.aux_arrays == []


def test_model_parallel_lstm_grad_req_add_accumulates():
    exe, _, _ = _lstm_pair(mt, grad_req="add")
    once = exe.grad_dict["l0_i2h_weight"].asnumpy().copy()
    exe.forward(is_train=True)
    exe.backward()
    _check(exe.grad_dict["l0_i2h_weight"].asnumpy(), 2 * once)


# -- the group-boundary copies ---------------------------------------------------
def _counting_to(monkeypatch):
    """Counts every ``Tensor.to`` call; a list of one int."""
    seen = [0]
    to = torch.Tensor.to

    def counted(self, *a, **k):
        seen[0] += 1
        return to(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "to", counted)
    return seen


def _g2c_dropout_bind(pkg):
    """The group2ctx MLP with a Dropout in ``dev2``, bound and filled."""
    with pkg.NameManager():
        with pkg.AttrScope(ctx_group="dev1"):
            fc1 = pkg.sym.FullyConnected(data=pkg.sym.Variable("data"),
                                         num_hidden=8, name="fc1")
        with pkg.AttrScope(ctx_group="dev2"):
            drop = pkg.sym.Dropout(pkg.sym.Activation(fc1, act_type="relu"),
                                   p=0.5)
            fc2 = pkg.sym.FullyConnected(data=drop, num_hidden=4,
                                         name="fc2")
        net = pkg.sym.SoftmaxOutput(data=fc2, name="softmax")
    g2c = {"dev1": pkg.cpu(1), "dev2": pkg.cpu(2)}
    exe = net.simple_bind(pkg.cpu(0), group2ctx=g2c, data=(16, 6),
                          softmax_label=(16,))
    rng = np.random.RandomState(8)
    for k, v in exe.arg_dict.items():
        v[:] = rng.uniform(-0.5, 0.5, v.shape).astype("f")
    exe.arg_dict["softmax_label"][:] = rng.randint(0, 4, 16).astype("f")
    return exe


def _lstm_bind(pkg):
    return _lstm_pair(pkg)[0]


def _step(pkg, exe):
    pkg.random.seed(9)
    exe.forward(is_train=True)
    exe.backward()


@pytest.mark.parametrize("bind", [_g2c_dropout_bind, _lstm_bind],
                         ids=["mlp_dropout", "lstm"])
def test_group_boundary_copies_match_jax(bind, monkeypatch):
    """The executor's group-boundary branch (each input and the node's
    key moved to the consumer's device with ``Tensor.to``, the gradient
    carried back by autograd), which several cards take, forced on: on
    the CPU every ``cpu(i)`` is one torch device, so the branch is off
    by itself and the copies here return their input. Outputs,
    gradients and the Dropout mask against the JAX executor, whose
    groups sit on distinct virtual devices; the forced step must make
    more ``Tensor.to`` calls than the same step without the branch."""
    want = bind(mj)
    _step(mj, want)
    got = bind(mt)
    seen = _counting_to(monkeypatch)
    _step(mt, got)
    plain = seen[0]
    got._multi_device = True
    seen[0] = 0
    _step(mt, got)
    assert seen[0] > plain
    _check(got.outputs[0].asnumpy(), want.outputs[0].asnumpy())
    for k, g in got.grad_dict.items():
        if g is not None:
            _check(g.asnumpy(), want.grad_dict[k].asnumpy())


# -- examples/model-parallel-lstm -----------------------------------------------
def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _NumpyInit:
    """The examples' Xavier replaced by seeded numpy values by name, the
    same in both packages."""

    def __init__(self, *a, **k):
        pass

    def __call__(self, name, arr):
        rng = np.random.RandomState(zlib.crc32(name.encode()))
        arr[:] = rng.uniform(-0.2, 0.2, arr.shape).astype("f")


def test_lstm_ptb_example_matches_jax(tmp_path, monkeypatch):
    rng = np.random.RandomState(0)
    words = ["w%d" % i for i in range(24)]
    lines = [" ".join(rng.choice(words, rng.randint(3, 8)))
             for _ in range(30)]
    (tmp_path / "ptb.train.txt").write_text("\n".join(lines) + "\n")
    argv = ["--data-dir", str(tmp_path), "--seq-len", "8", "--num-hidden",
            "12", "--num-embed", "8", "--num-lstm-layer", "2",
            "--num-devices", "4", "--num-epochs", "1", "--batch-size", "8",
            "--ctx", "cpu"]
    ppl = {}
    saved = sys.modules.pop("bucket_io", None)
    # the examples put their directories on sys.path and configure the
    # root logger: both are put back for the tests after this one
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setattr(logging.root, "handlers", list(logging.root.handlers))
    monkeypatch.setattr(logging.root, "level", logging.root.level)
    logging.disable(logging.INFO)
    try:
        for pkg, path in ((mj, "examples/model-parallel-lstm/lstm_ptb.py"),
                          (mt, "examples/model-parallel-lstm_torch/"
                               "lstm_ptb.py")):
            sys.modules.pop("bucket_io", None)
            ex = _load(os.path.join(ROOT, path), "mp_lstm_%s" % pkg.__name__)
            seen = []

            class Perplexity(pkg.metric.Perplexity):
                def get(self):
                    out = super().get()
                    seen.append(out[1])
                    return out

            monkeypatch.setattr(pkg.initializer, "Xavier", _NumpyInit)
            monkeypatch.setattr(pkg.metric, "Perplexity", Perplexity)
            np.random.seed(3)
            if pkg is mj:
                monkeypatch.setattr(sys, "argv", ["lstm_ptb.py"] + argv)
                ex.main()
            else:
                res = ex.main(argv)
                assert res["perplexity"] == seen
                assert res["group2ctx"] == {
                    "embed": "cpu(0)", "layer0": "cpu(1)",
                    "layer1": "cpu(2)", "decode": "cpu(3)"}
            ppl[pkg] = seen
    finally:
        logging.disable(logging.NOTSET)
        sys.modules.pop("bucket_io", None)
        if saved is not None:
            sys.modules["bucket_io"] = saved
    assert len(ppl[mt]) == len(ppl[mj]) == 1
    np.testing.assert_allclose(ppl[mt], ppl[mj], rtol=1e-4)
