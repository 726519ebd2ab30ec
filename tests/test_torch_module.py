"""The port's Module API against the JAX package's, on the CPU.

Every comparison starts both packages from the same numpy parameters and
data and runs the JAX package's per-batch loop (``MXNET_SCAN_TRAIN=0``,
the loop the port carries). f32 on both sides; tolerances as PERF.md §2:
relative L2 1e-4 where steps compound summation-order noise, rtol 1e-4
and atol 1e-5 for a single step.

- ``mnist_mlp``'s explicit workflow (fc1 128, relu, fc2 10,
  SoftmaxOutput): 20 SGD-momentum steps, each step's output and the
  final parameters;
- ``Module.fit`` of LeNet, one epoch of 4 batches: final parameters and
  the Train-accuracy;
- ``SequentialModule`` with ``auto_wiring`` and ``take_labels``: 10
  steps;
- ``backward(out_grads=...)`` from a ``PythonLossModule``: one step's
  parameter gradients;
- ``BucketingModule`` over the Embedding/sum/BatchNorm/FC ``sym_gen`` of
  ``tests/unittest/test_model_module.py``: one storage for both buckets,
  ``grad_req="add"`` kept private, outputs after alternating steps;
- ``Executor.reshape`` at a new batch size over the same parameters;
- ``Monitor`` taps on one LeNet batch: names, order and statistics;
- checkpoints: ``-symbol.json`` and ``.params`` bytes, ``Module.load``
  both ways, a ``begin_epoch`` resume; ``save_params``/``load_params``,
  ``score`` and ``iter_predict``;
- what the port refuses: a second context that is not there, a
  ``dist`` kvstore under the unported sharded update; and that
  ``MXNET_GUARDIAN=1``, refused before the guardian was ported, trains.
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt

BATCH = 16


@pytest.fixture(scope="module", autouse=True)
def _warm_cpu_math():
    """torch 2.13's CPU ``exp`` and ``tanh`` sometimes return errors up to
    1.5e-4 relative on their first multithreaded call in a process (see
    ``tests/test_torch_fit.py``); one call of each first avoids it."""
    t = torch.randn(100000)
    torch.exp(t)
    torch.tanh(t)
    torch.rsqrt(t.abs() + 1)


@pytest.fixture(scope="module", autouse=True)
def _per_batch_jax_loop():
    old = os.environ.get("MXNET_SCAN_TRAIN")
    os.environ["MXNET_SCAN_TRAIN"] = "0"
    yield
    if old is None:
        del os.environ["MXNET_SCAN_TRAIN"]
    else:
        os.environ["MXNET_SCAN_TRAIN"] = old


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _nd(pkg, arrays):
    return {k: pkg.nd.array(v, ctx=pkg.cpu()) for k, v in arrays.items()}


def _np(arrays):
    return {k: v.asnumpy() for k, v in arrays.items()}


def _params(sym, seed, **shapes):
    """Uniform(+-sqrt(3/fan_in)) numpy arrays for every argument that is
    neither an input nor a label."""
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    out = {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name in shapes or name.endswith("label"):
            continue
        fan = float(np.prod(shape[1:])) if len(shape) > 1 else 1.0
        out[name] = (rng.uniform(-1, 1, shape) * np.sqrt(3.0 / fan)).astype(
            np.float32)
    return out


def _digits(n, shape, seed):
    """Seeded images with a learnable class signal, as MNISTIter's."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 10, n).astype(np.float32)
    x = rng.rand(n, 28 * 28).astype(np.float32) * 0.3
    for i, c in enumerate(y.astype(int)):
        x[i, 28 * (2 + 2 * c):28 * (6 + 2 * c)] += 0.9
    return x.reshape((n,) + shape), y


def _mlp(pkg, hidden=128):
    s = pkg.sym
    with pkg.NameManager():
        return s.SoftmaxOutput(s.FullyConnected(s.Activation(
            s.FullyConnected(s.Variable("data"), num_hidden=hidden,
                             name="fc1"), act_type="relu"),
            num_hidden=10, name="fc2"), name="softmax")


# -- 1. mnist_mlp's explicit workflow ------------------------------------------
def _explicit(pkg, params, steps=20):
    x, y = _digits(BATCH * steps, (784,), seed=7)
    it = pkg.io.NDArrayIter(x, y, batch_size=BATCH, shuffle=False)
    mod = pkg.module.Module(_mlp(pkg), context=pkg.cpu())
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(arg_params=_nd(pkg, params))
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.1, "momentum": 0.9})
    metric = pkg.metric.Accuracy()
    outs = []
    for batch in it:
        mod.forward(batch, is_train=True)
        outs.append(mod.get_outputs()[0].asnumpy())
        mod.update_metric(metric, batch.label)
        mod.backward()
        mod.update()
    return outs, _np(mod.get_params()[0]), metric.get()[1]


@pytest.fixture(scope="module")
def explicit():
    params = _params(_mlp(mt), 1, data=(BATCH, 784))
    return _explicit(mj, params), _explicit(mt, params)


def test_explicit_workflow_step_outputs_match(explicit):
    (want, _, acc_j), (got, _, acc_t) = explicit
    assert len(got) == len(want) == 20
    for step, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape == (BATCH, 10)
        assert _rel_l2(g, w) <= 1e-4, step
    assert acc_t == acc_j


def test_explicit_workflow_final_params_match(explicit):
    (_, want, _), (_, got, _) = explicit
    assert sorted(got) == sorted(want)
    for name in want:
        assert _rel_l2(got[name], want[name]) <= 1e-4, name


# -- 2. Module.fit of LeNet ----------------------------------------------------
def _lenet_fit(pkg, params):
    x, y = _digits(4 * BATCH, (1, 28, 28), seed=8)
    it = pkg.io.NDArrayIter(x, y, batch_size=BATCH, shuffle=False)
    with pkg.NameManager():
        sym = pkg.models.get_lenet()
    mod = pkg.module.Module(sym, context=pkg.cpu())
    metric = pkg.metric.Accuracy()
    mod.fit(it, eval_metric=metric, num_epoch=1, arg_params=_nd(pkg, params),
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    return _np(mod.get_params()[0]), metric.get()[1]


def test_module_fit_lenet_matches():
    params = _params(mt.models.get_lenet(), 2, data=(BATCH, 1, 28, 28))
    want, acc_j = _lenet_fit(mj, params)
    got, acc_t = _lenet_fit(mt, params)
    assert acc_t == acc_j
    for name in want:
        assert _rel_l2(got[name], want[name]) <= 1e-4, name


# -- 3. SequentialModule -------------------------------------------------------
def _sequential(pkg, params, steps=10):
    x, y = _digits(BATCH * steps, (784,), seed=9)
    it = pkg.io.NDArrayIter(x, y, batch_size=BATCH, shuffle=False)
    s = pkg.sym
    with pkg.NameManager():
        net1 = s.Activation(s.FullyConnected(
            s.Variable("data"), num_hidden=64, name="fc1"), act_type="relu")
        net2 = s.SoftmaxOutput(s.FullyConnected(
            s.Variable("data"), num_hidden=10, name="fc2"), name="softmax")
    mod = pkg.module.SequentialModule()
    mod.add(pkg.module.Module(net1, label_names=(), context=pkg.cpu()))
    mod.add(pkg.module.Module(net2, context=pkg.cpu()), take_labels=True,
            auto_wiring=True)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(arg_params=_nd(pkg, params))
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1})
    outs = []
    for batch in it:
        mod.forward(batch, is_train=True)
        outs.append(mod.get_outputs()[0].asnumpy())
        mod.backward()
        mod.update()
    return outs, _np(mod.get_params()[0])


def test_sequential_module_matches():
    params = _params(_mlp(mt, 64), 3, data=(BATCH, 784))
    outs_j, want = _sequential(mj, params)
    outs_t, got = _sequential(mt, params)
    for step, (g, w) in enumerate(zip(outs_t, outs_j)):
        assert _rel_l2(g, w) <= 1e-4, step
    for name in want:
        assert _rel_l2(got[name], want[name]) <= 1e-4, name


# -- 4. backward(out_grads=...) from a PythonLossModule ------------------------
def _softmax_ce_grad(scores, labels):
    s, lab = scores.asnumpy(), labels.asnumpy().astype(int)
    e = np.exp(s - s.max(1, keepdims=True))
    p = e / e.sum(1, keepdims=True)
    p[np.arange(len(lab)), lab] -= 1.0
    return p / len(lab)


def _python_loss_grads(pkg, params):
    x, y = _digits(BATCH, (784,), seed=10)
    it = pkg.io.NDArrayIter(x, y, batch_size=BATCH, shuffle=False)
    s = pkg.sym
    with pkg.NameManager():
        net = s.FullyConnected(s.Activation(s.FullyConnected(
            s.Variable("data"), num_hidden=64, name="fc1"),
            act_type="relu"), num_hidden=10, name="fc2")
    feat = pkg.module.Module(net, label_names=(), context=pkg.cpu())
    feat.bind(data_shapes=it.provide_data)
    feat.init_params(arg_params=_nd(pkg, params))
    loss = pkg.module.PythonLossModule(grad_func=_softmax_ce_grad)
    loss.bind(data_shapes=[("data", (BATCH, 10))],
              label_shapes=[("softmax_label", (BATCH,))])
    batch = next(iter(it))
    feat.forward(batch, is_train=True)
    loss.forward(pkg.io.DataBatch(data=feat.get_outputs(), label=batch.label),
                 is_train=True)
    loss.backward()
    feat.backward(out_grads=loss.get_input_grads())
    return {k: g.asnumpy() for k, g in feat._execs[0].grad_dict.items()
            if g is not None}


def test_python_loss_out_grads_match():
    params = _params(_mlp(mt, 64), 4, data=(BATCH, 784))
    want = _python_loss_grads(mj, params)
    got = _python_loss_grads(mt, params)
    assert sorted(got) == sorted(want) == sorted(params)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                   atol=1e-5, err_msg=name)


# -- 5. BucketingModule --------------------------------------------------------
def _sym_gen(pkg, with_bn=True):
    def sym_gen(seq_len):
        s = pkg.sym
        data = s.Variable("data")
        emb = s.Embedding(data, input_dim=20, output_dim=8, name="emb")
        net = s.sum(emb, axis=(1,))
        if with_bn:
            net = s.BatchNorm(net, name="bn")
        out = s.FullyConnected(net, num_hidden=2, name="out")
        return (s.SoftmaxOutput(out, name="softmax"), ("data",),
                ("softmax_label",))
    return sym_gen


def _bucket_batch(pkg, key, seed, label=True):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 20, (4, key)).astype(np.float32)
    y = (x[:, 0] >= 10).astype(np.float32)
    d = pkg.io.DataDesc
    return pkg.io.DataBatch(
        data=[pkg.nd.array(x, ctx=pkg.cpu())],
        label=[pkg.nd.array(y, ctx=pkg.cpu())] if label else None, pad=0,
        index=None, bucket_key=key, provide_data=[d("data", (4, key))],
        provide_label=[d("softmax_label", (4,))])


def _bucketing(pkg, params):
    mod = pkg.module.BucketingModule(_sym_gen(pkg), default_bucket_key=10,
                                     context=pkg.cpu())
    d = pkg.io.DataDesc
    mod.bind(data_shapes=[d("data", (4, 10))],
             label_shapes=[d("softmax_label", (4,))])
    mod.init_params(arg_params=_nd(pkg, params))
    mod.init_optimizer(optimizer_params={"learning_rate": 0.5,
                                         "momentum": 0.9})
    outs = []
    for step, key in enumerate((10, 20, 10)):
        mod.forward(_bucket_batch(pkg, key, step))
        outs.append(mod.get_outputs()[0].asnumpy())
        mod.backward()
        mod.update()
    for key in (10, 20):
        mod.forward(_bucket_batch(pkg, key, 5, label=False), is_train=False)
        outs.append(mod.get_outputs()[0].asnumpy())
    return mod, outs


@pytest.fixture(scope="module")
def bucketing():
    sym, _, _ = _sym_gen(mt)(10)
    params = _params(sym, 5, data=(4, 10))
    return _bucketing(mj, params), _bucketing(mt, params)


def test_bucketing_outputs_match(bucketing):
    (_, want), (_, got) = bucketing
    assert len(got) == len(want) == 5
    for step, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape == (4, 2)
        assert _rel_l2(g, w) <= 1e-4, step


def test_bucketing_shares_one_storage(bucketing):
    _, (mod, _) = bucketing
    m10, m20 = mod._buckets[10]._execs[0], mod._buckets[20]._execs[0]
    for name in ("emb_weight", "bn_gamma", "bn_beta", "out_weight",
                 "out_bias"):
        assert m20.arg_dict[name] is m10.arg_dict[name], name
        assert m20.grad_dict[name] is m10.grad_dict[name], name
    for name in ("bn_moving_mean", "bn_moving_var"):
        assert m20.aux_dict[name] is m10.aux_dict[name], name
    assert m20.arg_dict["data"] is not m10.arg_dict["data"]
    # bucket 20 reads what an update through bucket 10 wrote
    before = m20.arg_dict["out_weight"].asnumpy()
    mod.forward(_bucket_batch(mt, 10, 9))
    mod.backward()
    mod.update()
    after = m20.arg_dict["out_weight"].asnumpy()
    assert not np.array_equal(before, after)
    np.testing.assert_array_equal(after, m10.arg_dict["out_weight"].asnumpy())


def test_bucketing_grad_req_add_not_aliased():
    mod = mt.module.BucketingModule(_sym_gen(mt, with_bn=False),
                                    default_bucket_key=10, context=mt.cpu())
    d = mt.io.DataDesc
    mod.bind(data_shapes=[d("data", (4, 10))],
             label_shapes=[d("softmax_label", (4,))], grad_req="add")
    mod.init_params()
    mod.forward(_bucket_batch(mt, 5, 0))
    m10, m5 = mod._buckets[10]._execs[0], mod._buckets[5]._execs[0]
    assert m5.arg_dict["emb_weight"] is m10.arg_dict["emb_weight"]
    assert m5.grad_dict["emb_weight"] is not m10.grad_dict["emb_weight"]
    assert m5._reqs[m5._arg_names.index("emb_weight")] == "add"


# -- 6. Executor.reshape -------------------------------------------------------
def _reshaped(pkg, params):
    sym = _mlp(pkg, 32)
    exe = sym.simple_bind(pkg.cpu(), grad_req="null", data=(8, 784),
                          softmax_label=(8,))
    exe.copy_params_from(_nd(pkg, params))
    new = exe.reshape(data=(3, 784), softmax_label=(3,))
    x, _ = _digits(3, (784,), seed=11)
    new.arg_dict["data"][:] = x
    return exe, new, new.forward(is_train=False)[0].asnumpy()


def test_executor_reshape_matches():
    params = _params(_mlp(mt, 32), 6, data=(8, 784))
    _, _, want = _reshaped(mj, params)
    exe, new, got = _reshaped(mt, params)
    assert got.shape == want.shape == (3, 10)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert new.arg_dict["data"].shape == (3, 784)
    for name in params:
        assert new.arg_dict[name] is exe.arg_dict[name], name


# -- 7. Monitor ----------------------------------------------------------------
def _monitor_taps(pkg, params):
    x, y = _digits(BATCH, (1, 28, 28), seed=12)
    it = pkg.io.NDArrayIter(x, y, batch_size=BATCH, shuffle=False)
    with pkg.NameManager():
        sym = pkg.models.get_lenet()
    mod = pkg.module.Module(sym, context=pkg.cpu())
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(arg_params=_nd(pkg, params))
    mon = pkg.monitor.Monitor(1, nan_aware=True)
    mod.install_monitor(mon)
    mon.tic()
    mod.forward(next(iter(it)), is_train=True)
    return mon.toc()


def test_monitor_taps_match():
    params = _params(mt.models.get_lenet(), 7, data=(BATCH, 1, 28, 28))
    want = _monitor_taps(mj, params)
    got = _monitor_taps(mt, params)
    assert [k for _, k, _ in got] == [k for _, k, _ in want]
    assert "conv1_output" in [k for _, k, _ in got]
    np.testing.assert_allclose([float(v) for _, _, v in got],
                               [float(v) for _, _, v in want], rtol=1e-5)
    assert mt.Monitor is mt.monitor.Monitor


# -- 8. checkpoints ------------------------------------------------------------
def _trained(pkg, params, prefix, epochs=1):
    x, y = _digits(4 * BATCH, (784,), seed=13)
    it = pkg.io.NDArrayIter(x, y, batch_size=BATCH, shuffle=False)
    mod = pkg.module.Module(_mlp(pkg, 32), context=pkg.cpu())
    mod.fit(it, num_epoch=epochs, arg_params=_nd(pkg, params),
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    mod.save_checkpoint(prefix, epochs, save_optimizer_states=True)
    if pkg is mj:
        mj.model.fence_checkpoint(prefix)
    return mod, it


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    params = _params(_mlp(mt, 32), 8, data=(BATCH, 784))
    out = {}
    for pkg in (mj, mt):
        prefix = str(d / pkg.__name__)
        out[pkg] = (prefix,) + _trained(pkg, params, prefix)
    return out


def test_checkpoint_bytes_equal(checkpoints):
    files = [[open(checkpoints[pkg][0] + suffix, "rb").read()
              for suffix in ("-0001.params", "-symbol.json")]
             for pkg in (mj, mt)]
    assert files[0][1] == files[1][1]
    # the same arrays give the same bytes: write the JAX side's trained
    # parameters through the port
    arg, aux = checkpoints[mj][1].get_params()
    prefix = checkpoints[mt][0] + "-copy"
    mt.model.save_checkpoint(prefix, 1, mt.sym.load_json(
        checkpoints[mj][1].symbol.tojson()), _nd(mt, _np(arg)),
        _nd(mt, _np(aux)))
    mt.model.fence_checkpoint(prefix)
    assert open(prefix + "-0001.params", "rb").read() == files[0][0]


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_module_load_across_packages(checkpoints, direction):
    src, dst = (mj, mt) if direction == "jax_to_torch" else (mt, mj)
    prefix, saved, it = checkpoints[src]
    want = saved.predict(it).asnumpy()
    loaded = dst.module.Module.load(prefix, 1, context=dst.cpu())
    dit = dst.io.NDArrayIter(*_digits(4 * BATCH, (784,), seed=13),
                             batch_size=BATCH, shuffle=False)
    loaded.bind(data_shapes=dit.provide_data, label_shapes=dit.provide_label,
                for_training=False)
    # the JAX package's bind leaves loaded parameters out of the
    # executor (the port's, like the reference's, copies them in)
    loaded.set_params(*loaded.get_params())
    got = loaded.predict(dit).asnumpy()
    assert got.shape == want.shape == (4 * BATCH, 10)
    assert (got.argmax(1) == want.argmax(1)).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_port_bind_copies_loaded_params(checkpoints):
    prefix, saved, it = checkpoints[mt]
    loaded = mt.module.Module.load(prefix, None, context=mt.cpu())
    loaded.bind(data_shapes=it.provide_data, label_shapes=it.provide_label,
                for_training=False)
    np.testing.assert_array_equal(loaded.predict(it).asnumpy(),
                                  saved.predict(it).asnumpy())


def _params_file_round_trip(pkg, prefix, tmp_path):
    """``save_params`` of the JAX-trained module's weights, ``load_params``
    into a fresh module, then ``score`` and ``iter_predict``."""
    mod = pkg.module.Module(_mlp(pkg, 32), context=pkg.cpu())
    x, y = _digits(4 * BATCH, (784,), seed=13)
    it = pkg.io.NDArrayIter(x, y, batch_size=BATCH, shuffle=False)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label,
             for_training=False)
    mod.init_params()
    mod.load_params(prefix + "-0001.params")
    fname = str(tmp_path / ("%s.params" % pkg.__name__))
    mod.save_params(fname)
    score = dict(mod.score(it, "ce"))["cross-entropy"]
    outs = [o[0].asnumpy() for o, _, _ in mod.iter_predict(it)]
    return open(fname, "rb").read(), score, np.concatenate(outs)


def test_save_load_params_score_and_iter_predict(checkpoints, tmp_path):
    prefix = checkpoints[mj][0]
    b_j, score_j, out_j = _params_file_round_trip(mj, prefix, tmp_path)
    b_t, score_t, out_t = _params_file_round_trip(mt, prefix, tmp_path)
    assert b_t == b_j
    assert out_t.shape == out_j.shape == (4 * BATCH, 10)
    np.testing.assert_allclose(out_t, out_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(score_t, score_j, rtol=1e-5)


def _resume(pkg, prefix, params):
    """Epoch 0 through ``_trained``; then ``Module.load`` with the
    optimizer state and ``fit(begin_epoch=1)`` for epoch 1."""
    mod = pkg.module.Module.load(prefix, 1, load_optimizer_states=True,
                                 context=pkg.cpu())
    x, y = _digits(4 * BATCH, (784,), seed=13)
    it = pkg.io.NDArrayIter(x, y, batch_size=BATCH, shuffle=False)
    arg, aux = mod._arg_params, mod._aux_params
    mod.fit(it, begin_epoch=1, num_epoch=2, arg_params=arg, aux_params=aux,
            force_init=True,
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    return _np(mod.get_params()[0]), mod._optimizer.num_update


def test_begin_epoch_resume_matches(checkpoints):
    params = _params(_mlp(mt, 32), 8, data=(BATCH, 784))
    want, n_j = _resume(mj, checkpoints[mj][0], params)
    got, n_t = _resume(mt, checkpoints[mt][0], params)
    # the pickled optimizer carries its update count across the resume
    assert n_t == n_j == 8
    for name in want:
        assert _rel_l2(got[name], want[name]) <= 1e-4, name


# -- what the port refuses -----------------------------------------------------
def test_second_context_raises():
    # several contexts bind one executor each (tests/test_torch_multi_
    # device.py); a card that is not there raises, naming the count
    missing = mt.gpu(mt.context.num_devices("gpu"))
    mod = mt.module.Module(_mlp(mt), context=[mt.cpu(0), missing])
    with pytest.raises(mt.MXNetError, match="visible"):
        mod.bind(data_shapes=[("data", (BATCH, 784))],
                 label_shapes=[("softmax_label", (BATCH,))])


def test_dist_kvstore_and_guardian_raise(monkeypatch):
    x, y = _digits(BATCH, (784,), seed=14)
    it = mt.io.NDArrayIter(x, y, batch_size=BATCH)
    mod = mt.module.Module(_mlp(mt, 32), context=mt.cpu())
    monkeypatch.setenv("MXNET_KV_SHARD_UPDATE", "1")
    with pytest.raises(mt.MXNetError, match="MXNET_KV_SHARD_UPDATE"):
        mod.fit(it, num_epoch=1, kvstore="dist_sync")
    monkeypatch.delenv("MXNET_KV_SHARD_UPDATE")
    monkeypatch.setenv("MXNET_GUARDIAN", "1")
    mod = mt.module.Module(_mlp(mt, 32), context=mt.cpu())
    mod.fit(it, num_epoch=1)
    assert all(np.isfinite(v.asnumpy()).all()
               for v in mod.get_params()[0].values())
