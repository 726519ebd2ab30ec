"""The port's optimizers and initializers against the JAX package's, on
the CPU.

- three updates of each registered optimizer (SGD with and without
  momentum, ccSGD, NAG, SGLD, Adam, AdaGrad, RMSProp, AdaDelta, Test) on
  two parameters from the same numpy weights and gradients, with wd,
  ``rescale_grad``, ``clip_gradient``, an idx2name map (the bias gets no
  wd) and a ``FactorScheduler``: every weight and state after every
  update within rtol 1e-6 (f32), the counts equal;
- SGLD's noise and ``threefry.normal`` within 2 ulp of
  ``jax.random.normal`` under the same keys (``erfinv`` against XLA's);
- a scanned Adam ``FeedForward.fit`` (K = 4, chunks of 4 and a tail of
  2) against the per-batch one, in the port and in the JAX package, at a
  constant lr (scanned equals per-batch) and under a ``FactorScheduler``
  whose boundary falls inside a chunk (each path equals the JAX
  package's same path): the final parameters within relative L2 1e-5,
  every count equal, the port's scanned trainer built;
- ``One``/``Zero``/``Load``/``Mixed`` exactly as the JAX package's;
  ``Orthogonal`` (rows orthonormal times ``scale``) and ``MSRAPrelu``
  (its Gaussian's standard deviation) by property; ``mx.init``'s names.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import threefry as tf

RTOL, ATOL = 1e-6, 1e-7
PKGS = {"jax": mj, "port": mt}
OPTIMIZERS = {
    "sgd": dict(momentum=0.0),
    "sgd_momentum": dict(momentum=0.9),
    "ccsgd": dict(momentum=0.9),
    "nag": dict(momentum=0.9),
    "sgld": {},
    "adam": dict(beta1=0.8),
    "adagrad": {},
    "rmsprop": {},
    "adadelta": dict(rho=0.85),
    "test": {},
}


@pytest.fixture(scope="module", autouse=True)
def _quick_jax_compiles():
    prev = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", prev)
    jax.clear_caches()


def _leaves(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [a.asnumpy() for a in state]
    return [state.asnumpy()]


def _updates(pkg, name, kw):
    rng = np.random.RandomState(9)
    weights = [rng.randn(4, 3).astype(np.float32),
               rng.randn(3).astype(np.float32)]
    grads = [[rng.randn(*w.shape).astype(np.float32) * 2 for w in weights]
             for _ in range(3)]
    pkg.random.seed(7)
    opt = pkg.optimizer.create(
        name.split("_")[0], learning_rate=0.05, wd=0.01, rescale_grad=0.5,
        clip_gradient=0.8, param_idx2name={0: "fc_weight", 1: "fc_bias"},
        lr_scheduler=pkg.lr_scheduler.FactorScheduler(step=2, factor=0.5),
        **kw)
    ctx = pkg.cpu()
    w_nd = [pkg.nd.array(w, ctx=ctx) for w in weights]
    states = [opt.create_state(i, w) for i, w in enumerate(w_nd)]
    trail = []
    for step in grads:
        for i, g in enumerate(step):
            opt.update(i, w_nd[i], pkg.nd.array(g, ctx=ctx), states[i])
            trail.append([w_nd[i].asnumpy()] + _leaves(states[i]))
    return trail, dict(opt._index_update_count), opt.num_update


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_three_updates_match_jax(name):
    (tj, cj, nj), (tt, ct, nt) = (_updates(PKGS[k], name, OPTIMIZERS[name])
                                  for k in ("jax", "port"))
    assert ct == cj and nt == nj == (0 if name == "test" else 3)
    assert type(mt.optimizer.create(name.split("_")[0])).__name__ == type(
        mj.optimizer.create(name.split("_")[0])).__name__
    for k, (a, b) in enumerate(zip(tt, tj)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL,
                                       err_msg="%s update %d" % (name, k))


def _ulps(got, want):
    spacing = np.spacing(np.maximum(np.abs(want), 1).astype(np.float32))
    return np.abs(got.astype(np.float64) - want) / spacing


def test_normal_within_two_ulp_of_jax():
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (64, 129),
                                        jnp.float32))
    got = tf.normal(tf.prng_key(5, device="cpu"), (64, 129)).numpy()
    assert got.dtype == np.float32 and got.shape == (64, 129)
    assert _ulps(got, want).max() <= 2.0


def test_sgld_noise_within_two_ulp_of_jax():
    """SGLD with a zero gradient and no wd: the step is its noise alone,
    drawn under the chain's next key in both packages."""
    noise = {}
    for k, pkg in PKGS.items():
        pkg.random.seed(3)
        opt = pkg.optimizer.SGLD(learning_rate=1.0)
        w = pkg.nd.zeros((50, 40), ctx=pkg.cpu())
        opt.update(0, w, pkg.nd.zeros((50, 40), ctx=pkg.cpu()), None)
        noise[k] = w.asnumpy()
    assert noise["port"].std() > 0.9
    assert _ulps(noise["port"], noise["jax"]).max() <= 2.0


# -- a scanned Adam fit against a per-batch one --------------------------------
BATCH, N_BATCHES, EPOCHS = 8, 6, 2


def _mlp(pkg):
    s = pkg.sym
    with pkg.NameManager():
        h = s.Activation(s.FullyConnected(s.Variable("data"), num_hidden=16,
                                          name="fc1"), act_type="relu")
        return s.SoftmaxOutput(s.FullyConnected(h, num_hidden=5, name="fc2"),
                               name="softmax")


def _adam_fit(pkg, scan, scheduler, monkeypatch):
    monkeypatch.setenv("MXNET_SCAN_TRAIN", "1" if scan else "0")
    monkeypatch.setenv("MXNET_TRAIN_SCAN_K", "4")
    rng = np.random.RandomState(2)
    x = rng.randn(BATCH * N_BATCHES, 10).astype(np.float32)
    y = rng.randint(0, 5, BATCH * N_BATCHES).astype(np.float32)
    shapes, _, _ = _mlp(mt).infer_shape(data=(BATCH, 10))
    args = {n: (rng.randn(*s) * 0.3).astype(np.float32)
            for n, s in zip(_mlp(mt).list_arguments(), shapes)
            if n not in ("data", "softmax_label")}
    opt = pkg.optimizer.Adam(
        learning_rate=0.01, wd=1e-3, rescale_grad=1.0 / BATCH,
        lr_scheduler=(pkg.lr_scheduler.FactorScheduler(step=5, factor=0.5)
                      if scheduler else None))
    built = []
    if pkg is mt:
        from mxnet_tpu_torch.parallel import fit_trainer
        real = fit_trainer.make_fit_trainer
        monkeypatch.setattr(fit_trainer, "make_fit_trainer",
                            lambda *a, **kw: built.append(1) or real(*a, **kw))
    model = pkg.FeedForward(
        _mlp(pkg), ctx=pkg.cpu(), num_epoch=EPOCHS, optimizer=opt,
        arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                    for k, v in args.items()})
    model.fit(X=pkg.io.NDArrayIter(x, y, batch_size=BATCH, shuffle=False))
    monkeypatch.undo()
    return ({k: v.asnumpy() for k, v in model.arg_params.items()},
            dict(opt._index_update_count), opt.num_update, built)


def _close(got, want, what):
    for n, w in want.items():
        rel = np.linalg.norm(got[n] - w) / np.linalg.norm(w)
        assert rel <= 1e-5, (what, n, rel)


@pytest.mark.parametrize("scheduler", [False, True],
                         ids=["constant_lr", "factor_scheduler"])
def test_scanned_adam_fit_matches_per_batch(scheduler, monkeypatch):
    """Adam's bias correction reads each step's own count in the scanned
    fit. Without a scheduler the scanned fit equals the per-batch one in
    both packages; with a boundary inside a chunk the scanned fit gives
    every parameter the post-increment lr (the JAX trainer's rule), so
    each path is held to the JAX package's same path."""
    runs = {(k, scan): _adam_fit(PKGS[k], scan, scheduler, monkeypatch)
            for k in ("jax", "port") for scan in (True, False)}
    assert runs[("port", True)][3] == [1] and runs[("port", False)][3] == []
    for key, got in runs.items():
        ref = runs[("jax", key[1])]
        assert got[1] == ref[1] and got[2] == ref[2] == EPOCHS * N_BATCHES
        _close(got[0], ref[0], key)
    if not scheduler:
        for k in ("jax", "port"):
            _close(runs[(k, True)][0], runs[(k, False)][0], k)


# -- initializers --------------------------------------------------------------
def _init(pkg, init, name, shape):
    arr = pkg.nd.zeros(shape, ctx=pkg.cpu())
    init(name, arr)
    return arr.asnumpy()


@pytest.mark.parametrize("kind", ["One", "Zero"])
def test_constant_initializers_match_jax(kind):
    for name in ("fc_weight", "fc_bias", "bn_gamma", "x_moving_var", "other"):
        got = {k: _init(p, getattr(p.initializer, kind)(), name, (3, 4))
               for k, p in PKGS.items()}
        np.testing.assert_array_equal(got["port"], got["jax"])


def test_load_and_mixed_match_jax(tmp_path):
    rng = np.random.RandomState(1)
    saved = {"arg:fc_weight": rng.randn(3, 4).astype(np.float32),
             "aux:bn_moving_mean": rng.randn(4).astype(np.float32)}
    path = str(tmp_path / "p.params")
    mt.nd.save(path, {k: mt.nd.array(v, ctx=mt.cpu())
                      for k, v in saved.items()})
    for k, pkg in PKGS.items():
        load = pkg.initializer.Load(path, default_init=pkg.initializer.One())
        np.testing.assert_array_equal(
            _init(pkg, load, "fc_weight", (3, 4)), saved["arg:fc_weight"])
        np.testing.assert_array_equal(
            _init(pkg, load, "bn_moving_mean", (4,)),
            saved["aux:bn_moving_mean"])
        np.testing.assert_array_equal(_init(pkg, load, "fc2_weight", (2,)),
                                      np.ones(2, np.float32))
        with pytest.raises(pkg.base.MXNetError, match="shape mismatch"):
            _init(pkg, load, "fc_weight", (4, 3))
        with pytest.raises(pkg.base.MXNetError, match="not in loaded"):
            _init(pkg, pkg.initializer.Load(path), "nope_weight", (2,))
        mixed = pkg.initializer.Mixed(["fc.*", ".*"], [
            pkg.initializer.Zero(), pkg.initializer.One()])
        np.testing.assert_array_equal(_init(pkg, mixed, "fc_weight", (2, 2)),
                                      np.zeros((2, 2), np.float32))
        np.testing.assert_array_equal(_init(pkg, mixed, "c_weight", (2, 2)),
                                      np.ones((2, 2), np.float32))
        with pytest.raises(pkg.base.MXNetError, match="did not match"):
            _init(pkg, pkg.initializer.Mixed(["fc.*"], [
                pkg.initializer.One()]), "c_weight", (2,))


@pytest.mark.parametrize("rand_type", ["uniform", "normal"])
@pytest.mark.parametrize("shape", [(6, 3, 2), (3, 8)])
def test_orthogonal_by_property(rand_type, shape):
    mt.random.seed(0)
    w = _init(mt, mt.initializer.Orthogonal(scale=1.5, rand_type=rand_type),
              "fc_weight", shape).reshape(shape[0], -1)
    gram = w @ w.T if w.shape[0] <= w.shape[1] else w.T @ w
    np.testing.assert_allclose(gram, 2.25 * np.eye(gram.shape[0]),
                               atol=1e-5)
    assert np.all(_init(mt, mt.initializer.Orthogonal(), "fc_bias",
                        (3,)) == 0)


def test_msra_prelu_by_property():
    mt.random.seed(0)
    shape = (256, 64, 3, 3)
    w = _init(mt, mt.initializer.MSRAPrelu(factor_type="in", slope=0.25),
              "conv_weight", shape)
    want = np.sqrt(2.0 / (1 + 0.25 ** 2) / (64 * 9))
    assert abs(w.std() / want - 1) < 0.01 and abs(w.mean()) < want * 0.01
    assert mt.initializer.MSRAPrelu().magnitude == \
        mj.initializer.MSRAPrelu().magnitude


def test_init_namespace_matches_jax():
    names = sorted(n for n in vars(mj.initializer.init)
                   if not n.startswith("_"))
    assert sorted(n for n in vars(mt.initializer.init)
                  if not n.startswith("_")) == names
