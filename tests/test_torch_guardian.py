"""The port's training guardian (``resilience/guardian.py``) against the
JAX package's, on the CPU.

- ``AnomalyDetector``: the verdicts over one loss and grad-norm sequence
  (warmup, a suspect and a poisoned loss, an explosion, non-finite
  values) are the JAX detector's, and so are the EMA baselines;
- guarded fits with ``grad.nan`` and ``loss.spike`` armed
  (``MXNET_FAULT_SPEC``), through ``FeedForward.fit`` and ``Module.fit``
  on the scanned path (K = 4) and the per-batch path: the guardian's
  counters, the action of every step, the rollbacks (step and target)
  and the fast-forwards are the JAX package's, and the final weights are
  within relative L2 1e-5 of the JAX fit's (f32, summation order);
- a guarded fit with nothing armed is bit-equal to the port's unguarded
  fit, on both paths, and a poisoned per-batch step's update does not
  land;
- the pieces: ``SnapshotRing``, ``MetricLossFeed``, ``fast_forward``,
  the updater sentinel's per-parameter suppression and its optimizer
  states, ``snapshot/restore/zero_updater_states``, the disk rollback
  from a checkpoint, ``FitTrainer``'s ``snapshot_state``/``restore_state``
  round trip, and ``guardian_vote`` over two gloo processes.

The net is a 2-layer MLP (16 -> 32 -> 4, SoftmaxOutput) over 12 batches
of 8, 2 epochs, SGD lr 0.1 momentum 0.9, from one set of numpy
parameters. The JAX references are computed once a module.
"""
import os
import subprocess
import sys
from contextlib import contextmanager

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, N_BATCHES, EPOCHS, K = 8, 12, 2, 4
GUARD_ENV = {"MXNET_GUARDIAN": "1", "MXNET_GUARDIAN_WARMUP": "3",
             "MXNET_GUARDIAN_SNAPSHOT_STEPS": "4",
             "MXNET_GUARDIAN_MAX_SKIPS": "2",
             "MXNET_GUARDIAN_FF_BATCHES": "1",
             "MXNET_GUARDIAN_SPIKE_SCALE": "1e4"}
# the scanned trainer draws the two points once a step, the per-batch
# updater once a parameter update (4 a step): each spec puts two
# consecutive poisoned steps (a rollback at MAX_SKIPS 2) and, later, one
# spike into epoch 1
SPECS = {"scan": "grad.nan:error:skip=5:count=2;"
                 "loss.spike:error:skip=16:count=1",
         "batch": "grad.nan:error:skip=20:count=5;"
                  "loss.spike:error:skip=50:count=1"}
CASES = [("ff", "scan"), ("ff", "batch"), ("module", "scan"),
         ("module", "batch")]


@pytest.fixture(scope="module", autouse=True)
def _env():
    """K = 4 in both packages; JAX compiles without XLA's passes (each
    program runs a few times)."""
    prev = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    with pytest.MonkeyPatch.context() as mp:
        for k in ("MXNET_SCAN_TRAIN", "MXNET_COMPUTE_DTYPE",
                  "MXNET_FAULT_SPEC", "MXNET_GUARDIAN_GRADNORM_MAX",
                  "MXNET_GUARDIAN_ZSCORE", "MXNET_GUARDIAN_GRADNORM_FACTOR",
                  "MXNET_GUARDIAN_SNAPSHOT_KEEP", "MXNET_KV_QUANTIZE"):
            mp.delenv(k, raising=False)
        mp.setenv("MXNET_TRAIN_SCAN_K", str(K))
        yield
    jax.config.update("jax_disable_most_optimizations", prev)
    jax.clear_caches()


@contextmanager
def _environ(values):
    old = {k: os.environ.get(k) for k in values}
    os.environ.update({k: v for k, v in values.items() if v is not None})
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _mlp(pkg):
    s = pkg.sym
    with pkg.NameManager():
        h = s.FullyConnected(s.Variable("data"), num_hidden=32, name="fc1")
        h = s.Activation(h, act_type="relu", name="relu1")
        h = s.FullyConnected(h, num_hidden=4, name="fc2")
        return s.SoftmaxOutput(h, name="softmax")


def _data(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(N_BATCHES * BATCH, 16).astype(np.float32)
    w = rng.randn(16, 4).astype(np.float32)
    y = np.argmax(x @ w, axis=1).astype(np.float32)
    return x, y


def _params(seed=1):
    rng = np.random.RandomState(seed)
    return {"fc1_weight": rng.randn(32, 16).astype(np.float32) * 0.25,
            "fc1_bias": np.zeros(32, np.float32),
            "fc2_weight": rng.randn(4, 32).astype(np.float32) * 0.25,
            "fc2_bias": np.zeros(4, np.float32)}


def _host(v):
    return np.array(v.asnumpy(), dtype=np.float32)


@contextmanager
def _capture(pkg):
    """Every guardian's step actions, rollbacks and fast-forwards."""
    g = pkg.resilience.guardian
    G = g.TrainingGuardian
    log = {"steps": [], "rollbacks": [], "ff": [], "guards": []}
    rec, rb, ff, create = G.record_step, G.rollback, g.fast_forward, G.create

    def record_step(self, *a, **k):
        out = rec(self, *a, **k)
        log["steps"].append((self.step, out))
        return out

    def rollback(self, *a, **k):
        at = self.step
        out = rb(self, *a, **k)
        log["rollbacks"].append((at, out))
        return out

    def fast_forward(it, n):
        out = ff(it, n)
        log["ff"].append((n, out))
        return out

    def create_(cls, *a, **k):
        out = create.__func__(cls, *a, **k)
        log["guards"].append(out)
        return out

    G.record_step, G.rollback, g.fast_forward = record_step, rollback, \
        fast_forward
    G.create = classmethod(create_)
    try:
        yield log
    finally:
        G.record_step, G.rollback, g.fast_forward = rec, rb, ff
        G.create = create


def _fit(pkg, api, path, spec=None, guard=True):
    """One fit; returns (final weights, capture log)."""
    x, y = _data()
    params = _params()
    env = dict(GUARD_ENV) if guard else {k: None for k in GUARD_ENV}
    env["MXNET_SCAN_TRAIN"] = "1" if path == "scan" else "0"
    pkg.resilience.faults.clear()
    with _environ(env), _capture(pkg) as log:
        if spec:
            pkg.resilience.faults.inject(spec)
        try:
            it = pkg.io.NDArrayIter(x, y, batch_size=BATCH)
            if api == "ff":
                if pkg is mt:
                    args, _ = mt.model.params_from_numpy(params, ctx=mt.cpu())
                else:
                    args = {k: mj.nd.array(v) for k, v in params.items()}
                m = pkg.FeedForward(_mlp(pkg), ctx=pkg.cpu(), num_epoch=EPOCHS,
                                    learning_rate=0.1, momentum=0.9,
                                    arg_params=args, aux_params={},
                                    numpy_batch_size=BATCH)
                m.fit(it, eval_metric="acc")
                out = {k: _host(v) for k, v in m.arg_params.items()}
            else:
                mod = pkg.module.Module(_mlp(pkg), context=pkg.cpu())
                mod.fit(it, num_epoch=EPOCHS, optimizer="sgd",
                        optimizer_params=(("learning_rate", 0.1),
                                          ("momentum", 0.9),
                                          ("rescale_grad", 1.0 / BATCH)),
                        arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                                    for k, v in params.items()},
                        aux_params={}, eval_metric="acc")
                out = {k: _host(v) for k, v in mod.get_params()[0].items()}
        finally:
            pkg.resilience.faults.clear()
    return out, log


def _counters(g):
    return (g.nonfinite_steps, g.skipped_steps, g.anomaly_steps,
            g.rollbacks, g.step)


@pytest.fixture(scope="module")
def jax_runs():
    return {case: _fit(mj, case[0], case[1], SPECS[case[1]])
            for case in CASES}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# -- the detector ---------------------------------------------------------------
LOSSES = [2.0, 1.9, 1.85, 1.8, 1.82, 1.79, 2.4, 1.78, 9.0, 1.77, float("nan"),
          1.76, 1.2, 1.75, 1.74]
NORMS = [1.0, 1.1, 0.9, 1.05, 1.0, 30.0, 1.0, 0.95, 1.0, float("inf"), 1.0,
         1.0, 1.0, 1.02, 1.0]


def _detector_run(pkg):
    g = pkg.resilience.guardian
    with _environ({"MXNET_GUARDIAN_WARMUP": "4"}):
        det = g.AnomalyDetector(g.GuardianConfig())
    out = []
    for loss, norm in zip(LOSSES, NORMS):
        v = det.classify(finite=np.isfinite(norm), grad_norm=norm, loss=loss)
        out.append(v)
        if v == g.GOOD:
            det.observe(grad_norm=norm, loss=loss)
    return out, (det._n, det._loss_mean, det._loss_sq, det._gnorm_mean)


def test_detector_verdicts_match_jax():
    got, gstate = _detector_run(mt)
    want, wstate = _detector_run(mj)
    assert got == want
    assert {"good", "suspect", "poisoned"} <= set(got)
    assert gstate == wstate


# -- guarded fits against the JAX package ---------------------------------------
@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_armed_fit_matches_jax(jax_runs, case):
    want_w, want = jax_runs[case]
    got_w, got = _fit(mt, case[0], case[1], SPECS[case[1]])
    assert len(got["guards"]) == len(want["guards"]) == 1
    gg, wg = got["guards"][0], want["guards"][0]
    assert _counters(gg) == _counters(wg)
    assert gg.nonfinite_steps >= 2 and gg.rollbacks >= 1
    assert gg.anomaly_steps >= 1
    assert got["steps"] == want["steps"]
    assert got["rollbacks"] == want["rollbacks"]
    assert got["ff"] == want["ff"] and got["ff"]
    assert set(got_w) == set(want_w)
    for k in want_w:
        assert np.isfinite(got_w[k]).all(), k
        assert _rel(got_w[k], want_w[k]) <= 1e-5, (k, _rel(got_w[k],
                                                          want_w[k]))


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_clean_guarded_fit_is_bit_equal(case):
    plain, log0 = _fit(mt, case[0], case[1], guard=False)
    guarded, log1 = _fit(mt, case[0], case[1], guard=True)
    assert log0["guards"] == [None]
    g = log1["guards"][0]
    assert _counters(g)[:4] == (0, 0, 0, 0)
    assert g.step == EPOCHS * N_BATCHES
    for k in plain:
        assert np.array_equal(plain[k], guarded[k]), k


def test_poisoned_batch_update_does_not_land():
    """One NaN on fc2_weight's gradient in the per-batch updater: that
    parameter and its momentum keep their values; the others update."""
    with _environ({"MXNET_GUARDIAN": "1"}):
        upd = mt.optimizer.get_updater(mt.optimizer.create(
            "sgd", learning_rate=0.1, momentum=0.9))
    assert upd.sentinel is not None
    w = [mt.nd.array(np.ones((3, 2), np.float32), ctx=mt.cpu()) for _ in range(2)]
    g = [mt.nd.array(np.full((3, 2), 0.5, np.float32), ctx=mt.cpu()) for _ in range(2)]
    for i in range(2):
        upd(i, g[i], w[i])
    assert upd.sentinel.read_step() == (True, pytest.approx(
        np.sqrt(12 * 0.25), rel=1e-6))
    before = [_host(v) for v in w]
    mom = [_host(upd.states[i]) for i in range(2)]
    g[1][:] = np.array([[0.5, np.nan]] * 3, np.float32)
    for i in range(2):
        upd(i, g[i], w[i])
    ok, norm = upd.sentinel.read_step()
    assert not ok and np.isnan(norm)
    assert np.array_equal(_host(w[1]), before[1])
    assert np.array_equal(_host(upd.states[1]), mom[1])
    assert not np.array_equal(_host(w[0]), before[0])
    snap = mt.resilience.snapshot_updater_states(upd)
    upd.states[0][:] = 7.0
    mt.resilience.restore_updater_states(upd, snap)
    assert np.array_equal(_host(upd.states[0]), snap[0][0].numpy())
    mt.resilience.zero_updater_states(upd)
    assert not _host(upd.states[1]).any()


def test_gradnorm_max_bound_on_device():
    with _environ({"MXNET_GUARDIAN": "1", "MXNET_GUARDIAN_GRADNORM_MAX": "1"}):
        upd = mt.optimizer.get_updater(mt.optimizer.create(
            "sgd", learning_rate=0.1))
    w = mt.nd.array(np.ones(4, np.float32), ctx=mt.cpu())
    upd(0, mt.nd.array(np.full(4, 2.0, np.float32), ctx=mt.cpu()), w)
    ok, norm = upd.sentinel.read_step()
    assert not ok and norm == pytest.approx(4.0)
    assert np.array_equal(_host(w), np.ones(4, np.float32))


def test_pieces_match_jax():
    for pkg in (mt, mj):
        g = pkg.resilience.guardian
        ring = g.SnapshotRing(2)
        for s in (1, 5, 9):
            ring.push(s, {"s": s})
        assert len(ring) == 2 and ring.latest()[0] == 9
        assert ring.pop_latest()[0] == 9 and ring.latest()[0] == 5
    feeds = []
    for pkg in (mt, mj):
        m = pkg.metric.create("ce")
        feed = pkg.resilience.guardian.MetricLossFeed(m)
        out = [feed.active]
        p = pkg.nd.array(np.array([[0.7, 0.3], [0.2, 0.8]], np.float32),
                         ctx=pkg.cpu())
        lab = pkg.nd.array(np.array([0, 1], np.float32), ctx=pkg.cpu())
        for _ in range(2):
            m.update([lab], [p])
            out.append(feed.step_loss())
        out.append(feed.step_loss())
        m.reset()
        out.append(feed.step_loss())
        out.append(pkg.resilience.guardian.MetricLossFeed(
            pkg.metric.create("acc")).active)
        feeds.append(out)
    assert feeds[0][0] is True and feeds[0][-1] is False
    np.testing.assert_allclose(
        [np.nan if v is None else float(v) for v in feeds[0]],
        [np.nan if v is None else float(v) for v in feeds[1]], rtol=1e-6)
    x, y = _data()
    n = [pkg.resilience.guardian.fast_forward(
        pkg.io.NDArrayIter(x, y, batch_size=BATCH), 20) for pkg in (mt, mj)]
    assert n == [N_BATCHES, N_BATCHES]


def test_disk_rollback_from_checkpoint(tmp_path):
    """An empty ring and a checkpoint prefix: the rollback loads the
    newest epoch's parameters and zeroes the optimizer states."""
    prefix = str(tmp_path / "mlp")
    params = _params()
    args, _ = mt.model.params_from_numpy(params, ctx=mt.cpu())
    mt.model.save_checkpoint(prefix, 3, _mlp(mt), args, {}, sync=True)
    with _environ({"MXNET_GUARDIAN": "1", "MXNET_GUARDIAN_MAX_SKIPS": "1"}):
        guard = mt.resilience.TrainingGuardian.create(prefix=prefix)
    got = {}
    guard.begin_step()
    assert guard.record_step(finite=False, suppressed=True) == "rollback"
    assert guard.rollback(lambda p: None,
                          disk_restore_fn=lambda a, x: got.update(a)) == -3
    assert guard.rollbacks == 1
    for k, v in params.items():
        assert np.array_equal(_host(got[k]), v)


def test_fit_trainer_snapshot_round_trip():
    x, y = _data()
    opt = mt.optimizer.create("sgd", learning_rate=0.1, momentum=0.9)
    args, _ = mt.model.params_from_numpy(_params(), ctx=mt.cpu())
    tr = mt.parallel.fit_trainer.make_fit_trainer(
        _mlp(mt), mt.cpu(), {"data": (BATCH, 16), "softmax_label": (BATCH,)},
        opt, args, {}, sorted(args))
    buf = [{"data": x[i * BATCH:(i + 1) * BATCH],
            "softmax_label": y[i * BATCH:(i + 1) * BATCH]} for i in range(2)]
    tr.run_chunk(tr.stage_chunk(buf))
    snap = tr.snapshot_state()
    before = {k: v.clone() for k, v in tr.params.items()}
    tr.run_chunk(tr.stage_chunk(buf))
    assert opt.num_update == 4
    tr.restore_state(snap)
    assert opt.num_update == 2
    for k in before:
        assert torch.equal(tr.params[k], before[k])
    tr.load_params({k: mt.nd.array(v, ctx=mt.cpu())
                    for k, v in _params(7).items()}, {})
    assert np.array_equal(tr.params["fc1_weight"].numpy(),
                          _params(7)["fc1_weight"])
    assert not tr.opt_states[0]._data.any()


_VOTE = r"""
import os, sys
sys.path.insert(0, %r)
import mxnet_tpu_torch as mt
kv = mt.kvstore.create("dist_sync")
rank = kv.rank
votes = [kv.guardian_vote(s, poisoned) for s, poisoned in
         enumerate([False, rank == 1, rank == 0, False])]
assert votes == [False, True, True, False], (rank, votes)
print("vote-ok", rank, kv.num_workers)
"""


def test_guardian_vote_two_gloo_ranks(tmp_path):
    script = tmp_path / "vote.py"
    script.write_text(_VOTE % ROOT)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "torch_launch.py"),
         "-n", "2", "--timeout", "120", "--", sys.executable, str(script)],
        env=env, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.count("vote-ok") == 2
