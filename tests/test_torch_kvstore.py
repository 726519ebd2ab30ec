"""The port's kvstore against the JAX package's, on the CPU.

- ``chip_smoke.kvstore_cases`` (one pair, a push from every context, a
  list of keys, a custom updater, SGD-momentum through ``set_optimizer``
  for three pushes, a one-value push then an in-place write to the pushed
  array) on 1-4 host contexts in both packages from the same seeded
  numpy values: the sums bit-equal (f32 sums in the same order), the
  updates within rtol 1e-6; the store keeps its value after the write;
- every case of tests/unittest/test_kvstore.py on its own inputs, bit
  for bit: the ``Test`` optimizer, the single-process dist_sync
  arithmetic, type/rank/workers;
- the messages of an unknown type, a duplicate init and an uninitialised
  key equal the JAX package's;
- ``kvstore_server``'s facade; ``save``/``load_optimizer_states`` (the
  loaded store's next update equal to the JAX package's after its own
  round trip); ``create`` of every known type; a pull writing into the
  destination's own tensor;
- ``NDArrayIter``'s and ``MNISTIter``'s ``num_parts``/``part_index``
  shards equal the JAX iterators' batches, shuffled or not;
- what is not ported raises ``MXNetError`` naming itself;
- in subprocesses (each under a timeout): the dist_sync arithmetic of
  tests/torch_nightly/dist_sync_kvstore.py with 2 and 3 gloo ranks
  through tools/torch_launch.py, exact, with the bucketed push's four
  all-reduces; a launcher whose worker exits 1 stops the other and
  exits 1.
"""
import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import chip_smoke
import mxnet_tpu as mj
import mxnet_tpu_torch as mt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (4, 4)


@pytest.fixture(autouse=True)
def _one_process(monkeypatch):
    for k in ("MXNET_NUM_PROCS", "MXNET_PROC_ID", "MXNET_COORDINATOR",
              "MXNET_KV_ELASTIC", "MXNET_KV_SHARD_UPDATE",
              "MXNET_KV_QUANTIZE", "MXNET_KV_BARRIER_TIMEOUT",
              "MXNET_TELEMETRY"):
        monkeypatch.delenv(k, raising=False)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_cases_match_jax(n):
    want = chip_smoke.kvstore_cases(mj, [mj.cpu(i) for i in range(n)],
                                    seed=n)
    got = chip_smoke.kvstore_cases(mt, [mt.cpu(i) for i in range(n)],
                                   seed=n)
    assert sorted(got) == sorted(want)
    for name in want:
        assert len(got[name]) == len(want[name])
        for a, b in zip(got[name], want[name]):
            if name == "sgd_momentum":
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)
            else:
                assert np.array_equal(a, b), name
    before, after = got["own_storage"]
    assert np.array_equal(before, after)


def _unit_cases(pkg):
    """tests/unittest/test_kvstore.py's cases on their own inputs."""
    nd, out = pkg.nd, {}
    kv = pkg.kvstore.create("local")
    kv.init(0, nd.zeros(SHAPE, pkg.cpu()))
    kv.set_optimizer(pkg.optimizer.create("test", rescale_grad=0.5))
    res = nd.empty(SHAPE, pkg.cpu())
    for step in range(2):
        kv.push(0, nd.ones(SHAPE, pkg.cpu()))
        kv.pull(0, out=res)
        out["test_optimizer_%d" % step] = res.asnumpy()
    rate, nrepeat = 2.0, 3
    kv = pkg.kvstore.create("dist_sync")
    kv.init(9, nd.ones(SHAPE, pkg.cpu()))
    kv.set_optimizer(pkg.optimizer.create("test", rescale_grad=rate))
    for _ in range(nrepeat):
        kv.push(9, nd.ones(SHAPE, pkg.cpu()))
    kv.pull(9, out=res)
    out["dist_sync"] = res.asnumpy()
    out["identity"] = (kv.type, kv.rank, kv.num_workers)
    return out


def test_unit_cases_match_jax():
    want, got = _unit_cases(mj), _unit_cases(mt)
    assert got["identity"] == want["identity"] == ("dist_sync", 0, 1)
    for k in ("test_optimizer_0", "test_optimizer_1", "dist_sync"):
        assert np.array_equal(got[k], want[k]), k
    # (nworker + 1) * nworker * rate / 2 * nrepeat / nworker + 1
    assert np.all(got["dist_sync"] == 7.0)


def _message(fn):
    try:
        fn()
    except Exception as e:   # the two packages' MXNetError
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("case", ["unknown", "duplicate", "push", "pull"])
def test_messages_match_jax(case):
    def run(pkg):
        kv = pkg.kvstore.create("local")
        kv.init(3, pkg.nd.zeros(SHAPE, pkg.cpu()))
        arr = pkg.nd.zeros(SHAPE, pkg.cpu())
        return {"unknown": lambda: pkg.kvstore.create("nope"),
                "duplicate": lambda: kv.init(3, arr),
                "push": lambda: kv.push(8, arr),
                "pull": lambda: kv.pull(8, out=arr)}[case]

    want, got = _message(run(mj)), _message(run(mt))
    assert want is not None and got == want


def test_a_pushed_array_written_in_place_leaves_the_store():
    kv = mt.kvstore.create("local")
    kv.init(3, mt.nd.zeros(SHAPE, mt.cpu()))
    v = mt.nd.array(np.arange(16.0).reshape(SHAPE), ctx=mt.cpu())
    kv.push(3, v)
    v += 5.0
    v._data.mul_(3)
    out = mt.nd.zeros(SHAPE, mt.cpu())
    kv.pull(3, out=out)
    assert np.array_equal(out.asnumpy(), np.arange(16.0).reshape(SHAPE))


def test_pull_writes_the_destination_tensor():
    kv = mt.kvstore.create("device")
    kv.init(0, mt.nd.ones(SHAPE, mt.cpu()))
    outs = [mt.nd.zeros(SHAPE, mt.cpu(i)) for i in range(3)]
    tensors = [o._data for o in outs]
    kv.pull(0, out=outs)
    for o, t in zip(outs, tensors):
        assert o._data is t and bool((t == 1).all())


def test_create_every_known_type():
    for name in mt.kvstore._KNOWN:
        kv = mt.kv.create(name)
        assert (kv.type, kv.rank, kv.num_workers) == (name, 0, 1)
    assert mt.kvstore_create is mt.kvstore.create
    assert mt.kvstore.backend() is None
    with pytest.raises(TypeError):
        mt.kvstore.create(3)


def test_server_facade_and_role(monkeypatch):
    from mxnet_tpu_torch.kvstore_server import (KVStoreServer,
                                                _init_kvstore_server_module)

    kv = mt.kvstore.create("local")
    server = KVStoreServer(kv)
    server._controller(0, pickle.dumps(mt.optimizer.create(
        "sgd", learning_rate=0.5)))
    assert kv._updater is not None and kv._optimizer.lr == 0.5
    server.run()
    with pytest.raises(mt.MXNetError):
        server._controller(42, b"")
    kv.send_command_to_servers(0, pickle.dumps(mt.optimizer.create(
        "sgd", learning_rate=0.25)))
    assert kv._optimizer.lr == 0.25
    monkeypatch.setenv("DMLC_ROLE", "server")
    with pytest.raises(mt.MXNetError, match="worker"):
        _init_kvstore_server_module()
    monkeypatch.setenv("DMLC_ROLE", "worker")
    _init_kvstore_server_module()


def test_optimizer_states_round_trip(tmp_path):
    """Save, load into a fresh store, update: equal to the JAX package
    doing the same (the state file holds the optimizer, not momenta)."""
    rng = np.random.RandomState(2)
    w0 = rng.rand(*SHAPE).astype(np.float32)
    grads = [rng.rand(*SHAPE).astype(np.float32) for _ in range(3)]

    def run(pkg, tag):
        kv = pkg.kvstore.create("local")
        kv.init(0, pkg.nd.array(w0, ctx=pkg.cpu()))
        kv.set_optimizer(pkg.optimizer.create(
            "sgd", learning_rate=0.1, momentum=0.9, rescale_grad=0.5))
        kv.push(0, pkg.nd.array(grads[0], ctx=pkg.cpu()))
        path = str(tmp_path / (tag + ".states"))
        kv.save_optimizer_states(path)
        kv2 = pkg.kvstore.create("local")
        kv2.init(0, pkg.nd.array(w0, ctx=pkg.cpu()))
        kv2.load_optimizer_states(path)
        for g in grads[1:]:
            kv2.push(0, pkg.nd.array(g, ctx=pkg.cpu()))
        out = pkg.nd.zeros(SHAPE, pkg.cpu())
        kv2.pull(0, out=out)
        return out.asnumpy(), kv2._optimizer.momentum

    (want, mj_mom), (got, mt_mom) = run(mj, "jax"), run(mt, "torch")
    assert mt_mom == mj_mom == 0.9
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("shuffle", [False, True])
def test_ndarray_iter_shards_match_jax(shuffle):
    rng = np.random.RandomState(0)
    x = rng.rand(50, 3).astype(np.float32)
    y = np.arange(50, dtype=np.float32)
    for part in range(3):
        batches = []
        for pkg in (mj, mt):
            np.random.seed(7)
            it = pkg.io.NDArrayIter(x, y, batch_size=4, shuffle=shuffle,
                                    num_parts=3, part_index=part)
            batches.append([(b.data[0].asnumpy(), b.label[0].asnumpy(),
                             b.pad) for b in it])
        assert len(batches[1]) == len(batches[0]) == 4
        for (dj, lj, pj), (dt, lt, pt) in zip(*batches):
            assert np.array_equal(dt, dj) and np.array_equal(lt, lj)
            assert pt == pj
    with pytest.raises(ValueError):
        mt.io.NDArrayIter(x, y, batch_size=4, num_parts=3, part_index=3)


def test_mnist_iter_shards_match_jax():
    labels = []
    for pkg in (mj, mt):
        np.random.seed(3)
        it = pkg.io.MNISTIter(batch_size=50, num_synthetic=300, seed=3,
                              num_parts=2, part_index=1)
        labels.append(np.concatenate([b.label[0].asnumpy() for b in it]))
    assert labels[1].shape == (150,)
    assert np.array_equal(labels[1], labels[0])


@pytest.mark.parametrize("knob", ["MXNET_KV_ELASTIC", "MXNET_KV_SHARD_UPDATE",
                                  "MXNET_KV_QUANTIZE",
                                  "MXNET_KV_BARRIER_TIMEOUT"])
def test_unported_dist_knobs_raise(monkeypatch, knob):
    monkeypatch.setenv(knob, "1")
    with pytest.raises(mt.MXNetError, match=knob):
        mt.kvstore.create("dist_sync")
    mt.kvstore.create("local")   # a local store never reads them


def test_unported_telemetry_and_heartbeats_raise(monkeypatch):
    kv = mt.kvstore.create("dist_sync")
    with pytest.raises(mt.MXNetError, match="dead_ranks"):
        kv.dead_ranks()
    # the guardian's vote and the store's counters are ported: one
    # process votes its own verdict, and MXNET_TELEMETRY builds a store
    assert kv.guardian_vote(0, True) is True
    assert kv.guardian_vote(1, False) is False
    monkeypatch.setenv("MXNET_TELEMETRY", "1")
    assert mt.kvstore.create("local").type == "local"


def test_backend_rule_without_a_card_is_gloo():
    if torch.cuda.is_available():
        pytest.skip("the rule's no-card branch")
    assert mt.kvstore._backend_rule(1) == "gloo"
    assert mt.kvstore._backend_rule(2) == "gloo"


def _launch(n, cmd, timeout=120):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "torch_launch.py"),
         "-n", str(n), "--timeout", str(timeout - 20), "--"] + cmd,
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)
    return proc, time.perf_counter() - t0


@pytest.mark.parametrize("n", [2, 3])
def test_dist_sync_arithmetic_across_processes(n):
    proc, _ = _launch(n, [sys.executable, os.path.join(
        ROOT, "tests", "torch_nightly", "dist_sync_kvstore.py"), "--ctx",
        "cpu"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    recs = [json.loads(x)["dist_sync_kvstore"]
            for x in proc.stdout.splitlines() if x.startswith("{")]
    assert sorted(r["rank"] for r in recs) == list(range(n))
    expect = (n + 1) * n / 2 * 2.0 * 4 + 1
    for r in recs:
        assert r["workers"] == n and r["backend"] == "gloo"
        assert r["value"] == expect
        assert r["all_reduces_per_bucketed_push"] == 4.0


def test_launcher_stops_the_job_when_a_worker_fails():
    body = ("import os, sys, time\n"
            "assert os.environ['MXNET_NUM_PROCS'] == '2'\n"
            "assert os.environ['MXNET_COORDINATOR'].startswith('127.0.0.1:')\n"
            "if os.environ['MXNET_PROC_ID'] == '1':\n"
            "    sys.exit(1)\n"
            "time.sleep(100)\n")
    proc, wall = _launch(2, [sys.executable, "-c", body])
    assert proc.returncode == 1, proc.stderr
    assert "worker 1 exited 1" in proc.stderr
    assert wall < 60
