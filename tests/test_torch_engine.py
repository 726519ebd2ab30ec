"""The port's dependency engine, async checkpoints and training callbacks,
on the CPU.

- the ordering rules of ``tests/unittest/test_engine.py`` against the
  port's engine (``csrc/engine.cc`` built with ``g++``), threaded and
  naive: program order on a variable, reads that overlap, a write alone
  and after the reads before it, later reads after the write,
  ``wait_for_var``, ``push_async``, a duplicate variable refused, a
  task's exception raised at the wait (the engine still usable after),
  deferred ``delete_variable``, and random read/write workloads equal
  to a sequential run;
- a failed build raises ``MXNetError`` (a compiler that is not there),
  also from ``Engine()``: there is no fallback;
- an async ``save_checkpoint`` writes the bytes of a sync one and of the
  JAX package's; ``keep_n`` leaves the JAX package's epochs on disk;
  ``load_checkpoint`` and ``nd.waitall`` fence a write in flight; a
  failed write surfaces at ``fit``'s end; ``do_checkpoint(keep_n=)``;
- ``log_train_metric`` and ``ProgressBar`` log the JAX package's lines;
  ``FeedForward.create``, ``fit(monitor=, work_load_list=)``.
"""
import logging
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import engine as eng

MODES = ["ThreadedEngine", "NaiveEngine"]


@pytest.fixture(params=MODES)
def engine(request):
    e = eng.Engine(engine_type=request.param)
    yield e
    e.close()


def test_push_and_wait_in_program_order(engine):
    v = engine.new_variable()
    out = []
    for i in range(6):
        engine.push(lambda i=i: (time.sleep(0.002), out.append(i)),
                    mutable_vars=[v])
    engine.wait_for_var(v)
    assert out == list(range(6))
    engine.wait_for_all()


def test_write_after_read_ordering(engine):
    """Reads granted before a write drain before it runs; the write
    finishes before later reads (threaded_engine.h:87-189)."""
    v = engine.new_variable()
    log = []
    lock = threading.Lock()

    def op(tag, delay):
        def fn():
            time.sleep(delay)
            with lock:
                log.append(tag)
        return fn

    for i in range(4):
        engine.push(op("r1", 0.02), const_vars=[v])
    engine.push(op("w", 0.0), mutable_vars=[v])
    for i in range(4):
        engine.push(op("r2", 0.0), const_vars=[v])
    engine.wait_for_all()
    assert log == ["r1"] * 4 + ["w"] + ["r2"] * 4


def test_concurrent_reads_overlap():
    e = eng.Engine(engine_type="ThreadedEngine")
    v = e.new_variable()
    barrier = threading.Barrier(2, timeout=10)
    e.push(barrier.wait, const_vars=[v])
    e.push(barrier.wait, const_vars=[v])
    e.wait_for_all()
    e.close()


def test_duplicate_var_is_error(engine):
    v = engine.new_variable()
    with pytest.raises(mt.MXNetError, match="duplicate"):
        engine.push(lambda: None, const_vars=[v], mutable_vars=[v])
    engine.wait_for_all()


def test_async_push(engine):
    """PushAsync: completion is signalled by the op, not by return
    (ref: engine.h:142-146)."""
    v = engine.new_variable()
    fired, saw = [], []

    def fn(on_complete):
        def later():
            time.sleep(0.05)
            fired.append(True)
            on_complete()
        threading.Thread(target=later).start()

    engine.push_async(fn, mutable_vars=[v])
    engine.push(lambda: saw.append(bool(fired)), const_vars=[v])
    engine.wait_for_all()
    assert saw == [True]


def test_exception_surfaces_at_the_wait(engine):
    v = engine.new_variable()

    def bad():
        raise ValueError("boom")

    engine.push(bad, mutable_vars=[v])
    with pytest.raises(ValueError, match="boom"):
        engine.wait_for_var(v)
    engine.push(bad, mutable_vars=[v])
    with pytest.raises(ValueError, match="boom"):
        engine.wait_for_all()
    out = []
    engine.push(lambda: out.append(1), mutable_vars=[v])
    engine.wait_for_all()   # still usable
    assert out == [1]


def test_delete_variable_deferred(engine):
    v = engine.new_variable()
    out = []
    engine.push(lambda: (time.sleep(0.02), out.append(1)), mutable_vars=[v])
    engine.delete_variable(v)   # must not tear down the pending op
    engine.wait_for_all()
    assert out == [1]
    with pytest.raises(mt.MXNetError, match="after delete_variable"):
        engine.push(lambda: None, mutable_vars=[v])


def test_random_workloads_equal_a_sequential_run(engine):
    rng = np.random.RandomState(0)
    n_vars = 8
    for _ in range(3):
        ops = []
        for _ in range(100):
            w = int(rng.randint(n_vars))
            reads = [int(r) for r in rng.choice(
                [i for i in range(n_vars) if i != w],
                size=int(rng.randint(0, 4)), replace=False)]
            ops.append((reads, w))
        expect = np.zeros(n_vars)
        for idx, (reads, w) in enumerate(ops):
            expect[w] = sum(expect[r] for r in reads) + idx
        vals = np.zeros(n_vars)
        hv = [engine.new_variable() for _ in range(n_vars)]

        def make(reads, w, idx):
            def fn():
                vals[w] = sum(vals[r] for r in reads) + idx
            return fn

        for idx, (reads, w) in enumerate(ops):
            engine.push(make(reads, w, idx),
                        const_vars=[hv[r] for r in reads],
                        mutable_vars=[hv[w]])
        engine.wait_for_all()
        np.testing.assert_array_equal(vals, expect)


def test_singleton_and_module_api(monkeypatch):
    monkeypatch.setattr(eng.Engine, "_instance", None)
    e = eng.get()
    assert e is eng.Engine.get() and e.is_native
    out = []
    eng.push(lambda: out.append(1))
    eng.wait_for_all()
    assert out == [1]
    e.close()


def test_failed_build_raises(tmp_path, monkeypatch):
    with pytest.raises(mt.MXNetError, match="not found"):
        eng.build(build_dir=tmp_path, cxx="/nonexistent/g++")
    monkeypatch.setattr(eng, "BUILD_DIR", tmp_path / "fresh")
    monkeypatch.setattr(eng, "_lib", None)
    monkeypatch.setenv("CXX", "/nonexistent/g++")
    with pytest.raises(mt.MXNetError, match="cannot build"):
        eng.Engine(engine_type="NaiveEngine")
    (tmp_path / "cxx").write_text("#!/bin/sh\necho 'bad flag' >&2\nexit 1\n")
    (tmp_path / "cxx").chmod(0o755)
    with pytest.raises(mt.MXNetError, match="bad flag"):
        eng.build(build_dir=tmp_path / "other", cxx=str(tmp_path / "cxx"))


def _params(pkg, seed=0):
    rng = np.random.RandomState(seed)
    arg = {"fc_weight": rng.rand(4, 3).astype(np.float32),
           "fc_bias": rng.rand(4).astype(np.float32)}
    aux = {"bn_moving_mean": rng.rand(4).astype(np.float32)}
    return ({k: pkg.nd.array(v, ctx=pkg.cpu()) for k, v in arg.items()},
            {k: pkg.nd.array(v, ctx=pkg.cpu()) for k, v in aux.items()})


def _sym(pkg):
    with pkg.NameManager():
        return pkg.sym.FullyConnected(pkg.sym.Variable("data"),
                                      num_hidden=4, name="fc")


def test_async_checkpoint_bytes_equal_sync_and_jax(tmp_path):
    files = {}
    for tag, pkg, kw in (("async", mt, {}), ("sync", mt, {"sync": True}),
                         ("jax", mj, {"sync": True})):
        prefix = str(tmp_path / tag / "m")
        (tmp_path / tag).mkdir()
        arg, aux = _params(pkg)
        pkg.model.save_checkpoint(prefix, 3, _sym(pkg), arg, aux, **kw)
        if tag == "async":
            # updates after the call must not reach the file
            arg["fc_bias"][:] = 0.0
        pkg.model.fence_checkpoint(prefix)
        files[tag] = [open(prefix + s, "rb").read()
                      for s in ("-0003.params", "-symbol.json")]
    assert files["async"] == files["sync"] == files["jax"]


def test_keep_n_leaves_the_jax_epochs(tmp_path):
    kept = {}
    for tag, pkg in (("torch", mt), ("jax", mj)):
        d = tmp_path / tag
        d.mkdir()
        prefix = str(d / "m")
        (d / "m-0001.params.tmp-99").write_bytes(b"stranded")
        (d / "m-0001.states").write_bytes(b"states")
        (d / "m-ft-0009.params").write_bytes(b"a sibling run's")
        arg, aux = _params(pkg)
        cb = pkg.callback.do_checkpoint(prefix, keep_n=2)
        assert cb.prefix == prefix
        for epoch in range(5):
            cb(epoch, _sym(pkg), arg, aux)
        pkg.model.fence_checkpoint(prefix)
        kept[tag] = sorted(p.name for p in d.iterdir())
    assert kept["torch"] == kept["jax"] == [
        "m-0004.params", "m-0005.params", "m-ft-0009.params",
        "m-symbol.json"]


def test_load_checkpoint_and_waitall_fence_a_write_in_flight(tmp_path,
                                                             monkeypatch):
    real = mt.model._write_params_atomic

    def slow(name, save_dict):
        time.sleep(0.3)
        real(name, save_dict)

    monkeypatch.setattr(mt.model, "_write_params_atomic", slow)
    prefix = str(tmp_path / "m")
    arg, aux = _params(mt)
    mt.model.save_checkpoint(prefix, 1, _sym(mt), arg, aux)
    _, arg2, aux2 = mt.model.load_checkpoint(prefix, 1)
    np.testing.assert_array_equal(arg2["fc_weight"].asnumpy(),
                                  arg["fc_weight"].asnumpy())
    mt.model.save_checkpoint(prefix, 2, _sym(mt), arg, aux)
    mt.nd.waitall()
    assert (tmp_path / "m-0002.params").exists()
    assert mt.model.find_latest_checkpoint(prefix) == 2


def _digits(n=32, seed=0):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 4, n).astype(np.float32)
    x = rng.rand(n, 10).astype(np.float32) * 0.1
    x[np.arange(n), y.astype(int)] += 1.0
    return x, y


def _mlp(pkg):
    with pkg.NameManager():
        net = pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=4,
                                     name="fc")
        return pkg.sym.SoftmaxOutput(net, name="softmax")


def test_failed_async_write_surfaces_at_fit_end(tmp_path, monkeypatch):
    def broken(name, save_dict):
        raise OSError("disk full")

    monkeypatch.setattr(mt.model, "_write_params_atomic", broken)
    x, y = _digits()
    model = mt.FeedForward(_mlp(mt), ctx=mt.cpu(), num_epoch=1,
                           learning_rate=0.1)
    with pytest.raises(OSError, match="disk full"):
        model.fit(mt.io.NDArrayIter(x, y, batch_size=8),
                  epoch_end_callback=mt.callback.do_checkpoint(
                      str(tmp_path / "m")))


def _batch_param(pkg, nbatch):
    metric = pkg.metric.create("acc")
    metric.update([pkg.nd.array(np.array([0.0, 1.0]), ctx=pkg.cpu())],
                  [pkg.nd.array(np.array([[0.9, 0.1], [0.8, 0.2]]),
                                ctx=pkg.cpu())])
    return pkg.model.BatchEndParam(epoch=2, nbatch=nbatch,
                                   eval_metric=metric, locals={})


def test_log_train_metric_and_progress_bar_log_the_jax_lines(caplog):
    lines = {}
    for tag, pkg in (("torch", mt), ("jax", mj)):
        caplog.clear()
        with caplog.at_level(logging.INFO):
            cb = pkg.callback.log_train_metric(2, auto_reset=True)
            bar = pkg.callback.ProgressBar(total=7, length=20)
            for nbatch in range(5):
                param = _batch_param(pkg, nbatch)
                cb(param)
                bar(param)
        lines[tag] = [r.getMessage() for r in caplog.records]
    assert lines["torch"] == lines["jax"]
    assert len(lines["torch"]) == 8


def test_create_monitor_and_work_load_list(tmp_path):
    x, y = _digits()
    it = mt.io.NDArrayIter(x, y, batch_size=8)
    with mt.cpu():
        model = mt.FeedForward.create(_mlp(mt), it, ctx=mt.cpu(),
                                      num_epoch=2, learning_rate=0.5,
                                      work_load_list=[1])
    assert model.score(it) > 0.9
    seen = []
    mon = mt.Monitor(1)
    mon.toc_print = lambda: seen.append(len(mon.toc()))
    model = mt.FeedForward(_mlp(mt), ctx=mt.cpu(), num_epoch=1,
                           learning_rate=0.1)
    model.fit(it, monitor=mon)
    assert len(seen) == 4 and all(n > 0 for n in seen), seen
    with pytest.raises(mt.MXNetError, match="work_load_list"):
        model.fit(it, work_load_list=[1, 1])
