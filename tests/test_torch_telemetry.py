"""mxnet_tpu_torch's telemetry core against the JAX package's.

- the registry: counters, gauges, histogram buckets and quantiles equal
  the JAX registry's for the same observations; Prometheus text and the
  console summary are byte-equal;
- the journal: the same records give lines of the same ``kind``s and
  keys;
- spans: nesting, trace ids, ``wire_context`` and ``event`` behave as
  the JAX package's; with telemetry off ``span()`` is the shared null
  context; while the port's profiler captures, a span lands in the
  torch trace;
- the serving fleet's catalog: one scenario (two replicas behind a
  router, a weight sync, a replica killed mid-stream) gives the JAX
  package's ``serving.*``, ``wsync.*`` and ``fleet.*`` metric names and
  the same span names, and ``chip_smoke.TELEMETRY_CATALOG`` is that set;
- the HTTP server's endpoints (``/profilez`` from mxprof, ``/enginez``
  from the dependency engine), ``MXNET_PROF`` switching mxprof on at
  ``reload()``, and the fault and retry copies counting their fires.

The tiny model is the JAX package's fleet tests' (vocab 61, 2 layers,
d_model 32, f32), its parameters carried across with
``params_from_numpy``.
"""
import json
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest

import mxnet_tpu as mj
import mxnet_tpu.telemetry as jtel
import mxnet_tpu_torch as mt
from mxnet_tpu.models import transformer as jt
from mxnet_tpu.serving import Engine as JEngine
from mxnet_tpu.serving import ServingConfig as JServingConfig
from mxnet_tpu.serving.fleet import ReplicaServer as JReplicaServer
from mxnet_tpu.serving.fleet import Router as JRouter
from mxnet_tpu.telemetry.registry import Registry as JRegistry
from mxnet_tpu.wsync.publisher import WeightPublisher as JPublisher
from mxnet_tpu.wsync.subscriber import WeightSubscriber as JSubscriber
from mxnet_tpu_torch import telemetry as tel
from mxnet_tpu_torch.models import transformer as tt
from mxnet_tpu_torch.serving import Engine, ServingConfig
from mxnet_tpu_torch.serving.fleet import ReplicaServer, Router
from mxnet_tpu_torch.telemetry.registry import Registry
from mxnet_tpu_torch.wsync.publisher import WeightPublisher
from mxnet_tpu_torch.wsync.subscriber import WeightSubscriber

ROOT = Path(__file__).resolve().parents[1]
MODEL = dict(vocab_size=61, num_layers=2, d_model=32, num_heads=2, d_ff=64,
             max_seq_len=96, dtype="float32")
POOL = dict(block_size=8, num_blocks=97, max_batch=4, prefill_chunk=16)
UNPORTED = ("MXNET_ENGINE_VERIFY", "MXNET_PROF")


@pytest.fixture(scope="module", autouse=True)
def _unported_switches_off():
    """The suite's conftest arms the JAX package's lock tracer; the
    port's Engine refuses it (the compile verifier is ported)."""
    with pytest.MonkeyPatch.context() as mp:
        for name in UNPORTED:
            mp.delenv(name, raising=False)
        yield


@pytest.fixture()
def both_on(monkeypatch, tmp_path):
    """Telemetry on in both packages, each journaling to its own file;
    both are reset and re-read from the restored environment after."""
    paths = {"jax": tmp_path / "jax.jsonl", "port": tmp_path / "port.jsonl"}
    monkeypatch.setenv("MXNET_TELEMETRY", "1")
    for pkg, t in (("jax", jtel), ("port", tel)):
        monkeypatch.setenv("MXNET_TELEMETRY_JOURNAL", str(paths[pkg]))
        t.reset()
        assert t.reload() is True
    yield paths
    monkeypatch.undo()
    for t in (jtel, tel):
        t.reset()
        t.reload()


# -- the registry ------------------------------------------------------------------
def _observe(reg_cls, values):
    reg = reg_cls()
    c = reg.counter("a.count")
    c.inc()
    c.inc(4)
    g = reg.gauge("a.depth")
    g.set(3)
    g.inc(2.5)
    g.dec()
    small = reg.histogram("h.small", capacity=64)
    big = reg.histogram("h.big")
    for v in values:
        small.observe(v)
        big.observe(v)
    return reg


@pytest.mark.parametrize("n", [0, 1, 7, 300])
def test_registry_matches_jax(n):
    rng = np.random.RandomState(n)
    # include values exactly on the bucket bounds
    values = list(np.abs(rng.lognormal(-4, 2.5, n)))
    values += list(JRegistry().histogram("x").BOUNDS[:min(n, 17)])
    jreg, treg = _observe(JRegistry, values), _observe(Registry, values)
    assert treg.snapshot() == jreg.snapshot()
    for name in ("h.small", "h.big"):
        th, jh = treg.histogram(name), jreg.histogram(name)
        assert th.bucket_counts() == jh.bucket_counts()
        assert th.percentiles((1.0, 33.3, 50.0, 99.9)) == jh.percentiles(
            (1.0, 33.3, 50.0, 99.9))
        assert th.percentile(77.0) == jh.percentile(77.0)
    with pytest.raises(TypeError) as te:
        treg.gauge("a.count")
    with pytest.raises(TypeError) as je:
        jreg.gauge("a.count")
    assert str(te.value) == str(je.value)


def test_prometheus_text_and_console_summary_byte_equal():
    try:
        for t in (jtel, tel):
            t.reset()
            t.counter("serving.requests_admitted").inc(3)
            t.gauge("fleet.queue_depth").set(2.5)
            h = t.histogram("serving.ttft_s")
            for v in (0.0004, 0.003, 0.2, 7.5, 400.0):
                h.observe(v)
            t.histogram("wsync.apply_secs")   # an empty histogram
        assert tel.prometheus_text() == jtel.prometheus_text()
        assert "mxtpu_serving_ttft_s_bucket" in tel.prometheus_text()
        assert tel.console_summary() == jtel.console_summary()
    finally:
        for t in (jtel, tel):
            t.reset()


# -- journal and spans -----------------------------------------------------------------
def _span_program(t):
    """The same span/event sequence in either package; returns what it
    observed, with span ids renumbered by first appearance."""
    out = {}
    with t.span("outer") as o:
        out["wire_outer"] = t.wire_context()
        with t.span("inner") as i:
            out["current"] = t.current_span() == i.id
            out["open"] = [r["name"] for r in t.open_spans()]
        box = {}

        def worker():
            with t.span("thread", parent=o.id) as th:
                box["parent"] = th.parent
                box["trace"] = th.trace
        w = threading.Thread(target=worker)
        w.start()
        w.join()
        out["thread_inherits"] = (box["parent"] == o.id,
                                  box["trace"] == o.trace)
        ctx = t.wire_context()
    with t.span("remote", wire=ctx) as r:
        out["remote"] = (r.trace == ctx["trace"],
                         r.remote_parent == ctx["span"], r.parent is None)
    t.event("lifecycle", t=1.5, dur=0.25, trace="abc", rid=7)
    out["none_outside"] = t.wire_context()
    tail = t.span_tail()
    ids = {}
    for rec in tail:
        ids.setdefault(rec["id"], len(ids))
    out["tail"] = [(rec["name"], ids[rec["id"]],
                    ids.get(rec["parent"]) if rec["parent"] else None,
                    sorted(rec)) for rec in tail]
    out["traces_shared"] = len({rec["trace"] for rec in tail
                                if rec["name"] != "lifecycle"})
    out["agg"] = {k: v["count"] for k, v in t.span_aggregates().items()}
    out["wire_keys"] = sorted(out.pop("wire_outer"))
    return out


def test_spans_trace_ids_and_wire_context_match_jax(both_on):
    assert _span_program(tel) == _span_program(jtel)


def test_journal_records_have_the_jax_kinds_and_keys(both_on):
    for t in (jtel, tel):
        _span_program(t)
        t.counter("serving.requests_admitted").inc()
        t.flush(mark="probe")
    recs = {}
    for pkg, path in both_on.items():
        recs[pkg] = [json.loads(line) for line in
                     path.read_text().splitlines() if line.strip()]
    shape = {pkg: [(r["kind"], r.get("name"), sorted(r)) for r in rs]
             for pkg, rs in recs.items()}
    assert shape["port"] == shape["jax"]
    assert [r["kind"] for r in recs["port"]][0] == "meta"
    assert recs["port"][-1]["mark"] == "probe"
    assert (recs["port"][-1]["counters"]
            == recs["jax"][-1]["counters"])


def test_disabled_span_is_the_shared_null_context(monkeypatch):
    monkeypatch.delenv("MXNET_TELEMETRY", raising=False)
    tel.reload()
    assert not tel.ENABLED
    a, b = tel.span("x"), tel.span("y")
    assert a is b is tel.tracing._NULL
    with a:
        pass
    assert tel.event("e") is None and tel.span_tail() == []


def test_span_lands_in_the_port_profilers_trace(monkeypatch, tmp_path):
    from mxnet_tpu_torch import profiler

    monkeypatch.setenv("MXNET_TELEMETRY", "1")
    tel.reload()
    try:
        profiler.profiler_set_config(filename=str(tmp_path / "trace"))
        profiler.profiler_set_state("run")
        with tel.span("mxtel.probe.span"):
            sum(range(1000))
        profiler.profiler_set_state("stop")
        assert "mxtel.probe.span" in Path(profiler.last_trace()).read_text()
    finally:
        monkeypatch.undo()
        tel.reset()
        tel.reload()


def test_mxnet_prof_is_refused(monkeypatch):
    # mxprof is ported: reload() turns it on instead of refusing
    monkeypatch.setenv("MXNET_PROF", "1")
    try:
        assert tel.reload() is not None and tel.prof.ENABLED
    finally:
        monkeypatch.undo()
        tel.reload()
    assert not tel.prof.ENABLED


# -- the serving fleet's catalog -----------------------------------------------------------
def _np_params(seed=0):
    rng = np.random.RandomState(seed)
    d, f = MODEL["d_model"], MODEL["d_ff"]

    def dense(shape, scale=None):
        scale = 1.0 / np.sqrt(shape[0]) if scale is None else scale
        return (rng.randn(*shape) * scale).astype(np.float32)

    def ln():
        return {"scale": np.ones(d, np.float32),
                "bias": np.zeros(d, np.float32)}

    return {"embed": dense((MODEL["vocab_size"], d), 0.02),
            "pos_embed": dense((MODEL["max_seq_len"], d), 0.02),
            "ln_f": ln(),
            "layers": [{"ln1": ln(), "wqkv": dense((d, 3 * d)),
                        "wo": dense((d, d)), "ln2": ln(),
                        "w1": dense((d, f)), "w2": dense((f, d))}
                       for _ in range(MODEL["num_layers"])]}


class _Dead:
    def __getattr__(self, _):
        def boom(*a, **k):
            raise ConnectionError("killed")
        return boom


def _fleet_scenario(pkg):
    """chip_smoke.py leg D's shape at the tiny size: two engines behind
    replicas and a router, engine 0 synced to the same weights published
    as version 1, four greedy requests, replica 0 killed mid-stream.
    Returns the streams and the registry's names and span names."""
    tree = _np_params(0)
    if pkg == "jax":
        params = jax.tree_util.tree_map(jax.numpy.asarray, tree)
        mk = lambda: JEngine(params, jt.TransformerConfig(**MODEL),  # noqa
                             JServingConfig(**POOL))
        rep_cls, router_cls = JReplicaServer, JRouter
        pub_cls, sub_cls, t = JPublisher, JSubscriber, jtel
    else:
        params = tt.params_from_numpy(tree, device="cpu")
        mk = lambda: Engine(params, tt.TransformerConfig(**MODEL),  # noqa
                            ServingConfig(**POOL), device="cpu")
        rep_cls, router_cls = ReplicaServer, Router
        pub_cls, sub_cls, t = WeightPublisher, WeightSubscriber, tel
    engines = [mk(), mk()]
    pub = pub_cls(bind=("127.0.0.1", 0))
    pub.start()
    try:
        pub.publish(params)
        sub = sub_cls(engines[0], "%s:%d" % tuple(pub.addr[:2]))
        assert sub.sync_once(wait=5.0) == 1
    finally:
        pub.close()
    router = router_cls(bind=None, health_interval=0.05)
    for i, e in enumerate(engines):
        router.register_local("rep%d" % i,
                              rep_cls(e, name="rep%d" % i, bind=None))
    prompts = [np.arange(1 + i, 9 + 2 * i, dtype=np.int32) for i in range(4)]
    streams = [router.submit(p, max_new_tokens=10) for p in prompts]
    deadline = time.monotonic() + 60
    victim = router._replicas["rep0"]
    while time.monotonic() < deadline:
        router.step()
        for e in engines:
            e.step()
        if any(len(router._requests[s.rid].tokens) >= 2
               for s in streams if s.rid in router._requests
               and router._requests[s.rid].replica == "rep0"):
            break
    victim.client = _Dead()
    victim.last_scrape_t = 0.0
    while router._requests and time.monotonic() < deadline:
        router.step()
        engines[1].step()
    out = [s.result(timeout=5) for s in streams]
    engines[0].rollback_weights()
    snap = t.snapshot()
    names = {n for kind in ("counters", "gauges", "histograms")
             for n in snap[kind]
             if n.split(".")[0] in ("serving", "wsync", "fleet")}
    spans = {r["name"] for r in t.span_tail()}
    return out, names, spans, router.stats()


def test_fleet_scenario_catalog_equals_jax(monkeypatch):
    monkeypatch.setenv("MXNET_TELEMETRY", "1")
    monkeypatch.setenv("MXNET_WSYNC_TTFT_WINDOW", "30")
    got = {}
    try:
        for pkg, t in (("jax", jtel), ("port", tel)):
            t.reset()
            t.reload()
            got[pkg] = _fleet_scenario(pkg)
    finally:
        monkeypatch.undo()
        for t in (jtel, tel):
            t.reset()
            t.reload()
    (jout, jnames, jspans, jst), (tout, tnames, tspans, tst) = (
        got["jax"], got["port"])
    assert tout == jout
    assert jst["evictions"] == tst["evictions"] == 1
    assert tst["redelivered"] >= 1
    assert tnames == jnames
    assert tspans == jspans
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    assert set(chip_smoke.TELEMETRY_CATALOG) == jnames


# -- the HTTP server ----------------------------------------------------------------------
def _get(port, path):
    try:
        with urllib.request.urlopen("http://127.0.0.1:%d%s" % (port, path),
                                    timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_http_endpoints(monkeypatch):
    monkeypatch.setenv("MXNET_TELEMETRY", "1")
    monkeypatch.setenv("MXNET_TELEMETRY_HTTP", "127.0.0.1:0")
    tel.reset()
    tel.reload()
    try:
        port = tel.server.port()
        assert port and tel.server.running()
        eng = Engine(tt.params_from_numpy(_np_params(0), device="cpu"),
                     tt.TransformerConfig(**MODEL), ServingConfig(**POOL),
                     device="cpu")
        eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=33)
        assert _get(port, "/healthz") == (200, "ok\n")
        # readiness is every live engine's: judge this one's by its id
        me = "serving engine %#x draining" % id(eng)
        assert me not in _get(port, "/readyz")[1]
        code, body = _get(port, "/servingz")
        # engines of earlier tests may still be alive in this process
        mine = [e for e in json.loads(body)["engines"]
                if any(r["state"] == "queued" and r["prompt_len"] == 5
                       and r["max_new_tokens"] == 33
                       for r in e["requests"])]
        assert code == 200 and len(mine) >= 1
        assert set(mine[0]) == set(eng.introspect())
        eng.run_until_idle()
        code, body = _get(port, "/metrics")
        assert code == 200
        assert "mxtpu_serving_requests_admitted 1" in body
        assert "mxtpu_serving_ttft_s_count 1" in body
        assert "mxtpu_serving_requests_completed 1" in body
        eng.drain()
        code, body = _get(port, "/readyz")
        assert code == 503 and me in body
        eng.resume()
        code, body = _get(port, "/profilez")
        assert code == 200 and set(json.loads(body)) == {
            "enabled", "config_key", "programs", "steps", "derived", "hbm"}
        code, body = _get(port, "/enginez")
        assert code == 200
        eng_body = json.loads(body)
        assert eng_body == {"engine": None} or {
            "pending", "queued", "in_flight", "engine", "native",
            "counters"} <= set(eng_body)
        code, body = _get(port, "/statusz")
        st = json.loads(body)
        # the verifier's summary when it is armed (the suite's conftest
        # arms it in record mode)
        from mxnet_tpu_torch.analysis import compile_verify as cv

        assert code == 200 and (st["jit_verify"] is None) == (
            not cv.ENABLED)
        if cv.ENABLED:
            assert set(st["jit_verify"]) == set(cv.summary())
        assert {"pid", "rank", "world", "uptime_s", "server_uptime_s",
                "journal", "jit_cache_dir", "compile", "env"} <= set(st)
        code, body = _get(port, "/tracez?n=5")
        assert code == 200 and set(json.loads(body)) == {
            "open", "recent", "aggregates"}
        assert len(json.loads(body)["recent"]) <= 5
        assert _get(port, "/nope")[0] == 404
        tel.server.mark_ready(False, "stopping")
        assert _get(port, "/readyz")[0] == 503
        tel.server.mark_ready(True)
    finally:
        monkeypatch.undo()
        tel.reset()
        tel.reload()
    assert not tel.server.running()


# -- resilience copies --------------------------------------------------------------------
def test_fault_point_and_retry_count_their_fires(monkeypatch):
    from mxnet_tpu_torch.resilience import faults
    from mxnet_tpu_torch.wsync.client import WsyncClient

    monkeypatch.setenv("MXNET_TELEMETRY", "1")
    tel.reset()
    tel.reload()
    pub = WeightPublisher(bind=("127.0.0.1", 0))
    pub.start()
    try:
        faults.inject("kv.coord:error:count=1")
        client = WsyncClient("%s:%d" % tuple(pub.addr[:2]))
        client._policy._sleep = lambda s: None
        assert client.poll_version(0)["status"] == "pending"
        c = tel.snapshot()["counters"]
        assert c["faults.fired_total"] == 1
        assert c["faults.fired.kv.coord"] == 1
        assert c["retry.retries_total"] == 1
        from mxnet_tpu.resilience import faults as jfaults

        spec = "x:error:p=0.5:seed=7:skip=2:count=5"
        assert faults.fire_pattern(spec, 40) == jfaults.fire_pattern(
            spec, 40)
    finally:
        faults.clear()
        pub.close()
        monkeypatch.undo()
        tel.reset()
        tel.reload()


# -- the training path's counters -----------------------------------------------------------
def _metric_names(t):
    snap = t.snapshot()
    return {k: set(snap[k]) for k in ("counters", "gauges", "histograms")}


def _train_and_serve(pkg, tiny_engine):
    """A LeNet fit on each path, a dependency-engine task and a served
    request, with telemetry on."""
    rng = np.random.RandomState(4)
    x = rng.rand(64, 1, 28, 28).astype(np.float32)
    y = rng.randint(0, 10, 64).astype(np.float32)
    for scan in ("1", "0"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("MXNET_SCAN_TRAIN", scan)
            mp.setenv("MXNET_TRAIN_SCAN_K", "2")
            pkg.random.seed(0)
            m = pkg.FeedForward(pkg.models.get_lenet(), ctx=pkg.cpu(),
                                num_epoch=1, learning_rate=0.05,
                                numpy_batch_size=16,
                                initializer=pkg.initializer.Xavier())
            m.fit(pkg.io.NDArrayIter(x, y, batch_size=16),
                  batch_end_callback=pkg.callback.Speedometer(16, 2))
    eng = pkg.engine.Engine.get()
    var = eng.new_variable()
    eng.push(lambda: None, mutable_vars=[var])
    eng.wait_for_var(var)
    eng.wait_for_all()
    tiny_engine()


def test_training_and_serving_metric_names_equal_jax(both_on):
    def serve(pkg):
        tree = _np_params(0)
        if pkg == "jax":
            eng = JEngine(jax.tree_util.tree_map(jax.numpy.asarray, tree),
                          jt.TransformerConfig(**MODEL),
                          JServingConfig(**POOL))
        else:
            eng = Engine(tt.params_from_numpy(tree, device="cpu"),
                         tt.TransformerConfig(**MODEL), ServingConfig(**POOL),
                         device="cpu")
        eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=4)
        eng.run_until_idle()

    _train_and_serve(mj, lambda: serve("jax"))
    _train_and_serve(mt, lambda: serve("port"))
    want, got = _metric_names(jtel), _metric_names(tel)
    for kind in want:
        assert got[kind] == want[kind], (kind, got[kind] ^ want[kind])


def test_training_path_counters_under_telemetry(both_on, tmp_path):
    """MXNET_TELEMETRY=1 on the executor, the fits, io.py, recordio.py,
    the kvstore and the dependency engine: each reports its metrics (the
    port once ignored the switch there without a word)."""
    _train_and_serve(mt, lambda: None)
    rec = mt.recordio.MXRecordIO(str(tmp_path / "r.rec"), "w")
    rec.write(b"abcd" * 4)
    rec.close()
    raw = bytearray((tmp_path / "r.rec").read_bytes())
    raw[0] ^= 0xFF           # break the record's magic
    (tmp_path / "r.rec").write_bytes(bytes(raw))
    r = mt.recordio.MXRecordIO(str(tmp_path / "r.rec"), "r", corrupt="skip")
    assert r.read() is None and r.num_skipped == 1
    kv = mt.kvstore.create("local")
    kv.init(3, mt.nd.ones((2, 2), ctx=mt.cpu()))
    kv.push(3, [mt.nd.ones((2, 2), ctx=mt.cpu())] * 2)
    kv.pull(3, out=mt.nd.zeros((2, 2), ctx=mt.cpu()))
    names = _metric_names(tel)
    assert {"executor.jit_builds_total", "engine.push_total",
            "engine.waits_total", "io.records_skipped_total",
            "kvstore.push_total", "kvstore.pull_total",
            "kvstore.push_bytes_total"} <= names["counters"]
    assert {"train.samples_per_sec", "engine.queue_depth"} <= names["gauges"]
    assert {"executor.forward_secs", "executor.backward_secs",
            "train.step_secs", "io.batch_fetch_secs",
            "engine.task_secs"} <= names["histograms"]
    spans = {s["name"] for s in tel.span_tail(10000)}
    assert {"epoch", "batch", "chunk"} <= spans


def test_fault_points_of_the_training_path(tmp_path):
    """``rio.read``, ``ckpt.write`` and ``engine.task`` fire where the JAX
    package's do: before a record's read (which then still succeeds),
    between a checkpoint's temporary file and its rename (no
    ``.params`` left behind), and before a dependency-engine task's
    body (raised at the wait)."""
    from mxnet_tpu_torch.resilience import faults

    path = tmp_path / "a.rec"
    w = mt.recordio.MXRecordIO(str(path), "w")
    w.write(b"x" * 8)
    w.close()
    try:
        faults.inject("rio.read:error:count=1")
        r = mt.recordio.MXRecordIO(str(path), "r")
        with pytest.raises(faults.FaultInjected):
            r.read()
        assert r.read() == b"x" * 8
        prefix = str(tmp_path / "m")
        args = {"w": mt.nd.ones((2,), ctx=mt.cpu())}
        faults.inject("ckpt.write:error:count=1")
        with pytest.raises(faults.FaultInjected):
            mt.model.save_checkpoint(prefix, 1, None, args, {}, sync=True)
        assert not Path(prefix + "-0001.params").exists()
        mt.model.save_checkpoint(prefix, 1, None, args, {}, sync=True)
        assert Path(prefix + "-0001.params").exists()
        eng = mt.engine.Engine.get()
        var = eng.new_variable()
        faults.inject("engine.task:error:count=1")
        eng.push(lambda: None, mutable_vars=[var])
        with pytest.raises(faults.FaultInjected):
            eng.wait_for_var(var)
    finally:
        faults.clear()


def test_engine_wait_watchdog_dumps_the_pending_tasks(monkeypatch):
    """``MXNET_ENGINE_WAIT_TIMEOUT`` bounds a wait behind a task that has
    not completed: the wait raises the pending-task dump naming it, and
    ``pending_snapshot`` (``/enginez``'s body) lists it in flight."""
    eng = mt.engine.Engine.get()
    var = eng.new_variable()
    release = threading.Event()

    def stuck_task(on_complete):
        def later():
            release.wait(20)
            on_complete()

        threading.Thread(target=later, daemon=True).start()

    eng.push_async(stuck_task, mutable_vars=[var])
    monkeypatch.setenv("MXNET_ENGINE_WAIT_TIMEOUT", "0.3")
    try:
        with pytest.raises(mt.MXNetError, match="in-flight: stuck_task"):
            eng.wait_for_var(var)
        with pytest.raises(mt.MXNetError, match="MXNET_ENGINE_WAIT_TIMEOUT"):
            eng.wait_for_all()
        snap = eng.pending_snapshot()
        assert "stuck_task" in snap["in_flight"] and snap["pending"] >= 1
    finally:
        release.set()
        monkeypatch.delenv("MXNET_ENGINE_WAIT_TIMEOUT")
        eng.wait_for_all()
    assert eng.pending_snapshot()["in_flight"] == []
