"""mxnet_tpu_torch's serving fleet and the Engine's drain against the JAX
package's.

The model is the JAX package's fleet tests' tiny LM (vocab 61, 2
layers, d_model 32, f32), its parameters made with numpy in the JAX
layout and carried across with ``params_from_numpy``; the JAX greedy
references are computed once for the module.

- the JAX ``test_fleet.py`` router cases (placement, affinity,
  backpressure, failover, re-registration, leave, cancel, the direct
  client) as parametrised cases over the same deterministic stub
  replica, in the port alone;
- the Engine's satellites: ``QueueFullError``'s payload, the idle-stream
  reaper, the redelivery prefix (byte-equal to the JAX engine's greedy
  stream);
- socketless real engines: fleet streams equal a single JAX engine's
  greedy streams, also after a replica dies mid-stream;
- every ``fleet_*`` reply carries the JAX package's keys;
- the drain cases of ``tests/unittest/test_serving.py`` (``TestDrain``);
- the switches of unported modules raise;
- ``python -m mxnet_tpu_torch.serving.fleet.replica`` (``--device cpu``)
  registers with a router, serves, and on SIGTERM drains, leaves and
  exits 0.
"""
import itertools
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest

from mxnet_tpu.models import transformer as jt
from mxnet_tpu.serving import Engine as JEngine
from mxnet_tpu.serving import ServingConfig as JServingConfig
from mxnet_tpu.serving.fleet import ReplicaServer as JReplicaServer
from mxnet_tpu_torch import telemetry as tel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import transformer as tt
from mxnet_tpu_torch.serving import Engine, QueueFullError, ServingConfig
from mxnet_tpu_torch.serving.fleet import FleetClient, ReplicaServer, Router

ROOT = Path(__file__).resolve().parents[1]
MODEL = dict(vocab_size=61, num_layers=2, d_model=32, num_heads=2, d_ff=64,
             max_seq_len=96, dtype="float32")
UNPORTED = ("MXNET_ENGINE_VERIFY", "MXNET_PROF")
# switches of the JAX package's analysis and profiling layers; the port
# carries mxprof and the compile/transfer verifier, not the lock tracer
SWITCHES = ("MXNET_ENGINE_VERIFY", "MXNET_JIT_VERIFY", "MXNET_PROF")


@pytest.fixture(scope="module", autouse=True)
def _unported_switches_off():
    """The suite's conftest arms the JAX package's lock tracer for every
    test; the port's Engine refuses it, so its tests run with it unset
    (the compile verifier is ported and stays in the conftest's record
    mode)."""
    with pytest.MonkeyPatch.context() as mp:
        for name in UNPORTED:
            mp.delenv(name, raising=False)
        yield


def _np_params(seed=0):
    """Params in the JAX package's layout and scales, made with numpy."""
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


PROMPTS = [np.arange(1, 8, dtype=np.int32), np.arange(3, 12, dtype=np.int32)]


@pytest.fixture(scope="module")
def model():
    tree = _np_params(0)
    jcfg = jt.TransformerConfig(**MODEL)
    jp = jax.tree_util.tree_map(jax.numpy.asarray, tree)
    tcfg = tt.TransformerConfig(**MODEL)
    tp = tt.params_from_numpy(tree, device="cpu")
    jeng = JEngine(jp, jcfg, JServingConfig(block_size=8, num_blocks=97,
                                            max_batch=4, prefill_chunk=16))
    prefix_prompt = np.arange(2, 11, dtype=np.int32)
    refs = jeng.generate(PROMPTS + [prefix_prompt], max_new_tokens=10)
    return {"jcfg": jcfg, "jp": jp, "tcfg": tcfg, "tp": tp, "jeng": jeng,
            "refs": refs[:2], "prefix_prompt": prefix_prompt,
            "prefix_ref": refs[2]}


def _mk_engine(model, **kw):
    kw.setdefault("block_size", 8)
    kw.setdefault("num_blocks", 33)
    kw.setdefault("max_batch", 4)
    kw.setdefault("prefill_chunk", 16)
    return Engine(model["tp"], model["tcfg"], ServingConfig(**kw),
                  device="cpu")


def _pump(engines, until, max_steps=2000):
    for _ in range(max_steps):
        any(e.step() for e in engines)
        if until():
            return True
    return False


def _idle(eng):
    return not (eng.sched.queue or eng.sched.active)


# -- the Engine's satellites ---------------------------------------------------
def test_queue_full_carries_depth_and_retry_after(model):
    eng = _mk_engine(model, max_queue_depth=1, max_batch=1, max_active=1)
    eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=4)
    with pytest.raises(QueueFullError) as ei:
        eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=4)
    assert ei.value.queue_depth == 1
    assert ei.value.retry_after_s > 0
    assert eng.stats()["rejected"] == 1
    eng2 = _mk_engine(model)
    eng2.drain()
    with pytest.raises(QueueFullError, match="draining") as ei2:
        eng2.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=2)
    assert ei2.value.retry_after_s > 0


def test_idle_stream_reaper_frees_blocks(model, monkeypatch):
    monkeypatch.setenv("MXNET_SERVE_STREAM_IDLE_S", "0.05")
    eng = _mk_engine(model)
    assert eng.cfg.stream_idle_s == 0.05
    h = eng.submit(np.arange(1, 9, dtype=np.int32), max_new_tokens=12)
    _pump([eng], lambda: len(eng.sched.active) > 0 and any(
        r.generated for r in eng.sched.active), 200)
    time.sleep(0.08)
    assert _pump([eng], lambda: eng.stats()["streams_reaped"] >= 1, 200)
    _pump([eng], lambda: _idle(eng), 200)
    assert h.status == "cancelled"
    assert eng.pool.utilization() == 0.0
    assert eng.stats()["streams_reaped"] == 1


def test_consumed_stream_is_not_reaped(model, monkeypatch):
    monkeypatch.setenv("MXNET_SERVE_STREAM_IDLE_S", "2.5")
    eng = _mk_engine(model)
    h = eng.submit(np.arange(1, 9, dtype=np.int32), max_new_tokens=6)
    got = []
    t = threading.Thread(target=lambda: got.extend(h.tokens()))
    t.start()
    _pump([eng], lambda: _idle(eng), 500)
    t.join(timeout=10)
    assert h.status == "finished" and len(got) == 6
    assert eng.stats()["streams_reaped"] == 0


def test_submit_prefix_tokens_equal_jax_greedy(model):
    full = model["prefix_ref"]
    eng = _mk_engine(model)
    h = eng.submit(model["prefix_prompt"], max_new_tokens=10,
                   prefix_tokens=full[:4])
    _pump([eng], lambda: _idle(eng), 500)
    assert h.result(timeout=5) == full[4:]


def test_submit_prefix_rejects_exhausted_budget(model):
    eng = _mk_engine(model)
    with pytest.raises(MXNetError, match="already meets"):
        eng.submit(np.arange(1, 5, dtype=np.int32), max_new_tokens=2,
                   prefix_tokens=[1, 2])
    assert eng.stats()["rejected"] == 1


@pytest.mark.parametrize("name", SWITCHES)
def test_unported_switch_raises(model, monkeypatch, name):
    monkeypatch.setenv(name, "1")
    if name in ("MXNET_PROF", "MXNET_JIT_VERIFY"):
        # mxprof (telemetry/prof.py) and the compile/transfer verifier
        # (analysis/compile_verify.py) are ported: the switch builds
        _mk_engine(model)
        return
    with pytest.raises(MXNetError, match="not ported"):
        _mk_engine(model)


# -- the router over deterministic stub replicas (the JAX cases) ---------------
class StubReplica:
    """fleet_* arms answered by a pure token function of the prompt;
    ``dead=True`` raises on every dispatch (the crash stand-in)."""

    def __init__(self, name, per_poll=2):
        self.name = name
        self.dead = False
        self.accepting = True
        self.full = None           # (queue_depth, retry_after_s) or None
        self.per_poll = per_poll
        self._rids = itertools.count()
        self._reqs = {}
        self.submits = 0

    @staticmethod
    def expected(prompt, max_new):
        base = int(sum(prompt))
        return [(base + i) % 50 for i in range(int(max_new))]

    def _dispatch(self, req):
        if self.dead:
            raise ConnectionError("dead")
        op = req.get("op")
        if op == "fleet_submit":
            if self.full is not None:
                return {"status": "full", "queue_depth": self.full[0],
                        "retry_after_s": self.full[1]}
            self.submits += 1
            rid = next(self._rids)
            toks = self.expected(req["prompt"], req["max_new"])
            self._reqs[rid] = {"toks": toks,
                               "sent": len(req.get("prefix") or [])}
            return {"status": "ok", "rid": rid, "name": self.name}
        if op == "fleet_stream":
            rec = self._reqs[req["rid"]]
            hi = min(len(rec["toks"]), rec["sent"] + self.per_poll)
            out = rec["toks"][rec["sent"]:hi]
            rec["sent"] = hi
            return {"status": "ok", "tokens": out,
                    "done": hi >= len(rec["toks"]),
                    "final_status": "finished"}
        if op == "fleet_cancel":
            return {"status": "ok", "known": req["rid"] in self._reqs}
        if op == "fleet_stats":
            return {"status": "ok", "name": self.name,
                    "accepting": self.accepting,
                    "stats": {"queue_depth": len(self._reqs)}}
        return {"status": "error", "message": "unknown op %r" % (op,)}


def _mk_router(n=2, **kw):
    kw.setdefault("health_interval", 0.0)
    router = Router(bind=None, **kw)
    reps = [StubReplica("rep%d" % i) for i in range(n)]
    for r in reps:
        router.register_local(r.name, r)
    return router, reps


def _run(router, until, max_steps=500):
    for _ in range(max_steps):
        router.step()
        if until():
            return True
    return False


def _case_least_loaded_placement():
    router, reps = _mk_router(n=3)
    streams = [router.submit([1, 2, i], max_new_tokens=2) for i in range(6)]
    router.step()
    assert [r.submits for r in reps] == [2, 2, 2]
    assert _run(router, lambda: not router._requests)
    for i, s in enumerate(streams):
        assert s.result(timeout=5) == StubReplica.expected([1, 2, i], 2)


def _case_session_affinity():
    router, reps = _mk_router(n=3)
    for i in range(4):
        router.submit([3, i], max_new_tokens=2, session="user-A")
        assert _run(router, lambda: not router._requests)
    assert sorted(r.submits for r in reps) == [0, 0, 4]


def _case_backpressure_and_full_backoff():
    router, reps = _mk_router(n=1, pending_max=2)
    reps[0].full = (5, 0.25)
    router.submit([1], max_new_tokens=2)
    router.submit([2], max_new_tokens=2)
    with pytest.raises(QueueFullError) as ei:
        router.submit([3], max_new_tokens=2)
    assert ei.value.queue_depth == 2
    now = time.monotonic()
    router.step(now)
    assert reps[0].submits == 0
    assert router._replicas["rep0"].full_until == pytest.approx(now + 0.25)
    reps[0].full = None
    for _ in range(500):
        router.step(time.monotonic() + 0.3)
        if not router._requests:
            break
    assert not router._requests and reps[0].submits == 2


def _case_failover_redelivers_losslessly():
    router, reps = _mk_router(n=2, inflight_cap=8)
    reps[0].per_poll = reps[1].per_poll = 1
    prompts = [[1, 2, i] for i in range(4)]
    streams = [router.submit(p, max_new_tokens=6) for p in prompts]
    for _ in range(3):
        router.step()
    victims = len(router._replicas["rep0"].inflight)
    assert victims > 0
    reps[0].dead = True
    assert _run(router, lambda: not router._requests)
    for p, s in zip(prompts, streams):
        assert s.result(timeout=5) == StubReplica.expected(p, 6)
    st = router.stats()
    assert (st["evictions"], st["redelivered"], st["completed"]) == (
        1, victims, 4)
    assert not router._replicas["rep0"].alive
    assert "rep0" in router._replicas


def _case_reregistration_revives():
    router, reps = _mk_router(n=2)
    reps[0].dead = True
    router.submit([5], max_new_tokens=2)
    assert _run(router, lambda: not router._requests)
    assert not router._replicas["rep0"].alive
    router.register_local("rep0", StubReplica("rep0"))
    assert router._replicas["rep0"].alive
    router.submit([5], max_new_tokens=2, session="s")
    assert _run(router, lambda: not router._requests)


def _case_graceful_leave_removes_entry():
    router, _ = _mk_router(n=2)
    assert router.leave("rep1")
    assert "rep1" not in router._replicas
    assert not router.leave("rep1")
    st = router.stats()
    assert st["left"] == 1 and st["evictions"] == 0


def _case_cancel_pending_and_inflight():
    router, reps = _mk_router(n=1)
    reps[0].per_poll = 0
    s1 = router.submit([1], max_new_tokens=4)
    router.step()
    s2 = router.submit([2], max_new_tokens=4)
    assert router.cancel(s2.rid) and router.cancel(s1.rid)
    assert s1.status == "cancelled" and s2.status == "cancelled"
    assert not router._requests and not router._pending
    assert not router._replicas["rep0"].inflight


def _case_client_direct_error_check():
    client = FleetClient(direct=StubReplica("r"))
    assert client.stats()["status"] == "ok"
    with pytest.raises(MXNetError):
        client.call("no_such_op")
    assert client.call("no_such_op", check=False)["status"] == "error"


ROUTER_CASES = {
    "least_loaded_placement": _case_least_loaded_placement,
    "session_affinity": _case_session_affinity,
    "backpressure_and_full_backoff": _case_backpressure_and_full_backoff,
    "failover_redelivers_losslessly": _case_failover_redelivers_losslessly,
    "reregistration_revives": _case_reregistration_revives,
    "graceful_leave_removes_entry": _case_graceful_leave_removes_entry,
    "cancel_pending_and_inflight": _case_cancel_pending_and_inflight,
    "client_direct_error_check": _case_client_direct_error_check,
}


@pytest.mark.parametrize("case", sorted(ROUTER_CASES))
def test_router_case(case):
    ROUTER_CASES[case]()


# -- real engines, socketless ----------------------------------------------------
class _Dead:
    def __getattr__(self, _):
        def boom(*a, **k):
            raise ConnectionError("killed")
        return boom


def test_fleet_matches_single_jax_engine_and_survives_kill(model):
    e1 = _mk_engine(model, num_blocks=97)
    e2 = _mk_engine(model, num_blocks=97)
    router = Router(bind=None, health_interval=0.05)
    router.register_local("rep0", ReplicaServer(e1, name="rep0", bind=None))
    router.register_local("rep1", ReplicaServer(e2, name="rep1", bind=None))
    refs = [r[:8] for r in model["refs"]]
    streams = [router.submit(p, max_new_tokens=8) for p in PROMPTS]
    # both land on replicas; let a couple of tokens stream
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        router.step()
        e1.step()
        e2.step()
        if any(len(router._requests[s.rid].tokens) >= 2 for s in streams
               if s.rid in router._requests):
            break
    victim = router._replicas["rep0"]
    assert victim.inflight, "rep0 holds no stream to redeliver"
    victim.client = _Dead()
    victim.last_scrape_t = 0.0
    while router._requests and time.monotonic() < deadline:
        router.step()
        e2.step()
    assert [s.result(timeout=5) for s in streams] == refs
    st = router.stats()
    assert st["completed"] == 2 and st["evictions"] == 1
    assert st["redelivered"] >= 1


def test_fleet_replies_carry_jax_keys(model):
    """The same ops on a JAX replica and a port replica, socketless: each
    reply has the JAX reply's keys (the port's engine stats add
    ``cp_prefills``)."""
    jeng = model["jeng"]
    teng = _mk_engine(model)
    out = {}
    for tag, rep, eng in (("jax", JReplicaServer(jeng, bind=None), jeng),
                          ("port", ReplicaServer(teng, bind=None), teng)):
        sub = rep._dispatch({"op": "fleet_submit", "prompt": [1, 2, 3],
                             "max_new": 3})
        eng.run_until_idle()
        deadline = time.monotonic() + 10
        while True:
            stream = rep._dispatch({"op": "fleet_stream", "rid": sub["rid"],
                                    "have": 0, "wait": 1.0})
            if stream["done"] or time.monotonic() > deadline:
                break
        sub2 = rep._dispatch({"op": "fleet_submit", "prompt": [4, 5],
                              "max_new": 2})
        cancel = rep._dispatch({"op": "fleet_cancel", "rid": sub2["rid"]})
        eng.run_until_idle()
        stats = rep._dispatch({"op": "fleet_stats"})
        drain = rep._dispatch({"op": "fleet_drain", "wait": False})
        full = rep._dispatch({"op": "fleet_submit", "prompt": [1],
                              "max_new": 2})
        bad = rep._dispatch({"op": "nope"})
        eng.resume()
        out[tag] = {"submit": set(sub), "stream": set(stream),
                    "cancel": set(cancel), "stats": set(stats),
                    "engine_stats": set(stats["stats"]),
                    "drain": set(drain), "full": set(full),
                    "bad": set(bad), "tokens": stream["tokens"]}
    jx, pt = out["jax"], out["port"]
    assert pt["tokens"] == jx["tokens"]
    for k in ("submit", "stream", "cancel", "stats", "drain", "full", "bad"):
        assert pt[k] == jx[k], k
    assert pt["engine_stats"] - jx["engine_stats"] == {"cp_prefills"}
    assert jx["engine_stats"] <= pt["engine_stats"]
    router = Router(bind=None)
    reg = router._dispatch({"op": "fleet_register", "name": "r",
                            "addr": "127.0.0.1:1"})
    leave = router._dispatch({"op": "fleet_leave", "name": "r"})
    assert set(reg) == {"status", "replicas"}
    assert set(leave) == {"status", "known"}


# -- drain (tests/unittest/test_serving.py TestDrain) --------------------------
def _prompts(rng, n):
    return [rng.randint(0, MODEL["vocab_size"], (int(rng.randint(4, 12)),))
            .astype(np.int32) for _ in range(n)]


def _drain_rejects_new_finishes_inflight(model):
    eng = _mk_engine(model)
    rng = np.random.RandomState(5)
    handles = [eng.submit(p, max_new_tokens=5) for p in _prompts(rng, 3)]
    assert eng.accepting()
    assert eng.drain() is False
    assert not eng.accepting()
    before = eng.stats()["rejected"]
    with pytest.raises(QueueFullError):
        eng.submit(_prompts(rng, 1)[0])
    assert eng.stats()["rejected"] == before + 1
    eng.run_until_idle()
    assert eng.drained
    for h in handles:
        assert len(h.result()) == 5 and h.status == "finished"
    st = eng.stats()
    assert st["draining"] and st["drained"]
    assert ("drained", -1) in eng.sched.events
    assert eng.sched.counts["drained"] == 1


def _drain_on_idle_engine_latches_immediately(model):
    eng = _mk_engine(model)
    assert eng.drain() is True
    assert eng.drained and not eng.accepting()


def _resume_reopens_admissions(model):
    eng = _mk_engine(model)
    eng.drain()
    assert eng.drained
    eng.resume()
    assert eng.accepting() and not eng.drained and not eng.draining
    h = eng.submit(_prompts(np.random.RandomState(6), 1)[0],
                   max_new_tokens=3)
    eng.run_until_idle()
    assert len(h.result()) == 3


def _drain_wait_blocks_until_background_loop_finishes(model):
    eng = _mk_engine(model)
    rng = np.random.RandomState(7)
    handles = [eng.submit(p, max_new_tokens=4) for p in _prompts(rng, 2)]
    eng.start()
    try:
        assert eng.drain(wait=True, timeout=60.0) is True
        assert eng.drained
        for h in handles:
            assert len(h.result()) == 4
    finally:
        eng.stop()


def _introspect_reports_drain_state(model):
    eng = _mk_engine(model)
    out = eng.introspect()
    assert out["draining"] is False and out["drained"] is False
    eng.drain()
    out = eng.introspect()
    assert out["draining"] is True and out["drained"] is True


def _drain_counted_in_telemetry(model):
    mp = pytest.MonkeyPatch()
    mp.setenv("MXNET_TELEMETRY", "1")
    tel.reset()
    tel.reload()
    try:
        eng = _mk_engine(model)
        eng.drain()
        assert tel.snapshot()["counters"]["serving.drains_total"] == 1
        assert "serve.drained" in [r["name"] for r in tel.span_tail(20)]
    finally:
        mp.undo()
        tel.reset()
        tel.reload()


DRAIN_CASES = {f.__name__.lstrip("_"): f for f in (
    _drain_rejects_new_finishes_inflight,
    _drain_on_idle_engine_latches_immediately, _resume_reopens_admissions,
    _drain_wait_blocks_until_background_loop_finishes,
    _introspect_reports_drain_state, _drain_counted_in_telemetry)}


@pytest.mark.parametrize("case", sorted(DRAIN_CASES))
def test_drain_case(model, case):
    DRAIN_CASES[case](model)


def test_drain_reject_reason_and_introspect_fields_equal_jax(model):
    """The drain rejection's message and ``introspect()``'s fields (the
    request table's too) are the JAX engine's."""
    jeng = model["jeng"]
    teng = _mk_engine(model, num_blocks=97)
    views, msgs = [], []
    for eng in (jeng, teng):
        eng.submit(PROMPTS[0], max_new_tokens=4)
        eng.step()
        views.append(eng.introspect())
        eng.drain()
        with pytest.raises(Exception) as ei:
            eng.submit(PROMPTS[1], max_new_tokens=2)
        msgs.append((type(ei.value).__name__, str(ei.value)))
        eng.run_until_idle()
        eng.resume()
    jv, tv = views
    assert set(tv) == set(jv)
    for k in ("spec", "wsync", "pool"):
        assert set(tv[k]) == set(jv[k]), k
    assert set(tv["stats"]) - set(jv["stats"]) == {"cp_prefills"}
    assert [set(r) for r in tv["requests"]] == [set(r) for r in
                                                jv["requests"]]
    assert [(r["state"], r["generated"]) for r in tv["requests"]] == [
        (r["state"], r["generated"]) for r in jv["requests"]]
    assert msgs[0] == msgs[1]


# -- the replica entry point -----------------------------------------------------
def test_replica_cli_registers_serves_and_drains_on_sigterm(model):
    """``python -m mxnet_tpu_torch.serving.fleet.replica --device cpu``:
    it registers with a router, its stream equals the same seeded demo
    engine's in this process, and SIGTERM drains it, sends
    ``fleet_leave`` and exits 0."""
    from mxnet_tpu_torch.serving.fleet.replica import build_demo_engine

    router = Router(bind=("127.0.0.1", 0), health_interval=0.05)
    host, port = router.serve()
    env = {k: v for k, v in os.environ.items() if k not in UNPORTED}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "mxnet_tpu_torch.serving.fleet.replica",
         "--router", "%s:%d" % (host, port), "--name", "rep0",
         "--device", "cpu", "--seed", "3"],
        cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 90
        while "rep0" not in router._replicas:
            assert proc.poll() is None, proc.communicate()
            assert time.monotonic() < deadline, "replica never registered"
            time.sleep(0.05)
        router.start()
        prompt = np.arange(4, 13, dtype=np.int32)
        got = router.submit(prompt, max_new_tokens=12).result(timeout=60)
        want = build_demo_engine(3, "cpu").generate([prompt], 12)[0]
        assert got == want
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
        assert proc.returncode == 0, err
        assert "fleet replica rep0 listening" in out
        assert router.stats()["left"] == 1
        assert "rep0" not in router._replicas
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        router.close()
