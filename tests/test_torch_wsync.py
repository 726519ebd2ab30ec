"""mxnet_tpu_torch's live weight sync (``wsync/``) against the JAX
package's.

The model is the JAX package's wsync tests' tiny LM (vocab 61, 2
layers, d_model 32, f32) with its aligned 1-layer draft; parameters are
made with numpy in the JAX layout and carried across with
``params_from_numpy``. Tolerances: none — every comparison here is of
fingerprints, file bytes, token streams or journal records.

- flat wire keys, ``fingerprint``, ``manifest_of`` and
  ``param_manifest`` equal the JAX package's for the same f32 and bf16
  values (bf16 as ``"<V2"`` and its raw bits);
- ``save_weights_checkpoint`` files are byte-equal in both directions,
  bf16 included, and each package reads the other's;
- the non-finite gate catches bf16 (the JAX package's does not);
- the publisher store, one transaction over loopback (applied, delta
  skip, acceptance probe, torn transaction), the engine's gates, the
  rollback ring;
- byte parity: a hot-swapped port engine equals a cold one (plain,
  speculative, and with a mesh and a long prompt, which reads the
  refreshed f32 unembedding), and equals a cold JAX engine on the same
  version, greedy and sampled;
- nothing starts with ``MXNET_WSYNC`` unset; ``MXNET_WSYNC=1`` with a
  publisher autosyncs;
- across packages over loopback (f32): a port subscriber syncs from a
  JAX publisher and a JAX subscriber from a port publisher;
- a transaction sequence journals the JAX package's records and counts.
"""
import dataclasses
import json
import threading
import time

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import mxnet_tpu.telemetry as jtel
from mxnet_tpu.models import transformer as jt
from mxnet_tpu.serving import Engine as JEngine
from mxnet_tpu.serving import ServingConfig as JServingConfig
from mxnet_tpu.wsync import common as jwc
from mxnet_tpu.wsync.publisher import WeightPublisher as JPublisher
from mxnet_tpu.wsync.subscriber import WeightSubscriber as JSubscriber
from mxnet_tpu_torch import telemetry as tel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import transformer as tt
from mxnet_tpu_torch.parallel import create_mesh
from mxnet_tpu_torch.serving import Engine, ServingConfig
from mxnet_tpu_torch.serving.model import cp_prefill_kv
from mxnet_tpu_torch.wsync import common as wc
from mxnet_tpu_torch.wsync import enabled as wsync_enabled
from mxnet_tpu_torch.wsync.publisher import CheckpointWatcher, WeightPublisher
from mxnet_tpu_torch.wsync.subscriber import WeightSubscriber, maybe_autosync

MODEL = dict(vocab_size=61, num_layers=2, d_model=32, num_heads=2, d_ff=64,
             max_seq_len=96, dtype="float32")
POOL = dict(block_size=8, num_blocks=33, max_batch=4, prefill_chunk=16,
            token_budget=64)
PROMPTS = [[7, 11, 13, 17, 19, 23], [3, 1, 4, 1, 5, 9, 2, 6]]
UNPORTED = ("MXNET_ENGINE_VERIFY", "MXNET_PROF")


@pytest.fixture(scope="module", autouse=True)
def _unported_switches_off():
    """The suite's conftest arms the JAX package's lock tracer; the
    port's Engine refuses it (the compile verifier is ported)."""
    with pytest.MonkeyPatch.context() as mp:
        for name in UNPORTED:
            mp.delenv(name, raising=False)
        yield


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


def _perturb(tree, scale, seed=0):
    """A same-shape variant of a numpy params tree (a 'new version')."""
    rng = np.random.default_rng(seed)
    return jwc.unflatten_params({
        k: (v + scale * rng.standard_normal(v.shape).astype(v.dtype))
        for k, v in jwc.flatten_params(tree).items()})


def _draft_of(tree):
    """The aligned draft: the first layer of the same set."""
    return {"embed": tree["embed"], "pos_embed": tree["pos_embed"],
            "layers": tree["layers"][:1], "ln_f": tree["ln_f"]}


def _port(tree):
    return tt.params_from_numpy(tree, device="cpu")


def _port_draft(tree):
    d = _draft_of(tree)
    return {"embed": torch.from_numpy(d["embed"]),
            "pos_embed": torch.from_numpy(d["pos_embed"]),
            "ln_f": {k: torch.from_numpy(v) for k, v in d["ln_f"].items()},
            "layers": [{k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()}
                            if isinstance(v, dict) else torch.from_numpy(v))
                        for k, v in d["layers"][0].items()}]}


def _jax(tree):
    return jax.tree_util.tree_map(jax.numpy.asarray, tree)


def _fp_of(params, draft=None):
    return {k: wc.fingerprint(v)
            for k, v in wc.combine_draft(params, draft).items()}


TCFG = tt.TransformerConfig(**MODEL)
DCFG = dataclasses.replace(TCFG, num_layers=1)


@pytest.fixture(scope="module")
def v0():
    return _np_params(0)


def _mk_engine(tree, spec=False, draft_tree=None, **kw):
    cfg = dict(POOL, **kw)
    if spec:
        return Engine(_port(tree), TCFG, ServingConfig(spec=True, spec_k=3,
                                                       **cfg),
                      draft_params=_port_draft(draft_tree or tree),
                      draft_cfg=DCFG, device="cpu")
    return Engine(_port(tree), TCFG, ServingConfig(**cfg), device="cpu")


@pytest.fixture()
def pub():
    p = WeightPublisher(bind=("127.0.0.1", 0))
    p.start()
    yield p
    p.close()


def _addr(p):
    return "%s:%d" % tuple(p.addr[:2])


# -- flat wire format, fingerprints, manifests ----------------------------------
def test_flat_keys_and_draft_split_equal_jax(v0):
    jflat = jwc.combine_draft(_jax(v0), _jax(_draft_of(v0)))
    tflat = wc.combine_draft(_port(v0), _port_draft(v0))
    assert list(tflat) == list(jflat)
    back = wc.flatten_params(wc.unflatten_params(tflat))
    assert set(back) == set(tflat)
    assert isinstance(wc.unflatten_params(tflat)["layers"], list)
    target, draft = wc.split_draft(tflat)
    assert set(draft) == set(wc.flatten_params(_port_draft(v0)))
    assert wc.split_draft(wc.combine_draft(_port(v0)))[1] is None


def _arrays(dtype):
    """The same values as JAX-side numpy arrays and port tensors."""
    rng = np.random.RandomState(3)
    f32 = [np.asarray(rng.randn(*s), np.float32)
           for s in ((), (7,), (3, 5), (2, 3, 4))]
    if dtype == "float32":
        return f32, [torch.from_numpy(a.copy()) for a in f32]
    bf = [a.astype(ml_dtypes.bfloat16) for a in f32]
    return bf, [torch.from_numpy(np.array(a.view(np.int16))).view(
        torch.bfloat16) for a in bf]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fingerprint_and_manifests_equal_jax(dtype, v0):
    japs, taps = _arrays(dtype)
    assert [wc.fingerprint(t) for t in taps] == [
        jwc.fingerprint(a) for a in japs]
    jflat = {"t%d" % i: a for i, a in enumerate(japs)}
    tflat = {"t%d" % i: t for i, t in enumerate(taps)}
    assert wc.manifest_of(tflat) == jwc.manifest_of(jflat)
    if dtype == "bfloat16":
        assert wc.manifest_of(tflat)["t1"]["dtype"] == "<V2"
    jtree = jax.tree_util.tree_map(
        lambda a: jax.numpy.asarray(a, jax.numpy.bfloat16
                                    if dtype == "bfloat16" else None), v0)
    ttree = tt.params_from_numpy(v0, device="cpu",
                                 dtype=getattr(torch, dtype))
    # layer norms stay f32 in the port's layout; the JAX tree casts all
    jtree = jax.tree_util.tree_map_with_path(
        lambda p, a: (a.astype(jax.numpy.float32)
                      if any(getattr(k, "key", None) in ("ln1", "ln2", "ln_f")
                             for k in p) else a), jtree)
    assert wc.param_manifest(ttree) == jwc.param_manifest(jtree)
    # a one-bit change moves the fingerprint, as in the JAX package
    t = taps[2].clone()
    t.view(torch.int16 if dtype == "bfloat16" else torch.int32)[0, 0] ^= 1
    assert wc.fingerprint(t) != wc.fingerprint(taps[2])
    assert wc.fingerprint(taps[2].reshape(5, 3)) != wc.fingerprint(taps[2])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weights_checkpoint_bytes_equal_both_ways(dtype, v0, tmp_path):
    jd = jax.numpy.bfloat16 if dtype == "bfloat16" else jax.numpy.float32
    td = getattr(torch, dtype)
    jtree = jax.tree_util.tree_map(lambda a: jax.numpy.asarray(a, jd), v0)
    jdraft = jax.tree_util.tree_map(lambda a: jax.numpy.asarray(a, jd),
                                    _draft_of(v0))
    ttree = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(np.asarray(
            jax.numpy.asarray(a, jd)).view(np.int16))).view(torch.bfloat16)
        if dtype == "bfloat16" else torch.from_numpy(a.copy()), v0)
    tdraft = wc.unflatten_params({
        k: v for k, v in wc.flatten_params(ttree).items()
        if k in wc.flatten_params(_draft_of(v0))})
    assert all(t.dtype == td for t in wc.flatten_params(ttree).values())
    jpath = jwc.save_weights_checkpoint(str(tmp_path / "jax"), 3, jtree,
                                        jdraft)
    tpath = wc.save_weights_checkpoint(str(tmp_path / "port"), 3, ttree,
                                       tdraft)
    with open(jpath, "rb") as fj, open(tpath, "rb") as ft:
        assert ft.read() == fj.read()
    want = {k: jwc.fingerprint(np.asarray(v))
            for k, v in jwc.combine_draft(jtree, jdraft).items()}
    lp, ld = wc.load_weights_checkpoint(str(tmp_path / "jax"), 3)
    assert _fp_of(lp, ld) == want
    assert all(t.dtype == td for t in wc.flatten_params(lp).values())
    jp, jdr = jwc.load_weights_checkpoint(str(tmp_path / "port"), 3)
    assert {k: jwc.fingerprint(np.asarray(jax.numpy.asarray(v, jd)))
            for k, v in jwc.combine_draft(jp, jdr).items()} == want
    wc.save_weights_checkpoint(str(tmp_path / "port"), 4, ttree)
    assert wc.load_weights_checkpoint(str(tmp_path / "port"), 4)[1] is None


def test_nonfinite_gate_catches_bf16_where_jax_skips_it():
    bf = np.ones((2, 3), np.float32).astype(ml_dtypes.bfloat16)
    bf[0, 1] = np.nan
    assert jwc.nonfinite_keys({"w": bf}) == []   # np.issubdtype skips it
    t = wc.host_tensor(bf)
    assert t.dtype == torch.bfloat16
    assert wc.nonfinite_keys({"w": t, "ok": torch.ones(3)}) == ["w"]
    f = np.ones(4, np.float32)
    f[2] = np.inf
    assert wc.nonfinite_keys({"f": torch.from_numpy(f)}) == \
        jwc.nonfinite_keys({"f": f}) == ["f"]
    assert wc.nonfinite_keys({"i": torch.arange(3)}) == []


def test_wire_carries_bf16_bits():
    t = torch.randn(4, 5).to(torch.bfloat16)
    a = wc.to_wire(t)
    assert a.dtype == np.uint16 and a.shape == (4, 5)
    back = wc.from_wire(a, wc.BF16_STR)
    assert back.dtype == torch.bfloat16 and torch.equal(back, t)
    jax_side = a.view(ml_dtypes.bfloat16)
    assert torch.equal(wc.from_wire(jax_side), t)
    f = torch.randn(3)
    assert wc.to_wire(f).dtype == np.float32
    assert torch.equal(wc.from_wire(wc.to_wire(f), "<f4"), f)


# -- publisher store -----------------------------------------------------------------
def test_publisher_versions_history_poll(v0):
    p = WeightPublisher(bind=None, history=2)
    params = _port(v0)
    assert p.publish(params) == 1
    assert p.publish(params) == 2
    assert p.publish(params, version=9) == 9
    with pytest.raises(MXNetError, match="monotonic"):
        p.publish(params, version=9)
    assert p._dispatch({"op": "wsync_manifest",
                        "version": 1})["status"] == "error"
    assert p._dispatch({"op": "wsync_manifest",
                        "version": 9})["status"] == "ok"
    assert p._dispatch({"op": "wsync_poll", "have": 9})["status"] == \
        "pending"
    resp = p._dispatch({"op": "wsync_poll", "have": 0})
    assert (resp["status"], resp["version"]) == ("ok", 9)
    assert p._dispatch({"op": "nope"})["status"] == "error"
    # the publisher keeps a host copy: the caller may mutate its params
    before = wc.fingerprint(p._versions[9]["tensors"]["embed"])
    params["embed"].add_(1.0)
    assert wc.fingerprint(p._versions[9]["tensors"]["embed"]) == before


def test_checkpoint_watcher_epoch_is_version(v0, tmp_path):
    p = WeightPublisher(bind=None)
    prefix = str(tmp_path / "train")
    w = CheckpointWatcher(p, prefix, interval=0.05)
    assert w.poll_once() is None
    wc.save_weights_checkpoint(prefix, 2, _port(v0))
    assert w.poll_once() == 2 and p._latest == 2
    assert w.poll_once() is None
    wc.save_weights_checkpoint(prefix, 3, _port(_perturb(v0, 0.01)))
    assert w.poll_once() == 3


# -- one transaction over the wire --------------------------------------------------
def test_rpc_round_trip_applies_target_and_draft(v0, pub):
    eng = _mk_engine(v0, spec=True)
    sub = WeightSubscriber(eng, _addr(pub), rank=0)
    assert sub.sync_once() is None
    v1 = _perturb(v0, 0.02, seed=1)
    pub.publish(_port(v1), _port_draft(v1))
    assert sub.sync_once(wait=5.0) == 1
    assert eng.weight_version() == 1
    assert _fp_of(eng.params, eng.draft_params) == _fp_of(
        _port(v1), _port_draft(v1))
    assert pub.acks() == [(1, 0, "applied")]
    assert sub.last["outcome"] == "applied"
    assert sub.last["fetched"] == len(wc.combine_draft(v1, _draft_of(v1)))


def test_delta_skip_fetches_only_changed(v0, pub):
    eng = _mk_engine(v0)
    sub = WeightSubscriber(eng, _addr(pub), rank=0)
    pub.publish(_port(v0))
    fetched = []
    orig = sub._client.fetch_tensor
    sub._client.fetch_tensor = (
        lambda v, k: (fetched.append(k), orig(v, k))[1])
    assert sub.sync_once(wait=5.0) == 1
    assert len(fetched) == len(wc.flatten_params(v0))
    nxt = _port(v0)
    nxt["ln_f"]["scale"] = nxt["ln_f"]["scale"] * 1.5
    pub.publish(nxt)
    del fetched[:]
    assert sub.sync_once(wait=5.0) == 2
    assert fetched == ["ln_f/scale"]


def test_acceptance_probe_refuses(v0, pub):
    eng = _mk_engine(v0)
    seen = []
    sub = WeightSubscriber(eng, _addr(pub), rank=3,
                           accept=lambda v, p, d: (seen.append(v), False)[1])
    pub.publish(_port(_perturb(v0, 0.02, seed=2)))
    assert sub.sync_once(wait=5.0) is None
    assert seen == [1] and eng.weight_version() is None
    assert pub.acks() == [(1, 3, "rejected:acceptance-probe")]
    assert sub.sync_once() is None


def test_torn_transaction_aborts_cleanly(v0, pub):
    eng = _mk_engine(v0)
    live, fps = eng.params, _fp_of(eng.params)
    sub = WeightSubscriber(eng, _addr(pub), rank=0)
    pub.publish(_port(_perturb(v0, 0.02, seed=3)))
    with pub._lock:
        pub._versions.clear()
    assert sub.sync_once(wait=5.0) is None
    assert eng.params is live and _fp_of(eng.params) == fps
    assert eng.weight_version() is None
    assert pub.acks() == [(1, 0, "aborted")]
    pub.publish(_port(_perturb(v0, 0.02, seed=4)))
    assert sub.sync_once(wait=5.0) == 2


# -- engine gates, atomic swap, rollback ---------------------------------------------
def _gate_nonfinite(v0):
    eng = _mk_engine(v0)
    live, fps = eng.params, _fp_of(eng.params)
    bad = _port(_perturb(v0, 0.01, seed=5))
    bad["layers"][1]["w1"][0, 0] = float("inf")
    with pytest.raises(MXNetError, match="non-finite tensors: layers/1/w1"):
        eng.install_weights(1, bad)
    assert eng.params is live and _fp_of(eng.params) == fps
    assert eng.weight_version() is None


def _gate_shape_dtype(v0):
    eng = _mk_engine(v0)
    fps = _fp_of(eng.params)
    short = _port(v0)
    short["embed"] = short["embed"][:-1]
    with pytest.raises(MXNetError, match="shape/dtype"):
        eng.install_weights(1, short)
    wide = _port(v0)
    wide["embed"] = wide["embed"].double()
    with pytest.raises(MXNetError, match="shape/dtype"):
        eng.install_weights(1, wide)
    assert eng.weight_version() is None and _fp_of(eng.params) == fps


def _gate_draft_mismatch_keeps_target(v0):
    eng = _mk_engine(v0, spec=True)
    live = eng.params
    v2 = _perturb(v0, 0.02, seed=6)
    bad_draft = _port(v2)       # 2 layers against the live draft's 1
    with pytest.raises(MXNetError, match="draft"):
        eng.install_weights(1, _port(v2), bad_draft)
    assert eng.params is live and eng.weight_version() is None


def _gate_draft_dropped_without_draft_model(v0):
    eng = _mk_engine(v0)
    v2 = _perturb(v0, 0.02, seed=7)
    assert eng.install_weights(1, _port(v2), _port_draft(v2)) == 1
    assert eng.weight_version() == 1 and eng.draft_params is None


def _gate_unstaged_write_caught_by_step(v0):
    eng = _mk_engine(v0)
    eng.submit(PROMPTS[0], max_new_tokens=2)
    eng.params = dict(eng.params)
    with pytest.raises(MXNetError, match="install_weights"):
        eng.step()
    eng.params = eng._installed_params
    eng.run_until_idle()


def _gate_install_copies(v0):
    """The installed set is the engine's own copy: the caller's later
    in-place writes (a trainer's next step) do not reach it."""
    eng = _mk_engine(v0)
    v1 = _port(_perturb(v0, 0.02, seed=8))
    eng.install_weights(1, v1)
    fps = _fp_of(eng.params)
    v1["embed"].add_(1.0)
    assert _fp_of(eng.params) == fps


GATES = {f.__name__[len("_gate_"):]: f for f in (
    _gate_nonfinite, _gate_shape_dtype, _gate_draft_mismatch_keeps_target,
    _gate_draft_dropped_without_draft_model,
    _gate_unstaged_write_caught_by_step, _gate_install_copies)}


@pytest.mark.parametrize("case", sorted(GATES))
def test_engine_gate(v0, case):
    GATES[case](v0)


def test_rollback_ring_walks_back_one_entry_per_call(v0):
    eng = _mk_engine(v0)
    sets = {v: _port(_perturb(v0, 0.02 * v, seed=v)) for v in (1, 2, 3)}
    for v in (1, 2, 3):
        eng.install_weights(v, sets[v])
    assert eng.stats()["weight_ring"] == 2
    assert eng.rollback_weights() == {"from_version": 3, "to_version": 2}
    assert _fp_of(eng.params) == _fp_of(sets[2])
    assert eng.rollback_weights() == {"from_version": 2, "to_version": 1}
    with pytest.raises(MXNetError, match="ring is empty"):
        eng.rollback_weights()
    assert eng.weight_version() == 1


def test_rollback_restores_draft_in_same_transaction(v0):
    eng = _mk_engine(v0, spec=True)
    d0 = _fp_of(eng.draft_params)
    v1 = _perturb(v0, 0.05, seed=8)
    eng.install_weights(1, _port(v1), _port_draft(v1))
    assert _fp_of(eng.draft_params) != d0
    eng.rollback_weights()
    assert _fp_of(eng.draft_params) == d0


# -- byte parity -----------------------------------------------------------------------
@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_hot_swap_matches_cold_engine(v0, pub, tmp_path, spec):
    vN = _perturb(v0, 0.05, seed=11)
    draftN = _port_draft(vN) if spec else None
    prefix = str(tmp_path / "ck")
    wc.save_weights_checkpoint(prefix, 7, _port(vN), draftN)
    hot = _mk_engine(v0, spec=spec)
    sub = WeightSubscriber(hot, _addr(pub), rank=0)
    pub.publish(_port(vN), draftN, version=7)
    assert sub.sync_once(wait=5.0) == 7
    cold_p, cold_d = wc.load_weights_checkpoint(prefix, 7)
    cfg = dict(POOL)
    if spec:
        cold = Engine(cold_p, TCFG, ServingConfig(spec=True, spec_k=3,
                                                  **cfg),
                      draft_params=cold_d, draft_cfg=DCFG, device="cpu")
    else:
        cold = Engine(cold_p, TCFG, ServingConfig(**cfg), device="cpu")
    assert (_fp_of(hot.params, hot.draft_params if spec else None)
            == _fp_of(cold.params, cold.draft_params if spec else None))
    assert hot.generate(PROMPTS, max_new_tokens=12) == cold.generate(
        PROMPTS, max_new_tokens=12)


def _streams(eng, sampled_seed=3):
    hs = [eng.submit(np.asarray(p, np.int32), max_new_tokens=10)
          for p in PROMPTS]
    hs.append(eng.submit(np.asarray(PROMPTS[1], np.int32), max_new_tokens=10,
                         temperature=0.8, top_p=0.95, seed=sampled_seed))
    eng.run_until_idle()
    return [h.result(timeout=5) for h in hs]


def test_hot_swapped_engine_equals_jax_engine_on_the_same_version(v0, pub):
    """Greedy streams and one sampled stream of a port engine synced to
    version N over loopback equal a cold JAX engine's on version N."""
    vN = _perturb(v0, 0.05, seed=12)
    hot = _mk_engine(v0)
    before = _streams(hot)
    sub = WeightSubscriber(hot, _addr(pub), rank=0)
    pub.publish(_port(vN))
    assert sub.sync_once(wait=5.0) == 1
    jeng = JEngine(_jax(vN), jt.TransformerConfig(**MODEL),
                   JServingConfig(**POOL))
    want = []
    for p in PROMPTS:
        want.append(jeng.submit(np.asarray(p, np.int32), max_new_tokens=10))
    want.append(jeng.submit(np.asarray(PROMPTS[1], np.int32),
                            max_new_tokens=10, temperature=0.8, top_p=0.95,
                            seed=3))
    jeng.run_until_idle()
    want = [h.result(timeout=5) for h in want]
    got = _streams(hot)
    assert got == want
    assert got != before, "version N must change the streams"


def test_hot_swap_refreshes_the_cp_unembedding(v0, pub):
    """With a mesh, a long prompt's first token is drawn from f32 x_last @
    embed.T on the host side of the cp prefill: after a sync it must come
    from the new embedding (a stale one gives another token here)."""
    long_prompt = list(np.random.RandomState(9).randint(0, 61, (48,)))
    mesh = create_mesh((1,), ("seq",), devices=["cpu"])
    kw = dict(mesh=mesh, cp_kind="ulysses", cp_min_tokens=32)
    vN = _perturb(v0, 0.05, seed=13)
    vN["embed"] = vN["embed"] + 0.5 * np.random.RandomState(14).randn(
        *vN["embed"].shape).astype(np.float32)
    hot = _mk_engine(v0, **kw)
    sub = WeightSubscriber(hot, _addr(pub), rank=0)
    pub.publish(_port(vN))
    assert sub.sync_once(wait=5.0) == 1
    cold = _mk_engine(vN, **kw)
    prompts = [np.asarray(long_prompt, np.int32),
               np.asarray(PROMPTS[0], np.int32)]
    got = hot.generate(prompts, max_new_tokens=6)
    assert got == cold.generate(prompts, max_new_tokens=6)
    assert hot.stats()["cp_prefills"] == 1
    # the case discriminates: the stale unembedding picks another token
    new = _port(vN)
    with torch.no_grad():
        _, _, x_last = cp_prefill_kv(new, TCFG, prompts[0], mesh,
                                     kind="ulysses")
        stale = int((x_last @ _port(v0)["embed"].float().T).argmax())
    assert stale != got[0][0]
    hot.rollback_weights()
    assert hot.generate(prompts, max_new_tokens=6) == _mk_engine(
        v0, **kw).generate(prompts, max_new_tokens=6)


# -- off by default ---------------------------------------------------------------------
def test_env_unset_no_thread_no_socket(v0, monkeypatch):
    monkeypatch.delenv("MXNET_WSYNC", raising=False)
    monkeypatch.delenv("MXNET_WSYNC_PUBLISHER", raising=False)
    assert not wsync_enabled()
    before = {t.name for t in threading.enumerate()}
    eng = _mk_engine(v0)
    assert eng._wsync_sub is None and maybe_autosync(eng) is None
    after = {t.name for t in threading.enumerate()} - before
    assert not any(n.startswith("mx-wsync") for n in after)
    monkeypatch.setenv("MXNET_WSYNC", "1")
    assert _mk_engine(v0)._wsync_sub is None   # no publisher named


def test_autosync_starts_and_applies(v0, pub, monkeypatch):
    monkeypatch.setenv("MXNET_WSYNC", "1")
    monkeypatch.setenv("MXNET_WSYNC_PUBLISHER", _addr(pub))
    monkeypatch.setenv("MXNET_WSYNC_POLL_WAIT", "0.2")
    eng = _mk_engine(v0)
    try:
        assert eng._wsync_sub is not None
        assert eng.introspect()["wsync"]["syncing"] is True
        pub.publish(_port(_perturb(v0, 0.02, seed=12)))
        deadline = time.monotonic() + 20.0
        while eng.weight_version() != 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert eng.weight_version() == 1
    finally:
        eng._wsync_sub.stop()


# -- across packages over loopback (f32) ------------------------------------------------
def test_port_subscriber_syncs_from_jax_publisher(v0):
    vN = _perturb(v0, 0.03, seed=15)
    jpub = JPublisher(bind=("127.0.0.1", 0))
    jpub.start()
    try:
        eng = _mk_engine(v0)
        sub = WeightSubscriber(eng, _addr(jpub), rank=1)
        jpub.publish(_jax(vN))
        assert sub.sync_once(wait=5.0) == 1
        assert jpub.acks() == [(1, 1, "applied")]
    finally:
        jpub.close()
    want = {k: jwc.fingerprint(np.asarray(v))
            for k, v in jwc.flatten_params(_jax(vN)).items()}
    assert _fp_of(eng.params) == want


def test_jax_subscriber_syncs_from_port_publisher(v0, pub):
    vN = _perturb(v0, 0.03, seed=16)
    jeng = JEngine(_jax(v0), jt.TransformerConfig(**MODEL),
                   JServingConfig(**POOL))
    jsub = JSubscriber(jeng, _addr(pub), rank=2)
    pub.publish(_port(vN))
    assert jsub.sync_once(wait=5.0) == 1
    assert pub.acks() == [(1, 2, "applied")]
    got = {k: jwc.fingerprint(np.asarray(v))
           for k, v in jwc.flatten_params(jeng.params).items()}
    assert got == _fp_of(_port(vN))


# -- telemetry: one trace id per transaction, the JAX package's records -------------------
def _transaction_sequence(pkg, v0, tmp_path):
    """publish v1 -> applied; publish v2 with a NaN -> rejected; rollback;
    in one package, journaling to its own file. Returns (wsync records,
    wsync counters, gauges, histogram names)."""
    mp = pytest.MonkeyPatch()
    journal = tmp_path / ("%s.jsonl" % pkg)
    mp.setenv("MXNET_TELEMETRY", "1")
    mp.setenv("MXNET_TELEMETRY_JOURNAL", str(journal))
    t = jtel if pkg == "jax" else tel
    t.reset()
    t.reload()
    try:
        v1 = _perturb(v0, 0.02, seed=13)
        bad = jwc.flatten_params(_perturb(v0, 0.02, seed=14))
        bad["embed"] = bad["embed"].copy()
        bad["embed"].flat[0] = np.nan
        bad = jwc.unflatten_params(bad)
        if pkg == "jax":
            p = JPublisher(bind=("127.0.0.1", 0))
            eng = JEngine(_jax(v0), jt.TransformerConfig(**MODEL),
                          JServingConfig(**POOL))
            sub_cls, conv = JSubscriber, _jax
        else:
            p = WeightPublisher(bind=("127.0.0.1", 0))
            eng = _mk_engine(v0)
            sub_cls, conv = WeightSubscriber, _port
        p.start()
        try:
            sub = sub_cls(eng, _addr(p), rank=0)
            p.publish(conv(v1))
            assert sub.sync_once(wait=5.0) == 1
            p.publish(conv(bad))
            assert sub.sync_once(wait=5.0) is None
            eng.rollback_weights()
        finally:
            p.close()
        t.flush(mark="exit")
        recs = [json.loads(line) for line in
                journal.read_text().splitlines() if line.strip()]
        snap = t.snapshot()
    finally:
        mp.undo()
        t.reset()
        t.reload()
    ws = [r for r in recs if r.get("kind") == "wsync"]
    pick = {k: v for k, v in snap["counters"].items()
            if k.startswith("wsync.")}
    gauges = {k: v for k, v in snap["gauges"].items()
              if k.startswith("wsync.")}
    return ws, pick, gauges, sorted(snap["histograms"])


def test_transaction_journal_and_counters_equal_jax(v0, tmp_path):
    jws, jc, jg, jh = _transaction_sequence("jax", v0, tmp_path)
    tws, tc, tg, th = _transaction_sequence("port", v0, tmp_path)
    assert [(r["event"], r["version"]) for r in tws] == [
        (r["event"], r["version"]) for r in jws]
    assert [sorted(r) for r in tws] == [sorted(r) for r in jws]
    assert (tc, tg, th) == (jc, jg, jh)
    by = {}
    for r in tws:
        by.setdefault(r["event"], []).append(r)
    (applied,) = by["applied"]
    assert applied["trace"] in [r["trace"] for r in by["staged"]]
    assert "non-finite" in by["rejected"][0]["reason"]
    assert [r["outcome"].split(":")[0] for r in by["ack"]] == [
        "applied", "rejected"]
