"""mxnet_tpu_torch sampled and speculative serving against the JAX package.

Configurations are the JAX package's own spec tests'
(``tests/unittest/test_spec_serving.py``): a vocab-61, 2-layer, d_model
32 f32 target, an independent 1-layer d_model 16 random draft, and the
aligned draft (the target's first layer, shared embeddings). Parameters
are made with numpy in the JAX layout and carried across with
``params_from_numpy``. The JAX reference engines are built once per
module and each runs one batch of requests, which the parametrized
cases read.

- sampled plain streams equal the JAX ``Engine``'s token for token, for
  the four filter settings of the JAX package's
  ``test_device_sampler_matches_host_reference`` and after eviction
  under a tight pool;
- greedy speculative streams equal plain greedy ones, with either draft,
  through eviction, chunked prefill, mid-decode cancel and ``set_spec``
  toggling; sampled speculative streams equal the JAX spec engine's on
  the same seeds and schedule;
- a sampled long prompt prefilled context-parallel (Ulysses, one-device
  mesh) draws the JAX package's first token, and the draft ingests it;
- ``Engine.__init__`` refuses what the JAX package refuses;
- an all-greedy batch makes no threefry draw in ``step``, ``draft_turn``
  or ``verify``.
"""
import jax
import numpy as np
import pytest

from mxnet_tpu.base import MXNetError as JMXNetError
from mxnet_tpu.models import transformer as jt
from mxnet_tpu.parallel.mesh import create_mesh as j_create_mesh
from mxnet_tpu.serving import Engine as JEngine
from mxnet_tpu.serving import ServingConfig as JServingConfig
from mxnet_tpu_torch import threefry as tf
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import transformer as tt
from mxnet_tpu_torch.parallel import create_mesh
from mxnet_tpu_torch.serving import Engine, ServingConfig

TARGET = dict(vocab_size=61, num_layers=2, d_model=32, num_heads=2, d_ff=64,
              max_seq_len=96, dtype="float32")
RANDOM_DRAFT = dict(TARGET, num_layers=1, d_model=16, d_ff=32)
POOL = dict(block_size=8, num_blocks=33, max_batch=4, prefill_chunk=16)
SPEC = dict(POOL, spec=True, spec_k=3, token_budget=64)
# the filter settings of the JAX package's host-reference sampler test
FILTERS = [(0.8, 0, 1.0), (1.3, 10, 1.0), (0.9, 0, 0.8), (1.0, 7, 0.9)]


@pytest.fixture(scope="module", autouse=True)
def _unported_switches_off():
    """The suite's conftest arms the JAX package's lock tracer
    (``MXNET_ENGINE_VERIFY``) for every test; the port's Engine refuses
    it, so its tests run with it unset (the compile verifier,
    ``MXNET_JIT_VERIFY``, is ported and stays in record mode)."""
    with pytest.MonkeyPatch.context() as mp:
        for name in ("MXNET_ENGINE_VERIFY", "MXNET_PROF"):
            mp.delenv(name, raising=False)
        yield


def _np_params(cfg, seed):
    """Params in the JAX package's layout and scales, made with numpy."""
    rng = np.random.RandomState(seed)

    def dense(shape, scale=None):
        scale = 1.0 / np.sqrt(shape[0]) if scale is None else scale
        return (rng.randn(*shape) * scale).astype(np.float32)

    def ln():
        return {"scale": np.ones(cfg.d_model, np.float32),
                "bias": np.zeros(cfg.d_model, np.float32)}

    d, f = cfg.d_model, cfg.d_ff
    return {"embed": dense((cfg.vocab_size, d), 0.02),
            "pos_embed": dense((cfg.max_seq_len, d), 0.02), "ln_f": ln(),
            "layers": [{"ln1": ln(), "wqkv": dense((d, 3 * d)),
                        "wo": dense((d, d)), "ln2": ln(),
                        "w1": dense((d, f)), "w2": dense((f, d))}
                       for _ in range(cfg.num_layers)]}


def _pair(kw, tree):
    """(JAX cfg, JAX params, port cfg, port params) of one numpy tree."""
    return (jt.TransformerConfig(**kw),
            jax.tree_util.tree_map(jax.numpy.asarray, tree),
            tt.TransformerConfig(**kw), tt.params_from_numpy(tree, "cpu"))


@pytest.fixture(scope="module")
def models():
    target = _np_params(jt.TransformerConfig(**TARGET), 0)
    aligned = {"embed": target["embed"], "pos_embed": target["pos_embed"],
               "layers": target["layers"][:1], "ln_f": target["ln_f"]}
    return {"target": _pair(TARGET, target),
            "random": _pair(RANDOM_DRAFT, _np_params(
                jt.TransformerConfig(**RANDOM_DRAFT), 7)),
            "aligned": _pair(dict(TARGET, num_layers=1), aligned)}


def _engine(models, draft=None, **kw):
    _, _, cfg, params = models["target"]
    if draft is None:
        return Engine(params, cfg, ServingConfig(**dict(POOL, **kw)),
                      device="cpu")
    _, _, dcfg, dparams = models[draft]
    return Engine(params, cfg, ServingConfig(**dict(SPEC, **kw)),
                  draft_params=dparams, draft_cfg=dcfg, device="cpu")


def _jengine(models, draft=None, **kw):
    cfg, params, _, _ = models["target"]
    if draft is None:
        return JEngine(params, cfg, JServingConfig(**dict(POOL, **kw)))
    dcfg, dparams, _, _ = models[draft]
    return JEngine(params, cfg, JServingConfig(**dict(SPEC, **kw)),
                   draft_params=dparams, draft_cfg=dcfg)


def _prompts(seed, n, lo=5, hi=20):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 61, (int(rng.randint(lo, hi)),)).astype(np.int32)
            for _ in range(n)]


def _run(eng, requests):
    """Submit (prompt, max_new, sampling kwargs) requests, drive the
    engine to idle, return the streams."""
    hs = [eng.submit(p, max_new_tokens=n, **kw) for p, n, kw in requests]
    eng.run_until_idle()
    return [h.result(timeout=5) for h in hs]


def _greedy(models, prompts, n):
    return _run(_engine(models, num_blocks=65),
                [(p, n, {}) for p in prompts])


# -- sampled plain decode -----------------------------------------------------
def _sampled_requests():
    reqs = []
    for i, (temp, top_k, top_p) in enumerate(FILTERS):
        for j, p in enumerate(_prompts(11 + i, 3)):
            reqs.append((p, 6, dict(temperature=temp, top_k=top_k,
                                    top_p=top_p, seed=21 + j)))
    # the JAX package's eviction-replay requests
    reqs += [(p, 10, dict(temperature=0.8, seed=50 + i))
             for i, p in enumerate(_prompts(14, 4, lo=8, hi=16))]
    return reqs


@pytest.fixture(scope="module")
def sampled_plain(models):
    reqs = _sampled_requests()
    want = _run(_jengine(models, num_blocks=65), reqs)
    got = _run(_engine(models, num_blocks=65), reqs)
    return reqs, want, got


@pytest.mark.parametrize("setting", range(len(FILTERS)))
def test_sampled_streams_equal_jax(sampled_plain, setting):
    _, want, got = sampled_plain
    rows = slice(3 * setting, 3 * setting + 3)
    assert got[rows] == want[rows]
    assert all(len(s) == 6 for s in got[rows])


def test_sampled_streams_replay_after_eviction(models, sampled_plain):
    """Draws are keyed by (seed, position): a tight pool that evicts and
    recomputes gives the streams the JAX engine gave un-evicted."""
    reqs, want, _ = sampled_plain
    eng = _engine(models, num_blocks=12)
    got = _run(eng, reqs[-4:])
    assert eng.stats()["evicted"] > 0, "pool was meant to force evictions"
    assert got == want[-4:]
    assert eng.pool.num_used == 0


# -- greedy speculative decode ------------------------------------------------
@pytest.mark.parametrize("draft", ["random", "aligned"])
def test_greedy_spec_equals_plain_greedy(models, draft):
    prompts = _prompts(3, 4)
    eng = _engine(models, draft)
    got = _run(eng, [(p, 10, {}) for p in prompts])
    assert got == _greedy(models, prompts, 10)
    st = eng.stats()
    assert st["spec_turns"] > 0 and st["spec_tokens_drafted"] > 0
    if draft == "aligned":
        assert st["spec_tokens_accepted"] > 0


def test_identical_draft_accepts_everything(models):
    _, _, cfg, params = models["target"]
    eng = Engine(params, cfg, ServingConfig(**SPEC), draft_params=params,
                 draft_cfg=cfg, device="cpu")
    prompts = _prompts(5, 2)
    assert _run(eng, [(p, 9, {}) for p in prompts]) == \
        _greedy(models, prompts, 9)
    st = eng.stats()
    assert st["spec_tokens_accepted"] == st["spec_tokens_drafted"] > 0
    assert st["spec_accept_rate"] == 1.0
    # q == p bit for bit: rejection sampling accepts every draft too
    eng = Engine(params, cfg, ServingConfig(**SPEC), draft_params=params,
                 draft_cfg=cfg, device="cpu")
    _run(eng, [(p, 8, dict(temperature=1.1, seed=40 + i))
               for i, p in enumerate(_prompts(13, 2))])
    st = eng.stats()
    assert st["spec_tokens_accepted"] == st["spec_tokens_drafted"] > 0


def test_greedy_spec_through_eviction(models):
    prompts = _prompts(6, 4, lo=8, hi=16)
    eng = _engine(models, "aligned", num_blocks=12)
    got = _run(eng, [(p, 10, {}) for p in prompts])
    assert eng.stats()["evicted"] > 0, "pool was meant to force evictions"
    assert got == _greedy(models, prompts, 10)
    assert eng.pool.num_used == 0 and eng.draft_pool.num_used == 0


def test_warmup_leaves_streams_unchanged(models):
    """``warmup``/``warmup_spec`` run every entry point on inactive rows,
    which write only the scratch block: the streams after them are the
    streams without them."""
    prompts = _prompts(7, 3)
    eng = _engine(models, "aligned")
    eng.model.warmup(eng.params, eng.pool, batch_sizes=(1, 4))
    eng.warmup_spec(batch_sizes=(1, 4))
    assert eng.pool.num_used == eng.draft_pool.num_used == 0
    reqs = [(p, 8, dict(temperature=0.9, seed=i)) for i, p in
            enumerate(prompts)]
    assert _run(eng, reqs) == _run(_engine(models, "aligned"), reqs)


def test_greedy_spec_after_chunked_prefill(models):
    prompt = _prompts(8, 1, lo=40, hi=41)
    eng = _engine(models, "aligned")
    assert _run(eng, [(prompt[0], 6, {})]) == _greedy(models, prompt, 6)


def test_mid_decode_cancel_frees_both_pools(models):
    eng = _engine(models, "aligned")
    h = eng.submit(_prompts(9, 1, lo=6, hi=7)[0], max_new_tokens=50)
    for _ in range(4):
        eng.step()
    assert eng.pool.num_used > 0 and eng.draft_pool.num_used > 0
    h.cancel()
    eng.run_until_idle()
    toks = h.result(timeout=5)
    assert h.status == "cancelled" and 0 < len(toks) < 50
    assert eng.pool.num_free == eng.pool.capacity
    assert eng.draft_pool.num_free == eng.draft_pool.capacity


def test_set_spec_toggle_and_catchup(models):
    """Plain decode while speculation is off, then the draft pool
    catches up past the lag: the stream stays the greedy stream."""
    prompt = _prompts(10, 1, lo=7, hi=8)[0]
    eng = _engine(models, "aligned")
    h = eng.submit(prompt, max_new_tokens=14)
    for _ in range(2):
        eng.step()
    eng.set_spec(False)
    assert not eng.spec_enabled
    turns = eng.stats()["spec_turns"]
    for _ in range(4):
        eng.step()
    assert eng.stats()["spec_turns"] == turns
    eng.set_spec(True)
    eng.run_until_idle()
    assert h.result(timeout=5) == _greedy(models, [prompt], 14)[0]
    assert eng.stats()["spec_turns"] > turns
    with pytest.raises(MXNetError, match="not configured"):
        _engine(models).set_spec(True)


# -- sampled speculative decode -----------------------------------------------
@pytest.fixture(scope="module")
def sampled_spec(models):
    prompts = _prompts(12, 4, lo=6, hi=14)
    reqs = [(prompts[0], 10, dict(temperature=0.9, seed=33)),
            (prompts[1], 10, dict(temperature=1.0, top_k=7, seed=34)),
            (prompts[2], 10, dict(temperature=0.8, top_p=0.9, seed=35)),
            (prompts[3], 10, {})]
    want = _run(_jengine(models, "aligned"), reqs)
    eng = _engine(models, "aligned")
    got = _run(eng, reqs)
    return reqs, want, got, eng.stats()


@pytest.mark.parametrize("row", range(4))
def test_sampled_spec_streams_equal_jax(sampled_spec, row):
    _, want, got, st = sampled_spec
    assert got[row] == want[row]
    assert st["spec_tokens_accepted"] > 0


def test_sampled_spec_replays_and_seeds_differ(models, sampled_spec):
    reqs, _, got, _ = sampled_spec
    assert _run(_engine(models, "aligned"), reqs) == got
    reseeded = [(p, n, dict(kw, seed=kw["seed"] + 100) if kw else kw)
                for p, n, kw in reqs]
    other = _run(_engine(models, "aligned"), reseeded)
    assert other[:3] != got[:3] and other[3] == got[3]


# -- long sampled prompt through the context-parallel prefill ------------------
def test_cp_prefilled_sampled_prompt_equals_jax(models):
    jcfg, jp, tcfg, tp = models["target"]
    prompt = _prompts(15, 1, lo=64, hi=65)[0]
    kw = dict(temperature=0.9, top_k=20, seed=77)
    cp = dict(cp_kind="ulysses", cp_min_tokens=64)
    jeng = JEngine(jp, jcfg, JServingConfig(
        mesh=j_create_mesh((1,), ("seq",)), **dict(POOL, **cp)))
    want = _run(jeng, [(prompt, 1, kw)])
    mesh = create_mesh((1,), ("seq",), devices=["cpu"])
    plain = _engine(models, mesh=mesh, **cp)
    assert _run(plain, [(prompt, 1, kw)]) == want
    assert plain.stats()["cp_prefills"] == 1
    # with a draft: it ingests the cp-prefilled context through its own
    # paged prefill, and the greedy spec stream is the plain greedy one
    spec = _engine(models, "aligned", mesh=mesh, **cp)
    assert _run(spec, [(prompt, 1, kw)]) == want
    spec = _engine(models, "aligned", mesh=mesh, **cp)
    got = _run(spec, [(prompt, 8, {})])
    assert got == _greedy(models, [prompt], 8)
    assert spec.stats()["cp_prefills"] == 1
    assert spec.stats()["spec_tokens_accepted"] > 0


# -- construction -------------------------------------------------------------
@pytest.mark.parametrize("case", ["spec_without_draft", "draft_without_spec",
                                  "spec_static_policy", "spec_k_zero"])
def test_init_refuses_as_jax(models, case):
    cfg_kw, draft = {
        "spec_without_draft": (dict(spec=True), None),
        "draft_without_spec": ({}, "random"),
        "spec_static_policy": (dict(spec=True, policy="static"), "random"),
        "spec_k_zero": (dict(spec=True, spec_k=0), "random"),
    }[case]
    jcfg, jp, tcfg, tp = models["target"]
    jd = models[draft][:2] if draft else (None, None)
    td = models[draft][2:] if draft else (None, None)
    with pytest.raises(JMXNetError) as want:
        JEngine(jp, jcfg, JServingConfig(**dict(POOL, **cfg_kw)),
                draft_params=jd[1], draft_cfg=jd[0])
    with pytest.raises(MXNetError) as got:
        Engine(tp, tcfg, ServingConfig(**dict(POOL, **cfg_kw)),
               draft_params=td[1], draft_cfg=td[0], device="cpu")
    assert str(got.value) == str(want.value)


def test_spec_off_has_no_draft(models):
    eng = _engine(models)
    _run(eng, [(p, 4, {}) for p in _prompts(1, 2)])
    assert eng.draft_model is None and eng.draft_pool is None
    st = eng.stats()
    assert st["spec_turns"] == 0 and st["spec_accept_rate"] is None
    assert not st["spec_enabled"]


# -- no draw in an all-greedy batch -------------------------------------------
def test_all_greedy_batch_makes_no_threefry_draw(models):
    eng = _engine(models, "aligned")
    tf.threefry2x32.calls.clear()
    _run(eng, [(p, 8, {}) for p in _prompts(16, 3)])
    st = eng.stats()
    assert st["spec_turns"] > 0 and st["tokens_emitted"] == 24
    assert tf.threefry2x32.calls == {}
    # the same entry points draw once a row samples
    _run(eng, [(_prompts(17, 1)[0], 4, dict(temperature=0.7, seed=1))])
    assert tf.threefry2x32.calls.get("cpu", 0) > 0


def test_draft_turn_and_verify_shapes(models):
    eng = _engine(models, "aligned")
    bt = np.zeros((2, eng.model.max_blocks), np.int32)
    bt[:, :2] = [[1, 2], [3, 4]]
    d, q = eng.draft_model.draft_turn(
        eng.draft_params, eng.draft_pool.k, eng.draft_pool.v,
        np.asarray([[3, 4], [5, 0]]), np.asarray([0, 0]),
        np.asarray([2, 1]), bt, np.ones(2, bool), np.asarray([3, 2]), 3,
        temperature=[0.9, 0.0], seed=[1, 2])
    assert d.shape == (2, 3) and q.shape == (2, 3, 61)
    np.testing.assert_allclose(q.sum(-1).numpy(), 1.0, rtol=1e-5)
    n, tok = eng.model.verify(
        eng.params, eng.pool.k, eng.pool.v, np.asarray([[4], [5]]), d, q,
        np.asarray([1, 0]), np.asarray([4, 3]), bt, np.ones(2, bool),
        temperature=[0.9, 0.0], seed=[1, 2])
    assert n.shape == tok.shape == (2,)
    assert 0 <= int(n[0]) <= 3 and 0 <= int(n[1]) <= 2


def test_sampled_turn_derives_its_keys_in_one_call(models):
    # a sampled draft turn: one key derivation (two hash passes) and one
    # Gumbel pass a proposal; a sampled verify: the key derivation, the
    # accept uniforms and one pass for the bonus and residual Gumbels
    eng = _engine(models, "aligned")
    bt = np.zeros((2, eng.model.max_blocks), np.int32)
    bt[:, :2] = [[1, 2], [3, 4]]
    samp = dict(temperature=[0.9, 0.0], seed=[1, 2])
    tf.threefry2x32.calls.clear()
    d, q = eng.draft_model.draft_turn(
        eng.draft_params, eng.draft_pool.k, eng.draft_pool.v,
        np.asarray([[3, 4], [5, 0]]), np.asarray([0, 0]),
        np.asarray([2, 1]), bt, np.ones(2, bool), np.asarray([3, 3]), 3,
        **samp)
    assert tf.threefry2x32.calls == {"cpu": 2 + 3}
    tf.threefry2x32.calls.clear()
    eng.model.verify(
        eng.params, eng.pool.k, eng.pool.v, np.asarray([[4], [5]]), d, q,
        np.asarray([1, 0]), np.asarray([4, 4]), bt, np.ones(2, bool), **samp)
    assert tf.threefry2x32.calls == {"cpu": 4}
