"""The port's compile/transfer verifier (``analysis/compile_verify.py``)
against the JAX package's runtime cases, on the CPU.

- the runtime cases of ``tests/unittest/test_mxjit.py``: a recompile
  storm and a static-value storm name the argument that changed,
  recompiles within budget are no violation, group budgets max-merge and
  audit, ``rebind`` keeps the compile history, the verifier off costs
  nothing, an over-budget region is caught with its sites, the
  ``summary()`` shape, and a serving decode step's ledger holds only
  the token vector (4 bytes a bucketed lane);
- parity: one small serving workload, plain and speculative, through
  the JAX ``Engine`` and the port's under ``MXNET_JIT_VERIFY=record``
  gives the same boundary names, the same compile count at each
  boundary and the same D2H bytes in each region; the D2H site ids
  differ only by the package's directory (``mxnet_tpu/`` and
  ``mxnet_tpu_torch/``).
"""
import jax
import numpy as np
import pytest
import torch

from mxnet_tpu.analysis import compile_verify as jcv
from mxnet_tpu.models import transformer as jt
from mxnet_tpu.serving import Engine as JEngine
from mxnet_tpu.serving import ServingConfig as JServingConfig
from mxnet_tpu_torch.analysis import compile_verify as cv
from mxnet_tpu_torch.models import transformer as tt
from mxnet_tpu_torch.serving import Engine, PagedKVPool, ServingConfig
from mxnet_tpu_torch.serving.model import ServingModel

TARGET = dict(vocab_size=61, num_layers=1, d_model=32, num_heads=2, d_ff=64,
              max_seq_len=96, dtype="float32")
DRAFT = dict(TARGET, num_layers=1, d_model=16, d_ff=32)
POOL = dict(block_size=8, num_blocks=33, max_batch=4, prefill_chunk=16)
SPEC = dict(POOL, spec=True, spec_k=3, token_budget=64)
STEP_SITE = "serving/model.py::ServingModel.step"


@pytest.fixture(scope="module", autouse=True)
def _record_mode():
    """Both verifiers armed in record mode (the suite's conftest sets it
    before either package is imported; a run without it gets it here),
    the port's ambient state cleared first; the lock tracer, which the
    port's Engine refuses, unset."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MXNET_JIT_VERIFY", "record")
        mp.delenv("MXNET_ENGINE_VERIFY", raising=False)
        mp.delenv("MXNET_PROF", raising=False)
        cv.reload()
        cv.reset()
        jcv.reload()
        yield
    cv.reload()
    jcv.reload()


def _zeros(n, dtype=torch.float32):
    return torch.zeros((n,), dtype=dtype)


# -- compile budgets -----------------------------------------------------------

def test_recompile_storm_names_the_changed_arg():
    assert cv.ENABLED and cv.MODE == "record"
    f = cv.wrap("test.storm", lambda x: x + 1.0, budget=1,
                group="test.storm")
    with cv.expecting_violations() as caught:
        f(_zeros(2))
        f(_zeros(3))                    # shape varies -> compile 2
        f(_zeros(3, torch.int32))       # dtype varies -> compile 3
    assert [v["event"] for v in caught] == ["unexpected_recompile"] * 2
    assert any("arg[0]: shape (2,) -> (3,)" in d for d in caught[0]["diff"])
    assert any("dtype float32 -> int32" in d for d in caught[1]["diff"])
    assert not any(r["name"] == "test.storm" for r in cv.unexpected())


def test_device_change_is_a_compile_named_in_the_diff():
    f = cv.wrap("test.device", lambda x: x, budget=1)
    with cv.expecting_violations() as caught:
        f(_zeros(2))
        f(torch.zeros((2,), device="meta"))
    assert len(caught) == 1
    assert caught[0]["diff"] == ["arg[0]: device cpu -> meta"]


def test_static_value_storm_names_the_value():
    g = cv.wrap("test.static_storm", lambda x, flip: x * 2.0, budget=1)
    with cv.expecting_violations() as caught:
        g(_zeros(2), True)
        g(_zeros(2), False)
    assert len(caught) == 1
    assert any("static value True -> False" in d
               for d in caught[0]["diff"])


def test_within_budget_recompiles_are_not_violations():
    f = cv.wrap("test.bucketed", lambda x: x + 1.0, budget=2)
    with cv.expecting_violations() as caught:
        f(_zeros(2))
        f(_zeros(4))     # second bucket: within budget
        f(_zeros(2))     # seen: no compile
    assert caught == [] and f.compiles == 2


def test_group_budget_declaration_and_check():
    cv.declare_budget("test.budget_group", 2)
    cv.declare_budget("test.budget_group", 1)   # max-merge
    f = cv.wrap("test.budget_member", lambda x: x - 1.0, budget=8,
                group="test.budget_group")
    for n in (2, 3, 4):
        f(_zeros(n))
    over = {g: (d, o) for g, d, o in cv.check_budgets()}
    assert over.get("test.budget_group") == (2, 3)


def test_rebind_keeps_compile_history():
    f = cv.wrap("test.rebind", lambda x: x * 3.0, budget=4)
    f(_zeros(2))
    raw = cv.unwrap(f)
    assert raw is not f
    g = cv.rebind(f, lambda x: x * 3.0)
    assert g is f and g.compiles == 1


def test_raise_mode_raises_at_the_offending_dispatch(monkeypatch):
    monkeypatch.setenv("MXNET_JIT_VERIFY", "1")
    try:
        assert cv.reload() and cv.MODE == "raise"
        f = cv.wrap("test.raise", lambda x: x, budget=1)
        f(_zeros(2))
        with cv.expecting_violations():   # diverted: no raise
            f(_zeros(3))
        with pytest.raises(cv.JitVerifyError, match=r"arg\[0\]: shape"):
            f(_zeros(5))
        assert any(r["name"] == "test.raise" for r in cv.unexpected())
    finally:
        monkeypatch.setenv("MXNET_JIT_VERIFY", "record")
        cv.reload()
        cv.reset()


def test_zero_overhead_when_off(monkeypatch):
    monkeypatch.setenv("MXNET_JIT_VERIFY", "0")
    try:
        assert cv.reload() is False

        def f(x):
            return x

        assert cv.wrap("test.off", f) is f
        assert cv.rebind(f, f) is f
        with cv.d2h_region("test.off", budget_bytes=0):
            cv.note_d2h(1 << 20, "test.off::pull")
        assert not cv.d2h_violations()
        assert "test.off::pull" not in cv.observed_d2h_sites()
        m = ServingModel(tt.TransformerConfig(**TARGET), block_size=4,
                         max_blocks_per_req=4, batch_buckets=(2,),
                         chunk_buckets=(8,))
        assert m._compiled(("step", 2, 1)) == m._sample_step
    finally:
        monkeypatch.setenv("MXNET_JIT_VERIFY", "record")
        assert cv.reload() is True


# -- the D2H ledger -----------------------------------------------------------

def _tiny_serving_model():
    cfg = tt.TransformerConfig(vocab_size=31, num_layers=1, d_model=16,
                               num_heads=2, d_ff=32, max_seq_len=64,
                               dtype="float32")
    params = tt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    pool = PagedKVPool(cfg.num_layers, cfg.num_heads,
                       cfg.d_model // cfg.num_heads, num_blocks=9,
                       block_size=4, device="cpu")
    m = ServingModel(cfg, block_size=4, max_blocks_per_req=4,
                     batch_buckets=(2,), chunk_buckets=(8,))
    return m, params, pool


def _step(m, params, pool, tokens=((1, 2, 3),)):
    bt = np.zeros((1, 4), np.int64)
    bt[0] = [1, 2, 3, 4]
    tokens = np.asarray(tokens, np.int64)
    return m.step(params, pool.k, pool.v, tokens, np.zeros((1,), np.int64),
                  np.asarray([tokens.shape[1]], np.int64), bt,
                  np.ones((1,), bool))


def test_serving_decode_passes_token_vector_only_ledger():
    """A step's entire D2H traffic is ONE token vector of 4 bytes per
    bucketed row."""
    m, params, pool = _tiny_serving_model()
    before = len(cv.d2h_violations())
    site = "mxnet_tpu_torch/" + STEP_SITE
    b0 = cv.observed_d2h_sites().get(site, {}).get("bytes", 0)
    for _ in range(3):
        with cv.d2h_region("test.decode_step", budget_bytes=4 * 2) as rec:
            _step(m, params, pool)
        assert rec["bytes"] == 4 * 2 and rec["sites"] == {site: 8}
    assert len(cv.d2h_violations()) == before
    assert cv.observed_d2h_sites()[site]["bytes"] - b0 == 3 * 4 * 2


def test_over_budget_region_is_caught_with_sites():
    m, params, pool = _tiny_serving_model()
    with cv.expecting_violations() as caught:
        with cv.d2h_region("test.too_tight", budget_bytes=1):
            _step(m, params, pool)
    assert len(caught) == 1
    v = caught[0]
    assert v["event"] == "d2h_over_budget" and v["budget_bytes"] == 1
    assert "mxnet_tpu_torch/" + STEP_SITE in v["sites"]


def test_off_bucket_dispatch_names_the_argument():
    """The bucket's program called with a chunk the bucket does not
    hold: the verifier names the tokens argument that broke it."""
    m, params, pool = _tiny_serving_model()
    _step(m, params, pool)                       # ("step", 2, 8)
    fn = m._compiled(("step", 2, 8))
    assert fn.compiles == 1
    samp = m._sampling_arrays(2, 1, None, None, None, None)
    batch = m._batch(2, torch.device("cpu"), [0], [3], [[1, 2, 3, 4]],
                     [True])
    with cv.expecting_violations() as caught:
        with torch.no_grad():
            fn(params, pool.k, pool.v, torch.zeros((2, 5), dtype=torch.int64),
               *batch, samp, 0)
    assert len(caught) == 1
    assert caught[0]["name"] == "serve.step|2|8"
    assert any(d.startswith("arg[3]: shape (2, 8) -> (2, 5)")
               for d in caught[0]["diff"])


def test_summary_shape_for_statusz():
    s = cv.summary()
    assert s["mode"] in ("record", "raise")
    assert isinstance(s["boundaries"], dict)
    assert isinstance(s["groups"], dict)
    assert set(s) == set(jcv.summary())


# -- parity with the JAX package ---------------------------------------------

def _np_params(cfg, seed):
    rng = np.random.RandomState(seed)

    def dense(shape, scale=None):
        scale = 1.0 / np.sqrt(shape[0]) if scale is None else scale
        return (rng.randn(*shape) * scale).astype(np.float32)

    def ln():
        return {"scale": np.ones(cfg["d_model"], np.float32),
                "bias": np.zeros(cfg["d_model"], np.float32)}

    d, f = cfg["d_model"], cfg["d_ff"]
    return {"embed": dense((cfg["vocab_size"], d), 0.02),
            "pos_embed": dense((cfg["max_seq_len"], d), 0.02), "ln_f": ln(),
            "layers": [{"ln1": ln(), "wqkv": dense((d, 3 * d)),
                        "wo": dense((d, d)), "ln2": ln(),
                        "w1": dense((d, f)), "w2": dense((f, d))}
                       for _ in range(cfg["num_layers"])]}


class _Ledger:
    """Every D2H region a package's engine opens, with the bytes it
    saw: the region context manager wrapped on the verifier module."""

    def __init__(self, mod, monkeypatch):
        self.regions = []
        inner = mod.d2h_region
        regions = self.regions

        import contextlib

        @contextlib.contextmanager
        def region(name, budget_bytes=None):
            with inner(name, budget_bytes=budget_bytes) as rec:
                yield rec
            regions.append((name, budget_bytes, rec["bytes"]))

        monkeypatch.setattr(mod, "d2h_region", region)


def _run(pkg, mod, monkeypatch, spec):
    """One workload: 2 greedy requests of mixed lengths (5 and 19
    tokens), 4 new tokens each; returns the new boundaries' (name,
    compiles, budget) and the regions."""
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, 61, (n,)).astype(np.int32) for n in (5, 19)]
    tree = _np_params(TARGET, 0)
    dtree = _np_params(DRAFT, 7)
    n0 = len(mod._BOUNDARIES)
    ledger = _Ledger(mod, monkeypatch)
    kw = dict(SPEC if spec else POOL)
    if pkg == "jax":
        put = lambda t: jax.tree_util.tree_map(jax.numpy.asarray, t)  # noqa
        extra = dict(draft_params=put(dtree),
                     draft_cfg=jt.TransformerConfig(**DRAFT)) if spec else {}
        eng = JEngine(put(tree), jt.TransformerConfig(**TARGET),
                      JServingConfig(**kw), **extra)
    else:
        extra = dict(draft_params=tt.params_from_numpy(dtree, "cpu"),
                     draft_cfg=tt.TransformerConfig(**DRAFT)) if spec else {}
        eng = Engine(tt.params_from_numpy(tree, "cpu"),
                     tt.TransformerConfig(**TARGET), ServingConfig(**kw),
                     device="cpu", **extra)
    streams = eng.generate(prompts, max_new_tokens=4)
    monkeypatch.undo()
    bounds = sorted((b.name, b.compiles, b.budget)
                    for b in mod._BOUNDARIES[n0:])
    return streams, bounds, ledger.regions


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_same_boundaries_compiles_and_d2h_bytes_as_jax(spec, monkeypatch):
    unexpected = len(jcv.unexpected()), len(cv.unexpected())
    violations = len(jcv.d2h_violations()), len(cv.d2h_violations())
    want_streams, want_bounds, want_regions = _run("jax", jcv, monkeypatch,
                                                   spec)
    got_streams, got_bounds, got_regions = _run("port", cv, monkeypatch,
                                                spec)
    assert got_streams == want_streams
    assert got_bounds == want_bounds
    names = {b[0].split("|")[0] for b in got_bounds}
    assert names == ({"serve.step", "serve.draft_turn", "serve.verify"}
                     if spec else {"serve.step"})
    assert got_regions == want_regions
    kinds = {r[0] for r in got_regions}
    assert kinds == ({"serve.spec_turn", "serve.decode_step"} if spec
                     else {"serve.decode_step"}) or (
        spec and kinds == {"serve.spec_turn"})
    # a plain decode step pulls the token vector at its bucket's width
    for name, budget, nbytes in got_regions:
        assert nbytes <= budget
        if name == "serve.decode_step":
            assert nbytes == budget
    assert (len(jcv.unexpected()), len(cv.unexpected())) == unexpected
    assert (len(jcv.d2h_violations()),
            len(cv.d2h_violations())) == violations
