"""The port's compile layer against the JAX package's, on the CPU.

- ``ir.find_fusible_chains`` finds the same chains (op and node names)
  on the same graphs;
- ``optimize`` under ``MXNET_COMPILE_OPT=1`` gives the same
  ``last_report()`` (the seconds aside) and the same rewritten node list
  (op names and node names) on mlp, lenet, resnet_small and the conv
  graph of ``tests/unittest/test_compile.py`` (resnet_small at one unit
  a stage and 16 px), and on bench.py's ResNet-50 (the card's leg A);
- golden equivalence in the port: with fold and fuse alone the bound
  executor's outputs and gradients are bit-equal to the unrewritten
  graph's; with every pass (layout rewrites the reductions) within
  rtol and atol 2e-3 (atol scaled by a gradient's largest magnitude),
  the JAX tests' bound;
- the port's rewritten executor against the JAX package's rewritten
  executor on the conv graph and lenet, from the same numpy parameters
  and inputs, f32: outputs
  within rtol 1e-4 / atol 1e-5 and every gradient within 1e-4 relative
  L2, ||got - want|| / ||want|| (two backends summing in different
  orders);
- ``check_equivalence`` catches a divergent graph; the layer is off by
  default and then costs nothing (the executor binds the user's graph
  object); each pass can be run alone;
- ``config_key()`` is byte-equal to the JAX package's over a set of
  environments;
- the tuning DB round-trips, survives corruption, and a JAX DB file
  loads (and the other way round); the tuner measures once and then
  reads, with an injected clock;
- the Predictor folds a subexpression of parameters, against the JAX
  Predictor's output; a training executor never bakes weights;
- ``FeedForward`` LeNet fits 5 per-batch steps under
  ``MXNET_COMPILE_OPT=1``: each step's loss within 1e-4 relative of the
  JAX fit's, outputs within 1e-3 relative L2;
- the jit cache's keyed directory (the JAX package's name for the same
  configuration), its sweep of corrupt entries and its counters, with an
  injected compile function (the host has no NVRTC), through
  ``ops._nvrtc.compile_cubin`` too.
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu.compile as mxc_j
import mxnet_tpu_torch as mt
import mxnet_tpu_torch.compile as mxc_t
from mxnet_tpu.compile import autotune as at_j
from mxnet_tpu.compile import ir as ir_j
from mxnet_tpu.compile import jit_cache as jc_j
from mxnet_tpu_torch.compile import autotune as at_t
from mxnet_tpu_torch.compile import fold as fold_t
from mxnet_tpu_torch.compile import ir as ir_t
from mxnet_tpu_torch.compile import jit_cache as jc_t
from mxnet_tpu_torch.compile import pipeline as pipe_t

ENV_KEYS = ("MXNET_COMPILE_OPT", "MXNET_COMPILE_PASSES",
            "MXNET_COMPILE_CACHE_DIR", "MXNET_COMPILE_TUNE",
            "MXNET_COMPILE_VERIFY", "MXNET_COMPILE_MATMUL_PREC",
            "MXNET_SCAN_TRAIN", "MXNET_TRAIN_SCAN_K")


@pytest.fixture(scope="module", autouse=True)
def _module_env():
    """Both compile layers start off; the JAX graphs compile with most
    optimizations off (they run a few times each); torch's CPU exp and
    tanh are warmed (their first multithreaded call can be off)."""
    import jax

    t = torch.randn(100000)
    torch.exp(t)
    torch.tanh(t)
    prev = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    with pytest.MonkeyPatch.context() as mp:
        for k in ENV_KEYS:
            mp.delenv(k, raising=False)
        _reload()
        yield
    _reload()
    jax.config.update("jax_disable_most_optimizations", prev)
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _reset_compile():
    """pytest restores a test's monkeypatched MXNET_COMPILE_* before
    this teardown; re-read them in both packages, and disarm the ports'
    cubin cache."""
    yield
    _reload()
    jc_t._configured_dir = None


def _reload():
    mxc_j.reload()
    mxc_t.reload()


def _set(monkeypatch, **env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    _reload()


# -- graphs, built in each package under a fresh name manager --------------

def _chain_sym(pkg):
    s = pkg.sym.Variable("data") + 1.0
    s = pkg.sym.Activation(data=s, act_type="relu")
    return s * 2.0


def _conv_sym(pkg):
    sym = pkg.sym
    data = sym.Variable("data")
    c1 = sym.Convolution(data=data, num_filter=8, kernel=(3, 3),
                         pad=(1, 1), name="c1")
    bn = sym.BatchNorm(data=c1, name="bn")
    act = sym.Activation(data=bn, act_type="relu")
    c2 = sym.Convolution(data=act, num_filter=8, kernel=(3, 3),
                         pad=(1, 1), name="c2")
    s = sym.Activation(data=c2 + c1, act_type="relu")
    p = sym.Pooling(data=s, kernel=(2, 2), stride=(2, 2), pool_type="max")
    fc = sym.FullyConnected(data=sym.Flatten(data=p), num_hidden=10,
                            name="fc")
    return sym.SoftmaxOutput(data=fc, name="softmax")


def _multi_consumer(pkg):
    a = pkg.sym.Variable("data") + 1.0
    return pkg.sym.Group([a * 2.0, a * 3.0])


def _head_interior(pkg):
    a = pkg.sym.Variable("data") + 1.0
    return pkg.sym.Group([a, pkg.sym.Activation(data=a, act_type="relu")])


def _binary_chain(pkg):
    s = pkg.sym.Variable("data") + pkg.sym.Variable("other")
    return pkg.sym.Activation(data=s, act_type="relu") * 0.5


GRAPHS = {
    "chain": (_chain_sym, {"data": (4, 6)}),
    "multi_consumer": (_multi_consumer, {"data": (4, 6)}),
    "head_interior": (_head_interior, {"data": (4, 6)}),
    "binary_chain": (_binary_chain, {"data": (3, 5), "other": (3, 5)}),
    "conv": (_conv_sym, {"data": (2, 3, 8, 8), "softmax_label": (2,)}),
    "mlp": (lambda pkg: pkg.models.get_mlp(),
            {"data": (8, 784), "softmax_label": (8,)}),
    "lenet": (lambda pkg: pkg.models.get_lenet(),
              {"data": (4, 1, 28, 28), "softmax_label": (4,)}),
    "resnet_small": (lambda pkg: pkg.models.get_resnet_small(
        num_classes=10, n=1), {"data": (2, 3, 16, 16),
                               "softmax_label": (2,)}),
}
ZOO = ["mlp", "lenet", "resnet_small", "conv"]


def _build(pkg, name):
    with pkg.name.NameManager():
        return GRAPHS[name][0](pkg)


def _shapes(sym, name):
    arg_shapes, _, _ = sym.infer_shape(**GRAPHS[name][1])
    return dict(zip(sym.list_arguments(), (tuple(s) for s in arg_shapes)))


def _node_list(sym):
    return [(n.op.name, n.name) for n in sym.nodes if not n.is_variable]


def _chains(ir, sym):
    return [[(n.op.name, n.name) for n in c]
            for c in ir.find_fusible_chains(sym)]


# -- IR walk ---------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_fusible_chains_match_the_jax_package(name):
    want = _chains(ir_j, _build(mj, name))
    got = _chains(ir_t, _build(mt, name))
    assert got == want
    if name == "chain":
        assert [op for op, _ in got[0]] == ["_plus_scalar", "Activation",
                                           "_mul_scalar"]
    if name in ("multi_consumer", "head_interior"):
        assert got == []


# -- optimize: the same report and the same rewritten graph ----------------

@pytest.fixture(scope="module")
def jax_rewrites():
    """The JAX package's report and node list for each zoo graph, under
    MXNET_COMPILE_OPT=1, computed once."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MXNET_COMPILE_OPT", "1")
        mxc_j.reload()
        for name in ZOO:
            sym = _build(mj, name)
            shapes = _shapes(sym, name)
            opt = sym.optimize(input_shapes=shapes, input_types={
                n: np.float32 for n in shapes})
            report = {k: v for k, v in mxc_j.last_report().items()
                      if k != "secs"}
            out[name] = (report, _node_list(opt))
    mxc_j.reload()
    return out


@pytest.mark.parametrize("name", ZOO)
def test_optimize_matches_the_jax_report_and_node_list(name, jax_rewrites,
                                                       monkeypatch):
    _set(monkeypatch, MXNET_COMPILE_OPT="1")
    sym = _build(mt, name)
    shapes = _shapes(sym, name)
    opt = sym.optimize(input_shapes=shapes,
                       input_types={n: np.float32 for n in shapes})
    report = {k: v for k, v in mxc_t.last_report().items() if k != "secs"}
    want_report, want_nodes = jax_rewrites[name]
    assert report == want_report
    assert _node_list(opt) == want_nodes
    # the mlp has no conv and no chain: nothing rewrites, in both
    assert (opt is not sym) == any(want_report.values()) == (name != "mlp")


def test_bench_resnet50_report_and_node_list_match_jax(monkeypatch):
    """bench.py's ResNet-50 (s2d stem, batch 128, 224 px): the graph
    the card's ``phase_compile`` leg A rewrites. Shapes only: nothing
    runs."""
    shapes = {"data": (128, 3, 224, 224), "softmax_label": (128,)}
    got = {}
    for pkg, mxc in ((mj, mxc_j), (mt, mxc_t)):
        _set(monkeypatch, MXNET_COMPILE_OPT="1")
        with pkg.name.NameManager():
            sym = pkg.models.get_resnet(1000, 50, stem="s2d", image=224)
        arg_shapes, _, _ = sym.infer_shape(**shapes)
        full = dict(zip(sym.list_arguments(), (tuple(a) for a in arg_shapes)))
        opt = sym.optimize(input_shapes=full,
                           input_types={n: np.float32 for n in full})
        got[pkg] = ({k: v for k, v in mxc.last_report().items()
                     if k != "secs"}, _node_list(opt))
    assert got[mt] == got[mj]
    assert got[mt][0] == {"fold": 0, "layout": 53, "fuse": 16,
                          "precision": 0}


# -- golden equivalence in the port ----------------------------------------

def _numpy_args(sym, name, seed=3):
    rng = np.random.RandomState(seed)
    out = {}
    for n, s in _shapes(sym, name).items():
        if n == "softmax_label":
            out[n] = rng.randint(0, 9, s).astype(np.float32)
        elif n in GRAPHS[name][1]:
            out[n] = rng.rand(*s).astype(np.float32)
        else:
            out[n] = rng.normal(0, 0.05, s).astype(np.float32)
    return out


def _run_exe(pkg, name, args):
    sym = _build(pkg, name)
    exe = sym.simple_bind(pkg.cpu(), grad_req="write", **GRAPHS[name][1])
    for n, a in exe.arg_dict.items():
        a[:] = args[n]
    outs = [o.asnumpy() for o in exe.forward(is_train=True)]
    exe.backward()
    grads = {n: g.asnumpy() for n, g in exe.grad_dict.items()
             if g is not None}
    return exe, outs, grads


@pytest.mark.parametrize("name", ZOO)
def test_golden_equivalence_in_the_port(name, monkeypatch):
    args = _numpy_args(_build(mt, name), name)
    exe, o_ref, g_ref = _run_exe(mt, name, args)
    assert exe._exec_symbol is exe._symbol
    _set(monkeypatch, MXNET_COMPILE_OPT="1", MXNET_COMPILE_PASSES="fold,fuse")
    exe, o_ff, g_ff = _run_exe(mt, name, args)
    for a, b in zip(o_ref, o_ff):
        assert np.array_equal(a, b)
    for k in g_ref:
        assert np.array_equal(g_ref[k], g_ff[k]), k
    _set(monkeypatch, MXNET_COMPILE_PASSES="fold,layout,fuse,precision")
    exe, o_opt, g_opt = _run_exe(mt, name, args)
    loose = mxc_t.last_report().get("layout", 0) > 0
    tol = 2e-3 if loose else 0.0
    for a, b in zip(o_ref, o_opt):
        assert a.shape == b.shape
        assert np.allclose(a, b, rtol=tol, atol=tol), (
            name, float(np.max(np.abs(a - b))))
    assert set(g_ref) == set(g_opt)
    for k in g_ref:
        scale = max(1.0, float(np.max(np.abs(g_ref[k]))))
        assert np.allclose(g_ref[k], g_opt[k], rtol=tol,
                           atol=tol * scale), (name, k)


def test_layout_bn_statistics_and_moving_averages(monkeypatch):
    """NHWC BatchNorm's batch statistics equal the NCHW ones within f32
    rounding, and the moving mean and variance update the same."""
    name = "conv"
    args = _numpy_args(_build(mt, name), name)
    ref, _, _ = _run_exe(mt, name, args)
    _set(monkeypatch, MXNET_COMPILE_OPT="1", MXNET_COMPILE_PASSES="layout")
    opt, _, _ = _run_exe(mt, name, args)
    names = [n.op.name for n in opt._exec_symbol.nodes if not n.is_variable]
    assert names.count("_mxc_to_nhwc") == 1
    assert names.count("_mxc_to_nchw") == 1
    assert names.count("_mxc_bn_nhwc") == 1
    for k, a in ref.aux_dict.items():
        b = opt.aux_dict[k].asnumpy()
        assert np.allclose(a.asnumpy(), b, rtol=1e-5, atol=1e-6), k
        assert not np.array_equal(a.asnumpy(), np.zeros_like(b))


# -- the port's rewritten executor against the JAX package's ---------------

@pytest.fixture(scope="module")
def jax_rewritten_runs():
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MXNET_COMPILE_OPT", "1")
        mxc_j.reload()
        for name in ("conv", "lenet"):
            args = _numpy_args(_build(mj, name), name)
            _, o, g = _run_exe(mj, name, args)
            out[name] = (args, o, g, mxc_j.last_report())
    mxc_j.reload()
    return out


def _rel(got, want):
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("name", ["conv", "lenet"])
def test_rewritten_executor_matches_the_jax_rewritten_executor(
        name, jax_rewritten_runs, monkeypatch):
    args, o_want, g_want, report = jax_rewritten_runs[name]
    _set(monkeypatch, MXNET_COMPILE_OPT="1")
    _, o_got, g_got = _run_exe(mt, name, args)
    assert {k: v for k, v in mxc_t.last_report().items() if k != "secs"} \
        == {k: v for k, v in report.items() if k != "secs"}
    for a, b in zip(o_got, o_want):
        assert np.allclose(a, b, rtol=1e-4, atol=1e-5), (
            name, float(np.max(np.abs(a - b))))
    assert set(g_got) == set(g_want)
    for k in g_want:
        if not np.any(g_want[k]):
            assert not np.any(g_got[k]), k
            continue
        assert _rel(g_got[k], g_want[k]) <= 1e-4, (name, k)


# -- the check, the switches ------------------------------------------------

def test_check_equivalence_catches_a_divergent_graph():
    data = mt.sym.Variable("data")
    ref, bad = data * 2.0, data * 3.0
    with pytest.raises(mxc_t.CompileVerifyError):
        pipe_t.check_equivalence(ref, bad, {"data": (2, 2)})
    pipe_t.check_equivalence(ref, ref, {"data": (2, 2)}, loose=True)


def test_verify_mode_binds_clean_and_with_data_only_shapes(monkeypatch):
    _set(monkeypatch, MXNET_COMPILE_OPT="1", MXNET_COMPILE_VERIFY="1")
    _build(mt, "conv").simple_bind(mt.cpu(), **GRAPHS["conv"][1])
    sym = _build(mt, "resnet_small")
    opt = sym.optimize(input_shapes=GRAPHS["resnet_small"][1])
    assert opt is not sym and mxc_t.last_report()["layout"] > 0


def test_off_by_default_and_zero_overhead():
    assert not mxc_t.enabled()
    sym = _chain_sym(mt)
    assert mxc_t.optimize(sym) is sym
    exe = sym.bind(mt.cpu(), {"data": mt.nd.ones((2, 2), mt.cpu())})
    assert exe._exec_symbol is sym


@pytest.mark.parametrize("only", ["fold", "layout", "fuse", "precision"])
def test_each_pass_runs_alone(only, monkeypatch):
    _set(monkeypatch, MXNET_COMPILE_OPT="1", MXNET_COMPILE_PASSES=only,
         MXNET_COMPILE_MATMUL_PREC="fast")
    assert mxc_t.active_passes() == (only,)
    exe = _build(mt, "conv").simple_bind(mt.cpu(), **GRAPHS["conv"][1])
    report = mxc_t.last_report()
    assert set(report) == {only, "secs"}
    names = [n.op.name for n in exe._exec_symbol.nodes if not n.is_variable]
    assert any(n.startswith("_mxc_to_") for n in names) == (only == "layout")
    assert any(n.startswith("_mxc_fused") for n in names) == (only == "fuse")
    assert any(n.startswith("_mxc_fc_prec") for n in names) == (
        only == "precision")


def test_unknown_pass_raises(monkeypatch):
    monkeypatch.setenv("MXNET_COMPILE_PASSES", "fuse,warp")
    with pytest.raises(ValueError):
        mxc_t.reload()


def test_matmul_precision_explicit_fast(monkeypatch):
    args = _numpy_args(_build(mt, "mlp"), "mlp")
    _, o_ref, _ = _run_exe(mt, "mlp", args)
    _set(monkeypatch, MXNET_COMPILE_OPT="1", MXNET_COMPILE_MATMUL_PREC="fast")
    m = torch.backends.cuda.matmul
    flags = ("allow_tf32", "allow_bf16_reduced_precision_reduction",
             "allow_fp16_reduced_precision_reduction")
    before = [getattr(m, f) for f in flags]
    _, o_opt, _ = _run_exe(mt, "mlp", args)
    assert mxc_t.last_report()["precision"] == 3
    # allowed for the one call, restored after it
    assert [getattr(m, f) for f in flags] == before
    for a, b in zip(o_ref, o_opt):
        assert np.allclose(a, b, rtol=2e-3, atol=2e-3)


ENVS = [
    {},
    {"MXNET_COMPILE_OPT": "1"},
    {"MXNET_COMPILE_OPT": "1", "MXNET_COMPILE_PASSES": "fold"},
    {"MXNET_COMPILE_OPT": "true", "MXNET_COMPILE_PASSES": "fuse, layout",
     "MXNET_COMPILE_MATMUL_PREC": "fast"},
    {"MXNET_COMPILE_OPT": "0", "MXNET_COMPILE_MATMUL_PREC": "F32"},
    {"MXNET_COMPILE_OPT": "yes", "MXNET_COMPILE_PASSES": "precision,fold",
     "MXNET_COMPILE_MATMUL_PREC": ""},
]


@pytest.mark.parametrize("env", ENVS, ids=lambda e: ",".join(
    "%s=%s" % (k[14:], v) for k, v in sorted(e.items())) or "default")
def test_config_key_is_the_jax_packages(env, monkeypatch):
    _set(monkeypatch, **env)
    assert mxc_t.config_key() == mxc_j.config_key()
    assert mxc_t.active_passes() == mxc_j.active_passes()


# -- the tuner and its database ---------------------------------------------

def test_tuning_db_roundtrip_and_corruption(tmp_path):
    path = str(tmp_path / "tuning.json")
    db = at_t.TuningDB(path)
    db.put("k1", {"choice": "a", "timings": {"a": 0.1}})
    assert at_t.TuningDB(path).get("k1")["choice"] == "a"
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    before = at_t.CORRUPT
    db2 = at_t.TuningDB(path)
    assert db2.get("k1") is None
    assert at_t.CORRUPT == before + 1
    assert os.path.exists(path + ".corrupt")
    db2.put("k2", {"choice": "b"})
    assert at_t.TuningDB(path).get("k2")["choice"] == "b"


def test_tuning_db_files_cross_the_packages(tmp_path):
    a, b = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    rec = {"choice": "nhwc", "timings": {"nchw": 0.2, "nhwc": 0.1},
           "backend": "cpu", "ts": 1.0}
    at_j.TuningDB(a).put("conv_layout|x", rec)
    assert at_t.TuningDB(a).get("conv_layout|x") == rec
    at_t.TuningDB(b).put("conv_layout|x", rec)
    assert at_j.TuningDB(b).get("conv_layout|x") == rec
    assert open(a, "rb").read() == open(b, "rb").read()


def test_tuner_measures_once_then_reads_with_an_injected_clock(tmp_path):
    db = at_t.TuningDB(str(tmp_path / "t.json"))
    ticks = iter(np.arange(0.0, 100.0, 0.5))

    def clock():
        return float(next(ticks))

    calls = []

    def thunk(name, work):
        def run():
            calls.append(name)
            # one clock tick a call, ``work`` extra ticks: a slower body
            return at_t.measure_calls(
                lambda: [clock() for _ in range(work)], (), warmup=1,
                iters=2, clock=clock)
        return run

    trials = at_t.TRIALS
    t = at_t.Tuner(db, measure_enabled=True, backend="cpu")
    assert t.pick("k", {"a": thunk("a", 3), "b": thunk("b", 1)},
                  default="a") == "b"
    assert calls == ["a", "b"] and at_t.TRIALS == trials + 2
    rec = db.get("k")
    assert rec["timings"] == {"a": 2.0, "b": 1.0} and rec["backend"] == "cpu"
    t2 = at_t.Tuner(at_t.TuningDB(db.path), measure_enabled=True,
                    backend="cpu")
    assert t2.pick("k", {"a": thunk("a", 3), "b": thunk("b", 1)},
                   default="a") == "b"
    assert calls == ["a", "b"] and at_t.TRIALS == trials + 2
    t3 = at_t.Tuner(db, measure_enabled=False, backend="cpu")
    assert t3.pick("k2", {"a": thunk("a", 1)}, default="a") == "a"
    assert calls == ["a", "b"]


def test_conv_layout_trials_key_like_the_jax_tuner(tmp_path):
    db = at_t.TuningDB(str(tmp_path / "t.json"))
    t = at_t.Tuner(db, measure_enabled=True)
    before = at_t.TRIALS
    params = {"kernel": (3, 3), "stride": (1, 1), "pad": (1, 1),
              "num_filter": 8, "num_group": 1, "dilate": None}
    assert t.pick_conv_layout(params, (2, 4, 8, 8)) in ("nchw", "nhwc")
    assert at_t.TRIALS == before + 2 and len(db) == 1
    (key,) = db._load()
    jt = at_j.Tuner(None, backend="cpu")
    seen = []
    jt.pick = lambda k, c, default: seen.append(k) or default
    jt.pick_conv_layout(params, (2, 4, 8, 8))
    assert key == seen[0]
    assert t.pick_matmul_precision((4, 16), 8) in ("f32", "fast")
    assert t.pick_segment_boundary(["a", "b", "c", "d"], (4, 6)) in (
        "whole", "split")


# -- fold: the Predictor and the training executor ---------------------------

def _fold_sym(pkg):
    data = pkg.sym.Variable("data")
    w = pkg.sym.Variable("w")
    return pkg.sym.FullyConnected(data=data, weight=w * 2.0, no_bias=True,
                                  num_hidden=4, name="fc")


def test_predictor_folds_a_parameter_subexpression(monkeypatch):
    rng = np.random.RandomState(3)
    wv = rng.rand(4, 8).astype(np.float32)
    x = rng.rand(2, 8).astype(np.float32)
    _set(monkeypatch, MXNET_COMPILE_OPT="1", MXNET_COMPILE_VERIFY="1")
    from mxnet_tpu.predictor import Predictor as PJ
    from mxnet_tpu_torch.predictor import Predictor as PT

    pj = PJ(_fold_sym(mj).tojson(), {"arg:w": mj.nd.array(wv)},
            ctx=mj.cpu(), input_shapes={"data": (2, 8)})
    pj.forward(data=x)
    want = pj.get_output(0)
    assert mxc_j.last_report()["fold"] == 1
    pt = PT(_fold_sym(mt).tojson(), {"arg:w": mt.nd.array(wv, mt.cpu())},
            ctx=mt.cpu(), input_shapes={"data": (2, 8)})
    assert mxc_t.last_report()["fold"] == 1
    assert "w" not in pt._exe._exec_symbol.list_arguments()
    (const,) = [n for n in pt._exe._exec_symbol.nodes
                if not n.is_variable and n.op.name == fold_t.CONST_OP]
    (val,), _ = const.op.apply({}, [], [], False, None)
    assert not val.requires_grad and val.device.type == "cpu"
    pt.forward(data=x)
    got = pt.get_output(0)
    assert np.allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.allclose(got, x @ (wv * 2.0).T, rtol=1e-5, atol=1e-6)


def test_training_executor_never_bakes_weights(monkeypatch):
    _set(monkeypatch, MXNET_COMPILE_OPT="1")
    data, w = mt.sym.Variable("data"), mt.sym.Variable("w")
    out = data * (w + 1.0)
    exe = out.bind(mt.cpu(), {"data": mt.nd.ones((2, 2), mt.cpu()),
                              "w": mt.nd.ones((2, 2), mt.cpu())})
    assert "w" in exe._exec_symbol.list_arguments()
    assert not any((not n.is_variable) and n.op.name == fold_t.CONST_OP
                   for n in exe._exec_symbol.nodes)


# -- FeedForward under MXNET_COMPILE_OPT=1 -----------------------------------

FIT_BATCH, FIT_STEPS = 16, 5


def _fit_data():
    rng = np.random.RandomState(5)
    x = rng.rand(FIT_BATCH * FIT_STEPS, 1, 28, 28).astype(np.float32)
    y = rng.randint(0, 10, FIT_BATCH * FIT_STEPS).astype(np.float32)
    for i in range(len(y)):
        c = int(y[i])
        x[i, 0, 2 + 2 * c:6 + 2 * c, 4:24] += 0.9
    return x, y


def _fit_params():
    sym = mt.models.get_lenet()
    shapes, _, _ = sym.infer_shape(data=(FIT_BATCH, 1, 28, 28))
    rng = np.random.RandomState(6)
    out = {}
    for name, shape in zip(sym.list_arguments(), shapes):
        if name in ("data", "softmax_label"):
            continue
        fan = float(np.prod(shape[1:])) if len(shape) > 1 else 1.0
        out[name] = (rng.uniform(-1, 1, shape) * np.sqrt(3.0 / fan)
                     ).astype(np.float32)
    return out


def _fit(pkg, params):
    x, y = _fit_data()
    it = pkg.io.NDArrayIter(x, y, batch_size=FIT_BATCH, shuffle=False)
    outs = []

    def record(param):
        em = param.locals["executor_manager"]
        outs.append(em.curr_execgrp.train_execs[0].outputs[0].asnumpy())

    model = pkg.FeedForward(
        pkg.models.get_lenet(), ctx=pkg.cpu(), num_epoch=1,
        learning_rate=0.1, momentum=0.9,
        arg_params={k: pkg.nd.array(v, pkg.cpu())
                    for k, v in params.items()})
    model.fit(X=it, batch_end_callback=record)
    return outs


def _losses(outs):
    _, y = _fit_data()
    y = y.reshape(FIT_STEPS, FIT_BATCH).astype(int)
    return [float(-np.mean(np.log(o[np.arange(FIT_BATCH), t] + 1e-12)))
            for o, t in zip(outs, y)]


def test_feedforward_lenet_fits_under_compile_opt(monkeypatch):
    _set(monkeypatch, MXNET_COMPILE_OPT="1", MXNET_SCAN_TRAIN="0")
    params = _fit_params()
    want = _fit(mj, params)
    got = _fit(mt, params)
    assert mxc_t.last_report()["layout"] == 2
    assert len(got) == len(want) == FIT_STEPS
    for a, b in zip(_losses(got), _losses(want)):
        assert abs(a - b) <= 1e-4 * abs(b), (a, b)
    for a, b in zip(got, want):
        assert _rel(a, b) <= 1e-3


# -- the persistent cubin cache ----------------------------------------------

def test_jit_cache_keyed_dir_sweep_and_counters(tmp_path, monkeypatch):
    base = str(tmp_path)
    _set(monkeypatch, MXNET_COMPILE_CACHE_DIR=base, MXNET_COMPILE_OPT="1")
    d = mxc_t.ensure_jit_cache()
    assert d == jc_j.keyed_dir(base, mxc_j.config_key())
    assert os.path.isdir(d) and jc_t.active_dir() == d
    assert not jc_t.donation_unsafe()
    built = []

    def build():
        built.append(1)
        return b"\x7fELF-cubin-%d" % len(built)

    h0, m0, c0 = jc_t.HITS, jc_t.MISSES, jc_t.CORRUPT
    key = jc_t.entry_key("src", "kern", "sm_90a", "12.9")
    assert jc_t.load_or_build(key, build) == b"\x7fELF-cubin-1"
    assert (jc_t.HITS - h0, jc_t.MISSES - m0, len(built)) == (0, 1, 1)
    jc_t._configured_dir = None             # a second process
    mxc_t.ensure_jit_cache()
    assert jc_t.load_or_build(key, build) == b"\x7fELF-cubin-1"
    assert (jc_t.HITS - h0, jc_t.MISSES - m0, len(built)) == (1, 1, 1)
    (entry,) = [n for n in os.listdir(d) if n.endswith("-cubin")]
    path = os.path.join(d, entry)
    raw = bytearray(open(path, "rb").read())
    raw[-3] ^= 0x01
    open(path, "wb").write(bytes(raw))
    jc_t._configured_dir = None             # a third process
    mxc_t.ensure_jit_cache()
    assert jc_t.CORRUPT - c0 == 1 and not os.path.exists(path)
    assert jc_t.load_or_build(key, build) == b"\x7fELF-cubin-2"
    assert (jc_t.HITS - h0, jc_t.MISSES - m0) == (1, 2)
    open(path, "wb").write(b"MXC1truncated")   # corrupt between sweeps
    assert jc_t.load_or_build(key, build) == b"\x7fELF-cubin-3"
    assert jc_t.CORRUPT - c0 == 2
    assert jc_t.stats() == {"hits": jc_t.HITS, "misses": jc_t.MISSES,
                            "corrupt": jc_t.CORRUPT}
    # another pass configuration keys another directory
    _set(monkeypatch, MXNET_COMPILE_PASSES="fold")
    assert mxc_t.ensure_jit_cache() != d


def test_nvrtc_compiles_go_through_the_cache(tmp_path, monkeypatch):
    from mxnet_tpu_torch.ops import _nvrtc

    ran = []
    monkeypatch.setattr(_nvrtc, "_load", lambda: (None, None))
    monkeypatch.setitem(_nvrtc.info, "nvrtc_version", "12.9")
    monkeypatch.setattr(_nvrtc, "_nvrtc_compile",
                        lambda src, name: ran.append(name) or b"cubin:" +
                        src.encode())
    assert _nvrtc.compile_cubin("a", "k") == b"cubin:a"    # cache off
    _set(monkeypatch, MXNET_COMPILE_CACHE_DIR=str(tmp_path))
    h0 = jc_t.HITS
    assert _nvrtc.compile_cubin("a", "k") == b"cubin:a"
    assert _nvrtc.compile_cubin("a", "k") == b"cubin:a"
    assert ran == ["k", "k"] and jc_t.HITS == h0 + 1
    monkeypatch.setitem(_nvrtc.info, "nvrtc_version", "13.0")
    _nvrtc.compile_cubin("a", "k")                         # a new toolkit
    assert ran == ["k", "k", "k"]
