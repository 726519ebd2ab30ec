"""The port's host modules and API gaps against the JAX package's, on the
CPU.

- ``ops/opdoc.py``: every op's Symbol and NDArray docstring, and every
  parameter Field's doc, byte-equal to the JAX package's;
- ``visualization`` (``mx.viz``): ``print_summary``'s text byte-equal,
  with and without shapes; ``plot_network``'s graphviz source (or,
  without graphviz, its error) equal;
- ``runtime``: the JAX package's keys with ``CUDA`` for ``TPU``; the
  unported native routes off, ``DIST_KVSTORE`` as torch.distributed;
- ``profiler``: a run writes a Chrome trace holding the scope's name;
  ``start_server`` raises;
- ``test_utils``: the gradient checks pass and fail on the same inputs
  as the JAX package's; ``check_symbolic_forward``/``backward``,
  ``check_consistency``, ``simple_forward``, ``check_speed``, ``np_reduce``
  and the comparison helpers;
- ``io.LayoutMapper``/``DefaultLayoutMapper``, ``DataDesc.get_list``,
  ``optimizer.state_nbytes``, ``context.cpu_pinned``,
  ``base.getenv``/``env_str``/``check_call``, ``misc``, ``libinfo``;
- ``FeedForward.fit(resume=)``: resumed parameters equal the JAX
  package's resumed fit within relative L2 1e-4 (f32, summation order
  compounded over the steps); the refusals.
"""
import contextlib
import io
import json
import logging
import os
import warnings

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu.ops import opdoc as opdoc_j
from mxnet_tpu.ops import registry as reg_j
from mxnet_tpu_torch.ops import opdoc as opdoc_t
from mxnet_tpu_torch.ops import registry as reg_t

PKGS = (mj, mt)


@pytest.fixture(scope="module", autouse=True)
def _env():
    """torch's CPU ``exp``/``tanh`` warmed (their first multithreaded
    call can err by 1.5e-4); the JAX references compiled without XLA's
    passes."""
    t = torch.randn(100000)
    torch.exp(t)
    torch.tanh(t)
    prev = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", prev)
    jax.clear_caches()


# -- opdoc ---------------------------------------------------------------------
def test_opdoc_is_a_byte_copy():
    assert open(opdoc_t.__file__, "rb").read() == \
        open(opdoc_j.__file__, "rb").read()


def test_every_op_docstring_equals_jax():
    names = sorted(reg_j.REGISTRY)
    assert names == sorted(n for n in reg_t.REGISTRY if n in reg_j.REGISTRY)
    for name in names:
        oj, ot = reg_j.get(name), reg_t.get(name)
        assert getattr(mt.sym, name).__doc__ == getattr(mj.sym, name).__doc__, \
            name
        for kind in ("symbol", "ndarray"):
            assert opdoc_t.build_doc(ot, name, kind) == \
                opdoc_j.build_doc(oj, name, kind), (name, kind)
        assert ot.doc == oj.doc, name
        assert {k: f.doc for k, f in ot.param_fields.items()} == \
            {k: f.doc for k, f in oj.param_fields.items()}, name
        fj = getattr(mj.nd, name, None)
        if fj is not None and fj.__doc__ == opdoc_j.build_doc(oj, name,
                                                             "ndarray"):
            assert getattr(mt.nd, name).__doc__ == fj.__doc__, name


# -- visualization -------------------------------------------------------------
def _printed(fn, *a, **k):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*a, **k)
    return buf.getvalue()


@pytest.mark.parametrize("shape", [None, {"data": (2, 3, 28, 28)}])
def test_print_summary_text_equals_jax(shape):
    texts = []
    for pkg in PKGS:
        with pkg.NameManager():
            sym = pkg.models.get_inception_bn_small(num_classes=10)
        texts.append(_printed(pkg.viz.print_summary, sym, shape=shape))
    assert texts[1] == texts[0] and "Total params" in texts[1]
    assert mt.visualization is mt.viz


def test_plot_network_matches_jax():
    """The same graphviz source where the package is installed, else the
    same ImportError (it is imported lazily in both)."""
    got = []
    for pkg in PKGS:
        with pkg.NameManager():
            sym = pkg.models.get_lenet()
        try:
            got.append(pkg.viz.plot_network(sym, title="lenet").source)
        except ImportError as e:
            got.append(("ImportError", str(e)))
    assert got[1] == got[0]


# -- runtime -------------------------------------------------------------------
def test_runtime_keys_match_jax():
    fj, ft = mj.runtime.feature_list(), mt.runtime.feature_list()
    assert sorted(ft) == sorted("CUDA" if k == "TPU" else k for k in fj)
    assert ft["CUDA"] == torch.cuda.is_available()
    for k in ("NATIVE_RECORDIO", "NATIVE_IMAGEDEC"):
        assert ft[k] is False
    assert ft["DIST_KVSTORE"] == torch.distributed.is_available()
    assert ft["TORCH"] and ft["PROFILER"]
    assert ft["NATIVE_ENGINE"] == mt.engine.library_path().exists()
    for k in ("OPENCV", "S3", "HDFS", "CAFFE"):
        assert ft[k] == fj[k], k
    with pytest.raises(KeyError):
        mt.runtime.has_feature("TPU")
    assert mt.runtime.features_summary().splitlines()[0].startswith("CAFFE")


# -- profiler ------------------------------------------------------------------
def test_profiler_writes_a_trace_with_the_scope(tmp_path):
    p = mt.profiler
    p.profiler_set_config(filename=str(tmp_path / "traces"))
    with pytest.raises(ValueError):
        p.profiler_set_state("pause")
    p.profiler_set_state("run")
    assert p.state() == "run"

    @p.annotate("annotated-step")
    def step():
        return torch.ones(64, 64) @ torch.ones(64, 64)

    with p.scope("smoke-scope"):
        step()
    p.profiler_set_state("stop")
    assert p.state() == "stop"
    path = p.last_trace()
    assert os.path.dirname(path) == str(tmp_path / "traces")
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert {"smoke-scope", "annotated-step"} <= names
    with pytest.raises(mt.MXNetError, match="no on-demand"):
        p.start_server()


# -- test_utils ----------------------------------------------------------------
def _fc(pkg):
    with pkg.NameManager():
        return pkg.sym.Activation(pkg.sym.FullyConnected(
            pkg.sym.Variable("data"), num_hidden=3, name="fc"),
            act_type="tanh", name="act")


def _wrong(pkg):
    """x * BlockGrad(x): the symbolic gradient is x, the numeric 2x."""
    x = pkg.sym.Variable("data")
    return x * pkg.sym.BlockGrad(x)


def _grad_check(pkg, build, seed):
    rng = np.random.RandomState(seed)
    np.random.seed(seed)
    sym = build(pkg)
    loc = {n: rng.randn(*s).astype(np.float32) for n, s in zip(
        sym.list_arguments(), sym.infer_shape(data=(2, 4))[0])}
    try:
        pkg.test_utils.check_numeric_gradient(sym, loc, numeric_eps=1e-2,
                                              check_eps=2e-2, ctx=pkg.cpu())
    except AssertionError:
        return False
    return True


@pytest.mark.parametrize("build,want", [(_fc, True), (_wrong, False)],
                         ids=["fc_tanh", "blockgrad"])
def test_numeric_gradient_check_agrees_with_jax(build, want):
    assert _grad_check(mt, build, 0) == _grad_check(mj, build, 0) == want


def test_symbolic_checks_and_helpers_match_jax():
    tu = mt.test_utils
    x = np.random.RandomState(1).randn(2, 4).astype(np.float32)
    for pkg in PKGS:
        sym = pkg.sym.Variable("data") * 2.0
        pkg.test_utils.check_symbolic_forward(sym, {"data": x}, [x * 2],
                                              ctx=pkg.cpu())
        pkg.test_utils.check_symbolic_backward(
            sym, {"data": x}, [np.ones_like(x)], {"data": np.full_like(x, 2)},
            ctx=pkg.cpu())
        with pytest.raises(AssertionError):
            pkg.test_utils.check_symbolic_forward(sym, {"data": x}, [x * 3],
                                                  ctx=pkg.cpu())
    got = [p.test_utils.simple_forward(_fc(p), ctx=p.cpu(), data=x,
                                       fc_weight=np.ones((3, 4), np.float32),
                                       fc_bias=np.zeros(3, np.float32))
           for p in PKGS]
    np.testing.assert_allclose(got[1], got[0], rtol=1e-6)
    a, b = x, x + 1e-3
    assert tu.reldiff(a, b) == mj.test_utils.reldiff(a, b)
    assert tu.almost_equal(a, a) and not tu.almost_equal(a, b)
    assert tu.same(a, a.copy()) and not tu.same(a, b)
    for axis, keep in ((None, False), (1, True), ((0, 1), False)):
        np.testing.assert_array_equal(
            tu.np_reduce(x, axis, keep, np.sum),
            mj.test_utils.np_reduce(x, axis, keep, np.sum))
    assert tu.default_dtype() is np.float32
    assert tu.default_numerical_threshold() == 1e-6
    assert tu.check_speed(_fc(mt), ctx=mt.cpu(), N=2, data=(2, 4)) > 0
    saved = getattr(mt.Context, "_default_bottom", None)
    try:
        tu.set_default_context(mt.cpu())
        assert tu.default_context() == mt.cpu()
    finally:
        mt.Context._default_bottom = saved


def test_check_consistency_over_two_contexts_matches_jax():
    outs = []
    for pkg in PKGS:
        np.random.seed(3)
        outs.append(pkg.test_utils.check_consistency(
            _fc(pkg), [{"ctx": pkg.cpu(), "data": (2, 4)},
                       {"ctx": pkg.cpu(), "data": (2, 4)}]))
    np.testing.assert_allclose(outs[1][-1][0], outs[0][-1][0], rtol=1e-5)


# -- API gaps ------------------------------------------------------------------
def test_layout_mapper_and_get_list_match_jax():
    for name in ("data", "data:__layout_TNC__", "x:__layout_NCHW__",
                 "y:__layout_HW__"):
        for axis in (0, 1):
            mj_, mt_ = (pkg.io.DefaultLayoutMapper(axis) for pkg in PKGS)
            assert mt_.get_batch_axis(name) == mj_.get_batch_axis(name)
            assert mt_.get_layout_string(name) == mj_.get_layout_string(name)
    for meth in ("get_layout_string", "get_batch_axis"):
        with pytest.raises(NotImplementedError):
            getattr(mt.io.LayoutMapper(), meth)("data")
    shapes = [("data", (4, 3)), ("label", (4,))]
    types = [("data", np.float16), ("label", np.int32)]
    for t in (None, types):
        got = mt.io.DataDesc.get_list(shapes, t)
        want = mj.io.DataDesc.get_list(shapes, t)
        assert [repr(d) for d in got] == [repr(d) for d in want]


def test_state_nbytes_matches_jax():
    sizes = []
    for pkg in PKGS:
        upd = pkg.optimizer.get_updater(pkg.optimizer.create(
            "adam", learning_rate=0.1))
        for i, shape in enumerate([(3, 4), (5,)]):
            w = pkg.nd.ones(shape, ctx=pkg.cpu())
            upd(i, pkg.nd.ones(shape, ctx=pkg.cpu()), w)
        sizes.append(pkg.optimizer.state_nbytes(upd))
    assert sizes[1] == sizes[0] == 2 * 4 * (12 + 5)


def test_small_api_names_match_jax():
    for pkg in PKGS:
        assert str(pkg.cpu_pinned(1)) == "cpu_pinned(1)"
    assert mt.cpu_pinned().torch_device == torch.device("cpu")
    b = mt.base
    os.environ["MXT_PROBE_VAR"] = "7"
    try:
        for fn in ("getenv", "env_str"):
            assert getattr(b, fn)("MXT_PROBE_VAR", "x") == \
                getattr(mj.base, fn)("MXT_PROBE_VAR", "x") == "7"
        assert b.getenv("MXT_PROBE_UNSET") is None
    finally:
        del os.environ["MXT_PROBE_VAR"]
    assert b.check_call(5) == mj.base.check_call(5) == 5
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        s = mt.misc.FactorScheduler(step=2, factor=0.5)
        assert isinstance(s, mt.lr_scheduler.FactorScheduler)
        mt.misc.LearningRateScheduler()
    assert [x.category for x in w] == [DeprecationWarning] * 2
    paths = mt.libinfo.find_lib_path()
    assert paths and all(p.endswith(".so") for p in paths)
    assert any("torch_engine" in p for p in paths) or all(
        os.path.exists(p) for p in paths)
    for name in ("viz", "visualization", "test_utils", "predictor",
                 "Predictor", "profiler", "runtime", "cpu_pinned"):
        assert hasattr(mt, name) and hasattr(mj, name), name


# -- FeedForward.fit(resume=) --------------------------------------------------
def _mlp(pkg):
    with pkg.NameManager():
        x = pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=8,
                                   name="fc1")
        x = pkg.sym.Activation(x, act_type="relu", name="r1")
        x = pkg.sym.FullyConnected(x, num_hidden=3, name="fc2")
        return pkg.sym.SoftmaxOutput(x, name="softmax")


def _resume_fit(pkg, prefix):
    """2 epochs checkpointed each epoch, then a new model resumed with
    ``resume=True`` to 3 epochs: its final parameters and begin epoch."""
    rng = np.random.RandomState(7)
    x = rng.rand(32, 5).astype(np.float32)
    y = rng.randint(0, 3, 32).astype(np.float32)
    rng = np.random.RandomState(8)
    args = {"fc1_weight": rng.randn(8, 5) * 0.3, "fc1_bias": np.zeros(8),
            "fc2_weight": rng.randn(3, 8) * 0.3, "fc2_bias": np.zeros(3)}

    def model(epochs):
        return pkg.FeedForward(
            _mlp(pkg), ctx=pkg.cpu(), num_epoch=epochs,
            optimizer=pkg.optimizer.SGD(learning_rate=0.1,
                                        rescale_grad=1 / 8.0),
            arg_params={k: pkg.nd.array(v.astype(np.float32), ctx=pkg.cpu())
                        for k, v in args.items()}, aux_params={})

    def it():
        return pkg.io.NDArrayIter(x, y, batch_size=8, shuffle=False)

    ckpt = pkg.callback.do_checkpoint(prefix)
    fresh = model(2)
    fresh.fit(X=it(), epoch_end_callback=ckpt, resume=True)   # no ckpt yet
    assert fresh.begin_epoch == 0
    resumed = model(3)
    resumed.fit(X=it(), epoch_end_callback=ckpt, resume=True)
    return resumed.begin_epoch, {k: v.asnumpy()
                                 for k, v in resumed.arg_params.items()}


def test_fit_resume_matches_jax(tmp_path):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MXNET_SCAN_TRAIN", "0")
        (ej, pj), (et, pt) = (_resume_fit(pkg, str(tmp_path / name))
                              for pkg, name in ((mj, "j"), (mt, "t")))
    assert et == ej == 2
    for n in pj:
        assert np.linalg.norm(pt[n] - pj[n]) <= 1e-4 * np.linalg.norm(pj[n])
    for pkg in PKGS:
        m = pkg.FeedForward(_mlp(pkg), ctx=pkg.cpu(), num_epoch=1)
        with pytest.raises(pkg.MXNetError, match="needs a checkpoint prefix"):
            m.fit(X=pkg.io.NDArrayIter(np.zeros((8, 5), np.float32),
                                       np.zeros(8, np.float32), batch_size=8),
                  resume=True, logger=logging.getLogger("resume"))
