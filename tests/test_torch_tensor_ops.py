"""The rest of the port's ``ops/tensor.py`` against the JAX package's ops,
and the NDArray functions in front of them, on the CPU.

- every op of the slice (the unary ops, ``_neg`` and ``tanh_op``; the
  ``broadcast_*`` binaries; ``max``/``max_axis``, ``min``/``min_axis``,
  ``mean``, ``norm``, ``argmax``/``argmin``, ``argmax_channel``;
  ``clip``, ``broadcast_axis``, ``broadcast_to``, ``dot``,
  ``batch_dot``, ``expand_dims``, ``flip``, ``slice_axis``,
  ``crop_nd``, ``softmax_cross_entropy``, ``element_mask``,
  ``choose_element_0index``, ``fill_element_0index``) as cases of
  parametrised tests: forward, dtype and shape, and the gradients of
  its float inputs under one seeded cotangent, on the same numpy-seeded
  f32 inputs: elementwise ops within rtol 1e-6 (atol 1e-7 for values
  near zero), products and reductions within rtol 1e-5 / atol 1e-6, the
  argument ops exactly; ``infer_shape`` and ``infer_type`` equal;
- ``_neg`` is ``negative``'s op and ``tanh_op`` a Symbol op only;
- ``nd.add`` … ``nd.power``, ``maximum``, ``minimum``, ``negative``
  and ``onehot_encode``, ``NDArray.T``, ``asscalar``, ``broadcast_to``
  and ``wait_to_write``, the top-level re-exports and
  ``random.randint`` (dtype, range, the key chain in step) against the
  JAX package's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu.ops import registry as reg_j
from mxnet_tpu_torch.ops import registry as reg_t

ELEM = (1e-6, 1e-7)
REDUCE = (1e-5, 1e-6)
EXACT = (0.0, 0.0)


@pytest.fixture(scope="module", autouse=True)
def _warm_cpu_math():
    """torch 2.13's CPU ``exp`` and ``tanh`` can err up to 1.5e-4 relative
    on their first multithreaded call in a process; one call of each on
    a large tensor first avoids it."""
    t = torch.randn(100000)
    torch.exp(t)
    torch.tanh(t)
    torch.sigmoid(t)


@pytest.fixture(scope="module", autouse=True)
def _quick_jax_compiles():
    prev = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", prev)
    jax.clear_caches()


def _x(*shape, seed=0, scale=1.0, shift=0.0):
    return (np.random.RandomState(seed).randn(*shape) * scale
            + shift).astype(np.float32)


def _pos(*shape, seed=0):
    return np.abs(_x(*shape, seed=seed)) + 0.5


def _ints(n, high, seed=0):
    return np.random.RandomState(seed).randint(0, high, n).astype(
        np.float32)


UNARY = {"abs": _x(3, 4), "ceil": _x(3, 4, scale=3.0),
         "cos": _x(3, 4), "exp": _x(3, 4), "floor": _x(3, 4, scale=3.0),
         "log": _pos(3, 4), "round": _x(3, 4, scale=3.0),
         "rsqrt": _pos(3, 4), "sign": _x(3, 4), "sin": _x(3, 4),
         "sqrt": _pos(3, 4), "square": _x(3, 4), "negative": _x(3, 4),
         "_neg": _x(3, 4), "tanh_op": _x(3, 4)}

# case id -> (op, params, inputs, differentiated inputs, (rtol, atol))
CASES = {name: (name, {}, [x], (0,), ELEM) for name, x in UNARY.items()}
_A, _B = _x(3, 1, 4, seed=1), _x(1, 5, 4, seed=2)
_IA, _IB = np.round(_A * 2), np.round(_B * 2)   # ties for the comparisons
for _nm in ("plus", "minus", "mul", "maximum", "minimum"):
    CASES["broadcast_" + _nm] = ("broadcast_" + _nm, {}, [_A, _B], (0, 1),
                                 ELEM)
CASES["broadcast_div"] = ("broadcast_div", {}, [_A, _pos(1, 5, 4)], (0, 1),
                          ELEM)
CASES["broadcast_power"] = ("broadcast_power", {}, [_pos(3, 1, 4), _B],
                            (0, 1), ELEM)
for _nm in ("equal", "greater", "lesser"):
    CASES["broadcast_" + _nm] = ("broadcast_" + _nm, {}, [_IA, _IB], (0, 1),
                                 EXACT)
_R = _x(3, 4, 5, seed=3)
for _nm in ("max", "max_axis", "min", "min_axis", "mean"):
    CASES[_nm] = (_nm, {}, [_R], (0,), REDUCE)
    CASES[_nm + "-axis1"] = (_nm, {"axis": (1,)}, [_R], (0,), REDUCE)
    CASES[_nm + "-axes02-keep"] = (_nm, {"axis": (0, 2), "keepdims": True},
                                   [_R], (0,), REDUCE)
CASES["mean-keepdims"] = ("mean", {"keepdims": True}, [_R], (0,), REDUCE)
CASES["norm"] = ("norm", {}, [_R], (0,), REDUCE)
CASES["argmax_channel"] = ("argmax_channel", {}, [_R], (), EXACT)
for _nm in ("argmax", "argmin"):
    CASES[_nm] = (_nm, {}, [_R], (), EXACT)
    CASES[_nm + "-axis2"] = (_nm, {"axis": 2}, [_R], (), EXACT)
    CASES[_nm + "-axis-1"] = (_nm, {"axis": -1}, [_x(6, seed=4)], (), EXACT)
CASES["clip"] = ("clip", {"a_min": -0.5, "a_max": 0.7}, [_R], (0,), ELEM)
CASES["broadcast_axis"] = ("broadcast_axis", {"axis": (1,), "size": (5,)},
                           [_A], (0,), REDUCE)
CASES["broadcast_axis-2"] = ("broadcast_axis", {"axis": (0, 1),
                                                "size": (2, 3)},
                             [_x(1, 1, 4)], (0,), REDUCE)
CASES["broadcast_to"] = ("broadcast_to", {"shape": (0, 5, 4)}, [_A], (0,),
                         REDUCE)
CASES["dot"] = ("dot", {}, [_x(4, 5), _x(5, 3, seed=1)], (0, 1), REDUCE)
CASES["dot-transpose_a"] = ("dot", {"transpose_a": True},
                            [_x(5, 4), _x(5, 3, seed=1)], (0, 1), REDUCE)
CASES["dot-transpose_b"] = ("dot", {"transpose_b": True},
                            [_x(4, 5), _x(3, 5, seed=1)], (0, 1), REDUCE)
CASES["dot-vectors"] = ("dot", {}, [_x(6), _x(6, seed=1)], (0, 1), REDUCE)
CASES["dot-3d"] = ("dot", {}, [_x(2, 4, 5), _x(5, 3, seed=1)], (0, 1),
                   REDUCE)
CASES["batch_dot"] = ("batch_dot", {}, [_x(2, 4, 5), _x(2, 5, 3, seed=1)],
                      (0, 1), REDUCE)
CASES["batch_dot-transposed"] = ("batch_dot", {"transpose_a": True,
                                               "transpose_b": True},
                                 [_x(2, 5, 4), _x(2, 3, 5, seed=1)], (0, 1),
                                 REDUCE)
CASES["expand_dims"] = ("expand_dims", {"axis": 1}, [_R], (0,), ELEM)
CASES["expand_dims-last"] = ("expand_dims", {"axis": -1}, [_R], (0,), ELEM)
CASES["flip"] = ("flip", {"axis": 1}, [_R], (0,), ELEM)
CASES["slice_axis"] = ("slice_axis", {"axis": 1, "begin": 1, "end": 3},
                       [_R], (0,), ELEM)
CASES["slice_axis-to-end"] = ("slice_axis", {"axis": 2, "begin": -3},
                              [_R], (0,), ELEM)
CASES["crop_nd"] = ("crop_nd", {"begin": (0, 1, 2), "end": (2, 3, 5)},
                    [_R], (0,), ELEM)
CASES["softmax_cross_entropy"] = ("softmax_cross_entropy", {},
                                  [_x(6, 5, scale=2.0), _ints(6, 5)], (0,),
                                  REDUCE)
CASES["element_mask"] = ("element_mask", {}, [_R, _ints(3, 2)], (0,), ELEM)
CASES["choose_element_0index"] = ("choose_element_0index", {},
                                  [_x(4, 5), _ints(4, 5)], (0,), ELEM)
CASES["fill_element_0index"] = ("fill_element_0index", {},
                                [_x(4, 5), _ints(4, 5, seed=1),
                                 _x(4, seed=2)], (0, 2), ELEM)

SLICE_OPS = sorted({c[0] for c in CASES.values()})


def test_cases_cover_every_op_of_the_slice():
    from mxnet_tpu_torch.ops import tensor

    assert len(SLICE_OPS) == 47
    for name in SLICE_OPS:
        assert reg_t.get(name).forward.__module__ in (tensor.__name__,
                                                      reg_t.__name__)


def _ops(name, params):
    oj, ot = reg_j.get(name), reg_t.get(name)
    return oj, oj.parse_params(dict(params)), ot, ot.parse_params(dict(params))


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_jax(case):
    name, params, inputs, diff, (rtol, atol) = CASES[case]
    oj, pj, ot, pt = _ops(name, params)

    def fj(*xs):
        full = [jnp.asarray(v) for v in inputs]
        for k, x in zip(diff, xs):
            full[k] = x
        return oj.apply(pj, full, [], True, None)[0]

    if not diff:
        outs_j, grads_j = fj(), []
    else:
        outs_j, vjp = jax.vjp(jax.jit(fj), *[jnp.asarray(inputs[k])
                                             for k in diff])
    cots = [np.random.RandomState(7).randn(*o.shape).astype(np.float32)
            for o in outs_j]
    xs = [torch.tensor(x, requires_grad=k in diff)
          for k, x in enumerate(inputs)]
    outs_t, _ = ot.apply(pt, xs, [], True, None)
    grads_t = []
    if diff:
        grads_j = vjp([jnp.asarray(c) for c in cots])
        if outs_t[0].requires_grad:
            grads_t = torch.autograd.grad(
                outs_t, [xs[k] for k in diff],
                [torch.tensor(c) for c in cots], allow_unused=True)
        else:   # a comparison: no gradient, as JAX's zeros
            grads_t = [None] * len(diff)
        grads_t = [torch.zeros_like(xs[k]) if g is None else g
                   for k, g in zip(diff, grads_t)]
    for a, b in zip([o.detach() for o in outs_t] + list(grads_t),
                    list(outs_j) + list(grads_j)):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


@pytest.mark.parametrize("case", sorted(CASES))
def test_infer_shape_and_type_match_jax(case):
    name, params, inputs, _, _ = CASES[case]
    oj, pj, ot, pt = _ops(name, params)
    shapes = [x.shape for x in inputs]
    assert ot.infer_shape(pt, shapes) == oj.infer_shape(pj, shapes)
    types = [np.dtype("float32")] * len(inputs)
    assert ot.infer_type(pt, types) == oj.infer_type(pj, types)
    assert ot.list_arguments(pt) == oj.list_arguments(pj)


@pytest.mark.parametrize("name", SLICE_OPS)
def test_op_fields_and_imperative_form_match_jax(name):
    ot, oj = reg_t.get(name), reg_j.get(name)
    assert ot.imperative == oj.imperative
    assert hasattr(mt.nd, name) == hasattr(mj.nd, name)
    assert hasattr(mt.sym, name) and hasattr(mj.sym, name)


def test_neg_aliases_negative_and_tanh_op_is_symbolic():
    assert reg_t.get("_neg") is reg_t.get("negative")
    assert not reg_t.get("tanh_op").imperative
    assert not hasattr(mt.nd, "tanh_op")


def test_symbol_graph_of_the_ops_serialises_alike():
    texts = []
    for pkg in (mj, mt):
        with pkg.NameManager():
            a, b = pkg.sym.Variable("a"), pkg.sym.Variable("b")
            s = pkg.sym.Group([
                pkg.sym.dot(a, b, transpose_b=True),
                pkg.sym.broadcast_plus(pkg.sym.exp(a), b),
                pkg.sym.max_axis(pkg.sym.clip(a, a_min=0, a_max=1),
                                 axis=1, keepdims=True),
                pkg.sym.tanh_op(pkg.sym.slice_axis(a, axis=0, begin=1,
                                                   end=2)),
                pkg.sym.argmax(a, axis=1), pkg.sym._neg(b)])
        texts.append(s.tojson())
    assert texts[0] == texts[1]


# -- the NDArray functions -----------------------------------------------------
def _pair(x):
    return (mj.nd.array(x, ctx=mj.cpu()), mt.nd.array(x, ctx=mt.cpu()))


def _same(a, b):
    if isinstance(b, mj.nd.NDArray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=1e-6)
    else:
        assert a == b and type(a) is type(b)


@pytest.mark.parametrize("fn", ["add", "subtract", "multiply", "divide",
                                "true_divide", "power", "maximum",
                                "minimum"])
@pytest.mark.parametrize("kinds", ["aa", "as", "sa", "ss"])
def test_module_arithmetic_matches_jax(fn, kinds):
    x, y = _pos(3, 4), _pos(3, 4, seed=1)
    args = []
    for k, v, s in zip(kinds, (x, y), (2.0, 3)):
        args.append(_pair(v) if k == "a" else (s, s))
    _same(getattr(mt.nd, fn)(*[a[1] for a in args]),
          getattr(mj.nd, fn)(*[a[0] for a in args]))


def test_scalar_maximum_minimum_are_not_the_reductions():
    """``max``/``min`` ops attach to the nd and sym modules, so the two
    scalars' branch of ``maximum``/``minimum`` must not call ``max()``."""
    for pkg in (mt.nd, mt.sym):
        assert pkg.maximum(1, 2) == 2 and pkg.minimum(1.5, -2) == -2


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_negative_keeps_the_dtype(dtype):
    x = np.arange(-3, 3).astype(dtype)
    aj, at = _pair(x)
    _same(mt.nd.negative(at), mj.nd.negative(aj))


def test_onehot_encode_matches_jax():
    idx = np.array([1, 3, 0, 3], np.float32)
    oj, ot = mj.nd.zeros((4, 5), ctx=mj.cpu()), mt.nd.zeros((4, 5),
                                                             ctx=mt.cpu())
    assert mt.nd.onehot_encode(_pair(idx)[1], ot) is ot
    mj.nd.onehot_encode(_pair(idx)[0], oj)
    _same(ot, oj)


def test_ndarray_methods_match_jax():
    aj, at = _pair(_x(2, 3, 4))
    _same(at.T, aj.T)
    t = at.T
    t[:] = 0.0   # a copy: the original keeps its values
    assert at.asnumpy().any()
    bj, bt = _pair(_x(2, 1, 4))
    _same(bt.broadcast_to((2, 5, 4)), bj.broadcast_to((2, 5, 4)))
    for bad in ((2, 5), (3, 1, 4)):
        with pytest.raises(mt.MXNetError):
            bt.broadcast_to(bad)
    sj, st = _pair(np.array([2.5], np.float32))
    assert st.asscalar() == sj.asscalar()
    assert type(st.asscalar()) is type(sj.asscalar())
    with pytest.raises(mt.MXNetError):
        at.asscalar()
    at.wait_to_write()
    mt.waitall()


def test_top_level_reexports_match_jax(tmp_path):
    for name in ("array", "zeros", "ones", "empty", "full", "arange",
                 "concatenate", "load", "save", "load_frombuffer",
                 "waitall", "init"):
        assert getattr(mt, name) is getattr(mt.nd if name != "init"
                                            else mt.initializer, name)
        assert hasattr(mj, name)
    assert mt.init.Xavier is mt.initializer.Xavier
    _same(mt.full((2, 3), 1.5, ctx=mt.cpu()), mj.full((2, 3), 1.5,
                                                       ctx=mj.cpu()))
    _same(mt.arange(2, 8, 2, ctx=mt.cpu()), mj.arange(2, 8, 2, ctx=mj.cpu()))
    _same(mt.concatenate([mt.ones((2, 2), ctx=mt.cpu())] * 2, axis=1),
          mj.concatenate([mj.ones((2, 2), ctx=mj.cpu())] * 2, axis=1))
    data = {"w": _x(3, 2)}
    mt.save(str(tmp_path / "t.params"),
            {k: mt.array(v, ctx=mt.cpu()) for k, v in data.items()})
    mj.save(str(tmp_path / "j.params"),
            {k: mj.array(v, ctx=mj.cpu()) for k, v in data.items()})
    raw = (tmp_path / "t.params").read_bytes()
    assert raw == (tmp_path / "j.params").read_bytes()
    np.testing.assert_array_equal(mt.load_frombuffer(raw)["w"].asnumpy(),
                                  data["w"])


def test_randint_matches_jax_dtype_and_keeps_the_chain():
    mj.random.seed(9)
    mt.random.seed(9)
    rj = mj.random.randint(2, 7, shape=(50,), ctx=mj.cpu())
    rt = mt.random.randint(2, 7, shape=(50,), ctx=mt.cpu())
    assert rt.dtype == rj.dtype and rt.shape == rj.shape
    v = rt.asnumpy()
    assert v.min() >= 2 and v.max() < 7 and len(np.unique(v)) > 1
    kj = mj.random.next_key()
    kj = jax.random.key_data(kj) if jax.dtypes.issubdtype(
        kj.dtype, jax.dtypes.prng_key) else kj
    np.testing.assert_array_equal(mt.random.next_key().numpy(),
                                  np.asarray(kj).astype(np.int64))


@pytest.mark.parametrize("name,args,kw", [
    ("clip", (_x(3, 4),), {"a_min": -0.2, "a_max": 0.3}),
    ("dot", (_x(3, 4), _x(4, 2, seed=1)), {}),
    ("sqrt", (_pos(5),), {}),
    ("max", (_x(3, 4),), {"axis": 1}),
    ("argmax_channel", (_x(3, 4),), {}),
])
def test_imperative_ops_match_jax(name, args, kw):
    outs = []
    for pkg in (mj, mt):
        outs.append(getattr(pkg.nd, name)(
            *[pkg.nd.array(a, ctx=pkg.cpu()) for a in args], **kw))
    _same(outs[1], outs[0])


# -- faults of the port, repaired: _rdiv_scalar, integer reductions ----------
def _bound_forward(pkg, sym, x, type_dict=None, extra=None):
    shapes = {"data": x.shape}
    shapes.update({k: v.shape for k, v in (extra or {}).items()})
    exe = sym.simple_bind(pkg.cpu(), grad_req="null",
                          type_dict=type_dict or {"data": x.dtype},
                          **shapes)
    exe.arg_dict["data"][:] = x
    for k, v in (extra or {}).items():
        exe.arg_dict[k][:] = v
    return exe.forward(is_train=False)[0]


@pytest.mark.parametrize("dtype", ["float32", "float16"])
@pytest.mark.parametrize("s", [2.5, -3, 7])
def test_rdiv_scalar_through_an_executor_is_bit_equal(dtype, s):
    """``s / sym`` binds ``_rdiv_scalar``; over 100,000 values its output
    is bit-equal to the JAX executor's (correctly rounded)."""
    rng = np.random.RandomState(6)
    x = (10.0 ** rng.uniform(-3, 3, 100000)
         * np.where(rng.rand(100000) < 0.5, -1, 1)).astype(dtype)
    outs = []
    for pkg in (mj, mt):
        sym = s / pkg.sym.Variable("data")
        assert sym.tojson().count("_rdiv_scalar") == 1
        outs.append(_bound_forward(pkg, sym, x))
    view = np.uint16 if dtype == "float16" else np.uint32
    assert outs[1].dtype == outs[0].dtype == np.dtype(dtype)
    np.testing.assert_array_equal(outs[1].asnumpy().view(view),
                                  outs[0].asnumpy().view(view))


INT_DATA = {"int32": np.random.RandomState(2).randint(
    -50, 50, (3, 4, 5)).astype(np.int32),
            "uint8": np.random.RandomState(3).randint(
    0, 255, (3, 4, 5)).astype(np.uint8)}
INT_REDUCE = [("sum", {}), ("sum", {"axis": 1}), ("sum_axis", {"axis": 2}),
              ("sum", {"axis": (0, 2), "keepdims": True}),
              ("mean", {}), ("mean", {"axis": 1})]


@pytest.mark.parametrize("dtype", sorted(INT_DATA))
@pytest.mark.parametrize("op,params", INT_REDUCE,
                         ids=["%s%s" % (o, sorted(p.items()))
                              for o, p in INT_REDUCE])
def test_integer_reductions_match_jax(dtype, op, params):
    """``sum`` of int32 is int32 and of uint8 uint32; ``mean`` is float32:
    the JAX ops' dtypes and values, through ``nd`` and a bound
    executor; for int32 the output's dtype is the port's own
    ``infer_type``'s."""
    x = INT_DATA[dtype]
    nds, syms = [], []
    for pkg in (mj, mt):
        nds.append(getattr(pkg.nd, op)(
            pkg.nd.array(x, ctx=pkg.cpu(), dtype=x.dtype), **params))
        syms.append(_bound_forward(
            pkg, getattr(pkg.sym, op)(pkg.sym.Variable("data"), **params),
            x))
    for got, want in ((nds[1], nds[0]), (syms[1], syms[0])):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_allclose(got.asnumpy(), want.asnumpy(),
                                   rtol=1e-6)
    if dtype == "int32":
        _, out_types, _ = getattr(mt.sym, op)(
            mt.sym.Variable("data"), **params).infer_type(data=x.dtype)
        assert op == "mean" or out_types[0] == syms[1].dtype


@pytest.mark.parametrize("dtype", sorted(INT_DATA))
def test_instance_norm_of_integer_data_matches_jax(dtype):
    """InstanceNorm over integer data (gamma and beta of the same type,
    as ``infer_type`` binds them) gives float32, as the JAX op does."""
    x = INT_DATA[dtype].reshape(3, 4, 5, 1)
    extra = {"gamma": np.arange(1, 5).astype(dtype),
             "beta": np.arange(4).astype(dtype)}
    outs = []
    for pkg in (mj, mt):
        sym = pkg.sym.InstanceNorm(pkg.sym.Variable("data"), name="in")
        outs.append(_bound_forward(
            pkg, sym, x, type_dict={"data": x.dtype},
            extra={"in_gamma": extra["gamma"], "in_beta": extra["beta"]}))
    assert outs[1].dtype == outs[0].dtype == np.float32
    np.testing.assert_allclose(outs[1].asnumpy(), outs[0].asnumpy(),
                               rtol=1e-5, atol=1e-6)
