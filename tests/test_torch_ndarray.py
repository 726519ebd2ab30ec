"""The port's NDArray against the JAX package's and numpy, on the CPU.

- ``nd.save`` of one dict of arrays in f32, f16, int32 and bf16 writes
  the same bytes in both packages (the JAX side's bf16 through
  ``ml_dtypes``, the port's from the tensor's int16 view), and each
  package loads the other's file;
- arithmetic and in-place writes (``[:]``, a basic-index view, ``+=``)
  match numpy and land in the same storage; a write through
  ``reshape`` lands in its parent (the port's reshape is a view, as the
  reference documents; the JAX package's copies);
- comparisons, truth values, integer arrays under scalar arithmetic and
  the default integer type match the JAX package's (value and dtype),
  and ``nd.save`` of an integer list writes the JAX package's bytes.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt

_RNG = np.random.RandomState(0)
ARRAYS = {
    "w_f32": _RNG.randn(3, 5).astype(np.float32),
    "h_f16": _RNG.randn(7).astype(np.float16),
    "i_int32": _RNG.randint(-9, 9, (2, 2, 3)).astype(np.int32),
    "b_bf16": _RNG.randn(4, 6).astype(np.float32),
    "scalar": np.asarray([2.5], np.float32),
}


def _jax_dict():
    out = {}
    for k, v in ARRAYS.items():
        if k.endswith("bf16"):
            v = v.astype(ml_dtypes.bfloat16)
        out[k] = mj.nd.array(v, ctx=mj.cpu(), dtype=v.dtype)
    return out


def _torch_dict():
    return {k: mt.nd.array(v, ctx=mt.cpu(),
                           dtype="bfloat16" if k.endswith("bf16") else None)
            for k, v in ARRAYS.items()}


def test_save_bytes_equal(tmp_path):
    mj.nd.save(str(tmp_path / "j.params"), _jax_dict())
    mt.nd.save(str(tmp_path / "t.params"), _torch_dict())
    assert (tmp_path / "j.params").read_bytes() == \
        (tmp_path / "t.params").read_bytes()


def test_list_save_bytes_equal(tmp_path):
    mj.nd.save(str(tmp_path / "j"), list(_jax_dict().values()))
    mt.nd.save(str(tmp_path / "t"), list(_torch_dict().values()))
    assert (tmp_path / "j").read_bytes() == (tmp_path / "t").read_bytes()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_each_package_loads_the_other(tmp_path, writer):
    path = str(tmp_path / "x.params")
    if writer == "jax":
        mj.nd.save(path, _jax_dict())
        got = {k: v._data for k, v in mt.nd.load(path).items()}
        for k, v in got.items():
            want = torch.from_numpy(np.asarray(ARRAYS[k]))
            if k.endswith("bf16"):
                assert v.dtype == torch.bfloat16
                want = want.to(torch.bfloat16)
            assert torch.equal(v, want), k
    else:
        mt.nd.save(path, _torch_dict())
        got = mj.nd.load(path)
        for k, v in got.items():
            want = ARRAYS[k]
            if k.endswith("bf16"):
                want = want.astype(ml_dtypes.bfloat16)
            assert v.dtype == want.dtype, k
            np.testing.assert_array_equal(v.asnumpy(), want, err_msg=k)


def test_corrupt_buffer_raises():
    with pytest.raises(mt.MXNetError):
        mt.nd.load_frombuffer(b"\x00" * 16)


def test_arithmetic_matches_numpy():
    a_np = _RNG.randn(4, 5).astype(np.float32)
    b_np = _RNG.rand(4, 5).astype(np.float32) + 0.5
    a = mt.nd.array(a_np, ctx=mt.cpu())
    b = mt.nd.array(b_np, ctx=mt.cpu())
    cases = [(a + b, a_np + b_np), (a - b, a_np - b_np),
             (a * b, a_np * b_np), (a / b, a_np / b_np),
             (a + 2, a_np + 2), (3 - a, 3 - a_np), (a * 0.5, a_np * 0.5),
             (2 / b, 2 / b_np), (b ** 2, b_np ** 2), (-a, -a_np)]
    for got, want in cases:
        assert got.context == mt.cpu()
        np.testing.assert_allclose(got.asnumpy(), want, rtol=1e-6)


def test_inplace_writes_share_storage():
    a = mt.nd.zeros((4, 5), ctx=mt.cpu())
    view = a[1:3]
    a[:] = 1.0
    np.testing.assert_array_equal(view.asnumpy(), np.ones((2, 5)))
    view[:] = np.full((2, 5), 7.0, np.float32)
    want = np.ones((4, 5), np.float32)
    want[1:3] = 7.0
    np.testing.assert_array_equal(a.asnumpy(), want)
    before = a.version
    a += 1
    assert a.version > before
    np.testing.assert_array_equal(view.asnumpy(), np.full((2, 5), 8.0))
    a[0, 1] = -1.0
    assert a.asnumpy()[0, 1] == -1.0
    c = a.copy()
    c[:] = 0.0
    assert a.asnumpy()[0, 0] == 2.0


def test_reshape_is_a_view_of_the_same_storage():
    """The port's ``NDArray.reshape`` shares memory with its parent, as
    the reference documents (``python/mxnet/ndarray.py:427``); the JAX
    package's copies (ROADMAP Queue 3's divergences)."""
    a = mt.nd.array(np.arange(12, dtype=np.float32).reshape(3, 4),
                    ctx=mt.cpu())
    r = a.reshape((2, 6))
    r[:] = np.full((2, 6), 5.0, np.float32)
    np.testing.assert_array_equal(a.asnumpy(), np.full((3, 4), 5.0))
    r[1, 5] = -1.0
    assert a.asnumpy()[2, 3] == -1.0
    a[0] = 9.0
    np.testing.assert_array_equal(r.asnumpy()[0, :4], np.full(4, 9.0))
    assert r.version == a.version
    flat = a.reshape((-1,))
    flat += 1
    assert a.asnumpy()[2, 3] == 0.0


def _both(fn):
    """``fn(package)`` through the JAX package and the port."""
    return fn(mj), fn(mt)


CMP_OPS = ["==", "!=", "<", "<=", ">", ">="]


@pytest.mark.parametrize("op", CMP_OPS)
@pytest.mark.parametrize("rhs", ["array", "scalar"])
def test_comparisons_give_float32_arrays_as_the_jax_package(op, rhs):
    a_np = np.asarray([[1, 2, 3], [4, 5, 6]], np.float32)
    b_np = np.asarray([[1, 0, 3], [7, 5, 2]], np.float32)

    def run(pkg):
        a = pkg.nd.array(a_np, ctx=pkg.cpu())
        b = pkg.nd.array(b_np, ctx=pkg.cpu()) if rhs == "array" else 3
        return eval("a %s b" % op)

    j, t = _both(run)
    assert isinstance(t, mt.nd.NDArray)
    assert t.dtype == j.dtype == np.float32
    np.testing.assert_array_equal(t.asnumpy(), np.asarray(j.asnumpy()))
    want = eval("a_np %s (b_np if rhs == 'array' else 3)" % op)
    np.testing.assert_array_equal(t.asnumpy(), want.astype(np.float32))


def test_equal_arrays_compare_equal_elementwise():
    a = mt.nd.array(np.ones((2, 3), np.float32), ctx=mt.cpu())
    b = mt.nd.array(np.ones((2, 3), np.float32), ctx=mt.cpu())
    np.testing.assert_array_equal((a == b).asnumpy(), np.ones((2, 3)))
    assert a.__hash__ is None and mt.nd.NDArray.__hash__ is None


@pytest.mark.parametrize("value,want", [([0.0], False), ([2.5], True),
                                        ([[0]], False), ([[-1]], True)])
def test_truth_of_one_element_as_the_jax_package(value, want):
    j, t = _both(lambda pkg: bool(pkg.nd.array(value, ctx=pkg.cpu())))
    assert t is j is want


@pytest.mark.parametrize("shape", [(2, 3), (0,)])
def test_truth_of_other_sizes_raises_as_the_jax_package(shape):
    for pkg in (mj, mt):
        with pytest.raises(ValueError, match="ambiguous"):
            bool(pkg.nd.zeros(shape, ctx=pkg.cpu()))


INT_SCALAR_CASES = ["a + 1", "a - 2", "1 - a", "a * 2", "3 * a", "a ** 2",
                    "2 ** a", "a / 2", "2 / a", "a + 1.5", "a * 0.5",
                    "a + a", "a / a"]


@pytest.mark.parametrize("expr", INT_SCALAR_CASES)
def test_int32_under_scalar_arithmetic_as_the_jax_package(expr):
    def run(pkg):
        a = pkg.nd.array(np.asarray([1, 2, 3], np.int32), ctx=pkg.cpu())
        return eval(expr)

    j, t = _both(run)
    assert t.dtype == j.dtype, expr
    np.testing.assert_allclose(t.asnumpy(), np.asarray(j.asnumpy()),
                               rtol=1e-6)


def test_int32_inplace_scalar_add_stays_int32():
    a = mt.nd.array(np.asarray([1, 2, 3], np.int32), ctx=mt.cpu())
    a += 1
    assert a.dtype == np.int32
    np.testing.assert_array_equal(a.asnumpy(), [2, 3, 4])


@pytest.mark.parametrize("source", [[1, 2, 3], np.arange(4),
                                    [1.0, 2.0], np.zeros(2, np.float64)])
def test_default_dtype_as_the_jax_package(source):
    j, t = _both(lambda pkg: pkg.nd.array(source, ctx=pkg.cpu()).dtype)
    assert t == np.dtype(j)


def test_int_list_save_bytes_equal(tmp_path):
    mj.nd.save(str(tmp_path / "j"), {"a": mj.nd.array([1, 2, 3],
                                                        ctx=mj.cpu())})
    mt.nd.save(str(tmp_path / "t"), {"a": mt.nd.array([1, 2, 3],
                                                        ctx=mt.cpu())})
    data = (tmp_path / "t").read_bytes()
    assert data == (tmp_path / "j").read_bytes()
    assert len(data) == 65
    loaded = mj.nd.load(str(tmp_path / "t"))["a"]
    assert loaded.dtype == np.int32
    np.testing.assert_array_equal(loaded.asnumpy(), [1, 2, 3])


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(mt.MXNetError):
        mt.nd.zeros((2,))


# -- scalar / NDArray and % (faults of the port, repaired) ----------------------
def _quotient_inputs(dtype, n=100000):
    """``n`` seeded values of ``dtype`` spread over magnitudes 1e-3-1e3,
    of both signs (no zeros)."""
    rng = np.random.RandomState(5)
    mag = 10.0 ** rng.uniform(-3, 3, n)
    return (mag * np.where(rng.rand(n) < 0.5, -1, 1)).astype(dtype)


@pytest.mark.parametrize("dtype", ["float32", "float16"])
@pytest.mark.parametrize("s", [2.5, -3, 7])
@pytest.mark.parametrize("form", ["operator", "nd.divide"])
def test_scalar_over_ndarray_is_bit_equal_to_jax(dtype, s, form):
    """``s / x`` and ``nd.divide(s, x)`` over 100,000 values: bit-equal
    to the JAX package's ``jnp.divide``, which rounds once (torch's
    ``s / x`` multiplies by the reciprocal, rounding twice)."""
    x = _quotient_inputs(dtype)
    outs = []
    for pkg in (mj, mt):
        a = pkg.nd.array(x, ctx=pkg.cpu(), dtype=x.dtype)
        outs.append(s / a if form == "operator" else pkg.nd.divide(s, a))
    assert outs[1].dtype == outs[0].dtype == np.dtype(dtype)
    np.testing.assert_array_equal(outs[1].asnumpy().view(np.uint16 if
                                                          dtype == "float16"
                                                          else np.uint32),
                                  outs[0].asnumpy().view(np.uint16 if
                                                         dtype == "float16"
                                                         else np.uint32))


def test_scalar_over_int32_gives_float32_as_jax():
    for s in (2.5, 7):
        outs = [s / pkg.nd.array(np.asarray([1, 3, -7], np.int32),
                                 ctx=pkg.cpu()) for pkg in (mj, mt)]
        assert outs[1].dtype == outs[0].dtype == np.float32
        np.testing.assert_array_equal(outs[1].asnumpy(), outs[0].asnumpy())


MOD_CASES = {
    "int32_int": (np.arange(-7, 8, dtype=np.int32), 3),
    "int32_neg_int": (np.arange(-7, 8, dtype=np.int32), -4),
    "int32_float": (np.arange(-7, 8, dtype=np.int32), 2.5),
    "float32_float": (np.linspace(-5.3, 5.3, 21).astype(np.float32), 1.7),
    "float32_neg": (np.linspace(-5.3, 5.3, 21).astype(np.float32), -0.9),
    "int32_ndarray": (np.arange(-7, 8, dtype=np.int32),
                      np.array([3, -2, 5] * 5, np.int32)),
    "float32_ndarray": (np.linspace(-5.3, 5.3, 21).astype(np.float32),
                        np.linspace(0.5, 2.5, 21).astype(np.float32)),
}


@pytest.mark.parametrize("case", sorted(MOD_CASES))
def test_mod_is_floor_modulo_as_jax(case):
    """``x % y`` is ``jnp.mod`` (the divisor's sign), value and dtype;
    neither package defines ``__rmod__``."""
    x, y = MOD_CASES[case]
    outs = []
    for pkg in (mj, mt):
        a = pkg.nd.array(x, ctx=pkg.cpu(), dtype=x.dtype)
        b = pkg.nd.array(y, ctx=pkg.cpu(), dtype=y.dtype) \
            if isinstance(y, np.ndarray) else y
        outs.append(a % b)
    assert outs[1].dtype == outs[0].dtype
    np.testing.assert_array_equal(outs[1].asnumpy(), outs[0].asnumpy())
    assert not hasattr(mt.nd.NDArray, "__rmod__")
    assert not hasattr(mj.nd.NDArray, "__rmod__")
