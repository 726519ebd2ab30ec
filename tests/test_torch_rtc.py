"""The port's RTC against the JAX package's, on the CPU.

A CUDA C body runs only on the card (``tests/test_torch_rtc_kernel_cuda.py``
and ``chip_smoke.py``); here:

- the decorated source is pinned byte for byte for an f32 template and a
  mixed bf16/int32 one (the reference's ``MXRtc::decorate`` form);
- the argument checks raise the same ``ValueError`` messages in both
  packages (input count, output count, input shape, output shape);
- a source body on CPU arrays raises ``MXNetError``, and so do
  ``block_shapes``, an unsupported dtype and a callable kernel on a grid;
- the callable kernel of ``tests/unittest/test_rtc.py`` gives the JAX
  package's values (Pallas in interpret mode there);
- the plain twin of every CUDA C body that ``chip_smoke.py`` launches
  (``chip_smoke.RTC_BODIES``) matches the JAX package's ``Rtc`` running
  the same function as a Pallas body, on the same seeded numpy inputs,
  rtol 1e-6 in f32.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from chip_smoke import RTC_BODIES


@pytest.fixture(scope="module", autouse=True)
def _warm_cpu_math():
    """torch 2.13's CPU ``exp`` and ``tanh`` sometimes return errors up to
    1.5e-4 relative on their first multithreaded call in a process (see
    ``tests/test_torch_fit.py``); one call of each first avoids it."""
    t = torch.randn(100000)
    torch.exp(t)
    torch.tanh(t)


def _pair(shape, dtype="float32", seed=0):
    x = np.random.RandomState(seed).rand(*shape).astype(np.float32)
    return (mj.nd.array(x, ctx=mj.cpu()),
            mt.nd.array(x, ctx=mt.cpu(), dtype=dtype))


def test_decorated_source_f32():
    x = mt.nd.zeros((10,), ctx=mt.cpu())
    y = mt.nd.zeros((10,), ctx=mt.cpu())
    k = mt.rtc.Rtc("abc", [("x", x)], [("y", y)],
                   "y[threadIdx.x] = expf(x[threadIdx.x] * 5.0f);")
    assert k.source == (
        '\nextern "C" __global__ void abc(const float* x,float* y) {\n'
        "const int x_ndim = 1;\n"
        "const int x_dims[] = {10};\n"
        "const int y_ndim = 1;\n"
        "const int y_dims[] = {10};\n"
        "y[threadIdx.x] = expf(x[threadIdx.x] * 5.0f);\n"
        "}\n")


def test_decorated_source_mixed_bf16_int32():
    a = mt.nd.zeros((3, 4), ctx=mt.cpu(), dtype="bfloat16")
    n = mt.nd.zeros((3,), ctx=mt.cpu(), dtype="int32")
    k = mt.rtc.Rtc("count", [("a", a)], [("n", n)],
                   "n[threadIdx.x] = (int)(float)a[threadIdx.x * 4];")
    assert k.source == (
        "#include <cuda_bf16.h>\n"
        '\nextern "C" __global__ void count(const __nv_bfloat16* a,int* n) {\n'
        "const int a_ndim = 2;\n"
        "const int a_dims[] = {3,4};\n"
        "const int n_ndim = 1;\n"
        "const int n_dims[] = {3};\n"
        "n[threadIdx.x] = (int)(float)a[threadIdx.x * 4];\n"
        "}\n")


def _bad_call(pkg, case):
    x = pkg.nd.zeros((4,), ctx=pkg.cpu())
    y = pkg.nd.zeros((4,), ctx=pkg.cpu())
    body = "y[...] = x[...]" if pkg is mj else "y[0] = x[0];"
    k = pkg.rtc.Rtc("idk", [("x", x)], [("y", y)], body)
    bad = pkg.nd.zeros((5,), ctx=pkg.cpu())
    args = {"inputs": ([x, x], [y]), "outputs": ([x], [y, y]),
            "input_shape": ([bad], [y]), "output_shape": ([x], [bad])}[case]
    with pytest.raises(ValueError) as err:
        k.push(*args)
    return str(err.value)


@pytest.mark.parametrize("case", ["inputs", "outputs", "input_shape",
                                  "output_shape"])
def test_bad_calls_raise_the_same_errors(case):
    assert _bad_call(mt, case) == _bad_call(mj, case)


def _cpu_kernel():
    x = mt.nd.zeros((4,), ctx=mt.cpu())
    y = mt.nd.zeros((4,), ctx=mt.cpu())
    return mt.rtc.Rtc("copy", [("x", x)], [("y", y)],
                      "y[threadIdx.x] = x[threadIdx.x];"), x, y


def test_source_body_on_cpu_arrays_raises():
    k, x, y = _cpu_kernel()
    with pytest.raises(mt.MXNetError, match="no CPU twin"):
        k.push([x], [y], (1, 1, 1), (4, 1, 1))


def test_block_shapes_raises():
    k, x, y = _cpu_kernel()
    with pytest.raises(mt.MXNetError, match="block_shapes"):
        k.push([x], [y], block_shapes=([((4,), lambda i: (0,))],
                                       [((4,), lambda i: (0,))]))


def test_unsupported_dtype_raises():
    x = mt.nd.NDArray(torch.zeros(4, dtype=torch.bool))
    with pytest.raises(mt.MXNetError, match="no CUDA C type"):
        mt.rtc.Rtc("b", [("x", x)], [("y", x)], "y[0] = x[0];")


def test_callable_kernel_matches_jax():
    def kern(x_ref, y_ref):
        y_ref[...] = x_ref[...] * x_ref[...]

    got = []
    for pkg in (mj, mt):
        x = pkg.nd.array(np.arange(6.0), ctx=pkg.cpu())
        y = pkg.nd.zeros((6,), ctx=pkg.cpu())
        pkg.rtc.Rtc("sq", [("x", x)], [("y", y)], kern).push([x], [y])
        got.append(y.asnumpy())
    np.testing.assert_array_equal(got[1], got[0])
    before = mt.rtc.launches
    with pytest.raises(mt.MXNetError, match="grid_dims"):
        mt.rtc.Rtc("sq", [("x", x)], [("y", y)], kern).push([x], [y],
                                                           (2, 1, 1))
    assert mt.rtc.launches == before


# the JAX package's Pallas body for each CUDA C body of RTC_BODIES:
# (Pallas source, input shapes, grid)
PALLAS = {
    "abc": ("y[...] = jnp.exp(x[...] * 5.0)", [(10,)], (1, 1, 1)),
    "axpb": ("out[...] = a[...] * b[...] + 1.0", [(3, 4), (3, 4)],
             (1, 1, 1)),
    "rowscale": ("i = pl.program_id(0)\n"
                 "y[i, :] = x[i, :] * (i + 1).astype(x.dtype)", [(4, 2)],
                 (4, 1, 1)),
    "mul_add": ("out[...] = a[...] * b[...] + c[...]",
                [(4096,), (4096,), (4096,)], (1, 1, 1)),
}
IN_NAMES = {"abc": "x", "axpb": "ab", "rowscale": "x", "mul_add": "abc"}
OUT_NAMES = {"abc": "y", "axpb": "out", "rowscale": "y", "mul_add": "out"}


@pytest.mark.parametrize("name", sorted(RTC_BODIES))
def test_plain_twin_matches_jax_pallas_body(name):
    src, shapes, grid = PALLAS[name]
    pairs = [_pair(s, seed=i) for i, s in enumerate(shapes)]
    ins_j = [p[0] for p in pairs]
    out_j = mj.nd.zeros(shapes[0], ctx=mj.cpu())
    mj.rtc.Rtc(name, list(zip(IN_NAMES[name], ins_j)),
               [(OUT_NAMES[name], out_j)], src).push(ins_j, [out_j], grid)
    twin = RTC_BODIES[name][1]
    got = twin(*[p[1]._data for p in pairs]).numpy()
    np.testing.assert_allclose(got, out_j.asnumpy(), rtol=1e-6, atol=0)
