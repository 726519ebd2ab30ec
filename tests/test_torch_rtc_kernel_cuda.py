"""RTC (K5) on the card: CUDA C bodies compiled by NVRTC and launched on
NDArrays through ``mx.rtc.Rtc``.

A CUDA C body has no CPU mode, so every test here carries the ``cuda``
marker and skips without a GPU. The file imports neither ``jax`` nor
``mxnet_tpu``, so it runs on a machine with the card and no JAX; the
repository's ``tests/conftest.py`` pins JAX, so skip it there:

    python -m pytest --noconftest tests/test_torch_rtc_kernel_cuda.py
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import rtc

pytestmark = pytest.mark.cuda


@pytest.fixture
def ctx():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA C body has no CPU mode")
    return mx.gpu(0)


def _push(ctx, name, body, ins, out_shapes, grid, block, dtype="float32"):
    nd_in = [mx.nd.array(a, ctx=ctx, dtype=dtype) for a in ins]
    outs = [mx.nd.zeros(s, ctx=ctx, dtype=dtype) for s in out_shapes]
    names = "abcdefgh"
    k = mx.rtc.Rtc(name, list(zip(names, nd_in)),
                   [("out%d" % i, o) for i, o in enumerate(outs)], body)
    before = rtc.launches
    k.push(nd_in, outs, grid, block)
    assert rtc.launches == before + 1
    torch.cuda.synchronize()
    return k, nd_in, outs


def test_rtc_exp_kernel(ctx):
    """The reference's canonical case: y = exp(x * 5), block (10, 1, 1)."""
    x = mx.nd.ones((10,), ctx=ctx)
    y = mx.nd.full((10,), 2.0, ctx=ctx)
    k = mx.rtc.Rtc("abc", [("x", x)], [("y", y)],
                   "y[threadIdx.x] = expf(x[threadIdx.x] * 5.0f);")
    k.push([x], [y], (1, 1, 1), (10, 1, 1))
    np.testing.assert_allclose(y.asnumpy(), np.exp(5.0) * np.ones(10),
                               rtol=1e-6)


def test_rtc_multi_io_and_reuse(ctx):
    body = ("const int i = threadIdx.x;\n"
            "if (i < a_dims[0] * a_dims[1]) out0[i] = a[i] * b[i] + 1.0f;")
    a = np.arange(12.0).reshape(3, 4)
    b = np.full((3, 4), 2.0)
    k, (na, nb), (out,) = _push(ctx, "axpb", body, [a, b], [(3, 4)],
                                (1, 1, 1), (12, 1, 1))
    np.testing.assert_allclose(out.asnumpy(), a * 2 + 1, rtol=1e-6)
    # the reference's contract: other arrays of the same shapes
    a2 = mx.nd.array(np.full((3, 4), 3.0), ctx=ctx)
    out2 = mx.nd.zeros((3, 4), ctx=ctx)
    k.push([a2, nb], [out2], (1, 1, 1), (12, 1, 1))
    np.testing.assert_allclose(out2.asnumpy(), np.full((3, 4), 7.0))


def test_rtc_grid_block_idx(ctx):
    body = ("const int i = blockIdx.x;\n"
            "for (int j = 0; j < a_dims[1]; ++j)\n"
            "  out0[i * a_dims[1] + j] = a[i * a_dims[1] + j] * (float)(i + 1);")
    x = np.arange(8.0).reshape(4, 2)
    _, _, (y,) = _push(ctx, "rowscale", body, [x], [(4, 2)], (4, 1, 1),
                       (1, 1, 1))
    np.testing.assert_allclose(y.asnumpy(), x * np.arange(1, 5)[:, None])


def test_cache_hit_leaves_compiles_unchanged(ctx):
    body = "out0[threadIdx.x] = a[threadIdx.x] + 1.0f;"
    _push(ctx, "plus_one", body, [np.zeros(8)], [(8,)], (1, 1, 1), (8, 1, 1))
    before = rtc.compiles
    _, _, (out,) = _push(ctx, "plus_one", body, [np.ones(8)], [(8,)],
                         (1, 1, 1), (8, 1, 1))
    assert rtc.compiles == before
    np.testing.assert_array_equal(out.asnumpy(), np.full(8, 2.0))


def test_syntax_error_raises_with_the_log(ctx):
    x = mx.nd.zeros((4,), ctx=ctx)
    k = mx.rtc.Rtc("broken", [("x", x)], [("y", x)], "y[0] = x[0] +;")
    before = rtc.launches
    with pytest.raises(mx.MXNetError, match="error"):
        k.push([x], [x])
    assert rtc.launches == before


def test_2d_grid_and_block(ctx):
    body = ("const int r = blockIdx.y * blockDim.y + threadIdx.y;\n"
            "const int c = blockIdx.x * blockDim.x + threadIdx.x;\n"
            "if (r < a_dims[0] && c < a_dims[1])\n"
            "  out0[r * a_dims[1] + c] = a[r * a_dims[1] + c] * 2.0f"
            " + (float)r;")
    a = np.random.RandomState(0).rand(37, 50)
    _, _, (out,) = _push(ctx, "grid2d", body, [a], [(37, 50)], (4, 5, 1),
                         (16, 8, 1))
    want = a.astype(np.float32) * 2 + np.arange(37)[:, None]
    np.testing.assert_allclose(out.asnumpy(), want, rtol=1e-6)


def test_bf16_body(ctx):
    body = ("const int i = blockIdx.x * blockDim.x + threadIdx.x;\n"
            "if (i < out0_dims[0])\n"
            "  out0[i] = __float2bfloat16(__bfloat162float(a[i]) *"
            " __bfloat162float(b[i]) + 0.5f);")
    rng = np.random.RandomState(1)
    a, b = rng.randn(1000), rng.randn(1000)
    _, (na, nb), (out,) = _push(ctx, "bf16_fma", body, [a, b], [(1000,)],
                                (4, 1, 1), (256, 1, 1), dtype="bfloat16")
    want = (na._data.float() * nb._data.float() + 0.5).to(torch.bfloat16)
    assert out._data.dtype == torch.bfloat16
    # a fused multiply-add against torch's rounded product: at most one
    # bf16 step (2^-8 relative) apart
    torch.testing.assert_close(out._data.float(), want.float(), rtol=2 ** -7,
                               atol=1e-6)


def test_noncontiguous_output_view(ctx):
    """A strided view is launched on a contiguous scratch buffer and the
    result lands in the view; the rest of the storage is untouched."""
    base = mx.nd.zeros((4, 6), ctx=ctx)
    view = base[:, 1:4]
    assert not view._data.is_contiguous()
    x = mx.nd.array(np.arange(12.0).reshape(4, 3), ctx=ctx)
    k = mx.rtc.Rtc("copy2x", [("x", x)], [("y", view)],
                   "y[threadIdx.x] = 2.0f * x[threadIdx.x];")
    k.push([x], [view], (1, 1, 1), (12, 1, 1))
    got = base.asnumpy()
    np.testing.assert_array_equal(got[:, 1:4], 2 * np.arange(12.0).reshape(4, 3))
    assert (got[:, 0] == 0).all() and (got[:, 4:] == 0).all()


def test_block_too_large_raises_from_the_launch(ctx):
    x = mx.nd.zeros((4,), ctx=ctx)
    y = mx.nd.zeros((4,), ctx=ctx)
    k = mx.rtc.Rtc("big_block", [("x", x)], [("y", y)], "y[0] = x[0];")
    before = rtc.launches
    with pytest.raises(mx.MXNetError, match="cuLaunchKernel"):
        k.push([x], [y], (1, 1, 1), (2048, 1, 1))
    assert rtc.launches == before
    k.push([x], [y], (1, 1, 1), (1, 1, 1))   # the context is still good
    torch.cuda.synchronize()


def test_wrong_dtype_or_device_raises(ctx):
    x = mx.nd.zeros((4,), ctx=ctx)
    y = mx.nd.zeros((4,), ctx=ctx)
    k = mx.rtc.Rtc("copy", [("x", x)], [("y", y)], "y[0] = x[0];")
    with pytest.raises(mx.MXNetError):
        k.push([mx.nd.zeros((4,), ctx=ctx, dtype="float16")], [y])
    with pytest.raises(mx.MXNetError):
        k.push([mx.nd.zeros((4,), ctx=mx.cpu())], [y])
