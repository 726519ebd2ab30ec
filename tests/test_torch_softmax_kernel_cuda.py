"""The Hopper row-softmax kernel (K1) on the card.

A CUDA kernel has no CPU mode, so every test here carries the ``cuda``
marker and skips without a GPU. The file imports neither ``jax`` nor
``mxnet_tpu``, so it runs on a machine with the card and no JAX; the
repository's ``tests/conftest.py`` pins JAX, so skip it there:

    python -m pytest --noconftest tests/test_torch_softmax_kernel_cuda.py
"""
import pytest
import torch

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import softmax as sm

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("shape,dtype,scale", [
    ((64, 10), torch.float32, 1.0),
    ((128, 1000), torch.float32, 1.0),
    ((128, 1000), torch.float32, 50.0),
    ((1000, 1001), torch.float16, 1.0),
    ((4096, 32000), torch.bfloat16, 1.0),
    ((8, 2097152), torch.float32, 1.0),
    ((3, 1), torch.float32, 1.0),
])
def test_kernel_matches_reference(card, shape, dtype, scale):
    g = torch.Generator(device=card).manual_seed(0)
    x = (torch.randn(shape, generator=g, device=card) * scale).to(dtype)
    before = sm.fused_softmax.launches
    y = sm.fused_softmax(x)
    assert sm.fused_softmax.launches == before + 1
    want = sm.softmax_reference(x)
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.shape == shape
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    diff = (y.float() - want.float()).abs()
    w = want.float()
    assert (diff <= tol * (w.pow(2).mean().sqrt() + w.abs())).all()
    assert torch.allclose(y.float().sum(-1),
                          torch.ones(shape[0], device=card),
                          atol=1e-3 if dtype == torch.float32 else 2e-2)


_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _widths():
    """(dtype, row width) on both sides of every variant boundary of the
    kernel (``softmax.variant``): 1, 2, 10, 31-33 and each variant's
    largest row and the next."""
    out = []
    for dtype in _DTYPES:
        v = 16 // torch.tensor([], dtype=dtype).element_size()
        limits = list(sm.SCALAR_CAPACITY) + [cap * v + v - 1
                                             for cap in sm.VECTOR_CAPACITY]
        out += [(dtype, c) for c in sorted(
            {1, 2, 10, 31, 32, 33} | {c + d for c in limits for d in (0, 1)})]
    return out


def _close(y, want, dtype):
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    diff = (y.float() - want.float()).abs()
    w = want.float()
    return bool((diff <= tol * (w.pow(2).mean().sqrt() + w.abs())).all())


@pytest.mark.parametrize("dtype,c", _widths())
def test_variant_boundaries(card, dtype, c):
    """37 rows (no multiple of the rows any variant's block takes) at each
    width around a boundary, against the plain version."""
    g = torch.Generator(device=card).manual_seed(c)
    x = torch.randn(37, c, generator=g, device=card).to(dtype)
    y = sm.fused_softmax(x)
    torch.cuda.synchronize()
    assert y.dtype == dtype and _close(y, sm.softmax_reference(x), dtype)


@pytest.mark.parametrize("c", [10, 33, 1000, 10000, 20000, 40000])
@pytest.mark.parametrize("dtype", _DTYPES)
def test_inf_and_nan_rows(card, dtype, c):
    """Rows with some -inf, all -inf, a NaN and a +inf give the plain
    version's NaN pattern, and its values elsewhere."""
    g = torch.Generator(device=card).manual_seed(1)
    x = torch.randn(7, c, generator=g, device=card).to(dtype)
    x[1, ::3] = float("-inf")
    x[2] = float("-inf")
    x[3, c // 2] = float("nan")
    x[4, c - 1] = float("inf")
    x[5, 0] = float("-inf")
    y = sm.fused_softmax(x)
    want = sm.softmax_reference(x)
    torch.cuda.synchronize()
    nan = torch.isnan(want.float())
    assert torch.equal(torch.isnan(y.float()), nan)
    assert nan[2].all() and nan[3].all() and nan[4].all()
    ok = ~nan.any(dim=1)
    assert _close(y[ok], want[ok], dtype)
    assert (y[1, ::3].float() == 0).all()


def test_unaligned_view_rows(card):
    """A row-slice view starts off the 16-byte grid: the kernel reads it
    with a scalar head and writes an aligned output."""
    x = torch.randn(33, 1001, device=card)[1:]
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    y = sm.fused_softmax(x)
    torch.cuda.synchronize()
    assert torch.allclose(y, sm.softmax_reference(x), atol=1e-6)


@pytest.mark.parametrize("bad", ["f64", "3d", "noncontig", "empty"])
def test_kernel_refuses(card, bad):
    x = {"f64": lambda: torch.randn(4, 8, device=card, dtype=torch.float64),
         "3d": lambda: torch.randn(2, 4, 8, device=card),
         "noncontig": lambda: torch.randn(8, 4, device=card).t(),
         "empty": lambda: torch.randn(0, 8, device=card)}[bad]()
    before = sm.fused_softmax.launches
    with pytest.raises(MXNetError):
        sm.fused_softmax(x)
    assert sm.fused_softmax.launches == before


def test_softmax_output_launches_k1(card):
    import mxnet_tpu_torch as mx

    net = mx.sym.SoftmaxOutput(data=mx.sym.Variable("data"), name="softmax")
    exe = net.simple_bind(mx.gpu(0), grad_req="write", data=(16, 100))
    exe.arg_dict["data"][:] = torch.randn(16, 100, device=card)
    exe.arg_dict["softmax_label"][:] = torch.arange(16, device=card) % 100
    before = sm.fused_softmax.launches
    out = exe.forward(is_train=True)[0]
    exe.backward()
    assert sm.fused_softmax.launches == before + 1
    prob = sm.softmax_reference(exe.arg_dict["data"]._data)
    assert torch.allclose(out._data, prob, atol=1e-6)
    onehot = torch.nn.functional.one_hot(torch.arange(16) % 100, 100)
    assert torch.allclose(exe.grad_dict["data"]._data,
                          prob - onehot.to(card, torch.float32), atol=1e-6)
