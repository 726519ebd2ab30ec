"""The Hopper matmul with column statistics (K6) on the card.

A CUDA kernel has no CPU mode, so every test here carries the ``cuda``
marker and skips without a GPU. The file imports neither ``jax`` nor
``mxnet_tpu``, so it runs on a machine with the card and no JAX; the
repository's ``tests/conftest.py`` pins JAX, so skip it there:

    python -m pytest --noconftest tests/test_torch_matmul_stats_kernel_cuda.py

Limits against the plain version (f32 matmul of the same bf16 values):
y per element within 1e-2 of (rms + |plain|), both rounding the f32 acc
to bf16 once; each column of s within 1e-5 of that column's sum of
|acc| and s2 within 1e-5 relative, the sums differing only in order.
"""
import pytest
import torch

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import matmul_stats as ms

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(card, m, k, n, mean=0.0, seed=0):
    g = torch.Generator(device=card).manual_seed(seed)
    x = (torch.randn(m, k, generator=g, device=card) + mean).to(
        torch.bfloat16)
    w = (torch.randn(k, n, generator=g, device=card) * 0.05).to(
        torch.bfloat16)
    return x, w


@pytest.mark.parametrize("m,k,n,mean", [
    (128 * 56 * 56, 64, 256, 0.0),
    (128 * 56 * 56, 256, 64, 0.0),
    (128 * 28 * 28, 512, 128, 0.0),
    (128 * 14 * 14, 1024, 256, 0.0),
    (1000, 64, 256, 0.0),
    (128 * 28 * 28, 512, 128, 0.5),
])
def test_kernel_matches_reference(card, m, k, n, mean):
    x, w = _inputs(card, m, k, n, mean)
    before = ms.matmul_stats.launches
    y, s, s2 = ms.matmul_stats(x, w)
    assert ms.matmul_stats.launches == before + 1
    yr, sr, s2r = ms.matmul_stats_reference(x, w)
    torch.cuda.synchronize()
    assert (y.dtype, y.shape) == (torch.bfloat16, (m, n))
    assert (s.shape, s2.shape) == ((1, n), (1, n))
    wf = yr.float()
    diff = (y.float() - wf).abs()
    assert (diff <= 1e-2 * (wf.pow(2).mean().sqrt() + wf.abs())).all()
    acc_abs = (x.float() @ w.float()).abs().sum(0, keepdim=True)
    assert ((s - sr).abs() <= 1e-5 * acc_abs).all()
    assert ((s2 - s2r).abs() <= 1e-5 * s2r).all()


def test_sums_are_deterministic(card):
    """No atomics: the same inputs give the same bits."""
    x, w = _inputs(card, 100352, 512, 128, 0.5, seed=1)
    a = ms.matmul_stats(x, w)
    b = ms.matmul_stats(x, w)
    torch.cuda.synchronize()
    assert all(torch.equal(p, q) for p, q in zip(a, b))


@pytest.mark.parametrize("m,k,n", [(1, 16, 8), (63, 48, 200), (65, 32, 72)])
def test_small_and_odd_shapes(card, m, k, n):
    x, w = _inputs(card, m, k, n, 0.5)
    y, s, s2 = ms.matmul_stats(x, w)
    yr, sr, s2r = ms.matmul_stats_reference(x, w)
    torch.cuda.synchronize()
    assert torch.allclose(y.float(), yr.float(), rtol=2 ** -7, atol=1e-6)
    acc_abs = (x.float() @ w.float()).abs().sum(0, keepdim=True)
    assert ((s - sr).abs() <= 1e-5 * acc_abs).all()
    assert ((s2 - s2r).abs() <= 1e-5 * s2r).all()


@pytest.mark.parametrize("bad", ["f32", "noncontig", "k24", "n264", "n12",
                                 "mismatch", "cpu_w"])
def test_kernel_refuses(card, bad):
    x, w = _inputs(card, 128, 64, 64)
    x, w = {"f32": lambda: (x.float(), w.float()),
            "noncontig": lambda: (x, w.t().contiguous().t()),
            "k24": lambda: (x[:, :24].contiguous(), w[:24].contiguous()),
            "n264": lambda: (x, torch.zeros(64, 264, device=card,
                                            dtype=torch.bfloat16)),
            "n12": lambda: (x, w[:, :12].contiguous()),
            "mismatch": lambda: (x, w[:32].contiguous()),
            "cpu_w": lambda: (x, w.cpu())}[bad]()
    before = ms.matmul_stats.launches
    with pytest.raises(MXNetError):
        ms.matmul_stats(x, w)
    assert ms.matmul_stats.launches == before
