"""The Hopper matmul with column statistics (K6) on the card.

A CUDA kernel has no CPU mode, so every test here carries the ``cuda``
marker and skips without a GPU. The file imports neither ``jax`` nor
``mxnet_tpu``, so it runs on a machine with the card and no JAX; the
repository's ``tests/conftest.py`` pins JAX, so skip it there:

    python -m pytest --noconftest tests/test_torch_matmul_stats_kernel_cuda.py

Limits against the plain version (f32 matmul of the same bf16 values):
y per element within 1e-2 of (rms + |plain|), both rounding the f32 acc
to bf16 once; s and s2 per column within ``chip_smoke``'s
``matmul_stats_limits``: 1e-5 of the column's sum over rows and k of
|x_ik w_kj| (s), and of 2 |acc| times that (s2), the sums differing
only in order.
"""
import pytest
import torch

from chip_smoke import matmul_stats_limits
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
    lim_s, lim_s2 = matmul_stats_limits(x, w)
    assert ((s - sr).abs() <= lim_s).all()
    assert ((s2 - s2r).abs() <= lim_s2).all()


@pytest.mark.parametrize("m,k,n", [(100352, 512, 128), (25088, 1024, 256)])
def test_sums_are_deterministic(card, m, k, n):
    """No atomics: the same inputs give the same bits, at C and D."""
    x, w = _inputs(card, m, k, n, 0.5, seed=1)
    a = ms.matmul_stats(x, w)
    b = ms.matmul_stats(x, w)
    torch.cuda.synchronize()
    assert all(torch.equal(p, q) for p, q in zip(a, b))


def _holds(x, w, got):
    y, s, s2 = got
    yr, sr, s2r = ms.matmul_stats_reference(x, w)
    torch.cuda.synchronize()
    lim_s, lim_s2 = matmul_stats_limits(x, w)
    return (torch.allclose(y.float(), yr.float(), rtol=2 ** -7, atol=1e-6)
            and bool(((s - sr).abs() <= lim_s).all())
            and bool(((s2 - s2r).abs() <= lim_s2).all()))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("m,k,n", [
    (1, 16, 8), (63, 48, 200), (65, 32, 72),
    (1, 64, 256), (1000, 64, 256),          # fewer tiles than SMs
    (8447, 64, 136),                        # M not a multiple of 64
    (777, 16, 128), (999, 48, 64),          # K not a multiple of 64
    (1000, 64, 8), (1000, 64, 72), (3000, 128, 200), (5000, 64, 256),
])
def test_small_and_odd_shapes(card, m, k, n, seed):
    """Each shape on three seeds: one row's columns can cancel to near
    zero, where the limit on s must still cover reordered sums."""
    x, w = _inputs(card, m, k, n, 0.5, seed=seed)
    assert _holds(x, w, ms.matmul_stats(x, w))


@pytest.mark.parametrize("bad", ["f32", "noncontig", "k24", "n264", "n12",
                                 "mismatch", "cpu_w", "unaligned"])
def test_kernel_refuses(card, bad):
    x, w = _inputs(card, 128, 64, 64)
    x, w = {"f32": lambda: (x.float(), w.float()),
            "noncontig": lambda: (x, w.t().contiguous().t()),
            "k24": lambda: (x[:, :24].contiguous(), w[:24].contiguous()),
            "n264": lambda: (x, torch.zeros(64, 264, device=card,
                                            dtype=torch.bfloat16)),
            "n12": lambda: (x, w[:, :12].contiguous()),
            "mismatch": lambda: (x, w[:32].contiguous()),
            "cpu_w": lambda: (x, w.cpu()),
            "unaligned": lambda: (torch.zeros(129 * 64 + 1, device=card,
                                              dtype=torch.bfloat16)[1:]
                                  .view(129, 64), w)}[bad]()
    before = ms.matmul_stats.launches
    with pytest.raises(MXNetError):
        ms.matmul_stats(x, w)
    assert ms.matmul_stats.launches == before
