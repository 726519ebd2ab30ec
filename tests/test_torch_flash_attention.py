"""mxnet_tpu_torch flash attention against the JAX package's.

CPU side: the port's ``flash_attention`` on CPU tensors is its plain
version ``attention_reference``; it is held against the JAX Pallas
kernel run in interpret mode (``MXNET_PALLAS=1``) and against
``_attention_reference``, in f32, within 2e-5. The CUDA kernel itself
runs only on the card: its tests are in
``test_torch_flash_kernel_cuda.py``. The rule by which the bf16 kernel
reads q, k, v through their strides (``tma_strides``) is plain Python
and is held here.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import flash_attention as fa

TOL = 2e-5


def _qkv(seed, b, h, t, d, tk=None):
    rng = np.random.RandomState(seed)
    tk = t if tk is None else tk
    return (rng.randn(b, h, t, d).astype(np.float32),
            rng.randn(b, h, tk, d).astype(np.float32),
            rng.randn(b, h, tk, d).astype(np.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [128, 256])
@pytest.mark.parametrize("d", [16, 32])
def test_matches_jax_pallas_interpret(monkeypatch, causal, t, d):
    monkeypatch.setenv("MXNET_PALLAS", "1")
    q, k, v = _qkv(t + d + causal, 1, 2, t, d)
    scale = 1.0 / np.sqrt(d)
    assert pk.flash_kernel_usable(t, t, d, d)
    ref_kernel = np.asarray(pk.flash_attention(q, k, v, causal=causal))
    ref_plain = np.asarray(pk._attention_reference(q, k, v, causal, scale))
    out = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal).numpy()
    np.testing.assert_allclose(out, ref_kernel, atol=TOL, rtol=0)
    np.testing.assert_allclose(out, ref_plain, atol=TOL, rtol=0)

    # lse against row 0 of the Pallas kernel's 8-row-broadcast lse
    bq, bk, ok = pk._select_blocks(t, t)
    assert ok
    _, lse_j = pk._flash_attention_pallas(q, k, v, causal, scale, bq, bk)
    lse_j = np.asarray(lse_j)[:, 0, :].reshape(1, 2, t)
    _, lse = fa.attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(lse.numpy(), lse_j, atol=TOL, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_ragged_and_rectangular_match_jax_reference(causal):
    """Lengths off the TPU's 128 grid, and tq != tk (top-left causal
    rule), against the JAX plain attention."""
    q, k, v = _qkv(3, 2, 2, 100, 16, tk=150)
    scale = 0.3
    ref = np.asarray(pk._attention_reference(q, k, v, causal, scale))
    out = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal,
                             scale=scale).numpy()
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)


def test_lse_is_logsumexp_of_scaled_masked_scores():
    q, k, v = _qkv(4, 1, 1, 40, 8)
    o, lse = fa.attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal=True)
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(8)
    s = np.where(np.tril(np.ones((40, 40), bool)), s, -np.inf)
    want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) \
        + s.max(-1)
    np.testing.assert_allclose(lse.numpy(), want, atol=TOL, rtol=0)
    assert o.dtype == torch.float32 and lse.shape == (1, 1, 40)


def test_kernel_gate(monkeypatch):
    assert fa.flash_kernel_usable(2048, 2048, 128, 128)
    assert fa.flash_kernel_usable(2000, 2000, 64, 64)
    assert not fa.flash_kernel_usable(256, 256, 32, 32)
    assert not fa.flash_kernel_usable(256, 256, 64, 128)
    monkeypatch.setenv("MXNET_FLASH_MIN_T", "512")
    assert not fa.flash_kernel_usable(256, 256, 64, 64)
    assert fa.flash_kernel_usable(512, 512, 64, 64)


def test_kernel_wrapper_refuses_cpu_tensors():
    """No fallback: the kernel wrapper raises on what the kernel does
    not take, before anything is built."""
    q = torch.zeros(1, 1, 8, 64)
    with pytest.raises(MXNetError, match="CUDA"):
        fa.flash_attention_fwd(q, q, q)


def test_cpu_path_counts_no_launch():
    q = torch.randn(1, 2, 16, 64)
    before = fa.flash_attention.launches
    fa.flash_attention(q, q, q)
    assert fa.flash_attention.launches == before


def _lm_views(qkv, b, t, h, d):
    """q, k, v as the transformer hands them over: chunks of one
    ``[B, T, 3HD]`` product, reshaped to heads and transposed."""
    return tuple(x.reshape(b, t, h, d).transpose(1, 2)
                 for x in qkv.chunk(3, dim=-1))


def test_plain_path_on_lm_strided_views_matches_jax_reference():
    """The layout the LM forward gives the kernel: the plain path on
    those views equals the JAX plain attention on contiguous copies, and
    its gradients reach the one qkv tensor as they do through
    contiguous copies."""
    b, t, h, d = 2, 48, 2, 16
    qkv_np = np.random.RandomState(5).randn(b, t, 3 * h * d).astype(
        np.float32)
    qkv = torch.from_numpy(qkv_np).requires_grad_()
    q, k, v = _lm_views(qkv, b, t, h, d)
    assert not q.is_contiguous()
    out = fa.flash_attention(q, k, v, causal=True)
    qn, kn, vn = (np.ascontiguousarray(x.detach().numpy()) for x in (q, k, v))
    ref = np.asarray(pk._attention_reference(qn, kn, vn, True,
                                             1.0 / np.sqrt(d)))
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=TOL, rtol=0)
    (g,) = torch.autograd.grad(out.square().sum(), (qkv,))
    qkv2 = torch.from_numpy(qkv_np).requires_grad_()
    out2 = fa.flash_attention(*(x.contiguous() for x in
                                _lm_views(qkv2, b, t, h, d)), causal=True)
    (g2,) = torch.autograd.grad(out2.square().sum(), (qkv2,))
    np.testing.assert_allclose(g.numpy(), g2.numpy(), atol=1e-6, rtol=0)


def test_tma_strides_rule():
    """Which views the bf16 kernel reads in place, and through which
    (B, H, T) element strides; None means the wrapper copies first."""
    bf = torch.bfloat16
    x = torch.zeros(2, 4, 64, 64, dtype=bf)
    assert fa.tma_strides(x) == (4 * 64 * 64, 64 * 64, 64)
    # the LM's heads of one qkv product: no copy
    q, k, v = _lm_views(torch.zeros(2, 64, 3 * 4 * 128, dtype=bf),
                        2, 64, 4, 128)
    for view in (q, k, v):
        assert fa.tma_strides(view) == (64 * 1536, 128, 1536)
    # extent 1: its free stride becomes the view's span
    assert fa.tma_strides(torch.zeros(1, 4, 64, 64, dtype=bf)) == \
        (4 * 64 * 64, 64 * 64, 64)
    assert fa.tma_strides(torch.zeros(1, 1, 5, 64, dtype=bf)) == \
        (320, 320, 64)
    # f32 rows of 64 are 256 bytes
    assert fa.tma_strides(torch.zeros(1, 2, 3, 64)) == (384, 192, 64)
    # refused: D not contiguous, a start off 16 bytes, a row stride that
    # is not a multiple of 16 bytes
    assert fa.tma_strides(x.transpose(2, 3)) is None
    assert fa.tma_strides(torch.zeros(1, 2, 8, 72, dtype=bf)[..., 1:65]) \
        is None
    assert fa.tma_strides(torch.zeros(1, 2, 8, 68, dtype=bf)[..., :64]) \
        is None
    assert fa.tma_strides(torch.zeros(2, 2, 8, 72, dtype=bf)[..., :64]) \
        == (2 * 8 * 72, 8 * 72, 72)
    # the backward's dO: the gradient that o.transpose(1, 2).reshape(B, T,
    # H*D) hands back to o, a head-transposed view read in place
    do = _grad_output_view(2, 64, 4, 128)
    assert not do.is_contiguous()
    assert fa.tma_strides(do) == (64 * 512, 128, 512)
    # refused: the same dO 8 bytes off 16, or from rows of H*D + 4
    # elements (a T stride of 1032 bytes)
    wide = torch.zeros(2, 64, 4 * 128 + 4, dtype=bf)
    assert fa.tma_strides(
        wide[..., 4:4 + 512].reshape(2, 64, 4, 128).transpose(1, 2)) is None
    assert fa.tma_strides(
        wide[..., :512].reshape(2, 64, 4, 128).transpose(1, 2)) is None


def _grad_output_view(b, t, h, d):
    """The gradient that reaches the attention output o ([B, H, T, D])
    when the LM reads it as ``o.transpose(1, 2).reshape(B, T, H*D)``."""
    o = torch.zeros(b, h, t, d, dtype=torch.bfloat16, requires_grad=True)
    seen = []

    class Tap(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            seen.append(g)
            return g

    y = Tap.apply(o).transpose(1, 2).reshape(b, t, h * d)
    y.backward(torch.ones(b, t, h * d, dtype=torch.bfloat16))
    return seen[0]


def test_tma_operands_copy_only_what_the_rule_refuses():
    """The bf16 kernels' wrappers pass a view the rule takes as it is
    (the same storage, no copy) and copy one it refuses into a
    contiguous, 16-byte aligned tensor with the same values."""
    bf = torch.bfloat16
    q, k, v = _lm_views(torch.randn(2, 64, 3 * 4 * 128).to(bf), 2, 64, 4,
                        128)
    do = _grad_output_view(2, 64, 4, 128)
    off = torch.randn(1, 2, 8, 72).to(bf)[..., 4:68]
    assert fa.tma_strides(off) is None
    got = fa._tma_operands(q, k, v, do, off)
    for a, b in zip(got[:4], (q, k, v, do)):
        assert a is b
    assert got[4].is_contiguous() and got[4].data_ptr() % 16 == 0
    assert fa.tma_strides(got[4]) is not None
    assert torch.equal(got[4], off)


def test_kernel_build_hash_covers_included_headers(tmp_path, monkeypatch):
    """A library is named by its source and the csrc headers it
    includes, so an edit to the shared header rebuilds the libraries that
    include it (both flash libraries and K6's) and no other."""
    from mxnet_tpu_torch.ops import _build

    for name in ("flash_fwd", "flash_bwd", "matmul_stats"):
        assert [p.name for p in _build._sources(
            _build._CSRC / _build.SOURCES[name][0])] == [
                _build.SOURCES[name][0], "flash_common.cuh"]
    for f in _build._CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "_CSRC", tmp_path)
    before = {n: _build._so_path(n)[1].name for n in _build.SOURCES}
    header = tmp_path / "flash_common.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {n: _build._so_path(n)[1].name for n in _build.SOURCES}
    assert {n for n in before if before[n] != after[n]} == {
        "flash_fwd", "flash_bwd", "matmul_stats"}
