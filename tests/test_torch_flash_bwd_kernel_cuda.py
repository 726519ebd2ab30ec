"""The Hopper flash-attention backward kernels (K3 dQ, K4 dK/dV) on the
card.

A CUDA kernel has no CPU mode, so every test here carries the ``cuda``
marker and skips without a GPU. The file imports neither ``jax`` nor
``mxnet_tpu``; run it on the machine with the card with

    python -m pytest --noconftest tests/test_torch_flash_bwd_kernel_cuda.py

Tolerances, per output against ``attention_bwd_reference`` on the same
card tensors, per element |kernel - plain| <= tol * (rms(plain) +
|plain|) and ||kernel - plain|| <= tol * ||plain||, with tol 1e-2 in
bf16 and 1e-4 in f32. The limit follows each entry, not the largest:
under the causal mask a head's late rows are some 30x smaller than its
first. In bf16 both sides round their output to bf16 (steps of 2^-8 to
2^-7 of the value), so they differ by at most one step, and the
kernel's P and dS enter their products as hi + lo bf16 terms (~2^-16);
the rms term covers entries near zero, where dS cancels. In f32 only
the summation order differs.
"""
import pytest
import torch

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _operands(card, shape, dtype, tk, causal, seed=0):
    g = torch.Generator(device=card).manual_seed(seed)
    b, h, tq, d = shape
    kv = (b, h, tq if tk is None else tk, d)
    q = torch.randn(shape, generator=g, device=card).to(dtype)
    k = torch.randn(kv, generator=g, device=card).to(dtype)
    v = torch.randn(kv, generator=g, device=card).to(dtype)
    do = torch.randn(shape, generator=g, device=card).to(dtype)
    o, lse = fa.attention_reference(q, k, v, causal=causal)
    return q, k, v, o, lse, do


def _close(got, want, tol):
    g, w = got.float(), want.float()
    lim = tol * (w.pow(2).mean().sqrt() + w.abs())
    return (((g - w).abs() <= lim).all().item()
            and (g - w).norm().item() <= tol * w.norm().item())


@pytest.mark.parametrize("shape,dtype,causal,tk", [
    ((16, 8, 1024, 128), torch.bfloat16, True, None),
    ((2, 4, 2000, 64), torch.bfloat16, True, None),
    ((2, 4, 2000, 64), torch.bfloat16, False, None),
    ((1, 8, 384, 128), torch.float32, True, None),
    ((1, 2, 100, 64), torch.bfloat16, True, 150),
    ((1, 2, 200, 64), torch.bfloat16, True, 70),
    ((1, 2, 200, 128), torch.float32, False, 70),
])
def test_bwd_kernels_match_reference(card, shape, dtype, causal, tk):
    q, k, v, o, lse, do = _operands(card, shape, dtype, tk, causal)
    before = (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    assert (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    want = fa.attention_bwd_reference(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    for name, g_, w in zip(("dq", "dk", "dv"), got, want):
        assert g_.dtype == dtype and g_.shape == w.shape
        assert _close(g_, w, tol), name


def test_backward_from_non_contiguous_grad_output(card):
    """grad_output after the head transpose is not contiguous: the
    autograd path copies it and agrees with the plain backward on the
    same operands, laid out contiguously (the forward's own o and lse,
    dO = the head-major bf16 grad output)."""
    b, t, h, d = 2, 256, 4, 64
    g = torch.Generator(device=card).manual_seed(1)
    x = torch.randn(b, t, 3 * h * d, generator=g, device=card).to(
        torch.bfloat16).requires_grad_()
    qkv = x.reshape(b, t, 3, h, d).permute(2, 0, 3, 1, 4)
    o = fa.flash_attention(qkv[0], qkv[1], qkv[2])
    w = torch.randn(b, t, h * d, generator=g, device=card)
    (gx,) = torch.autograd.grad(
        (o.transpose(1, 2).reshape(b, t, h * d).float() * w).sum(), (x,))

    q, k, v = (qkv[i].detach().contiguous() for i in range(3))
    o2, lse = fa.flash_attention_fwd(q, k, v)
    do = w.reshape(b, t, h, d).transpose(1, 2).to(torch.bfloat16)
    want = torch.stack(fa.attention_bwd_reference(q, k, v, o2, lse, do))
    torch.cuda.synchronize()
    assert _close(gx, want.permute(1, 3, 0, 2, 4).reshape(gx.shape), 1e-2)


def test_grad_refuses_what_the_kernels_do_not_take(card):
    """No fallback: under grad, fp16 and head_dim 32 raise."""
    for shape, dtype, match in (((1, 2, 64, 64), torch.float16, "dtype"),
                                ((1, 2, 64, 32), torch.bfloat16,
                                 "head_dim")):
        q = torch.randn(shape, device=card).to(dtype).requires_grad_()
        with pytest.raises(MXNetError, match=match):
            fa.flash_attention(q, q, q)
