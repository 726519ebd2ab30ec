"""The Hopper flash-attention backward kernels (K3 dQ, K4 dK/dV) on the
card: against the plain version at D = 64 and 128, causal and not,
ragged and Tq != Tk shapes and f32, in both of K3's bf16 block shapes;
on the LM's strided q/k/v and transposed dO (read in place: the two
kernel calls ask for dq, dk and dv and nothing else, flash_attention_bwd
for no more than its D pass); two calls give the same bits; an operand
off the tensor maps' rule is copied first.

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
    ((1, 4, 2000, 128), torch.bfloat16, False, None),
    ((1, 4, 2000, 128), torch.bfloat16, True, None),
    ((1, 2, 150, 128), torch.bfloat16, True, 100),
    ((1, 2, 70, 128), torch.bfloat16, False, 300),
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
    autograd path reads it in place and agrees with the plain backward
    on the same operands, laid out contiguously (the forward's own o and
    lse, dO = the head-major bf16 grad output)."""
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


@pytest.mark.parametrize("wide,shape,causal,tk", [
    (True, (4, 8, 600, 128), True, None),
    (True, (8, 8, 300, 64), False, 200),
    (False, (2, 4, 1000, 128), True, None),
    (False, (1, 2, 300, 64), False, 200),
])
def test_both_dq_block_shapes_match_reference(card, wide, shape, causal,
                                              tk):
    """K3's 128-row blocks, taken where the grid has at least as many
    128-row tiles as the card has SMs (``wide``), and its 64-row blocks,
    taken below that."""
    b, h, tq, d = shape
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert (b * h * -(-tq // 128) >= sms) == wide
    q, k, v, o, lse, do = _operands(card, shape, torch.bfloat16, tk, causal)
    dcap = (do.float() * o.float()).sum(-1)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, dcap, causal, d ** -0.5)
    want = fa.attention_bwd_reference(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert _close(dq, want[0], 1e-2)


def _lm_operands(card, b, t, h, d, seed=2):
    """The transformer's views: q, k, v chunks of one [B, T, 3HD]
    product, dO the head-transposed gradient of
    ``o.transpose(1, 2).reshape(B, T, HD)``."""
    g = torch.Generator(device=card).manual_seed(seed)
    qkv = torch.randn(b, t, 3 * h * d, generator=g, device=card).to(
        torch.bfloat16)
    q, k, v = (x.reshape(b, t, h, d).transpose(1, 2)
               for x in qkv.chunk(3, dim=-1))
    do = torch.randn(b, t, h * d, generator=g, device=card).to(
        torch.bfloat16).reshape(b, t, h, d).transpose(1, 2)
    o, lse = fa.attention_reference(q, k, v)
    return q, k, v, o, lse, do, (do.float() * o.float()).sum(-1)


def _peak_new_bytes(card, fn):
    """fn's result and the most bytes beyond those held before that it
    asked of the caching allocator at any moment, before the allocator's
    rounding: a copy made and freed inside fn counts."""
    torch.cuda.synchronize(card)
    torch.cuda.reset_peak_memory_stats(card)
    before = torch.cuda.memory_stats(card)["requested_bytes.all.current"]
    out = fn()
    torch.cuda.synchronize(card)
    return out, (torch.cuda.memory_stats(card)["requested_bytes.all.peak"]
                 - before)


@pytest.mark.parametrize("b,t,h,d", [(2, 1000, 8, 128), (2, 512, 4, 64)])
def test_lm_strided_operands_are_read_in_place(card, b, t, h, d):
    """The LM's q, k, v and dO go to K3 and K4 as they are: the two
    kernel calls ask for dq, dk and dv and nothing else at any moment;
    flash_attention_bwd, which decides what to copy, asks for no more
    than its D = rowsum(dO * O) pass alone does (a copy of an operand
    would be held through that pass); both agree with the plain
    version."""
    q, k, v, o, lse, do, dcap = _lm_operands(card, b, t, h, d)
    assert not do.is_contiguous()
    assert all(fa.tma_strides(x) is not None for x in (q, k, v, do))
    scale = d ** -0.5
    fa.flash_bwd_dq(q, k, v, do, lse, dcap, True, scale)   # build, warm
    (dq, dk, dv), new_bytes = _peak_new_bytes(card, lambda: (
        fa.flash_bwd_dq(q, k, v, do, lse, dcap, True, scale),
        *fa.flash_bwd_dkv(q, k, v, do, lse, dcap, True, scale)))
    assert new_bytes == 3 * b * h * t * d * 2
    _, d_bytes = _peak_new_bytes(
        card, lambda: (do.float() * o.float()).sum(-1))
    full, full_bytes = _peak_new_bytes(
        card, lambda: fa.flash_attention_bwd(q, k, v, o, lse, do))
    assert full_bytes == d_bytes
    want = fa.attention_bwd_reference(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    for name, got, again, w in zip(("dq", "dk", "dv"), (dq, dk, dv), full,
                                   want):
        assert got.is_contiguous() and got.shape == (b, h, t, d)
        assert _close(got, w, 1e-2), name
        assert torch.equal(got, again), name


def test_two_calls_give_the_same_bits(card):
    """No atomics: dq, dk and dv are bitwise the same from call to
    call."""
    q, k, v, o, lse, do, dcap = _lm_operands(card, 2, 1024, 8, 128)
    first = (fa.flash_bwd_dq(q, k, v, do, lse, dcap, True, 128 ** -0.5),
             *fa.flash_bwd_dkv(q, k, v, do, lse, dcap, True, 128 ** -0.5))
    second = (fa.flash_bwd_dq(q, k, v, do, lse, dcap, True, 128 ** -0.5),
              *fa.flash_bwd_dkv(q, k, v, do, lse, dcap, True, 128 ** -0.5))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_operand_off_the_rule_is_copied_first(card):
    """q starting 2 bytes off 16 and a dO with rows of 264 bytes break
    the tensor maps' rule: the kernel wrappers refuse them, and
    flash_attention_bwd copies them first and agrees with the plain
    version."""
    g = torch.Generator(device=card).manual_seed(3)
    shape = (1, 4, 300, 128)
    q = torch.randn((1, 4, 300, 136), generator=g, device=card).to(
        torch.bfloat16)[..., 1:129]
    k, v = (torch.randn(shape, generator=g, device=card).to(torch.bfloat16)
            for _ in range(2))
    do = torch.randn((1, 4, 300, 132), generator=g, device=card).to(
        torch.bfloat16)[..., :128]
    assert fa.tma_strides(q) is None and fa.tma_strides(do) is None
    o, lse = fa.attention_reference(q, k, v)
    dcap = (do.float() * o.float()).sum(-1)
    with pytest.raises(MXNetError, match="tma_strides"):
        fa.flash_bwd_dq(q, k, v, do, lse, dcap, True, 128 ** -0.5)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do)
    want = fa.attention_bwd_reference(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    for name, g_, w in zip(("dq", "dk", "dv"), got, want):
        assert _close(g_, w, 1e-2), name
