"""The Hopper flash-attention forward kernel on the card (the backward
kernels have their own file, ``test_torch_flash_bwd_kernel_cuda.py``):
against the plain version at ragged, rectangular, D = 64 and 128 and f32
shapes, in both of the bf16 kernel's block shapes, on the LM's strided
q/k/v views (read in place: the call allocates only o and lse) and on
operands that have to be copied first.

A CUDA kernel has no CPU mode, so every test here carries the ``cuda``
marker and skips without a GPU. The file imports neither ``jax`` nor
``mxnet_tpu``, so it runs on a machine with the card and no JAX; the
repository's ``tests/conftest.py`` pins JAX, so skip it there:

    python -m pytest --noconftest tests/test_torch_flash_kernel_cuda.py
"""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _close(got, want, tol):
    """Per element |got - want| <= tol * (rms(want) + |want|): a causal
    head's late rows are far smaller than its first."""
    g, w = got.float(), want.float()
    return ((g - w).abs() <= tol * (w.pow(2).mean().sqrt() + w.abs())).all()


def _qkv(card, shape, dtype, tk=None, seed=0):
    g = torch.Generator(device=card).manual_seed(seed)
    b, h, t, d = shape
    kv_shape = (b, h, t if tk is None else tk, d)
    return (torch.randn(shape, generator=g, device=card).to(dtype),
            torch.randn(kv_shape, generator=g, device=card).to(dtype),
            torch.randn(kv_shape, generator=g, device=card).to(dtype))


@pytest.mark.parametrize("shape,dtype,causal,tk", [
    ((1, 8, 2048, 128), torch.bfloat16, True, None),
    ((2, 4, 2000, 64), torch.bfloat16, False, None),
    ((2, 4, 2000, 64), torch.bfloat16, True, None),
    ((1, 2, 100, 64), torch.bfloat16, True, 150),
    ((1, 2, 200, 128), torch.float32, False, 70),
    ((1, 8, 384, 128), torch.float32, True, None),
])
def test_kernel_matches_reference(card, shape, dtype, causal, tk):
    q, k, v = _qkv(card, shape, dtype, tk)
    before = fa.flash_attention.launches
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    assert fa.flash_attention.launches == before + 1
    o_ref, lse_ref = fa.attention_reference(q, k, v, causal=causal)
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert o.dtype == dtype and lse.shape == shape[:3]
    assert (o.float() - o_ref.float()).abs().max().item() <= tol
    assert _close(o, o_ref, 1e-2 if dtype == torch.bfloat16 else 1e-4)
    assert (lse - lse_ref).abs().max().item() <= 1e-3


@pytest.mark.parametrize("variant", [1, 2])
@pytest.mark.parametrize("shape,causal,tk", [
    ((2, 4, 2000, 64), True, None),
    ((2, 4, 2000, 128), False, None),
    ((1, 2, 100, 64), True, 150),
    ((2, 3, 300, 128), True, 77),
])
def test_both_block_shapes_match_reference(card, variant, shape, causal, tk):
    """The bf16 kernel's two block shapes (128 query rows in two
    warpgroups, 64 in one), each at D = 64 and 128, ragged and Tq != Tk,
    whatever the shape would pick by itself."""
    q, k, v = _qkv(card, shape, torch.bfloat16, tk)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, variant=variant)
    o_ref, lse_ref = fa.attention_reference(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert (o.float() - o_ref.float()).abs().max().item() <= 2e-2
    assert _close(o, o_ref, 1e-2)
    assert (lse - lse_ref).abs().max().item() <= 1e-3


def _lm_qkv(card, b, t, h, d, seed=0):
    """q, k, v as the transformer builds them: chunks of one
    [B, T, 3HD] product, reshaped to heads and transposed."""
    g = torch.Generator(device=card).manual_seed(seed)
    qkv = torch.randn((b, t, 3 * h * d), generator=g, device=card).to(
        torch.bfloat16)
    return tuple(x.reshape(b, t, h, d).transpose(1, 2)
                 for x in qkv.chunk(3, dim=-1))


def _block(nbytes):
    """What the caching allocator books for a tensor of nbytes."""
    return -(-nbytes // 512) * 512


@pytest.mark.parametrize("b,t,h,d", [(2, 1000, 8, 128), (1, 2048, 8, 128),
                                     (2, 512, 4, 64)])
def test_lm_strided_views_are_read_in_place(card, b, t, h, d):
    """The LM's views go to the kernel as they are: the call allocates
    o and lse and nothing else, and agrees with the plain version."""
    q, k, v = _lm_qkv(card, b, t, h, d)
    assert not q.is_contiguous() and fa.tma_strides(q) is not None
    fa.flash_attention_fwd(q, k, v)       # build and warm
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(card)
    o, lse = fa.flash_attention_fwd(q, k, v)
    assert torch.cuda.memory_allocated(card) - before == \
        _block(o.numel() * 2) + _block(lse.numel() * 4)
    assert o.is_contiguous() and o.shape == (b, h, t, d)
    o_ref, lse_ref = fa.attention_reference(q, k, v)
    torch.cuda.synchronize()
    assert (o.float() - o_ref.float()).abs().max().item() <= 2e-2
    assert _close(o, o_ref, 1e-2)
    assert (lse - lse_ref).abs().max().item() <= 1e-3


def test_operand_off_the_rule_is_copied_first(card):
    """q starting 2 bytes off 16 and k with rows of 264 bytes break the
    tensor maps' rule: the wrapper copies them, and the kernel still
    runs once and agrees."""
    g = torch.Generator(device=card).manual_seed(3)
    wide = torch.randn((1, 4, 300, 136), generator=g, device=card).to(
        torch.bfloat16)
    q = wide[..., 1:129]
    k = torch.randn((1, 4, 300, 132), generator=g, device=card).to(
        torch.bfloat16)[..., :128]
    v = torch.randn((1, 4, 300, 128), generator=g, device=card).to(
        torch.bfloat16)
    assert fa.tma_strides(q) is None and fa.tma_strides(k) is None
    before = fa.flash_attention.launches
    o, lse = fa.flash_attention_fwd(q, k, v)
    assert fa.flash_attention.launches == before + 1
    o_ref, lse_ref = fa.attention_reference(q, k, v)
    torch.cuda.synchronize()
    assert _close(o, o_ref, 1e-2)
    assert (lse - lse_ref).abs().max().item() <= 1e-3


def test_kernel_refuses_what_it_does_not_take(card):
    q, k, v = _qkv(card, (1, 2, 64, 32), torch.bfloat16)
    with pytest.raises(MXNetError, match="head_dim"):
        fa.flash_attention(q, k, v)
    q, k, v = _qkv(card, (1, 2, 64, 64), torch.float16)
    with pytest.raises(MXNetError, match="dtype"):
        fa.flash_attention(q, k, v)


def test_grad_input_launches_forward_then_both_backward_kernels(card):
    """A CUDA input that requires grad goes through FlashAttention: K2
    once in the forward, then K3 and K4 once each in the backward."""
    q, k, v = _qkv(card, (1, 2, 64, 64), torch.bfloat16)
    q.requires_grad_(True)
    counts = (fa.flash_attention.launches, fa.flash_bwd_dq.launches,
              fa.flash_bwd_dkv.launches)
    o = fa.flash_attention(q, k, v)
    assert fa.flash_attention.launches == counts[0] + 1
    assert (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == counts[1:]
    (dq,) = torch.autograd.grad(o.float().sum(), (q,))
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == (counts[0] + 1, counts[1] + 1,
                                           counts[2] + 1)
    assert dq.shape == q.shape and torch.isfinite(dq.float()).all()


def test_ulysses_cp_prefill_launches_the_kernel_once_per_layer(card):
    """The serving path's long-prompt prefill on the card goes through
    the kernel, once per layer, and agrees with the same prefill on the
    CPU (the plain version there); f32, so only the kernel and the
    matmuls' summation order differ."""
    from mxnet_tpu_torch.models.transformer import (TransformerConfig,
                                                    init_params)
    from mxnet_tpu_torch.parallel import create_mesh
    from mxnet_tpu_torch.serving import cp_prefill_kv
    from mxnet_tpu_torch.serving.engine import _to_device

    cfg = TransformerConfig(vocab_size=64, num_layers=3, d_model=256,
                            num_heads=2, d_ff=512, max_seq_len=512,
                            dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    on_card = _to_device(params, card)
    tokens = np.random.RandomState(0).randint(0, 64, (300,))
    before = fa.flash_attention.launches
    k, v, x_last = cp_prefill_kv(
        on_card, cfg, tokens, create_mesh((1,), ("seq",), devices=[card]),
        kind="ulysses")
    assert fa.flash_attention.launches == before + cfg.num_layers
    k_cpu, _, x_cpu = cp_prefill_kv(
        params, cfg, tokens, create_mesh((1,), ("seq",), devices=["cpu"]),
        kind="ulysses")
    assert k.shape == (3, 300, 2, 128)
    assert (k.cpu() - k_cpu).abs().max().item() <= 1e-3
    assert (x_last.cpu() - x_cpu).abs().max().item() <= 1e-3
