"""mxnet_tpu_torch flash-attention backward against the JAX package's.

On CPU tensors the port's backward is its plain version
``attention_bwd_reference`` (also what ``FlashAttention`` runs there).
It is held, in f32 within 1e-4, against the JAX Pallas backward
``_flash_attention_bwd_pallas`` in interpret mode (``MXNET_PALLAS=1``,
lse taken from row 0 of its 8-row layout) and against ``jax.vjp`` of
``_attention_reference``. The CUDA kernels K3/K4 run only on the card:
their tests are in ``test_torch_flash_bwd_kernel_cuda.py``.
"""
import jax
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu_torch.ops import flash_attention as fa

TOL = 1e-4
CASES = [(causal, t, d) for causal in (True, False) for t in (128, 256)
         for d in (16, 32)]


def _inputs(seed, b, h, tq, d, tk=None):
    rng = np.random.RandomState(seed)
    tk = tq if tk is None else tk
    return (rng.randn(b, h, tq, d).astype(np.float32),
            rng.randn(b, h, tk, d).astype(np.float32),
            rng.randn(b, h, tk, d).astype(np.float32),
            rng.randn(b, h, tq, d).astype(np.float32))


def _jax_case(causal, t, d):
    """One jitted program: the Pallas forward and backward (interpret
    mode) and the vjp of the plain JAX attention."""
    scale = 1.0 / np.sqrt(d)
    bq, bk, ok = pk._select_blocks(t, t)
    assert ok and pk.flash_kernel_usable(t, t, d, d)

    def run(q, k, v, do):
        o, lse = pk._flash_attention_pallas(q, k, v, causal, scale, bq, bk)
        pallas = pk._flash_attention_bwd_pallas(q, k, v, o, lse, do, causal,
                                                scale, bq, bk)
        _, pull = jax.vjp(lambda q, k, v: pk._attention_reference(
            q, k, v, causal, scale), q, k, v)
        return o, lse, pallas, pull(do)

    return jax.jit(run)


@pytest.fixture(scope="module")
def jax_grads():
    """For each case: the inputs, the Pallas backward (interpret mode)
    and the vjp of the plain JAX attention; computed once."""
    mp = pytest.MonkeyPatch()
    mp.setenv("MXNET_PALLAS", "1")
    try:
        out = {}
        for causal, t, d in CASES:
            inputs = _inputs(t + d + causal, 1, 2, t, d)
            o, lse, pallas, plain = _jax_case(causal, t, d)(*inputs)
            out[(causal, t, d)] = dict(
                inputs=inputs, o=np.asarray(o),
                lse=np.asarray(lse)[:, 0, :].reshape(1, 2, t),
                pallas=[np.asarray(g) for g in pallas],
                plain=[np.asarray(g) for g in plain])
        return out
    finally:
        mp.undo()


@pytest.mark.parametrize("causal,t,d", CASES)
def test_bwd_reference_matches_jax_pallas_interpret(jax_grads, causal, t,
                                                    d):
    case = jax_grads[(causal, t, d)]
    q, k, v, do = (torch.from_numpy(x) for x in case["inputs"])
    o, lse = fa.attention_reference(q, k, v, causal=causal)
    np.testing.assert_allclose(lse.numpy(), case["lse"], atol=TOL, rtol=0)
    np.testing.assert_allclose(o.numpy(), case["o"], atol=TOL, rtol=0)
    grads = fa.attention_bwd_reference(q, k, v, o, lse, torch.from_numpy(
        case["inputs"][3]), causal=causal)
    for got, want_k, want_p in zip(grads, case["pallas"], case["plain"]):
        np.testing.assert_allclose(got.numpy(), want_k, atol=TOL, rtol=0)
        np.testing.assert_allclose(got.numpy(), want_p, atol=TOL, rtol=0)


@pytest.mark.parametrize("causal,t,d", CASES)
def test_autograd_function_matches_jax_pallas_interpret(jax_grads, causal,
                                                        t, d):
    """flash_attention under autograd on CPU tensors goes through
    FlashAttention and its gradients equal the Pallas backward's."""
    case = jax_grads[(causal, t, d)]
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in case["inputs"][:3])
    o = fa.flash_attention(q, k, v, causal=causal)
    assert o.grad_fn is not None and "FlashAttention" in type(
        o.grad_fn).__name__
    grads = torch.autograd.grad(o, (q, k, v),
                                torch.from_numpy(case["inputs"][3]))
    for got, want in zip(grads, case["pallas"]):
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_ragged_rectangular_bwd_matches_jax_vjp(causal):
    """Lengths off the TPU's 128 grid and tq != tk (top-left causal
    rule), against jax.vjp of the JAX plain attention."""
    q, k, v, do = _inputs(5, 2, 2, 100, 16, tk=150)
    scale = 0.3
    want = jax.jit(lambda q, k, v, do: jax.vjp(
        lambda q, k, v: pk._attention_reference(q, k, v, causal, scale),
        q, k, v)[1](do))(q, k, v, do)
    tq_, tk_, tv_ = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = fa.flash_attention(tq_, tk_, tv_, causal=causal, scale=scale)
    got = torch.autograd.grad(o, (tq_, tk_, tv_), torch.from_numpy(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=0)


def test_no_grad_forward_saves_nothing_and_counts_no_launch():
    q = torch.randn(1, 2, 16, 64, requires_grad=True)
    counts = (fa.flash_attention.launches, fa.flash_bwd_dq.launches,
              fa.flash_bwd_dkv.launches)
    with torch.no_grad():
        o = fa.flash_attention(q, q, q)
    assert o.grad_fn is None and not o.requires_grad
    o = fa.flash_attention(q, q, q)
    o.sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()
    assert counts == (fa.flash_attention.launches, fa.flash_bwd_dq.launches,
                      fa.flash_bwd_dkv.launches)
