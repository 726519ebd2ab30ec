"""mxnet_tpu_torch context-parallel prefill against the JAX package's.

``cp_prefill_kv`` on a one-device mesh, Ulysses and ring, whole-prompt
and chunked: K, V and the final hidden state match in f32 within 2e-4.
The JAX side runs its Pallas flash kernel in interpret mode
(``MXNET_PALLAS=1``), as its own tests do.
"""
import jax
import numpy as np
import pytest
import torch

from mxnet_tpu.models import transformer as jt
from mxnet_tpu.parallel.mesh import create_mesh as j_create_mesh
from mxnet_tpu.parallel.ring_attention import \
    make_ring_attention as j_make_ring
from mxnet_tpu.parallel.ulysses import make_ulysses_attention as j_make_uly
from mxnet_tpu.serving import cp_prefill_kv as j_cp_prefill_kv
from mxnet_tpu_torch.models import transformer as tt
from mxnet_tpu_torch.ops import flash_attention as fa
from mxnet_tpu_torch.parallel import (create_mesh, make_ring_attention,
                                      make_ulysses_attention)
from mxnet_tpu_torch.serving import cp_prefill_kv

TOL = 2e-4


def _np_params(cfg, seed):
    """Params in the JAX package's layout and scales, made with numpy."""
    rng = np.random.RandomState(seed)

    def dense(shape, scale=None):
        scale = 1.0 / np.sqrt(shape[0]) if scale is None else scale
        return (rng.randn(*shape) * scale).astype(np.float32)

    def ln():
        return {"scale": np.ones(cfg.d_model, np.float32),
                "bias": np.zeros(cfg.d_model, np.float32)}

    d, f = cfg.d_model, cfg.d_ff
    return {"embed": dense((cfg.vocab_size, d), 0.02),
            "pos_embed": dense((cfg.max_seq_len, d), 0.02), "ln_f": ln(),
            "layers": [{"ln1": ln(), "wqkv": dense((d, 3 * d)),
                        "wo": dense((d, d)), "ln2": ln(),
                        "w1": dense((d, f)), "w2": dense((f, d))}
                       for _ in range(cfg.num_layers)]}


@pytest.fixture(scope="module")
def model():
    kw = dict(vocab_size=61, num_layers=2, d_model=32, num_heads=2, d_ff=64,
              max_seq_len=320, dtype="float32")
    jcfg, tcfg = jt.TransformerConfig(**kw), tt.TransformerConfig(**kw)
    tree = _np_params(jcfg, 0)
    jp = jax.tree_util.tree_map(jax.numpy.asarray, tree)
    return jcfg, jp, tcfg, tt.params_from_numpy(tree, device="cpu")


@pytest.mark.parametrize("kind", ["ulysses", "ring"])
@pytest.mark.parametrize("chunk", [None, 128])
def test_cp_prefill_matches_jax(monkeypatch, model, kind, chunk):
    monkeypatch.setenv("MXNET_PALLAS", "1")
    jcfg, jp, tcfg, tp = model
    prompt = np.random.RandomState(11).randint(0, 61, (256,)).astype(
        np.int32)
    jk, jv, jx = j_cp_prefill_kv(jp, jcfg, prompt,
                                 j_create_mesh((1,), ("seq",)), kind=kind,
                                 chunk=chunk)
    mesh = create_mesh((1,), ("seq",), devices=["cpu"])
    k, v, x = cp_prefill_kv(tp, tcfg, prompt, mesh, kind=kind, chunk=chunk)
    assert k.shape == (2, 256, 2, 16) and x.shape == (32,)
    np.testing.assert_allclose(k.numpy(), jk, atol=TOL, rtol=0)
    np.testing.assert_allclose(v.numpy(), jv, atol=TOL, rtol=0)
    np.testing.assert_allclose(x.numpy(), jx, atol=TOL, rtol=0)


def test_ulysses_gate_takes_flash_attention(monkeypatch):
    """At a head_dim the kernel takes (64), the Ulysses local attention
    is flash_attention: once per layer for a whole-prompt prefill, and
    only for the first chunk (q_offset 0) of a chunked one."""
    tcfg = tt.TransformerConfig(vocab_size=61, num_layers=2, d_model=128,
                                num_heads=2, d_ff=64, max_seq_len=320,
                                dtype="float32")
    tp = tt.init_params(tcfg, torch.Generator().manual_seed(1), "cpu")
    calls = []
    orig = fa.flash_attention

    def counting(*a, **kw):
        calls.append(a[0].shape)
        return orig(*a, **kw)

    monkeypatch.setattr(fa, "flash_attention", counting)
    prompt = np.random.RandomState(5).randint(0, 61, (192,)).astype(np.int32)
    mesh = create_mesh((1,), ("seq",), devices=["cpu"])
    k, v, x = cp_prefill_kv(tp, tcfg, prompt, mesh, kind="ulysses")
    assert calls == [(1, 2, 192, 64)] * 2
    calls.clear()
    kc, vc, xc = cp_prefill_kv(tp, tcfg, prompt, mesh, kind="ulysses",
                               chunk=64)
    assert calls == [(1, 2, 64, 64)] * 2
    np.testing.assert_allclose(kc.numpy(), k.numpy(), atol=TOL, rtol=0)
    np.testing.assert_allclose(xc.numpy(), x.numpy(), atol=TOL, rtol=0)
    # the ring scheme (held against the JAX package above) agrees
    kr, _, xr = cp_prefill_kv(tp, tcfg, prompt, mesh, kind="ring")
    np.testing.assert_allclose(k.numpy(), kr.numpy(), atol=TOL, rtol=0)
    np.testing.assert_allclose(x.numpy(), xr.numpy(), atol=TOL, rtol=0)


@pytest.mark.parametrize("scheme,q_offset,causal", [
    ("ring", 24, True), ("ring", 0, False),
    ("ulysses", 24, True), ("ulysses", 0, False)])
def test_attention_schemes_match_jax(scheme, q_offset, causal):
    """Chunked-prefill geometry: 16 queries at key position q_offset."""
    rng = np.random.RandomState(q_offset + causal)
    tk = 16 + q_offset
    q = rng.randn(1, 2, 16, 8).astype(np.float32)
    k = rng.randn(1, 2, tk, 8).astype(np.float32)
    v = rng.randn(1, 2, tk, 8).astype(np.float32)
    jfac = {"ring": j_make_ring, "ulysses": j_make_uly}[scheme]
    tfac = {"ring": make_ring_attention,
            "ulysses": make_ulysses_attention}[scheme]
    want = np.asarray(jfac(j_create_mesh((1,), ("seq",)), causal=causal,
                           q_offset=q_offset)(q, k, v))
    mesh = create_mesh((1,), ("seq",), devices=["cpu"])
    got = tfac(mesh, causal=causal, q_offset=q_offset)(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_multi_device_mesh_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        create_mesh((2,), ("seq",), devices=["cpu", "cpu"])
    mesh = create_mesh((1, 1), ("data", "seq"), devices=["cpu"])
    assert mesh.shape == {"data": 1, "seq": 1}
