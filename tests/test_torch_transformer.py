"""mxnet_tpu_torch transformer against the JAX package's.

Params are built by the JAX package and carried across with
``params_from_numpy``; logits must match the JAX ``forward`` in f32
within 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.models import transformer as jt
from mxnet_tpu_torch.models import transformer as tt


def _cfgs(dtype="float32"):
    kw = dict(vocab_size=61, num_layers=2, d_model=32, num_heads=2, d_ff=64,
              max_seq_len=96, dtype=dtype)
    return jt.TransformerConfig(**kw), tt.TransformerConfig(**kw)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_numpy_round_trip(dtype):
    jcfg, _ = _cfgs(dtype)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tt.params_from_numpy(_np_tree(jp), device="cpu")
    want_dtype = getattr(torch, dtype)
    assert tp["embed"].dtype == want_dtype
    assert tp["layers"][1]["wqkv"].dtype == want_dtype
    assert tp["ln_f"]["scale"].dtype == torch.float32
    flat_j = jax.tree_util.tree_leaves(jp)
    flat_t = jax.tree_util.tree_leaves(tp)
    assert len(flat_j) == len(flat_t)
    for a, b in zip(flat_j, flat_t):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      b.float().numpy())


def test_params_from_numpy_recast():
    jcfg, _ = _cfgs()
    jp = jt.init_params(jcfg, jax.random.PRNGKey(1))
    tp = tt.params_from_numpy(_np_tree(jp), device="cpu",
                              dtype=torch.bfloat16)
    assert tp["layers"][0]["w1"].dtype == torch.bfloat16
    assert tp["layers"][0]["ln1"]["bias"].dtype == torch.float32


def test_forward_matches_jax():
    T = 33
    jcfg, tcfg = _cfgs()
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tt.params_from_numpy(_np_tree(jp), device="cpu")
    tokens = np.random.RandomState(T).randint(0, 61, (2, T)).astype(np.int32)
    want = np.asarray(jt.forward(jp, jnp.asarray(tokens), jcfg))
    got = tt.forward(tp, tokens, tcfg).numpy()
    assert got.shape == (2, T, 61)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_layer_norm_and_gelu_match_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 32).astype(np.float32) * 3 + 1
    p = {"scale": rng.randn(32).astype(np.float32),
         "bias": rng.randn(32).astype(np.float32)}
    want = np.asarray(jt._layer_norm(jnp.asarray(x), p))
    got = tt._layer_norm(torch.from_numpy(x),
                         {k: torch.from_numpy(v) for k, v in p.items()})
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tt._gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x))),
                               atol=1e-5, rtol=0)


def test_init_params_shapes_and_scales():
    _, tcfg = _cfgs()
    g = torch.Generator().manual_seed(0)
    p = tt.init_params(tcfg, g, device="cpu")
    assert p["embed"].shape == (61, 32)
    assert p["layers"][0]["wqkv"].shape == (32, 96)
    assert p["layers"][1]["w2"].shape == (64, 32)
    assert abs(p["embed"].std().item() - 0.02) < 0.005
    assert abs(p["layers"][0]["w1"].std().item() - 32 ** -0.5) < 0.05


def test_entry_points_need_a_device_without_cuda():
    """No CPU fallback: without CUDA, an entry point called without a
    device raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from mxnet_tpu_torch.base import MXNetError

    _, tcfg = _cfgs()
    with pytest.raises(MXNetError, match="CUDA"):
        tt.init_params(tcfg, torch.Generator())
