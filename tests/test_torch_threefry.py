"""mxnet_tpu_torch.threefry against jax.random, bit for bit.

The serving sampler keys every draw by ``fold_in(fold_in(PRNGKey(seed),
pos), salt)`` (``mxnet_tpu/serving/sampling.py``). Over every (seed,
position, salt) triple of seeds {0, 1, 7, 2^31, 2^32-1}, positions {0,
1, 5, 2047, 2^31-1} and salts 0-3, the port's keys, 32-bit draws and
uniforms equal JAX's exactly at V in {1, 61, 32000}. Gumbels differ only
through the two ``log``s: within 2 ulp of max(|g|, 1), the spacing of
the terms the outer ``log`` sums (near g = 0 the output's own ulp is
far finer than either ``log``'s error).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu_torch import threefry as tf
from mxnet_tpu_torch.base import MXNetError

SEEDS = (0, 1, 7, 2 ** 31, 2 ** 32 - 1)
POSITIONS = (0, 1, 5, 2047, 2 ** 31 - 1)
SALTS = (0, 1, 2, 3)


def _triples():
    s, p, a = zip(*[(s, p, a) for s in SEEDS for p in POSITIONS
                    for a in SALTS])
    return (np.asarray(s, np.uint32), np.asarray(p, np.int32),
            np.asarray(a, np.int32))


@pytest.fixture(scope="module")
def keys():
    seed, pos, salt = _triples()

    def one(s, p, a):
        return jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(s), p), a)

    want = np.asarray(jax.jit(jax.vmap(one))(seed, pos, salt))
    got = tf.fold_in(tf.fold_in(tf.prng_key(seed, "cpu"), pos), salt)
    return want, got


def _jax_draw(fn, keys, V):
    return np.asarray(jax.jit(jax.vmap(lambda k: fn(k, V)))(keys))


def test_partitionable_mode_is_the_one_ported():
    assert jax.config.jax_threefry_partitionable
    assert not jax.config.jax_high_dynamic_range_gumbel


def test_fold_in_chain_keys_equal_jax(keys):
    want, got = keys
    assert got.dtype == torch.int64 and got.shape == (len(want), 2)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_prng_key_is_zero_then_seed():
    got = tf.prng_key(np.asarray([0, 5, 2 ** 32 - 1], np.uint32), "cpu")
    assert got.tolist() == [[0, 0], [0, 5], [0, 2 ** 32 - 1]]
    # uint32 conversion of a negative seed wraps, as astype(np.uint32)
    assert tf.prng_key(np.asarray([-1]), "cpu").tolist() == [[0, 2 ** 32 - 1]]
    want = np.asarray(jax.random.PRNGKey(np.uint32(7)))
    assert tf.prng_key(np.asarray([7]), "cpu")[0].tolist() == want.tolist()


@pytest.mark.parametrize("V", [1, 61, 32000])
def test_random_bits_equal_jax(keys, V):
    want = _jax_draw(lambda k, n: jax.random.bits(k, (n,), jnp.uint32),
                     keys[0], V)
    got = tf.random_bits(keys[1], V)
    assert got.shape == (len(want), V)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("V", [1, 61, 32000])
def test_uniform_bits_equal_jax(keys, V):
    want = _jax_draw(lambda k, n: jax.random.uniform(k, (n,), jnp.float32),
                     keys[0], V)
    got = tf.uniform(keys[1], V).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # a scalar draw is element 0 of a vector draw (iota_2x32_shape(()))
    scalar = np.asarray(jax.jit(jax.vmap(
        lambda k: jax.random.uniform(k, (), jnp.float32)))(keys[0]))
    np.testing.assert_array_equal(got[:, 0].view(np.int32),
                                  scalar.view(np.int32))


def test_uniform_range_bits_equal_jax(keys):
    tiny = np.finfo(np.float32).tiny
    want = _jax_draw(lambda k, n: jax.random.uniform(
        k, (n,), jnp.float32, minval=tiny, maxval=1.0), keys[0], 61)
    got = tf.uniform(keys[1], 61, minval=tiny, maxval=1.0).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("V", [1, 61, 32000])
def test_gumbel_within_two_ulp_of_jax(keys, V):
    want = _jax_draw(lambda k, n: jax.random.gumbel(k, (n,), jnp.float32),
                     keys[0], V)
    got = tf.gumbel(keys[1], V).numpy()
    assert np.isfinite(got).all() and got.dtype == np.float32
    spacing = np.spacing(np.maximum(np.abs(want), 1).astype(np.float32))
    err = np.abs(got.astype(np.float64) - want) / spacing
    assert err.max() <= 2.0, err.max()


def test_call_counter_by_device():
    tf.threefry2x32.calls.clear()
    tf.gumbel(tf.prng_key(np.arange(3), "cpu"), 8)
    assert tf.threefry2x32.calls == {"cpu": 1}
    tf.fold_in(tf.prng_key(np.arange(3), "cpu"), 2)
    assert tf.threefry2x32.calls == {"cpu": 2}


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine "
                    "without CUDA")
def test_prng_key_defaults_to_the_card():
    with pytest.raises(MXNetError, match="CUDA"):
        tf.prng_key(np.arange(3))
