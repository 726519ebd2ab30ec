"""mxnet_tpu_torch sampling against the JAX package's.

Greedy is exact argmax (first index on ties) on the device path and
the host path; ``filter_dist`` matches the JAX package's numpy host
reference; the sampled draws (``sample_tokens`` and ``host_sample``)
give the JAX package's tokens on the same logits, parameters, seeds and
positions, with the distributions within rtol 1e-6; an all-greedy batch
makes no threefry draw.
"""
import jax
import numpy as np
import pytest
import torch

from mxnet_tpu.serving import sampling as js
from mxnet_tpu_torch import threefry as tf
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serving import sampling as ts


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (5, 1.0), (0, 0.8),
                                         (7, 0.5)])
def test_filter_dist_matches_jax_host_reference(top_k, top_p):
    rng = np.random.RandomState(top_k)
    logits = (rng.randn(3, 40) * 2).astype(np.float32)
    temp = np.asarray([0.5, 1.0, 1.7], np.float32)
    tk = np.full((3,), top_k, np.int32)
    tp = np.full((3,), top_p, np.float32)
    want_m, want_p = js.filter_dist(np, logits, temp, tk, tp)
    got_m, got_p = ts.filter_dist(torch.from_numpy(logits), temp, tk, tp)
    np.testing.assert_allclose(got_m.numpy(), want_m, atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(got_p.numpy(), want_p, atol=1e-6, rtol=0)


def test_greedy_is_first_argmax_on_both_paths():
    logits = np.asarray([[0.5, 2.0, 2.0, -1.0], [3.0, 3.0, 0.0, 1.0]],
                        np.float32)
    tok, probs = ts.sample_tokens(torch.from_numpy(logits),
                                  np.zeros(2, np.float32), None, None, None,
                                  None, ts.SALT_TARGET)
    assert tok.tolist() == [1, 0] and tok.dtype == torch.int32
    assert probs.sum(-1).tolist() == [1.0, 1.0]
    for row in logits:
        assert ts.host_sample(row, 0.0, 0, 1.0, 0, 3) == \
            js.host_sample(row, 0.0, 0, 1.0, 0, 3)


# (temperature, top_k, top_p) per row of an 8-row batch
_CASES = {
    "greedy": ([0.0] * 8, [0] * 8, [1.0] * 8),
    "temperature": ([0.7, 1.0, 1.3, 0.4, 0.9, 2.0, 1.1, 0.8], [0] * 8,
                    [1.0] * 8),
    "top_k": ([0.8] * 8, [1, 2, 5, 10, 61, 3, 7, 20], [1.0] * 8),
    "top_p": ([1.0] * 8, [0] * 8, [0.1, 0.5, 0.8, 0.9, 0.95, 0.3, 1.0, 0.6]),
    "mixed": ([0.0, 0.9, 1.2, 0.0, 0.6, 1.0, 0.8, 1.5],
              [0, 0, 10, 5, 0, 7, 3, 0], [1.0, 1.0, 1.0, 0.9, 0.7, 0.8, 1.0,
                                          0.5]),
}


def _near_top_p_boundary(logits, temp, top_k, top_p):
    """Tokens whose top-p keep decision (mass before them < top_p) is
    within f32 cumulative-sum rounding (1e-6) of flipping. torch's CPU
    ``cumsum`` accumulates f32 in double, XLA's in f32, so the two
    packages may decide those tokens differently (ROADMAP Queue 3); the
    probabilities of every other token must agree within rtol 1e-6."""
    _, probs = js.filter_dist(np, logits, temp, top_k, np.ones_like(top_p))
    probs = probs.astype(np.float64)
    order = np.argsort(-probs, axis=-1, kind="stable")
    sp = np.take_along_axis(probs, order, axis=-1)
    before = np.cumsum(sp, axis=-1) - sp
    near = np.abs(before - top_p[:, None]) < 1e-6
    out = np.zeros_like(near)
    np.put_along_axis(out, order, near, axis=-1)
    # a batch with no filtering row takes the sort-free path in both
    return out & np.any((top_k > 0) | (top_p < 1))


@pytest.fixture(scope="module")
def jax_sampler():
    return jax.jit(js.sample_tokens, static_argnums=(6,))


@pytest.mark.parametrize("case", sorted(_CASES))
def test_sample_tokens_equal_jax(jax_sampler, case):
    temp, top_k, top_p = (np.asarray(a, d) for a, d in zip(
        _CASES[case], (np.float32, np.int32, np.float32)))
    rng = np.random.RandomState(len(case))
    logits = (rng.randn(8, 61) * 3).astype(np.float32)
    seed = np.asarray([0, 1, 7, 2 ** 31, 2 ** 32 - 1, 5, 9, 123], np.uint32)
    pos = np.asarray([0, 1, 5, 17, 2047, 3, 60, 2 ** 31 - 1], np.int32)
    for salt in (ts.SALT_TARGET, ts.SALT_DRAFT):
        want_t, want_p = jax_sampler(logits, temp, top_k, top_p, seed, pos,
                                     salt)
        got_t, got_p = ts.sample_tokens(torch.from_numpy(logits), temp,
                                        top_k, top_p, seed, pos, salt)
        assert got_t.dtype == torch.int32
        assert got_t.tolist() == np.asarray(want_t).tolist()
        got_p, want_p = got_p.numpy(), np.asarray(want_p)
        near = _near_top_p_boundary(logits, temp, top_k, top_p)
        np.testing.assert_allclose(np.where(near, 0, got_p),
                                   np.where(near, 0, want_p), rtol=1e-6,
                                   atol=0)
        # at the boundary a token is kept by one package and dropped by
        # the other: only ever a token of vanishing mass
        assert np.abs(got_p - want_p)[near].max(initial=0) < 1e-6


@pytest.mark.parametrize("temp,top_k,top_p", [(0.8, 0, 1.0), (1.3, 10, 1.0),
                                              (0.9, 0, 0.8), (1.0, 7, 0.9)])
def test_host_sample_equal_jax(temp, top_k, top_p):
    rng = np.random.RandomState(11)
    for i in range(6):
        row = (rng.randn(61) * 2).astype(np.float32)
        want = js.host_sample(row, temp, top_k, top_p, 21 + i, 5 + i)
        assert ts.host_sample(row, temp, top_k, top_p, 21 + i, 5 + i) == want
        assert ts.host_sample(torch.from_numpy(row), temp, top_k, top_p,
                              21 + i, 5 + i, ts.SALT_RESIDUAL) == \
            js.host_sample(row, temp, top_k, top_p, 21 + i, 5 + i,
                           js.SALT_RESIDUAL)


def test_fold_keys_and_host_key_equal_jax():
    seed = np.asarray([0, 3, 2 ** 32 - 1], np.uint32)
    pos = np.asarray([0, 40, 2 ** 31 - 1], np.int32)
    for salt in (ts.SALT_TARGET, ts.SALT_ACCEPT, ts.SALT_DRAFT,
                 ts.SALT_RESIDUAL):
        want = np.asarray(js.fold_keys(seed, pos, salt)).astype(np.int64)
        got = ts.fold_keys(seed, torch.from_numpy(pos), salt)
        np.testing.assert_array_equal(got.numpy(), want)
        assert ts.host_key(3, 40, salt).tolist() == \
            np.asarray(js.host_key(3, 40, salt)).tolist()
    # one call over per-row salts gives each row's key
    salts = np.asarray([0, 3, 1], np.int32)
    want = np.stack([np.asarray(js.fold_keys(seed[i:i + 1], pos[i:i + 1],
                                             int(salts[i])))[0]
                     for i in range(3)]).astype(np.int64)
    got = ts.fold_keys(seed, torch.from_numpy(pos), torch.from_numpy(salts))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine "
                    "without CUDA")
def test_fold_keys_of_host_positions_default_to_the_card():
    with pytest.raises(MXNetError, match="CUDA"):
        ts.fold_keys(np.arange(3), np.arange(3), ts.SALT_TARGET)


def test_all_greedy_batch_makes_no_draw():
    logits = torch.from_numpy(
        np.random.RandomState(0).randn(4, 61).astype(np.float32))
    args = ([0] * 4, [1.0] * 4, np.arange(4), np.arange(4))
    tf.threefry2x32.calls.clear()
    ts.sample_tokens(logits, np.zeros(4, np.float32), *args, ts.SALT_TARGET)
    assert tf.threefry2x32.calls == {}
    ts.sample_tokens(logits, np.asarray([0, 0, 0.5, 0], np.float32), *args,
                     ts.SALT_TARGET)
    assert sum(tf.threefry2x32.calls.values()) > 0
