"""mxnet_tpu_torch sampling against the JAX package's.

Greedy is exact argmax (first index on ties) on the card path and the
host path; ``filter_dist`` matches the JAX package's numpy host
reference; a sampled draw raises until the threefry bits are ported.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu.serving import sampling as js
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


def test_sampled_draw_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ts.host_sample(np.zeros(4, np.float32), 0.8, 0, 1.0, 0, 3)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ts.sample_tokens(torch.zeros(2, 4), np.asarray([0.0, 0.5]), None,
                         None, None, None, ts.SALT_TARGET)
