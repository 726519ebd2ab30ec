"""The serving sampler's threefry draws and speculative turn on the card.

The port's threefry is integer torch ops, so its keys, bits and
uniforms must be the same on the card as on the host (the CPU tests hold
the host's equal to JAX's); a sampled ``sample_tokens`` call must do its
vocabulary-wide work on the card; a draft turn followed by a verify must
give the same tokens twice. Every test carries the ``cuda`` marker and
skips without a GPU. The file imports neither ``jax`` nor ``mxnet_tpu``:

    python -m pytest --noconftest tests/test_torch_sampling_cuda.py
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from mxnet_tpu_torch import threefry as tf
from mxnet_tpu_torch.models.transformer import TransformerConfig, init_params
from mxnet_tpu_torch.serving import sampling as ts
from mxnet_tpu_torch.serving.model import ServingModel

pytestmark = pytest.mark.cuda

SEEDS = (0, 1, 7, 2 ** 31, 2 ** 32 - 1)
POSITIONS = (0, 1, 5, 2047, 2 ** 31 - 1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the draws are checked on the card")
    return torch.device("cuda", 0)


def _triples():
    s, p, a = zip(*[(s, p, a) for s in SEEDS for p in POSITIONS
                    for a in range(4)])
    return np.asarray(s, np.uint32), np.asarray(p, np.int64), a


@pytest.mark.parametrize("V", [1, 61, 32000])
def test_bits_and_uniforms_equal_the_hosts(card, V):
    seed, pos, salt = _triples()
    keys = {}
    for dev in ("cpu", card):
        k = tf.fold_in(tf.prng_key(seed, dev), torch.as_tensor(pos,
                                                               device=dev))
        keys[str(dev)] = tf.fold_in(k, torch.as_tensor(salt, device=dev))
    host, dev = keys["cpu"], keys[str(card)]
    assert dev.device.type == "cuda"
    assert torch.equal(dev.cpu(), host)
    assert torch.equal(tf.random_bits(dev, V).cpu(), tf.random_bits(host, V))
    u_dev, u_host = tf.uniform(dev, V).cpu(), tf.uniform(host, V)
    assert torch.equal(u_dev.view(torch.int32), u_host.view(torch.int32))
    g_dev, g_host = tf.gumbel(dev, V).cpu(), tf.gumbel(host, V)
    spacing = np.spacing(np.maximum(g_host.abs().numpy(), 1))
    assert (np.abs((g_dev - g_host).double().numpy()) <= 2 * spacing).all()


class _HostTensors(TorchDispatchMode):
    """Records the largest host tensor any op of the call touches."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        for t in tree_leaves((args, kwargs or {})):
            if isinstance(t, torch.Tensor) and t.device.type == "cpu":
                self.largest = max(self.largest, t.numel())
        return func(*args, **(kwargs or {}))


def test_sampled_call_keeps_the_vocabulary_on_the_card(card):
    g = torch.Generator(device=card).manual_seed(0)
    logits = torch.randn(4, 32000, generator=g, device=card) * 3
    temp = np.asarray([0.8, 1.0, 0.0, 1.3], np.float32)
    tf.threefry2x32.calls.clear()
    with _HostTensors() as seen:
        tok, probs = ts.sample_tokens(
            logits, temp, np.asarray([50, 0, 0, 7]),
            np.asarray([1.0, 0.9, 1.0, 1.0], np.float32),
            np.arange(4, dtype=np.uint32),
            torch.arange(4, device=card) + 100, ts.SALT_TARGET)
    # only the [4] per-row parameters ever lie on the host
    assert seen.largest <= 4
    assert tok.device.type == probs.device.type == "cuda"
    assert set(tf.threefry2x32.calls) == {"cuda"}
    assert int(tok[2]) == int(logits[2].argmax())   # the greedy row


def test_draft_turn_then_verify_same_tokens_twice(card):
    cfg = TransformerConfig(vocab_size=512, num_layers=2, d_model=128,
                            num_heads=2, d_ff=256, max_seq_len=64,
                            dtype="bfloat16")
    params = init_params(cfg, torch.Generator(device=card).manual_seed(0),
                         card)
    model = ServingModel(cfg, block_size=8, max_blocks_per_req=8,
                         batch_buckets=(1, 2, 4), chunk_buckets=(2, 8))
    shape = (cfg.num_layers, 17, 8, cfg.num_heads, cfg.head_dim)
    bt = np.zeros((3, 8), np.int32)
    bt[:, :2] = [[1, 2], [3, 4], [5, 6]]
    samp = dict(temperature=[0.9, 0.0, 1.2], top_k=[0, 0, 20],
                top_p=[0.95, 1.0, 1.0], seed=[3, 4, 5])
    outs = []
    for _ in range(2):
        kp = torch.zeros(shape, dtype=torch.bfloat16, device=card)
        vp = torch.zeros_like(kp)
        d, q = model.draft_turn(
            params, kp, vp, np.asarray([[5, 6], [7, 0], [8, 9]]),
            np.asarray([0, 0, 0]), np.asarray([2, 1, 2]), bt,
            np.ones(3, bool), np.asarray([4, 4, 2]), 4, **samp)
        n, tok = model.verify(
            params, kp, vp, np.asarray([[6], [7], [9]]), d, q,
            np.asarray([1, 0, 1]), np.asarray([5, 5, 3]), bt,
            np.ones(3, bool), **samp)
        assert d.device.type == n.device.type == tok.device.type == "cuda"
        outs.append((d.cpu(), n.cpu(), tok.cpu()))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
