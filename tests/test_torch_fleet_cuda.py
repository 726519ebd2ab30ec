"""The serving fleet's card paths: weight staging, gates and replicas.

On the card ``Engine.install_weights`` copies a weight set onto the
device on a side stream before it takes the step lock; the non-finite
gate reads every tensor on the device (bf16 included) in one host
read; fingerprints of card tensors equal their host copies'; the demo
replica engine is the same on every build from one seed. Every test
carries the ``cuda`` marker and skips without a GPU. The file imports
neither ``jax`` nor ``mxnet_tpu``:

    python -m pytest --noconftest tests/test_torch_fleet_cuda.py
"""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models.transformer import TransformerConfig, init_params
from mxnet_tpu_torch.serving import Engine, ServingConfig
from mxnet_tpu_torch.serving.fleet.replica import build_demo_engine
from mxnet_tpu_torch.wsync import common as wc

pytestmark = pytest.mark.cuda

MODEL = dict(vocab_size=61, num_layers=2, d_model=128, num_heads=2,
             d_ff=256, max_seq_len=96, dtype="bfloat16")
POOL = dict(block_size=8, num_blocks=33, max_batch=4, prefill_chunk=16)
PROMPTS = [np.arange(1, 8, dtype=np.int32), np.arange(3, 12, dtype=np.int32)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the engine's weights live on the "
                    "card")
    return torch.device("cuda", 0)


def _params(seed, device):
    cfg = TransformerConfig(**MODEL)
    return cfg, init_params(
        cfg, torch.Generator(device=device).manual_seed(seed), device)


def _fps(params):
    return {k: wc.fingerprint(v) for k, v in wc.flatten_params(params).items()}


def test_install_from_host_equals_a_cold_engine(card):
    cfg, p0 = _params(0, card)
    _, p1 = _params(1, card)
    host_v1 = {k: v.cpu() for k, v in wc.flatten_params(p1).items()}
    hot = Engine(p0, cfg, ServingConfig(**POOL), device=card)
    before = hot.generate(PROMPTS, max_new_tokens=8)
    assert hot.install_weights(1, wc.unflatten_params(host_v1)) == 1
    assert all(t.is_cuda for t in wc.flatten_params(hot.params).values())
    assert _fps(hot.params) == _fps(p1)
    cold = Engine(p1, cfg, ServingConfig(**POOL), device=card)
    got = hot.generate(PROMPTS, max_new_tokens=8)
    assert got == cold.generate(PROMPTS, max_new_tokens=8)
    hot.rollback_weights()
    assert hot.generate(PROMPTS, max_new_tokens=8) == before


def test_installed_set_is_the_engines_own_copy(card):
    cfg, p0 = _params(0, card)
    _, p1 = _params(1, card)
    eng = Engine(p0, cfg, ServingConfig(**POOL), device=card)
    eng.install_weights(1, p1)
    fps = _fps(eng.params)
    p1["embed"].add_(1.0)     # the caller's next optimizer step
    torch.cuda.synchronize()
    assert _fps(eng.params) == fps


def test_nonfinite_bf16_on_the_card_is_refused(card):
    cfg, p0 = _params(0, card)
    _, bad = _params(2, card)
    bad["layers"][1]["w2"][3, 5] = float("nan")
    assert wc.nonfinite_keys(wc.flatten_params(bad)) == ["layers/1/w2"]
    eng = Engine(p0, cfg, ServingConfig(**POOL), device=card)
    fps = _fps(eng.params)
    with pytest.raises(MXNetError, match="non-finite tensors: layers/1/w2"):
        eng.install_weights(1, bad)
    assert _fps(eng.params) == fps and eng.weight_version() is None


def test_card_fingerprints_equal_host_copies(card):
    t = torch.randn(33, 17, device=card).to(torch.bfloat16)
    assert wc.fingerprint(t) == wc.fingerprint(t.cpu())
    assert wc.manifest_of({"t": t}) == wc.manifest_of({"t": t.cpu()})
    assert torch.equal(wc.from_wire(wc.to_wire(t), wc.BF16_STR), t.cpu())


def test_demo_replica_engine_is_the_same_on_every_build(card):
    a = build_demo_engine(7, card)
    b = build_demo_engine(7, card)
    assert a.device.type == "cuda"
    assert _fps(a.params) == _fps(b.params)
    assert a.generate(PROMPTS, 10) == b.generate(PROMPTS, 10)
