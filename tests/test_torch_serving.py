"""mxnet_tpu_torch serving engine against the JAX package's.

Greedy ``Engine.generate`` streams are byte-equal between the two
packages from the same parameters (made with numpy in the JAX layout,
carried across with ``params_from_numpy``) in three setups: paged path only; a
one-device mesh with Ulysses context-parallel prefill for long prompts;
and a tight pool that forces evict and recompute.
"""
import jax
import numpy as np
import pytest
import torch

from mxnet_tpu.models import transformer as jt
from mxnet_tpu.parallel.mesh import create_mesh as j_create_mesh
from mxnet_tpu.serving import Engine as JEngine
from mxnet_tpu.serving import ServingConfig as JServingConfig
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import transformer as tt
from mxnet_tpu_torch.parallel import create_mesh
from mxnet_tpu_torch.serving import (Engine, PagedKVPool, QueueFullError,
                                     ServingConfig)


@pytest.fixture(scope="module", autouse=True)
def _unported_switches_off():
    """The suite's conftest arms the JAX package's lock tracer
    (``MXNET_ENGINE_VERIFY``) for every test; the port's Engine refuses
    it, so its tests run with it unset (the compile verifier,
    ``MXNET_JIT_VERIFY``, is ported and stays in record mode)."""
    with pytest.MonkeyPatch.context() as mp:
        for name in ("MXNET_ENGINE_VERIFY", "MXNET_PROF"):
            mp.delenv(name, raising=False)
        yield


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


def _both(model, prompts, max_new, jmesh=None, tmesh=None, **kw):
    jcfg, jp, tcfg, tp = model
    jeng = JEngine(jp, jcfg, JServingConfig(mesh=jmesh, **kw))
    teng = Engine(tp, tcfg, ServingConfig(mesh=tmesh, **kw), device="cpu")
    return (jeng.generate(prompts, max_new_tokens=max_new),
            teng.generate(prompts, max_new_tokens=max_new), jeng, teng)


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 61, (n,)).astype(np.int32) for n in lens]


def test_paged_path_streams_equal_jax(model):
    prompts = _prompts(1, [5, 19, 12])
    want, got, _, teng = _both(model, prompts, 8, block_size=8,
                               num_blocks=33, max_batch=4, prefill_chunk=16)
    assert got == want
    assert all(len(s) == 8 for s in got)
    assert teng.pool.num_used == 0


def test_ulysses_cp_prefill_streams_equal_jax(model, monkeypatch):
    """A 256-token prompt takes the context-parallel prefill (Ulysses on
    a one-device mesh); the 7- and 40-token prompts the paged path."""
    monkeypatch.setenv("MXNET_PALLAS", "1")
    prompts = _prompts(2, [256, 7, 40])
    want, got, jeng, teng = _both(
        model, prompts, 6, jmesh=j_create_mesh((1,), ("seq",)),
        tmesh=create_mesh((1,), ("seq",), devices=["cpu"]),
        cp_kind="ulysses", cp_min_tokens=128, block_size=8, num_blocks=64,
        max_batch=4, prefill_chunk=16)
    assert got == want
    assert teng.stats()["cp_prefills"] == 1
    assert all(len(s) == 6 for s in got)


def test_tight_pool_evict_recompute_streams_equal_jax(model):
    prompts = _prompts(5, [9, 15, 11, 14])
    want, got, jeng, teng = _both(model, prompts, 10, block_size=8,
                                  num_blocks=9, max_batch=4,
                                  prefill_chunk=16)
    assert teng.stats()["evicted"] > 0, "pool was meant to force evictions"
    assert teng.stats()["evicted"] == jeng.stats()["evicted"]
    assert got == want
    assert teng.pool.num_used == 0


def _engine(model, **kw):
    _, _, tcfg, tp = model
    kw.setdefault("block_size", 8)
    kw.setdefault("num_blocks", 33)
    kw.setdefault("max_batch", 4)
    kw.setdefault("prefill_chunk", 16)
    return Engine(tp, tcfg, ServingConfig(**kw), device="cpu")


def test_engine_without_device_raises_on_cpu_only_machine(model):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, tcfg, tp = model
    with pytest.raises(MXNetError, match="CUDA"):
        Engine(tp, tcfg, ServingConfig(block_size=8, num_blocks=9))


def test_stream_api_cancel_and_background(model):
    eng = _engine(model)
    h = eng.submit(np.arange(6), max_new_tokens=4)
    eng.run_until_idle()
    assert len(h.result(timeout=5)) == 4 and h.status == "finished"
    h2 = eng.submit(np.arange(9), max_new_tokens=50)
    eng.step()
    eng.step()
    h2.cancel()
    eng.run_until_idle()
    assert h2.status == "cancelled" and eng.pool.num_used == 0
    eng.start()
    try:
        outs = eng.generate([np.arange(4)], max_new_tokens=3)
    finally:
        eng.stop()
    assert len(outs[0]) == 3


def test_admission_control(model):
    eng = _engine(model, max_queue_depth=1)
    eng.submit(np.arange(4), max_new_tokens=2)
    with pytest.raises(QueueFullError):
        eng.submit(np.arange(4), max_new_tokens=2)
    with pytest.raises(MXNetError, match="engine limit"):
        eng.submit(np.arange(300), max_new_tokens=60)
    assert eng.stats()["rejected"] == 2


def test_paged_pool_allocator():
    pool = PagedKVPool(2, 2, 8, num_blocks=9, block_size=4, device="cpu")
    assert pool.k.shape == (2, 9, 4, 2, 8) and pool.capacity == 8
    blocks = pool.alloc(5)
    assert 0 not in blocks and pool.num_used == 5
    assert pool.alloc(4) is None
    pool.free(blocks)
    with pytest.raises(ValueError, match="double free"):
        pool.free(blocks[:1])
    with pytest.raises(ValueError, match="invalid"):
        pool.free([0])
    assert pool.high_water_mark() == 5
