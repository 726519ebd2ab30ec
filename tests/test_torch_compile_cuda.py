"""The compile layer and the compile/transfer verifier on the card.

- the layout pass's NHWC convolution, BatchNorm (training statistics,
  moving averages and gradients) and pooling ops on ``cuda`` against
  their NCHW twins, f32 (TF32 off): outputs and gradients within 1e-4
  relative L2 (max pooling bit-equal, average pooling within 1e-6: a
  window sums in another order); the NHWC convolution's output comes back as a contiguous
  NHWC tensor (cuDNN's channels-last route, no ``.contiguous()`` copy);
- the persistent cubin cache across two subprocesses under one
  ``MXNET_COMPILE_CACHE_DIR``: the first compiles one RTC body with
  NVRTC (one miss), the second loads it (one hit, no NVRTC compile), a
  third after a flipped byte counts one corrupt entry, recompiles and
  still computes the body's plain twin;
- ``JitVerifyError`` from an off-bucket decode dispatch under
  ``MXNET_JIT_VERIFY=1``, naming the argument.

Every test carries the ``cuda`` marker and skips without a GPU. The file
imports neither ``jax`` nor ``mxnet_tpu``:

    python -m pytest --noconftest tests/test_torch_compile_cuda.py
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the ops run on the card")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _rel(got, want):
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def _layout_op(name):
    from mxnet_tpu_torch.compile import layout

    return layout._op(name)


def _nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def test_nhwc_conv_matches_nchw_and_stays_channels_last(card):
    from mxnet_tpu_torch.ops import registry

    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 64, 28, 28, generator=g).to(card)
    w = (torch.randn(128, 64, 3, 3, generator=g) * 0.05).to(card)
    b = torch.randn(128, generator=g).to(card)
    conv = registry.get("Convolution")
    params = conv.parse_params({"kernel": (3, 3), "pad": (1, 1),
                                "stride": (2, 2), "num_filter": 128})
    xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
    (want,), _ = conv.apply(params, [xs, ws, b], [], True, None)
    xn = _nhwc(x).requires_grad_()
    wn = w.clone().requires_grad_()
    (got,), _ = _layout_op("_mxc_conv_nhwc").apply(params, [xn, wn, b], [],
                                                   True, None)
    assert got.shape == (8, 14, 14, 128) and got.is_contiguous()
    assert _rel(_nchw(got), want) <= 1e-4
    dy = torch.randn(want.shape, generator=g).to(card)
    gx, gw = torch.autograd.grad(want, [xs, ws], dy)
    gxn, gwn = torch.autograd.grad(got, [xn, wn], _nhwc(dy))
    assert _rel(_nchw(gxn), gx) <= 1e-4 and _rel(gwn, gw) <= 1e-4


def test_nhwc_batchnorm_matches_nchw(card):
    from mxnet_tpu_torch.ops import registry

    g = torch.Generator().manual_seed(1)
    x = (torch.randn(16, 32, 14, 14, generator=g) * 3 + 1).to(card)
    gamma = torch.rand(32, generator=g).to(card) + 0.5
    beta = torch.randn(32, generator=g).to(card)
    aux = [torch.zeros(32, device=card), torch.ones(32, device=card)]
    bn = registry.get("BatchNorm")
    params = bn.parse_params({"fix_gamma": False, "eps": 1e-5})
    xs = x.clone().requires_grad_()
    gs = gamma.clone().requires_grad_()
    (want,), want_aux = bn.apply(params, [xs, gs, beta], aux, True, None)
    xn = _nhwc(x).requires_grad_()
    gn = gamma.clone().requires_grad_()
    (got,), got_aux = _layout_op("_mxc_bn_nhwc").apply(
        params, [xn, gn, beta], aux, True, None)
    assert _rel(_nchw(got), want) <= 1e-5
    for a, b in zip(got_aux, want_aux):
        assert _rel(a, b) <= 1e-5
    dy = torch.randn(want.shape, generator=g).to(card)
    gx, gg = torch.autograd.grad(want, [xs, gs], dy)
    gxn, ggn = torch.autograd.grad(got, [xn, gn], _nhwc(dy))
    assert _rel(_nchw(gxn), gx) <= 1e-4 and _rel(ggn, gg) <= 1e-4


@pytest.mark.parametrize("kw", [
    {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1), "pool_type": "max"},
    {"kernel": (3, 3), "stride": (2, 2), "pool_type": "avg",
     "pooling_convention": "full"},
    {"kernel": (7, 7), "global_pool": True, "pool_type": "avg"},
], ids=["max", "avg_full", "global"])
def test_nhwc_pooling_matches_nchw(card, kw):
    from mxnet_tpu_torch.ops import registry

    g = torch.Generator().manual_seed(2)
    x = torch.randn(4, 16, 15, 15, generator=g).to(card)
    pool = registry.get("Pooling")
    params = pool.parse_params(kw)
    (want,), _ = pool.apply(params, [x], [], False, None)
    (got,), _ = _layout_op("_mxc_pool_nhwc").apply(params, [_nhwc(x)], [],
                                                   False, None)
    if kw["pool_type"] == "max":
        assert torch.equal(_nchw(got), want)
    else:   # a window's sum in another order
        assert _rel(_nchw(got), want) <= 1e-6


_CACHE_CHILD = r"""
import json, sys
import torch
sys.path.insert(0, %r)
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.compile import jit_cache
from mxnet_tpu_torch.ops import _nvrtc
x = mx.nd.array(torch.arange(256, dtype=torch.float32).numpy() / 64,
                ctx=mx.gpu(0))
y = mx.nd.zeros((256,), ctx=mx.gpu(0))
k = mx.rtc.Rtc("abc", [("x", x)], [("y", y)],
               "y[threadIdx.x] = expf(x[threadIdx.x] * 0.5f);")
k.push([x], [y], grid_dims=(1, 1, 1), block_dims=(256, 1, 1))
torch.cuda.synchronize()
err = float((y._data - (x._data * 0.5).exp()).abs().max())
print(json.dumps(dict(jit_cache.stats(), nvrtc=_nvrtc.COMPILES, err=err,
                      dir=jit_cache.active_dir())))
"""


def test_cubin_cache_across_processes(card, tmp_path):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("MXNET_COMPILE")}
    env["MXNET_COMPILE_CACHE_DIR"] = str(tmp_path)

    def child():
        proc = subprocess.run(
            [sys.executable, "-c", _CACHE_CHILD % str(ROOT)], env=env,
            capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        return json.loads(proc.stdout.strip().splitlines()[-1])

    first = child()
    assert (first["misses"], first["hits"], first["nvrtc"]) == (1, 0, 1)
    second = child()
    assert (second["hits"], second["misses"], second["nvrtc"]) == (1, 0, 0)
    (entry,) = [p for p in Path(first["dir"]).iterdir()
                if p.name.endswith("-cubin")]
    raw = bytearray(entry.read_bytes())
    raw[len(raw) // 2] ^= 0x10
    entry.write_bytes(bytes(raw))
    third = child()
    assert (third["corrupt"], third["misses"], third["nvrtc"]) == (1, 1, 1)
    for r in (first, second, third):
        assert r["err"] <= 1e-5


def test_off_bucket_decode_dispatch_raises(card, monkeypatch):
    from mxnet_tpu_torch.analysis import compile_verify as cv
    from mxnet_tpu_torch.models import transformer as tt
    from mxnet_tpu_torch.serving import PagedKVPool
    from mxnet_tpu_torch.serving.model import ServingModel

    monkeypatch.setenv("MXNET_JIT_VERIFY", "1")
    cv.reload()
    try:
        cfg = tt.TransformerConfig(vocab_size=64, num_layers=1, d_model=64,
                                   num_heads=2, d_ff=128, max_seq_len=64,
                                   dtype="float32")
        params = tt.init_params(cfg, torch.Generator(card).manual_seed(0),
                                card)
        pool = PagedKVPool(1, 2, 32, num_blocks=9, block_size=4,
                           device=card)
        m = ServingModel(cfg, block_size=4, max_blocks_per_req=4,
                         batch_buckets=(2,), chunk_buckets=(8,))
        bt = np.asarray([[1, 2, 3, 4]], np.int64)
        m.step(params, pool.k, pool.v, np.asarray([[5]], np.int64),
               np.asarray([3], np.int64), np.asarray([1], np.int64), bt,
               np.ones((1,), bool))
        fn = m._compiled(("step", 2, 1))
        samp = m._sampling_arrays(2, 1, None, None, None, None)
        batch = m._batch(2, card, [3], [1], bt, [True])
        with pytest.raises(cv.JitVerifyError, match=r"arg\[3\]: shape "
                           r"\(2, 1\) -> \(2, 3\)"):
            with torch.no_grad():
                fn(params, pool.k, pool.v,
                   torch.zeros((2, 3), dtype=torch.int64, device=card),
                   *batch, samp, 0)
    finally:
        monkeypatch.undo()
        cv.reload()
