"""The fused Symbol train step and the scanned fit's chunk on the card.

A small s2d net (ResNet's space-to-depth stem, BatchNorm, pooling, FC,
SoftmaxOutput; image 32, batch 8): one bf16 ``make_symbol_train_step``
step on the card against the same step on the host (outputs and every
parameter within relative L2 2e-2, the CPU tests' bf16 limit: cuDNN and
the host round bf16 products at other points); K1 (SoftmaxOutput's
forward) launched once a step by ``step.loop``; no host synchronisation
inside ``step.loop`` or ``FitTrainer.run_chunk`` (``torch.cuda``'s sync
debug mode set to raise). Every test carries the ``cuda`` marker and
skips without a GPU. The file imports neither ``jax`` nor
``mxnet_tpu``:

    python -m pytest --noconftest tests/test_torch_symbol_trainer_cuda.py
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import threefry
from mxnet_tpu_torch.models import resnet
from mxnet_tpu_torch.ops import softmax as sm
from mxnet_tpu_torch.parallel import make_fit_trainer, make_symbol_train_step

pytestmark = pytest.mark.cuda

IMAGE, BATCH, CLASSES, K = 32, 8, 10, 3
SHAPES = {"data": (BATCH, 3, IMAGE, IMAGE), "softmax_label": (BATCH,)}
BF16_TOL = 2e-2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the step runs on the card")
    return mx.gpu(0)


def _net():
    s = mx.sym
    with mx.NameManager():
        conv = resnet._s2d_stem(s.Variable("data"), "conv0", image=IMAGE)
        bn = s.BatchNorm(data=conv, fix_gamma=False, eps=2e-5, momentum=0.9,
                         name="conv0_bn")
        act = s.Activation(data=bn, act_type="relu", name="conv0_relu")
        pool = s.Pooling(data=act, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                         pool_type="max", name="pool0")
        gap = s.Pooling(data=pool, global_pool=True, kernel=(7, 7),
                        pool_type="avg", name="pool1")
        fc = s.FullyConnected(data=s.Flatten(data=gap, name="flat"),
                              num_hidden=CLASSES, name="fc1")
        return s.SoftmaxOutput(data=fc, name="softmax")


def _batches(steps, device):
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.rand(steps, BATCH, 3, IMAGE, IMAGE)
                         .astype(np.float32)).to(torch.bfloat16)
    y = torch.from_numpy(rng.randint(0, CLASSES, (steps, BATCH))
                         .astype(np.float32))
    return {"data": x.to(device), "softmax_label": y.to(device)}


def _rel_l2(got, want):
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def test_bf16_step_on_card_matches_host(card):
    got, want = {}, {}
    for ctx, out in ((card, got), (mx.cpu(), want)):
        step, state = make_symbol_train_step(_net(), SHAPES, ctx=ctx,
                                             compute_dtype="bfloat16", seed=3)
        b = _batches(1, ctx.torch_device)
        state, outs = step(state, {k: v[0] for k, v in b.items()},
                           threefry.prng_key(0, device="cpu"))
        out["outs"], out["params"] = outs, state["params"]
    assert got["outs"][0].dtype == want["outs"][0].dtype == torch.bfloat16
    assert got["outs"][0].is_cuda
    assert _rel_l2(got["outs"][0], want["outs"][0]) <= BF16_TOL
    for n, p in want["params"].items():
        assert got["params"][n].dtype == torch.float32
        assert _rel_l2(got["params"][n], p) <= BF16_TOL, n


def test_loop_launches_k1_once_a_step_without_a_host_sync(card):
    step, state = make_symbol_train_step(_net(), SHAPES, ctx=card,
                                         compute_dtype="bfloat16")
    b = _batches(K, card.torch_device)
    key = threefry.prng_key(1, device="cpu")
    state, _ = step.loop(state, b, key)          # builds K1, warms cuDNN
    torch.cuda.synchronize()
    sm.fused_softmax.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, outs = step.loop(state, b, key)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert sm.fused_softmax.launches == K
    assert outs[0].shape == (K, BATCH, CLASSES)
    assert bool(torch.isfinite(outs[0].float()).all())
    for n, p in state["params"].items():
        assert bool(torch.isfinite(p).all()), n


def test_fit_chunk_without_a_host_sync(card):
    sym = _net()
    exe = sym.simple_bind(card, grad_req="null", data=SHAPES["data"],
                          softmax_label=SHAPES["softmax_label"])
    init = mx.initializer.Xavier()
    args = {n: a for n, a in exe.arg_dict.items() if n not in SHAPES}
    for n, a in args.items():
        init(n, a)
    opt = mx.optimizer.SGD(learning_rate=0.05, momentum=0.9,
                           rescale_grad=1.0 / BATCH)
    trainer = make_fit_trainer(sym, card, SHAPES, opt, args, exe.aux_dict,
                               sorted(args), compute_dtype="bfloat16")
    b = _batches(K, card.torch_device)
    batches = [{n: v[k] for n, v in b.items()} for k in range(K)]
    trainer.run_chunk(trainer.stage_chunk(batches))
    staged = trainer.stage_chunk(batches)
    torch.cuda.synchronize()
    sm.fused_softmax.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = trainer.run_chunk(staged)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert sm.fused_softmax.launches == K
    assert opt.num_update == 2 * K
    assert outs[0].shape == (K, BATCH, CLASSES)
    assert outs[0].dtype == torch.bfloat16
