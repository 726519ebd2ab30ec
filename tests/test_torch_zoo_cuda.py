"""This slice's ops, the zoo nets and Inception-BN's scanned fit on the
card.

- every case of ``chip_smoke.ZOO_OP_CASES`` (the rest of ``ops/nn.py``
  and ``ops/tensor.py``: 58 ops) on the card against the same port op
  on the host (``chip_smoke.zoo_op_check``): forward and gradients
  within rtol 1e-4, atol 1e-5; ``LeakyReLU`` ``rrelu``'s training draws
  (threefry on the card) and the argument ops bit-equal;
- every net of ``chip_smoke.ZOO_NETS`` (AlexNet, VGG-16 with and without
  BatchNorm, GoogLeNet, Inception-v3, U-Net, the MLP), one training step
  at batch 2 on the card against the host (``chip_smoke.zoo_net_check``:
  outputs and every gradient that does not vanish within NET_TOL, 1e-3);
- Inception-BN's first step at batch 2 and 224x224 on the card against
  the host (``chip_smoke.phase_inception_bn_grad_check``);
- one chunk of Inception-BN-small's scanned fit (train_cifar10's net,
  batch 16 at 28x28, K = 3) queued with no host synchronisation
  (``torch.cuda``'s sync debug mode set to raise), K1 launched once a
  step.

Every test carries the ``cuda`` marker and skips without a GPU. The file
imports neither ``jax`` nor ``mxnet_tpu``:

    python -m pytest --noconftest tests/test_torch_zoo_cuda.py
"""
import numpy as np
import pytest
import torch

import chip_smoke
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import softmax as sm
from mxnet_tpu_torch.parallel import make_fit_trainer

pytestmark = pytest.mark.cuda

BATCH, K = 16, 3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the ops run on the card")
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield mx.gpu(0)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = prev


@pytest.mark.parametrize("case", chip_smoke.ZOO_OP_CASES)
def test_op_on_card_matches_host(card, case):
    rec = chip_smoke.zoo_op_check(case, "cuda")
    if case == "LeakyReLU_rrelu_train":
        assert rec["exact"] == [0]


@pytest.mark.parametrize("net", sorted(chip_smoke.ZOO_NETS))
def test_zoo_net_on_card_matches_host(card, net):
    rec = chip_smoke.zoo_net_check(net, "cuda")
    assert rec["finite"] and rec["grads_checked"] > 0


def test_inception_bn_step_on_card_matches_host(card):
    rec = chip_smoke.phase_inception_bn_grad_check("cuda", batch=2)
    assert rec["grads_checked"] > 60


def test_inception_bn_small_chunk_without_a_host_sync(card):
    sym = mx.models.get_inception_bn_small(num_classes=10)
    shapes = {"data": (BATCH, 3, 28, 28), "softmax_label": (BATCH,)}
    exe = sym.simple_bind(card, grad_req="null", **shapes)
    init = mx.initializer.Xavier(factor_type="in", magnitude=2.34)
    args = {n: a for n, a in exe.arg_dict.items() if n not in shapes}
    for n, a in args.items():
        init(n, a)
    opt = mx.optimizer.SGD(learning_rate=0.05, momentum=0.9, wd=1e-5)
    trainer = make_fit_trainer(sym, card, shapes, opt, args, exe.aux_dict,
                               sorted(args))
    rng = np.random.RandomState(0)
    batches = [{"data": rng.rand(BATCH, 3, 28, 28).astype(np.float32),
                "softmax_label": rng.randint(0, 10, BATCH).astype(
                    np.float32)} for _ in range(K)]
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
    (prob,) = outs
    assert prob.shape == (K, BATCH, 10) and prob.is_cuda
    assert bool(torch.isfinite(prob).all())
    np.testing.assert_allclose(prob.sum(dim=-1).cpu().numpy(), 1.0,
                               rtol=1e-5)
    for n, p in trainer.params.items():
        assert bool(torch.isfinite(p).all()), n
