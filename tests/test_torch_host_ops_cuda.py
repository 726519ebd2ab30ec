"""The host bridges, Faster R-CNN's step and the optimizers on the card.

- ``chip_smoke.host_bridge_checks``: a Custom op and a NumpyOp loss, two
  TorchModules under a TorchCriterion, and the 31 ``mx.th`` functions
  on the card against the host (outputs and gradients under
  ``closeness`` at 1e-4);
- ``chip_smoke.rcnn_grad_check``: Faster R-CNN's train step on the card
  against the host, the two CustomOps' outputs made equal;
- ``chip_smoke.rcnn_repeat_check``: that step three times on the card,
  byte-equal;
- a host op's outputs land on its inputs' device, and its gradients on
  the card: a Custom node between two card ops;
- K1 once a step at [32, 3] through three steps of Faster R-CNN's
  per-batch ``Module.fit``;
- every optimizer of ``chip_smoke.OPTIMIZER_CASES``: three updates on
  the card against the host.

Every test carries the ``cuda`` marker and skips without a GPU. The file
imports neither ``jax`` nor ``mxnet_tpu``:

    python -m pytest --noconftest tests/test_torch_host_ops_cuda.py
"""
import numpy as np
import pytest
import torch

import chip_smoke
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import softmax as sm

pytestmark = pytest.mark.cuda


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


def test_host_bridges_match_the_host(card):
    checks = chip_smoke.host_bridge_checks("cuda")
    assert checks["th"]["functions"] == 31
    assert all(c["ok"] for c in checks.values()), checks


def test_rcnn_step_matches_the_host(card):
    rec = chip_smoke.rcnn_grad_check("cuda")
    assert rec["custom_forwards"] == 2


def test_rcnn_step_is_reproducible_on_the_card(card):
    rec = chip_smoke.rcnn_repeat_check("cuda")
    assert rec["repeats"] == 3 and not rec["differ"]


def test_host_op_outputs_and_gradients_on_the_card(card):
    chip_smoke._register_smoke_ops()
    x = mx.sym.Variable("data")
    fc = mx.sym.FullyConnected(x, num_hidden=8, name="fc")
    aff = mx.sym.Custom(data=fc, gamma=mx.sym.Variable("gamma"),
                        op_type="smoke_affine", name="aff")
    net = mx.sym.MakeLoss(mx.sym.sum(mx.sym.square(aff)), name="loss")
    exe = net.simple_bind(card, data=(4, 5))
    rng = np.random.RandomState(0)
    for a in exe.arg_dict.values():
        a[:] = rng.randn(*a.shape)
    taps = {}
    exe.set_monitor_callback(lambda n, a: taps.setdefault(n, a))
    exe.forward(is_train=True)
    exe.backward()
    assert taps["aff_output"]._data.is_cuda
    assert all(g._data.is_cuda and float(g._data.abs().sum()) > 0
               for g in exe.grad_dict.values() if g is not None)


def test_rcnn_fit_launches_k1_once_a_step(card):
    ex = chip_smoke._example_modules(chip_smoke.RCNN_DIR,
                                     chip_smoke.RCNN_NAMES)
    with card:
        it = ex["train_end2end"].DetectionIter(3)
        mod = mx.module.Module(
            ex["symbol_rcnn"].get_train(num_classes=3), context=card,
            data_names=("data", "im_info", "gt_boxes"),
            label_names=("label", "bbox_target", "bbox_weight"))
        metric = mx.metric.CompositeEvalMetric()
        metric.add(ex["train_end2end"].RPNAccuracy())
        metric.add(ex["train_end2end"].RCNNAccuracy())
        sm.fused_softmax.launches = 0
        mod.fit(it, num_epoch=1, optimizer="sgd",
                optimizer_params={"learning_rate": 5e-3, "momentum": 0.9},
                initializer=mx.initializer.Xavier(), eval_metric=metric)
        torch.cuda.synchronize()
    assert sm.fused_softmax.launches == 3
    cls_prob = mod.get_outputs()[2]
    assert cls_prob.shape == (32, 3) and cls_prob._data.is_cuda


@pytest.mark.parametrize("name", sorted(chip_smoke.OPTIMIZER_CASES))
def test_optimizer_on_card_matches_host(card, name):
    got = chip_smoke.optimizer_updates(name, "cuda", shape=(256, 129))
    want = chip_smoke.optimizer_updates(name, "cpu", shape=(256, 129))
    for gs, ws in zip(got, want):
        for g, w in zip(gs, ws):
            assert chip_smoke.within(chip_smoke._np_close(g, w),
                                     chip_smoke.HOST_TOL)
