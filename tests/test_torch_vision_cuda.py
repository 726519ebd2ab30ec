"""This slice's ops and SSD's scanned fit on the card.

- every case of ``chip_smoke.SSD_OP_CASES`` on the card against the same
  port op on the host (``chip_smoke.ssd_op_check``): ``MultiBoxTarget``
  on duplicate anchors and duplicate ground truth (exact ties in the
  bipartite argmax), tied mining scores and an image without ground
  truth; ``MultiBoxDetection`` with score ties, ``force_suppress`` on
  and off; ``ROIPooling``, ``SpatialTransformer``, ``Correlation``,
  ``WarpCTC``, ``SVMOutput``, the regression outputs, ``MakeLoss`` and
  ``smooth_l1``. Forward and gradients within rtol 1e-4, atol 1e-5;
  ``cls_target``, ``loc_mask`` and detection ids, scores and row order
  bit-equal;
- one chunk of SSD's scanned fit (``examples/ssd_torch``'s training
  graph, batch 8 at 64x64, K = 3) queued with no host synchronisation
  (``torch.cuda``'s sync debug mode set to raise), K1 launched 0 times.

Every test carries the ``cuda`` marker and skips without a GPU. The file
imports neither ``jax`` nor ``mxnet_tpu``:

    python -m pytest --noconftest tests/test_torch_vision_cuda.py
"""
import numpy as np
import pytest
import torch

import chip_smoke
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import softmax as sm
from mxnet_tpu_torch.parallel import make_fit_trainer

pytestmark = pytest.mark.cuda

BATCH, IMAGE, K = 8, 64, 3


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


@pytest.mark.parametrize("case", chip_smoke.SSD_OP_CASES)
def test_op_on_card_matches_host(card, case):
    rec = chip_smoke.ssd_op_check(case, "cuda")
    if case.startswith("MultiBoxTarget"):
        assert rec["exact"] == [1, 2]
        t = rec["targets"]
        assert t["positive"] and t["negative"] and t["ignored"]


def test_ssd_fit_chunk_without_a_host_sync(card):
    ex = chip_smoke._ssd_example()
    sym = ex.get_symbol_train(3)
    shapes = {"data": (BATCH, 3, IMAGE, IMAGE), "label": (BATCH, 3, 5)}
    exe = sym.simple_bind(card, grad_req="null", **shapes)
    init = mx.initializer.Xavier()
    args = {n: a for n, a in exe.arg_dict.items() if n not in shapes}
    for n, a in args.items():
        init(n, a)
    opt = mx.optimizer.SGD(learning_rate=0.1, momentum=0.9, wd=5e-4)
    trainer = make_fit_trainer(sym, card, shapes, opt, args, exe.aux_dict,
                               sorted(args))
    X, Y = ex.synthetic_detection_set(BATCH * K, IMAGE, 3)
    batches = [{"data": X[k * BATCH:(k + 1) * BATCH],
                "label": Y[k * BATCH:(k + 1) * BATCH]} for k in range(K)]
    trainer.run_chunk(trainer.stage_chunk(batches))
    staged = trainer.stage_chunk(batches)
    torch.cuda.synchronize()
    sm.fused_softmax.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = trainer.run_chunk(staged)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert sm.fused_softmax.launches == 0
    assert opt.num_update == 2 * K
    cls_prob, loc_loss, cls_label = outs
    assert cls_prob.shape == (K, BATCH, 4, 1280) and cls_prob.is_cuda
    assert cls_label.shape == (K, BATCH, 1280)
    for o in outs:
        assert bool(torch.isfinite(o).all())
    lab = cls_label.cpu().numpy()
    assert (lab > 0).any() and (lab == 0).any() and (lab < 0).any()
    for n, p in trainer.params.items():
        assert bool(torch.isfinite(p).all()), n
