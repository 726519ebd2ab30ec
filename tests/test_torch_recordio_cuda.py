"""The RecordIO image pipeline into the card.

- a packed ``.rec`` (``chip_smoke.make_image_folder``, 32 images,
  ``tools/torch_im2rec.py --resize 256``) read back equal to the bytes
  packed (``chip_smoke.check_packed_records``);
- its first batch through ``ImageRecordIter`` at train_imagenet.py's
  augmentation under ``PrefetchingIter``, copied to the card: the same
  bits on the card as on the host, the labels the ``.lst``'s;
- one ResNet-50 training step on that batch (batch 4, 4 classes) on the
  card against the host (``chip_smoke.net_closeness``: outputs within
  NET_TOL, gradients within the larger of NET_TOL and twice a 1e-6
  nudge's gap), K1 launched once.

Every test carries the ``cuda`` marker and skips without a GPU. The file
imports neither ``jax`` nor ``mxnet_tpu``:

    python -m pytest --noconftest tests/test_torch_recordio_cuda.py
"""
import os

import numpy as np
import pytest
import torch

import chip_smoke
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import softmax as sm

pytestmark = pytest.mark.cuda

BATCH = 4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the batch goes to the card")
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield mx.gpu(0)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = prev


@pytest.fixture
def packed(card, tmp_path):
    root = str(tmp_path / "images")
    chip_smoke.make_image_folder(root, 32, seed=4)
    prefix = str(tmp_path / "train")
    tool, _ = chip_smoke.pack_image_folder(prefix, root)
    labels, ids = chip_smoke.check_packed_records(tool, prefix, root)
    return prefix + ".rec", labels, ids


def _first_batch(path):
    it = mx.io.PrefetchingIter(mx.io.ImageRecordIter(
        path_imgrec=path, mean_r=chip_smoke.RECORDIO_MEAN[0],
        mean_g=chip_smoke.RECORDIO_MEAN[1], mean_b=chip_smoke.RECORDIO_MEAN[2],
        data_shape=(3, 224, 224), batch_size=BATCH, rand_crop=True,
        rand_mirror=True, random_h=36, random_s=50, random_l=50))
    return it.next()


def test_rec_batch_to_the_card(packed, card):
    path, labels, ids = packed
    batch = _first_batch(path)
    host = batch.data[0].asnumpy()
    on_card = batch.data[0].copyto(card)
    assert on_card.context == card and on_card._data.is_cuda
    np.testing.assert_array_equal(on_card.asnumpy(), host)
    np.testing.assert_array_equal(batch.label[0].asnumpy(),
                                  [labels[i] for i in ids[:BATCH]])
    assert [chip_smoke.pattern_class(x) for x in host] == \
        [int(v) for v in batch.label[0].asnumpy()]


def test_resnet_step_on_a_rec_batch_matches_host(packed, card):
    path, _, _ = packed
    batch = _first_batch(path)
    with mx.NameManager():
        sym = mx.models.get_resnet(num_classes=chip_smoke.RECORDIO_CLASSES,
                                   num_layers=50)
    shapes = {"data": (BATCH, 3, 224, 224), "softmax_label": (BATCH,)}
    args, aux = chip_smoke.zoo_params(sym, shapes, seed=13)
    args["data"] = batch.data[0].asnumpy()
    args["softmax_label"] = batch.label[0].asnumpy()
    sm.fused_softmax.launches = 0
    got = chip_smoke.net_step(sym, shapes, args, aux, "cuda")
    assert sm.fused_softmax.launches == 1
    want = chip_smoke.net_step(sym, shapes, args, aux, "cpu")
    nudged = chip_smoke.net_step(sym, shapes, chip_smoke.nudge(args), aux,
                                 "cuda")
    rec = chip_smoke.net_closeness(got, want, nudged)
    assert rec["ok"], rec
    assert os.path.exists(path)
