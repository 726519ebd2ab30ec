"""Faster R-CNN mAP evaluation on the synthetic detection set, sharing
the SSD example's VOC07 11-point MApMetric (ref: the reference evaluates
rcnn with example/rcnn/rcnn/tester.py pred_eval / voc_eval — same
protocol, shared code here per VERDICT r3 item 5). examples/rcnn/
eval_map.py loading examples/ssd_torch/evaluate.py in place of
examples/ssd/evaluate.py.
"""
import importlib.util
import os

import numpy as np


def _load_ssd_metric():
    """Import examples/ssd_torch/evaluate.py under a distinct module name
    (both examples name their eval module evaluate.py)."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "ssd_torch", "evaluate.py")
    spec = importlib.util.spec_from_file_location("ssd_torch_evaluate", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.MApMetric


MApMetric = _load_ssd_metric()


def evaluate_map(test_mod, make_image_fn, detect_fn, num_images,
                 num_classes, seed=123):
    """Run detection over freshly drawn synthetic images and return the
    VOC07 mAP. gt rows use the MApMetric convention (cls, x1, y1, x2, y2)
    with class ids as trained (1..num_classes-1, 0 = background)."""
    metric = MApMetric(num_classes)
    rng = np.random.RandomState(seed)
    for _ in range(num_images):
        img, gt = make_image_fn(rng)
        gt_valid = gt[gt[:, 2] > gt[:, 0]]
        gt_rows = np.full((max(1, len(gt_valid)), 5), -1, np.float32)
        for i, row in enumerate(gt_valid):
            gt_rows[i] = [row[4], row[0], row[1], row[2], row[3]]
        dets = detect_fn(test_mod, img)
        det_rows = np.full((max(1, len(dets)), 6), -1, np.float32)
        for i, (c, d) in enumerate(dets):
            det_rows[i] = [c, d[4], d[0], d[1], d[2], d[3]]
        metric.update(gt_rows[None], det_rows[None])
    return metric.get()[1]
