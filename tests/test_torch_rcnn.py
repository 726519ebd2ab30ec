"""Faster R-CNN end to end: ``examples/rcnn_torch`` on the port against
``examples/rcnn`` on the JAX package, on the CPU.

- ``get_train()`` and ``get_test()``: ``tojson()`` bytes equal (two
  ``Custom`` nodes with their keyword arguments);
- one batch through the train symbol from the same numpy parameters
  (``model.params_from_numpy`` on the port's side): the five heads and
  every parameter's gradient within rtol 1e-4, atol 1e-5 (f32 through
  the proposal's NMS and ROIPooling); the sampled rois equal;
- ``Module.fit`` of the example's ``DetectionIter`` over 2 images for 2
  epochs, SGD 5e-3 / 0.9, wd 5e-4 (the example's), from the same
  parameters: the final parameters within relative L2 1e-4 and the two
  metrics' readings equal; the port takes the per-batch loop, the
  scanned trainer refusing a graph with host ops;
- ``rcnn_utils.py`` is a byte copy below its docstring, and
  ``eval_map`` loads ``examples/ssd_torch/evaluate.py``;
- the port's train step three times from the same parameters
  (``chip_smoke.rcnn_repeat_check``): heads and gradients byte-equal, as
  the JAX package's are (ROIPooling's gather sums its gradient in a
  fixed order).

The two examples define modules of the same names (``proposal``,
``symbol_rcnn``, ...): each directory is imported in turn with its own
directory first on ``sys.path``, and its modules are taken out of
``sys.modules`` again afterwards.
"""
import importlib
import logging
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt

ROOT = Path(__file__).resolve().parents[1]
NAMES = ("proposal", "proposal_target", "rcnn_utils", "symbol_rcnn",
         "train_end2end", "eval_map")
INPUTS = ("data", "im_info", "gt_boxes", "label", "bbox_target",
          "bbox_weight")
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module", autouse=True)
def _warm_cpu_math():
    """torch 2.13's CPU ``exp`` and ``tanh`` can err up to 1.5e-4 relative
    on their first multithreaded call in a process; one call of each on
    a large tensor first avoids it."""
    t = torch.randn(100000)
    torch.exp(t)
    torch.tanh(t)


@pytest.fixture(scope="module", autouse=True)
def _quick_jax_compiles():
    prev = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", prev)
    jax.clear_caches()


def _example(dirname):
    saved_path = list(sys.path)
    saved = {n: sys.modules.pop(n, None) for n in NAMES}
    sys.path.insert(0, str(ROOT / "examples" / dirname))
    try:
        return {n: importlib.import_module(n) for n in NAMES}
    finally:
        sys.path[:] = saved_path
        for n, m in saved.items():
            if m is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = m


@pytest.fixture(scope="module")
def ex():
    return {"jax": (mj, _example("rcnn")), "port": (mt, _example("rcnn_torch"))}


def test_symbols_serialise_alike(ex):
    texts = {}
    for k, (mx, e) in ex.items():
        with mx.NameManager():
            train = e["symbol_rcnn"].get_train(num_classes=3).tojson()
        with mx.NameManager():
            test = e["symbol_rcnn"].get_test(num_classes=3).tojson()
        texts[k] = train, test
    assert texts["port"] == texts["jax"]
    assert texts["port"][0].count('"op": "Custom"') == 2


def test_utils_copy_and_eval_map_source(ex):
    def body(p):
        text = p.read_text()
        return text[text.index('"""', 3) + 3:]

    assert body(ROOT / "examples" / "rcnn_torch" / "rcnn_utils.py") == body(
        ROOT / "examples" / "rcnn" / "rcnn_utils.py")
    assert ex["port"][1]["eval_map"].MApMetric.__module__ == \
        "ssd_torch_evaluate"


def _params(e, seed=5):
    """Xavier-scaled (uniform, avg, magnitude 3) seeded numpy weights,
    zero biases, for the train symbol's parameters."""
    mx = mt
    with mx.NameManager():
        net = e["symbol_rcnn"].get_train(num_classes=3)
    shapes, _, _ = net.infer_shape(data=(1, 3, 128, 128), im_info=(1, 3),
                                   gt_boxes=(1, 3, 5))
    rng = np.random.RandomState(seed)
    args = {}
    for n, s in zip(net.list_arguments(), shapes):
        if n in INPUTS:
            continue
        if n.endswith("_bias"):
            args[n] = np.zeros(s, np.float32)
            continue
        fan_in = s[1] * int(np.prod(s[2:]))
        fan_out = s[0] * int(np.prod(s[2:]))
        scale = np.sqrt(3.0 / ((fan_in + fan_out) / 2.0))
        args[n] = rng.uniform(-scale, scale, s).astype(np.float32)
    return args


def _batch(mx, e, index):
    it = e["train_end2end"].DetectionIter(2)
    for _ in range(index + 1):
        b = it.next()
    return it, b


def _one_batch(mx, e, params):
    with mx.cpu():
        it, b = _batch(mx, e, 0)
    with mx.NameManager():
        net = e["symbol_rcnn"].get_train(num_classes=3)
    ctx = mx.cpu()
    mod = mx.module.Module(net, context=ctx,
                           data_names=("data", "im_info", "gt_boxes"),
                           label_names=("label", "bbox_target",
                                        "bbox_weight"))
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    if mx is mt:
        arg, aux = mt.model.params_from_numpy(params, ctx=ctx)
    else:
        arg = {k: mx.nd.array(v, ctx=ctx) for k, v in params.items()}
        aux = {}
    mod.init_params(arg_params=arg, aux_params=aux)
    with ctx:
        mod.forward_backward(b)
    outs = [o.asnumpy() for o in mod.get_outputs()]
    exe = mod._execs[0]
    grads = {n: g.asnumpy() for n, g in exe.grad_dict.items()
             if g is not None and n in params}
    return outs, grads


def test_one_batch_outputs_and_gradients_match_jax(ex):
    params = _params(ex["port"][1])
    got = {k: _one_batch(mx, e, params) for k, (mx, e) in ex.items()}
    (oj, gj), (ot, gt) = got["jax"], got["port"]
    assert [o.shape for o in ot] == [o.shape for o in oj]
    for i, (a, b) in enumerate(zip(ot, oj)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                   err_msg="head %d" % i)
    np.testing.assert_array_equal(ot[4], oj[4])   # the sampled labels
    assert sorted(gt) == sorted(gj) == sorted(params)
    for n in gj:
        scale = max(np.abs(gj[n]).max(), 1e-3)
        np.testing.assert_allclose(gt[n], gj[n], rtol=RTOL,
                                   atol=ATOL * scale * 100, err_msg=n)
    assert np.abs(gt["rcnn_cls_score_weight"]).max() > 0
    assert np.abs(gt["bb_conv1_weight"]).max() > 0


def _fit(mx, e, params, caplog=None):
    it = e["train_end2end"].DetectionIter(2)
    with mx.NameManager():
        net = e["symbol_rcnn"].get_train(num_classes=3)
    ctx = mx.cpu()
    mx.random.seed(0)
    mod = mx.module.Module(net, context=ctx,
                           data_names=("data", "im_info", "gt_boxes"),
                           label_names=("label", "bbox_target",
                                        "bbox_weight"))
    metric = mx.metric.CompositeEvalMetric()
    metric.add(e["train_end2end"].RPNAccuracy())
    metric.add(e["train_end2end"].RCNNAccuracy())
    arg = {k: mx.nd.array(v, ctx=ctx) for k, v in params.items()}
    with ctx:
        mod.fit(it, num_epoch=2, optimizer="sgd",
                optimizer_params={"learning_rate": 5e-3, "momentum": 0.9,
                                  "wd": 5e-4},
                arg_params=arg, aux_params={}, eval_metric=metric)
    return ({k: v.asnumpy() for k, v in mod.get_params()[0].items()},
            dict(zip(*metric.get())))


def test_two_image_fit_matches_jax(ex, caplog):
    params = _params(ex["port"][1], seed=6)
    with caplog.at_level(logging.DEBUG):
        got = {k: _fit(mx, e, params) for k, (mx, e) in ex.items()}
    assert any("scanned fit unavailable" in r.getMessage()
               and "host ops" in r.getMessage() for r in caplog.records)
    (pj, mj_), (pt, mt_) = got["jax"], got["port"]
    assert sorted(pt) == sorted(pj)
    for n in pj:
        rel = np.linalg.norm(pt[n] - pj[n]) / max(np.linalg.norm(pj[n]),
                                                  1e-12)
        assert rel <= 1e-4, (n, rel)
    assert mt_ == pytest.approx(mj_, rel=1e-6)


def test_train_step_repeats_byte_equal():
    import chip_smoke

    rec = chip_smoke.rcnn_repeat_check("cpu")
    assert rec["tensors"] == 25 and not rec["differ"]
