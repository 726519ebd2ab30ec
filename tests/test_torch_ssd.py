"""SSD (baseline config #5) end to end: ``examples/ssd_torch`` on the port
against ``examples/ssd`` on the JAX package, on the CPU.

- ``get_symbol_train(3)`` and ``get_symbol(3)``: ``tojson()`` bytes equal;
- ``Module.fit`` from the same numpy parameters (Xavier-scaled, seeded),
  SGD lr 0.1, momentum 0.9, wd 5e-4 (the example's), batch 4 at 32x32,
  2 epochs of 5 batches: scanned (``MXNET_TRAIN_SCAN_K=4``: a chunk of 4
  and a tail of 1 an epoch; the port must build its scanned trainer) and
  per batch (``MXNET_SCAN_TRAIN=0``). Each step's three heads (read by
  the example's ``MultiBoxMetric``) within relative L2 1e-4, its
  ``cls_target`` (the ``cls_label`` head) exactly equal, the final
  parameters within relative L2 1e-4, the metric's readings within 1e-4
  relative;
- the detection module of each example over the JAX fit's parameters,
  on held-out images: ids and row order exactly equal, scores within
  1e-5 relative, boxes within 1e-5; the copied ``evaluate_detections``
  gives the same mAP.

The two examples define modules of the same names (``symbol_ssd``,
``train_net``, ``evaluate``): each is loaded by path under a name of its
own, and ``train_net``'s imports of its siblings are pointed at its own
directory's while it loads.
"""
import importlib.util
import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt

ROOT = Path(__file__).resolve().parents[1]
BATCH, IMAGE, N_BATCHES, EPOCHS, K = 4, 32, 5, 2, 4
REL_L2 = 1e-4


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


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _example(dirname, tag):
    """(symbol_ssd, evaluate, train_net) of one example directory."""
    d = ROOT / "examples" / dirname
    sym = _load(d / "symbol_ssd.py", tag + "_symbol_ssd")
    ev = _load(d / "evaluate.py", tag + "_evaluate")
    saved = {n: sys.modules.get(n) for n in ("symbol_ssd", "evaluate")}
    path = list(sys.path)
    sys.modules.update(symbol_ssd=sym, evaluate=ev)
    try:
        tn = _load(d / "train_net.py", tag + "_train_net")
    finally:
        sys.path[:] = path
        for n, m in saved.items():
            if m is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = m
    return sym, ev, tn


@pytest.fixture(scope="module")
def examples():
    return {"jax": (mj,) + _example("ssd", "ssd_jax"),
            "port": (mt,) + _example("ssd_torch", "ssd_port")}


def test_symbols_serialise_alike(examples):
    texts = {}
    for key, (pkg, sym, _, _) in examples.items():
        with pkg.NameManager():
            train = sym.get_symbol_train(3).tojson()
        with pkg.NameManager():
            det = sym.get_symbol(3).tojson()
        texts[key] = (train, det)
    assert texts["port"] == texts["jax"]


def _params(examples):
    """Xavier-scaled (uniform, avg, magnitude 3, as the example's
    initializer) seeded numpy parameters; zero biases."""
    _, sym, _, _ = examples["port"]
    with mt.NameManager():
        net = sym.get_symbol_train(3)
    shapes, _, _ = net.infer_shape(data=(BATCH, 3, IMAGE, IMAGE),
                                   label=(BATCH, 3, 5))
    rng = np.random.RandomState(21)
    args = {}
    for n, s in zip(net.list_arguments(), shapes):
        if n in ("data", "label"):
            continue
        if n.endswith("bias"):
            args[n] = np.zeros(s, np.float32)
            continue
        fan_in, fan_out = np.prod(s[1:]), s[0] * np.prod(s[2:])
        a = np.sqrt(3.0 / ((fan_in + fan_out) / 2.0))
        args[n] = rng.uniform(-a, a, s).astype(np.float32)
    return args


def _fit(examples, key, scan, args):
    pkg, sym, _, tn = examples[key]
    X, Y = tn.synthetic_detection_set(BATCH * N_BATCHES, IMAGE, 3)
    steps = []

    class Recording(tn.MultiBoxMetric):
        def update(self, labels, preds):
            steps.append([p.asnumpy().copy() for p in preds])
            super().update(labels, preds)

    metric = Recording()
    readings = []
    built = []
    env = {"MXNET_TRAIN_SCAN_K": str(K)} if scan else {"MXNET_SCAN_TRAIN": "0"}
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("MXNET_SCAN_TRAIN", raising=False)
        mp.delenv("MXNET_COMPUTE_DTYPE", raising=False)
        for k, v in env.items():
            mp.setenv(k, v)
        if key == "port":
            from mxnet_tpu_torch.parallel import fit_trainer

            make = fit_trainer.make_fit_trainer
            mp.setattr(fit_trainer, "make_fit_trainer",
                       lambda *a, **kw: built.append(1) or make(*a, **kw))
        with pkg.cpu():
            it = pkg.io.NDArrayIter(X, Y, batch_size=BATCH, shuffle=False,
                                    label_name="label")
            with pkg.NameManager():
                net = sym.get_symbol_train(3)
            mod = pkg.module.Module(net, data_names=("data",),
                                    label_names=("label",),
                                    context=pkg.cpu())
            mod.fit(it, eval_metric=metric, optimizer="sgd",
                    optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                                      "wd": 5e-4},
                    arg_params={k: pkg.nd.array(v) for k, v in args.items()},
                    aux_params={}, num_epoch=EPOCHS,
                    batch_end_callback=lambda p: readings.append(
                        p.eval_metric.get()[1]))
            final = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    return dict(steps=steps, readings=readings, final=final, built=built)


@pytest.fixture(scope="module")
def fits(examples):
    args = _params(examples)
    return {(key, scan): _fit(examples, key, scan, args)
            for key in ("jax", "port") for scan in (True, False)}


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("scan", [True, False], ids=["scanned", "per_batch"])
def test_fit_steps_match_jax(fits, scan):
    got, want = fits[("port", scan)], fits[("jax", scan)]
    assert len(got["steps"]) == len(want["steps"]) == N_BATCHES * EPOCHS
    assert got["built"] == ([1] if scan else [])
    for s, (pt, pj) in enumerate(zip(got["steps"], want["steps"])):
        for head in (0, 1):
            assert _rel_l2(pt[head], pj[head]) <= REL_L2, (s, head)
        np.testing.assert_array_equal(pt[2], pj[2], err_msg="step %d" % s)
        assert (pj[2] > 0).any() and (pj[2] == 0).any()
    np.testing.assert_allclose(np.array(got["readings"]),
                               np.array(want["readings"]), rtol=1e-4)
    assert sorted(got["final"]) == sorted(want["final"])
    for n, v in want["final"].items():
        assert _rel_l2(got["final"][n], v) <= REL_L2, n


def test_scanned_and_per_batch_fits_agree(fits):
    """The port's scanned fit against its own per-batch loop: the same
    steps, so the same targets."""
    a, b = fits[("port", True)], fits[("port", False)]
    for pa, pb in zip(a["steps"], b["steps"]):
        np.testing.assert_array_equal(pa[2], pb[2])
        assert _rel_l2(pa[0], pb[0]) <= REL_L2


def _detector(pkg, sym, params):
    with pkg.NameManager():
        det_sym = sym.get_symbol(3, nms_thresh=0.5)
    det = pkg.module.Module(det_sym, data_names=("data",), label_names=None,
                            context=pkg.cpu())
    det.bind(data_shapes=[("data", (BATCH, 3, IMAGE, IMAGE))],
             for_training=False)
    det.set_params({k: pkg.nd.array(v) for k, v in params.items()}, {},
                   allow_missing=False)
    return det


def test_detection_and_map_match_jax(examples, fits):
    params = fits[("jax", True)]["final"]
    _, _, _, tn = examples["jax"]
    Xe, Ye = tn.synthetic_detection_set(2 * BATCH, IMAGE, 3, seed=99)
    outs, maps = {}, {}
    for key, (pkg, sym, ev, _) in examples.items():
        with pkg.cpu():
            det = _detector(pkg, sym, params)
            rows = []
            for lo in range(0, len(Xe), BATCH):
                det.forward(pkg.io.DataBatch(
                    data=[pkg.nd.array(Xe[lo:lo + BATCH])], label=None),
                    is_train=False)
                rows.append(det.get_outputs()[0].asnumpy())
            outs[key] = np.concatenate(rows)
            maps[key] = ev.evaluate_detections(det, Xe, Ye, BATCH, 3)
    got, want = outs["port"], outs["jax"]
    assert got.shape == want.shape == (2 * BATCH, 320, 6)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_allclose(got[..., 1], want[..., 1], rtol=1e-5)
    np.testing.assert_allclose(got[..., 2:], want[..., 2:], atol=1e-5)
    kept = want[..., 0] >= 0
    assert kept.any() and (~kept).any()
    assert maps["port"] == maps["jax"]


def test_example_defaults_and_context():
    """The port's example runs on ``gpu`` unless told ``cpu``."""
    _, _, tn = _example("ssd_torch", "ssd_port_args")
    argv = sys.argv
    try:
        sys.argv = ["train_net.py"]
        assert tn.parse_args().ctx == "gpu"
        sys.argv = ["train_net.py", "--ctx", "cpu"]
        assert tn.parse_args().ctx == "cpu"
    finally:
        sys.argv = argv
    assert os.path.dirname(tn.__file__).endswith("ssd_torch")
