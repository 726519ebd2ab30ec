"""The port's model zoo and ``examples/image-classification_torch``
against the JAX package's, on the CPU.

- every zoo net at its defaults (the MLP, Inception-BN and its 28x28
  small form, AlexNet, VGG-16 with and without BatchNorm, GoogLeNet,
  Inception-v3, U-Net): ``tojson()`` byte-equal, ``infer_shape`` equal,
  and the copies of the zoo's files equal their originals;
- one bound executor's training forward and backward on the same
  numpy-seeded parameters and data (and Dropout keys, under
  ``random.seed``), for the MLP, Inception-BN-small at
  28x28, AlexNet at batch 2 and U-Net at 16x16: every output within
  rtol 1e-4, atol 1e-5; every gradient (and moving statistic), element
  by element, within 1e-4 (the larger of its rms and the rms of all
  the net's gradients (moving statistics), + the element's size), and
  within relative L2 1e-4 where
  its rms is above 1e-3 of that rms (a bias before a BatchNorm has a
  zero gradient, up to rounding): f32 both sides, the order of
  the convolutions' and BatchNorm's sums differs, and a weight's
  gradient sums many products, so its small elements carry the error of
  its large ones (U-Net's BatchNorm at 32x32 already parts the two by
  2e-3 relative: its one-pass variance cancels in f32);
- ``FeedForward.fit`` steps of
  ``examples/image-classification_torch/train_cifar10.py`` against
  ``examples/image-classification/train_cifar10.py`` (Inception-BN-small
  on the examples' own synthetic data, batch 32, SGD lr 0.05, momentum
  0.9, wd 1e-5, through each example's ``train_model.fit``), both
  starting from one checkpoint that ``--load-epoch`` reads, compared on
  the checkpoints each writes after its epoch: after one step every
  parameter and moving statistic within relative L2 1e-4 and the
  training accuracy equal; after 10 steps within twice the gap that a
  1e-6 relative change of the starting parameters opens in the port's
  own 10 steps (the fit is chaotic in f32: ~3e-2 in either package);
- the copied examples' ``--ctx`` choices (``auto`` is ``gpu(0)``) and
  their RecordIO branch (``ImageRecordIter`` under ``PrefetchingIter``
  over a packed ``train.rec``).

The two example directories define modules of the same names: each is
loaded by path under a name of its own, its ``train_model`` pointed at
its own directory's while it loads.
"""
import importlib.util
import logging
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import mxnet_tpu as mj
import mxnet_tpu_torch as mt

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-4, 1e-5
REL_L2 = 1e-4

ZOO = {
    "mlp": (lambda p: p.models.get_mlp(), {"data": (2, 784)}),
    "inception_bn": (lambda p: p.models.get_inception_bn(),
                     {"data": (2, 3, 224, 224)}),
    "inception_bn_small": (lambda p: p.models.get_inception_bn_small(),
                           {"data": (2, 3, 28, 28)}),
    "alexnet": (lambda p: p.models.get_alexnet(), {"data": (2, 3, 224, 224)}),
    "vgg16": (lambda p: p.models.get_vgg(), {"data": (2, 3, 224, 224)}),
    "vgg16_bn": (lambda p: p.models.get_vgg(batch_norm=True),
                 {"data": (2, 3, 224, 224)}),
    "googlenet": (lambda p: p.models.get_googlenet(),
                  {"data": (2, 3, 224, 224)}),
    "inception_v3": (lambda p: p.models.get_inception_v3(),
                     {"data": (2, 3, 299, 299)}),
    "unet": (lambda p: p.models.get_unet(), {"data": (2, 3, 32, 32)}),
}


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


def _build(pkg, net):
    with pkg.NameManager():
        return ZOO[net][0](pkg)


@pytest.mark.parametrize("net", sorted(ZOO))
def test_zoo_graph_equals_jax(net):
    sj, st = _build(mj, net), _build(mt, net)
    assert st.tojson() == sj.tojson()
    shapes = ZOO[net][1]
    assert st.infer_shape(**shapes) == sj.infer_shape(**shapes)


def test_zoo_exports_match_jax():
    assert sorted(mt.models.__all__) == sorted(mj.models.__all__)


@pytest.mark.parametrize("path", ["mlp.py", "inception_bn.py",
                                  "classic_convnets.py", "unet.py"])
def test_zoo_copy_matches_original(path):
    assert (ROOT / "mxnet_tpu_torch" / "models" / path).read_text() == \
        (ROOT / "mxnet_tpu" / "models" / path).read_text()


def _step(pkg, sym, shapes, args, aux):
    exe = sym.simple_bind(pkg.cpu(), grad_req="write", **shapes)
    for n, v in args.items():
        exe.arg_dict[n][:] = v
    for n, v in aux.items():
        exe.aux_dict[n][:] = v
    pkg.random.seed(0)   # AlexNet's Dropout masks: one key in both chains
    exe.forward(is_train=True)
    exe.backward()
    grads = {n: g.asnumpy() for n, g in exe.grad_dict.items()
             if g is not None and n in args and not n.endswith("label")
             and n != "data"}
    return ([o.asnumpy() for o in exe.outputs], grads,
            {n: a.asnumpy() for n, a in exe.aux_dict.items()})


@pytest.mark.parametrize("net,shapes", [
    ("mlp", {"data": (4, 784)}),
    ("inception_bn_small", {"data": (2, 3, 28, 28)}),
    ("alexnet", {"data": (2, 3, 224, 224)}),
    ("unet", {"data": (2, 3, 16, 16)}),
])
def test_executor_step_matches_jax(net, shapes):
    sj, st = _build(mj, net), _build(mt, net)
    label = [n for n in st.list_arguments() if n.endswith("label")][0]
    _, out_shapes, _ = st.infer_shape(**shapes)
    shapes = dict(shapes, **{label: out_shapes[0][:1] + out_shapes[0][2:]})
    args, aux = chip_smoke.zoo_params(st, shapes, seed=3)
    oj, gj, aj = _step(mj, sj, shapes, args, aux)
    ot, gt, at = _step(mt, st, shapes, args, aux)
    assert sorted(gt) == sorted(gj) and sorted(at) == sorted(aj)
    for a, b in zip(ot, oj):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    for got, want in ((gt, gj), (at, aj)):
        if want:
            scale = _rms(np.concatenate([v.ravel() for v in want.values()]))
        for n in want:
            _close(got[n], want[n], scale, n)


def _rms(v):
    return float(np.sqrt(np.mean(np.square(v))))


def _close(a, b, scale, name):
    """Element by element within RTOL of (the larger of the tensor's rms
    and ``scale``, plus the element's size), and within relative L2
    REL_L2 unless the tensor vanishes beside ``scale``."""
    err = np.abs(a - b)
    assert np.all(err <= RTOL * (max(_rms(b), scale) + np.abs(b))), (
        name, err.max())
    if _rms(b) > 1e-3 * scale:
        assert np.linalg.norm(a - b) <= REL_L2 * np.linalg.norm(b), name


# -- the image-classification examples -----------------------------------------
def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _example(dirname, tag, script="train_cifar10.py"):
    """(train_model, the script's module) of one example directory."""
    d = ROOT / "examples" / dirname
    tm = _load(d / "train_model.py", tag + "_train_model")
    saved = sys.modules.get("train_model")
    path = list(sys.path)
    sys.modules["train_model"] = tm
    try:
        ex = _load(d / script, tag + "_" + script[:-3])
    finally:
        sys.path[:] = path
        if saved is None:
            sys.modules.pop("train_model", None)
        else:
            sys.modules["train_model"] = saved
    return tm, ex


BATCH, STEPS = 32, 10


def _fit_cifar10(pkg, dirname, tag, prefix, monkeypatch):
    """10 steps of the example's fit from the checkpoint at ``prefix``
    epoch 0; returns the checkpoint it writes after the epoch and the
    training accuracy."""
    tm, ex = _example(dirname, tag)
    argv = ["train_cifar10.py", "--synthetic", "--ctx", "cpu",
            "--batch-size", str(BATCH), "--num-epochs", "1",
            "--model-prefix", str(prefix), "--load-epoch", "0"]
    monkeypatch.setattr(sys, "argv", argv)
    args = ex.parse_args()
    with pkg.NameManager():
        net = pkg.models.get_inception_bn_small(num_classes=10)

    def loader(args, kv):
        np.random.seed(11)   # the iterators' shuffle
        train, _ = ex.get_iterator(args, kv)
        sel = train.idx[:STEPS * BATCH]
        return (pkg.io.NDArrayIter(train.data[0][1][sel],
                                   train.label[0][1][sel],
                                   batch_size=BATCH), None)

    accs = []
    model = tm.fit(args, net, loader, batch_end_callback=lambda p: accs.append(
        p.eval_metric.get()[1]))
    _, arg, aux = pkg.model.load_checkpoint(str(prefix), 1)
    return ({k: v.asnumpy() for k, v in arg.items()},
            {k: v.asnumpy() for k, v in aux.items()}, accs[-1], model)


def _rel(got, want):
    """The largest relative L2 gap over the parameters."""
    return max(np.linalg.norm(got[n] - want[n])
               / max(np.linalg.norm(want[n]), 1e-30) for n in want)


def test_cifar10_example_fit_matches_jax(tmp_path, monkeypatch):
    """The two examples' 10 steps part by no more than twice what a
    1e-6 relative change of the starting parameters makes the port's
    own 10 steps part: the fit amplifies f32 rounding (BatchNorm's
    one-pass variance over the 28x28 images of the examples' synthetic
    set, whose class rows add 1.0 to a 0-0.1 background, cancels in
    f32), so a summation order in the first steps moves the tenth by
    ~3e-2 relative in either package; after one step the two packages
    agree within 1e-4. The scanned fits run the 10 steps as one chunk
    (``MXNET_TRAIN_SCAN_K=10``), which JAX compiles once. The port's
    three fits run at one torch thread, set here and restored after:
    torch's CPU reductions split by thread, so the chaos a 1e-6 nudge
    opens, and the gap to the JAX fit, otherwise depend on the thread
    count that the process (or an earlier test in it) left."""
    monkeypatch.setenv("MXNET_TRAIN_SCAN_K", str(STEPS))
    logging.disable(logging.INFO)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with mj.NameManager():
            sym = mj.models.get_inception_bn_small(num_classes=10)
        shapes = {"data": (BATCH, 3, 28, 28), "softmax_label": (BATCH,)}
        args, aux = chip_smoke.zoo_params(sym, shapes, seed=5)
        params = {k: v for k, v in args.items()
                  if k not in ("data", "softmax_label")}
        noise = np.random.RandomState(1)
        nudged = {k: (v * (1 + 1e-6 * noise.randn(*v.shape))).astype(
            np.float32) for k, v in params.items()}
        out = {}
        for pkg, dirname, tag, start in (
                (mj, "image-classification", "ic_jax", params),
                (mt, "image-classification_torch", "ic_port", params),
                (mt, "image-classification_torch", "ic_nudged", nudged)):
            prefix = tmp_path / tag / "cifar"
            prefix.parent.mkdir()
            mj.model.save_checkpoint(
                str(prefix), 0, sym,
                {k: mj.nd.array(v, ctx=mj.cpu()) for k, v in start.items()},
                {k: mj.nd.array(v, ctx=mj.cpu()) for k, v in aux.items()})
            out[tag] = _fit_cifar10(pkg, dirname, tag, prefix, monkeypatch)
    finally:
        torch.set_num_threads(threads)
        logging.disable(logging.NOTSET)
    (aj, xj, accj, _), (at, xt, acct, model) = out["ic_jax"], out["ic_port"]
    an, xn, accn, _ = out["ic_nudged"]
    assert sorted(at) == sorted(aj) and sorted(xt) == sorted(xj)
    for name in aj:
        assert not np.array_equal(aj[name], params[name]), name
    chaos = _rel(an, at)
    assert 1e-4 < chaos and _rel(at, aj) <= 2 * chaos, (_rel(at, aj), chaos)
    assert _rel(xt, xj) <= 2 * max(_rel(xn, xt), 1e-4)
    assert abs(acct - accj) <= 2 * max(abs(accn - acct), 1.0 / (STEPS * BATCH))
    assert model.ctx == [mt.cpu(0)]


def test_cifar10_example_first_step_matches_jax(tmp_path, monkeypatch):
    """One step of each example from the same checkpoint: every
    parameter and moving statistic within relative L2 1e-4."""
    monkeypatch.setattr(sys.modules[__name__], "STEPS", 1)
    logging.disable(logging.INFO)
    try:
        with mj.NameManager():
            sym = mj.models.get_inception_bn_small(num_classes=10)
        shapes = {"data": (BATCH, 3, 28, 28), "softmax_label": (BATCH,)}
        args, aux = chip_smoke.zoo_params(sym, shapes, seed=5)
        params = {k: v for k, v in args.items()
                  if k not in ("data", "softmax_label")}
        out = []
        for pkg, dirname, tag in ((mj, "image-classification", "ic1_jax"),
                                  (mt, "image-classification_torch",
                                   "ic1_port")):
            prefix = tmp_path / tag / "cifar"
            prefix.parent.mkdir()
            mj.model.save_checkpoint(
                str(prefix), 0, sym,
                {k: mj.nd.array(v, ctx=mj.cpu()) for k, v in params.items()},
                {k: mj.nd.array(v, ctx=mj.cpu()) for k, v in aux.items()})
            out.append(_fit_cifar10(pkg, dirname, tag, prefix, monkeypatch))
    finally:
        logging.disable(logging.NOTSET)
    assert _rel(out[1][0], out[0][0]) <= REL_L2
    assert _rel(out[1][1], out[0][1]) <= REL_L2
    assert out[1][2] == out[0][2]


def test_examples_ctx_and_record_branch(monkeypatch, tmp_path):
    tm, ex = _example("image-classification_torch", "ic_port_args",
                      "train_imagenet.py")
    monkeypatch.setattr(sys, "argv", ["train_imagenet.py"])
    args = ex.parse_args()
    assert args.ctx == "auto" and args.network == "resnet"
    assert [str(c) for c in tm._contexts(args)] == [str(mt.gpu(0))]
    args.ctx = "cpu"
    assert tm._contexts(args) == [mt.cpu(0)]
    monkeypatch.setattr(sys, "argv", ["train_imagenet.py", "--ctx", "tpu"])
    with pytest.raises(SystemExit):
        ex.parse_args()
    args.synthetic = False
    args.data_dir = str(tmp_path)
    w = mt.recordio.MXRecordIO(str(tmp_path / "train.rec"), "w")
    for i in range(4):
        w.write(mt.recordio.pack_img((0, float(i), i, 0), np.full(
            (240, 250, 3), 40 * i, np.uint8)))
    w.close()
    args.batch_size = 2
    train, val = ex.get_iterator(args, mt.kvstore.create("local"))
    assert isinstance(train, mt.io.PrefetchingIter) and val is None
    assert isinstance(train.iters[0], mt.io.ImageRecordIter)
    batches = list(train)
    assert [b.data[0].shape for b in batches] == [(2, 3, 224, 224)] * 2
    np.testing.assert_array_equal(
        np.concatenate([b.label[0].asnumpy() for b in batches]),
        [0.0, 1.0, 2.0, 3.0])
