"""FeedForward in the port against the JAX package's, on the CPU.

- 20 SGD-momentum steps of LeNet (lr 0.1, momentum 0.9, batch 16,
  ``NDArrayIter(shuffle=False)``) from the same numpy parameters: every
  step's output and every final parameter agree within 1e-4 relative
  L2, ||got - want|| / ||want|| (f32 on both sides, differing in
  summation order, which the steps compound to ~2e-5 in fc1_weight;
  per element the near-zero weights would have no relative scale; both
  sides run their per-batch loops, ``MXNET_SCAN_TRAIN=0``, whose
  executors the callback reads; ``tests/test_torch_fit_scan.py`` holds
  the scanned fit);
- the canonical LeNet fit of the verify recipe scores > 0.9 in the port;
- a checkpoint either package saved loads in the other and predicts the
  same classes, probabilities within 1e-5, and the two packages write the
  same ``.params`` and ``-symbol.json`` bytes for the same arrays.
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt

BATCH, STEPS = 16, 20


@pytest.fixture(scope="module", autouse=True)
def _warm_cpu_math():
    """torch 2.13's CPU ``exp`` and ``tanh`` sometimes return errors up to
    1.5e-4 relative on their first multithreaded call in a process (plain
    torch reproduces it: ``torch.exp`` twice on the same [64, 1000]
    tensor, the first result off); one call of each on a large tensor
    first avoids it, so the comparisons see the port's arithmetic."""
    t = torch.randn(100000)
    torch.exp(t)
    torch.tanh(t)
    torch.rsqrt(t.abs() + 1)


def _data():
    rng = np.random.RandomState(5)
    x = rng.rand(BATCH * STEPS, 1, 28, 28).astype(np.float32)
    y = rng.randint(0, 10, BATCH * STEPS).astype(np.float32)
    for i in range(len(y)):   # a learnable class signal, as MNISTIter's
        c = int(y[i])
        x[i, 0, 2 + 2 * c:6 + 2 * c, 4:24] += 0.9
    return x, y


def _params(sym):
    shapes, _, _ = sym.infer_shape(data=(BATCH, 1, 28, 28))
    rng = np.random.RandomState(6)
    out = {}
    for name, shape in zip(sym.list_arguments(), shapes):
        if name in ("data", "softmax_label"):
            continue
        fan = float(np.prod(shape[1:])) if len(shape) > 1 else 1.0
        out[name] = (rng.uniform(-1, 1, shape) * np.sqrt(3.0 / fan)
                     ).astype(np.float32)
    return out


def _fit(pkg, arg_params):
    x, y = _data()
    it = pkg.io.NDArrayIter(x, y, batch_size=BATCH, shuffle=False)
    outs = []

    def record(param):
        em = param.locals["executor_manager"]
        outs.append(em.curr_execgrp.train_execs[0].outputs[0].asnumpy())

    model = pkg.FeedForward(pkg.models.get_lenet(), ctx=pkg.cpu(),
                            num_epoch=1, learning_rate=0.1, momentum=0.9,
                            arg_params=arg_params)
    model.fit(X=it, batch_end_callback=record)
    return model, outs


@pytest.fixture(scope="module")
def fits():
    sym = mt.models.get_lenet()
    params = _params(sym)
    old = os.environ.get("MXNET_SCAN_TRAIN")
    os.environ["MXNET_SCAN_TRAIN"] = "0"
    try:
        jax_model, jax_outs = _fit(
            mj, {k: mj.nd.array(v, ctx=mj.cpu()) for k, v in params.items()})
        args, _ = mt.model.params_from_numpy(params, ctx=mt.cpu())
        torch_model, torch_outs = _fit(mt, args)
    finally:
        if old is None:
            del os.environ["MXNET_SCAN_TRAIN"]
        else:
            os.environ["MXNET_SCAN_TRAIN"] = old
    return jax_model, jax_outs, torch_model, torch_outs


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_every_step_output_matches(fits):
    _, jax_outs, _, torch_outs = fits
    assert len(jax_outs) == len(torch_outs) == STEPS
    for step, (want, got) in enumerate(zip(jax_outs, torch_outs)):
        assert got.shape == want.shape == (BATCH, 10)
        assert _rel_l2(got, want) <= 1e-4, step


def test_final_parameters_match(fits):
    jax_model, _, torch_model, _ = fits
    assert sorted(jax_model.arg_params) == sorted(torch_model.arg_params)
    for name, want in jax_model.arg_params.items():
        got = torch_model.arg_params[name].asnumpy()
        assert _rel_l2(got, want.asnumpy()) <= 1e-4, name


def test_canonical_lenet_fit_scores():
    """The verify recipe's fit, on the port's CPU path."""
    train = mt.io.MNISTIter(batch_size=64, num_synthetic=1024, seed=1)
    val = mt.io.MNISTIter(batch_size=64, num_synthetic=512, seed=2,
                          shuffle=False)
    model = mt.FeedForward(mt.models.get_lenet(), ctx=mt.cpu(0),
                           num_epoch=3, learning_rate=0.1, momentum=0.9,
                           initializer=mt.initializer.Xavier())
    model.fit(X=train, eval_data=val)
    assert model.score(val) > 0.9


def _predict(pkg, model):
    x, y = _data()
    it = pkg.io.NDArrayIter(x[:64], y[:64], batch_size=BATCH, shuffle=False)
    return model.predict(it)


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_checkpoint_loads_across_packages(fits, tmp_path, direction):
    jax_model, _, torch_model, _ = fits
    src, dst = (mj, mt) if direction == "jax_to_torch" else (mt, mj)
    saved = jax_model if src is mj else torch_model
    prefix = str(tmp_path / "lenet")
    saved.save(prefix, 1)
    loaded = dst.FeedForward.load(prefix, 1, ctx=dst.cpu())
    want = _predict(src, saved)
    got = _predict(dst, loaded)
    assert got.shape == want.shape == (64, 10)
    assert (got.argmax(axis=1) == want.argmax(axis=1)).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_checkpoint_files_are_byte_equal(fits, tmp_path):
    """Both packages write the same files for the same arrays."""
    _, _, torch_model, _ = fits
    args = {k: v.asnumpy() for k, v in torch_model.arg_params.items()}
    files = []
    for pkg in (mj, mt):
        prefix = str(tmp_path / pkg.__name__)
        with pkg.NameManager():
            sym = pkg.models.get_lenet()
        pkg.model.save_checkpoint(
            prefix, 3, sym,
            {k: pkg.nd.array(v, ctx=pkg.cpu()) for k, v in args.items()}, {})
        pkg.model.fence_checkpoint(prefix)
        files.append([open(prefix + suffix, "rb").read()
                      for suffix in ("-0003.params", "-symbol.json")])
    assert files[0] == files[1]
