"""The port's Predictor and compiled export against the JAX package's, on
the CPU.

LeNet (batch 4, 1x28x28) and Inception-BN-small (batch 4, 3x28x28, 10
classes) are checkpointed once with seeded parameters (and moving
statistics); both packages' ``Predictor.from_checkpoint`` read the same
``prefix-symbol.json`` and ``prefix-0001.params`` bytes:

- outputs, partial outputs (``output_names`` of an internal head),
  ``get_output_shape`` and ``reshape`` to batch 2 within rtol 1e-4,
  atol 1e-5 (f32 both sides, summation order only);
- the error messages of both packages are equal;
- ``ctx=None`` is ``gpu(0)`` in the port, so without CUDA it raises;
- LeNet's ``export_compiled``/``load_compiled`` round trip is
  bit-equal to the Predictor's outputs, the program holds the custom op
  ``mxnet_tpu_torch::fused_softmax``, and loading and running it builds
  no Symbol and consults no op registry; a JAX artifact raises.
"""
import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt

RTOL, ATOL = 1e-4, 1e-5
NETS = {
    "lenet": (lambda pkg: pkg.models.get_lenet(), (4, 1, 28, 28), "fc1"),
    "inception_bn_small": (
        lambda pkg: pkg.models.get_inception_bn_small(num_classes=10),
        (4, 3, 28, 28), "conv_1"),
}


@pytest.fixture(scope="module", autouse=True)
def _env():
    """torch's CPU ``exp``/``tanh`` can err by 1.5e-4 on their first
    multithreaded call in a process: one call of each first; the JAX
    references compiled without XLA's passes (each runs once or
    twice)."""
    t = torch.randn(100000)
    torch.exp(t)
    torch.tanh(t)
    prev = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", prev)
    jax.clear_caches()


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """prefix -> (input shape, internal head) for each net, saved by the
    port (files byte-equal to the JAX package's: test_torch_fit.py)."""
    out = {}
    for name, (build, dshape, head) in NETS.items():
        with mt.NameManager():
            sym = build(mt)
        arg_shapes, _, aux_shapes = sym.infer_shape(data=dshape)
        rng = np.random.RandomState(1)
        args = {n: mt.nd.array((rng.randn(*s) * 0.2).astype(np.float32),
                               ctx=mt.cpu())
                for n, s in zip(sym.list_arguments(), arg_shapes)
                if n not in ("data", "softmax_label")}
        aux = {n: mt.nd.array((rng.rand(*s) + 0.5 if n.endswith("var")
                               else rng.randn(*s) * 0.1).astype(np.float32),
                              ctx=mt.cpu())
               for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
        prefix = str(tmp_path_factory.mktemp(name) / name)
        mt.model.save_checkpoint(prefix, 1, sym, args, aux, sync=True)
        out[name] = (prefix, dshape, head)
    return out


def _data(dshape, seed=2):
    return np.random.RandomState(seed).rand(*dshape).astype(np.float32)


def _pair(prefix, dshape, **kw):
    return (mj.Predictor.from_checkpoint(prefix, 1, ctx=mj.cpu(),
                                         input_shapes={"data": dshape}, **kw),
            mt.Predictor.from_checkpoint(prefix, 1, ctx=mt.cpu(),
                                         input_shapes={"data": dshape}, **kw))


@pytest.mark.parametrize("net", sorted(NETS))
def test_outputs_match_jax(checkpoints, net):
    prefix, dshape, _ = checkpoints[net]
    pj, pt = _pair(prefix, dshape)
    x = _data(dshape)
    pj.forward(data=x)
    pt.forward(data=x)
    assert pt.get_output_shape(0) == pj.get_output_shape(0) == (dshape[0], 10)
    np.testing.assert_allclose(pt.get_output(0), pj.get_output(0),
                               rtol=RTOL, atol=ATOL)
    # reshape to batch 2, sharing the weights
    small = (2,) + dshape[1:]
    for p in (pj, pt):
        p.reshape({"data": small})
        p.set_input("data", x[:2])
        p.forward()
    assert pt.get_output_shape() == pj.get_output_shape() == (2, 10)
    np.testing.assert_allclose(pt.get_output(0), pj.get_output(0),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("net", sorted(NETS))
def test_partial_outputs_match_jax(checkpoints, net):
    prefix, dshape, head = checkpoints[net]
    pj, pt = _pair(prefix, dshape, output_names=[head, "softmax"])
    x = _data(dshape, seed=3)
    pj.forward(data=x)
    pt.forward(data=x)
    for i in range(2):
        assert pt.get_output_shape(i) == pj.get_output_shape(i)
        np.testing.assert_allclose(pt.get_output(i), pj.get_output(i),
                                   rtol=RTOL, atol=ATOL)


def _message(fn):
    try:
        fn()
    except Exception as e:   # noqa: BLE001 - the message is the point
        return type(e).__name__, str(e)
    return None


def test_error_messages_match_jax(checkpoints):
    prefix, dshape, _ = checkpoints["lenet"]
    pj, pt = _pair(prefix, dshape)
    bad = np.zeros((3,) + dshape[1:], np.float32)
    for call in (lambda p: p.get_output(0),
                 lambda p: p.set_input("label", bad),
                 lambda p: p.set_input("data", bad),
                 lambda p: p.forward(data=bad)):
        assert _message(lambda: call(pt)) == _message(lambda: call(pj))
    with open(prefix + "-symbol.json") as f:
        js = f.read()
    for pkg in (mj, mt):
        with pytest.raises(pkg.MXNetError, match="requires input_shapes"):
            pkg.Predictor(js, b"", ctx=pkg.cpu())
    with pytest.raises(mt.MXNetError, match="not a compiled-model artifact"):
        mt.predictor.load_compiled(b"XXXX")


def test_default_device_is_the_card(checkpoints):
    if torch.cuda.is_available():
        pytest.skip("a card is present: gpu(0) exists")
    prefix, dshape, _ = checkpoints["lenet"]
    with pytest.raises(mt.MXNetError, match="no such CUDA device"):
        mt.Predictor.from_checkpoint(prefix, 1, input_shapes={"data": dshape})


def test_export_round_trip_is_bit_equal(checkpoints):
    prefix, dshape, _ = checkpoints["lenet"]
    pt = mt.Predictor.from_checkpoint(prefix, 1, ctx=mt.cpu(),
                                      input_shapes={"data": dshape})
    x = _data(dshape, seed=4)
    pt.forward(data=x)
    want = pt.get_output(0)
    blob = pt.export_compiled()
    assert blob[:4] == b"MXTC"
    # loading and running the program needs no Symbol and no registry
    with mock_no_graph():
        compiled = mt.predictor.load_compiled(blob)
        compiled.forward(data=x)
        got = compiled.get_output(0)
    np.testing.assert_array_equal(got, want)
    assert "mxnet_tpu_torch.fused_softmax" in str(compiled._program.graph)


class mock_no_graph:
    """Makes building a Symbol or reading the op registry raise."""

    def __enter__(self):
        from unittest import mock

        def refuse(*a, **k):
            raise AssertionError("load_compiled built a Symbol or read "
                                 "the op registry")

        self._patches = [mock.patch.object(mt.symbol.Symbol, "__init__",
                                           refuse),
                         mock.patch.object(mt.ops.registry, "get", refuse)]
        for p in self._patches:
            p.start()
        return self

    def __exit__(self, *exc):
        for p in self._patches:
            p.stop()


def test_jax_artifact_is_refused(checkpoints):
    prefix, dshape, _ = checkpoints["lenet"]
    pj = mj.Predictor.from_checkpoint(prefix, 1, ctx=mj.cpu(),
                                      input_shapes={"data": dshape})
    blob = pj.export_compiled()
    with pytest.raises(mt.MXNetError, match="JAX package"):
        mt.predictor.load_compiled(blob)
