"""K1 inside an exported program, the Predictor and mirroring, on the card.

A CUDA kernel has no CPU mode, so every test here carries the ``cuda``
marker and skips without a GPU. The file imports neither ``jax`` nor
``mxnet_tpu``, so it runs on a machine with the card and no JAX; the
repository's ``tests/conftest.py`` pins JAX, so skip it there:

    python -m pytest --noconftest tests/test_torch_predictor_cuda.py

- the custom op ``mxnet_tpu_torch::fused_softmax`` in a program traced by
  ``torch.export``, saved and loaded: on a CUDA tensor it launches K1
  (the count grows) and agrees with the plain version (f32, 1e-4 of the
  row's scale, as the kernel tests hold);
- a LeNet Predictor on the card, its exported program (outputs equal to
  the Predictor's, bit for bit, K1 launched in it) and a Predictor on
  the host (1e-4);
- a mirrored step of a small conv net with Dropout on the card equals
  the unmirrored one (outputs, gradients, BatchNorm's statistics; bit
  for bit, or relative L2 1e-6 a tensor where cuDNN parts them).
"""
import io
import os
from unittest import mock

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import softmax as sm

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _close(got, want, tol=1e-4):
    got, want = got.float(), want.float()
    scale = want.pow(2).mean().sqrt() + want.abs()
    return bool(((got - want).abs() <= tol * scale).all())


class _Softmax(torch.nn.Module):
    def forward(self, x):
        return sm.fused_softmax(x) * 2.0


def test_custom_op_in_an_exported_program_launches_k1(card):
    x = torch.randn(256, 1000, device=card)
    ep = torch.export.export(_Softmax(), (x,), strict=False)
    assert "mxnet_tpu_torch.fused_softmax" in str(ep.graph)
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    prog = torch.export.load(io.BytesIO(buf.getvalue())).module()
    before = sm.fused_softmax.launches
    y = prog(x)
    torch.cuda.synchronize()
    assert sm.fused_softmax.launches == before + 1
    assert _close(y, sm.softmax_reference(x) * 2.0)


@pytest.fixture
def lenet_checkpoint(tmp_path):
    sym = mx.models.get_lenet()
    arg_shapes, _, _ = sym.infer_shape(data=(8, 1, 28, 28))
    rng = np.random.RandomState(0)
    args = {n: mx.nd.array((rng.randn(*s) * 0.1).astype(np.float32),
                           ctx=mx.cpu())
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    prefix = str(tmp_path / "lenet")
    mx.model.save_checkpoint(prefix, 1, sym, args, {}, sync=True)
    return prefix


def test_predictor_and_its_exported_program_on_the_card(card,
                                                        lenet_checkpoint):
    shapes = {"data": (8, 1, 28, 28)}
    x = np.random.RandomState(1).rand(8, 1, 28, 28).astype(np.float32)
    pred = mx.Predictor.from_checkpoint(lenet_checkpoint, 1,
                                        input_shapes=shapes)   # gpu(0)
    before = sm.fused_softmax.launches
    pred.forward(data=x)
    out = pred.get_output(0)
    assert sm.fused_softmax.launches == before + 1
    host = mx.Predictor.from_checkpoint(lenet_checkpoint, 1, ctx=mx.cpu(),
                                        input_shapes=shapes)
    host.forward(data=x)
    assert _close(torch.from_numpy(out), torch.from_numpy(host.get_output(0)))
    compiled = mx.predictor.load_compiled(pred.export_compiled())
    before = sm.fused_softmax.launches
    compiled.forward(data=x)
    got = compiled.get_output(0)
    assert sm.fused_softmax.launches == before + 1
    np.testing.assert_array_equal(got, out)


def _net():
    s = mx.sym
    x = s.Convolution(s.Variable("data"), num_filter=16, kernel=(3, 3),
                      pad=(1, 1), name="c1")
    x = s.Activation(s.BatchNorm(x, fix_gamma=False, name="bn1"),
                     act_type="relu", name="r1")
    x = s.Dropout(x, p=0.5, name="drop")
    x = s.Convolution(x, num_filter=16, kernel=(3, 3), pad=(1, 1), name="c2")
    x = s.Activation(s.BatchNorm(x, fix_gamma=False, name="bn2"),
                     act_type="relu", name="r2")
    x = s.Pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="max")
    x = s.FullyConnected(s.Flatten(x), num_hidden=10, name="fc")
    return s.SoftmaxOutput(x, name="softmax")


def _step(mirror):
    with mock.patch.dict(os.environ):
        os.environ.pop("MXNET_BACKWARD_DO_MIRROR", None)
        if mirror:
            os.environ["MXNET_BACKWARD_DO_MIRROR"] = "1"
        exe = _net().simple_bind(mx.gpu(0), data=(16, 3, 32, 32))
    assert exe._remat == mirror
    rng = np.random.RandomState(2)
    for n, a in exe.arg_dict.items():
        a[:] = (rng.randint(0, 10, a.shape) if n == "softmax_label"
                else rng.randn(*a.shape) * 0.2)
    mx.random.seed(5)
    exe.forward(is_train=True)
    exe.backward()
    return ([o.asnumpy() for o in exe.outputs],
            {n: g.asnumpy() for n, g in exe.grad_dict.items()},
            {n: a.asnumpy() for n, a in exe.aux_dict.items()})


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_mirrored_step_equals_unmirrored_on_the_card(card):
    plain, mirrored = _step(False), _step(True)
    for a, b in zip(mirrored[0], plain[0]):
        assert _rel(a, b) <= 1e-6
    for part in (1, 2):
        for n in plain[part]:
            assert _rel(mirrored[part][n], plain[part][n]) <= 1e-6, n
