"""The recurrent LM path's random draws and its K1 shapes on the card.

Dropout's mask and the fused ``RNN`` op's inter-layer masks are threefry
bits computed by integer torch ops, so they must be the same on the card
as on the host under the same key (the CPU tests hold the host's equal to
JAX's): the ``Dropout`` op, the ``RNN`` op's training forward in two of
its modes, and an executor's Dropout nodes at the LSTM's full width, each
against the same computation on the host. K1, SoftmaxOutput's forward,
at the LSTM path's shapes [32·T, 200] f32 for T = 10 and 60, against its
plain version. Every test carries the ``cuda`` marker and skips without
a GPU. The file imports neither ``jax`` nor ``mxnet_tpu``:

    python -m pytest --noconftest tests/test_torch_rnn_cuda.py
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import threefry as tf
from mxnet_tpu_torch.ops import registry
from mxnet_tpu_torch.ops import softmax as sm

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the draws are checked on the card")
    return torch.device("cuda", 0)


def _key(seed, dev):
    return tf.fold_in(tf.prng_key(seed, device=dev), 17)


@pytest.mark.parametrize("p,shape", [(0.5, (320, 200)), (0.3, (32, 200)),
                                     (0.9, (7, 33, 5))])
def test_dropout_op_equal_on_card_and_host(card, p, shape):
    op = registry.get("Dropout")
    params = op.parse_params({"p": p})
    x = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    got = op.apply(params, [x.to(card)], [], True, _key(3, card))[0][0]
    want = op.apply(params, [x], [], True, _key(3, "cpu"))[0][0]
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)
    kept = (want != 0).double().mean().item()
    assert abs(kept - (1 - p)) < 4 * np.sqrt(p * (1 - p) / want.numel())


@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_rnn_dropout_masks_equal_on_card_and_host(card, mode):
    """A three-layer training forward at the LSTM's width: the mask of
    a layer key drawn on the card equals the host's, and the forward
    agrees with the host's within f32 limits (one other mask would move
    it by order one)."""
    from mxnet_tpu_torch.ops.sequence import rnn_param_size

    op = registry.get("RNN")
    params = op.parse_params({"mode": mode, "state_size": 200,
                              "num_layers": 3, "p": 0.5})
    T, N, H = 10, 32, 200
    g = torch.Generator().manual_seed(2)
    ins = [torch.randn(T, N, H, generator=g),
           torch.randn(rnn_param_size(mode, H, H, 3, False), generator=g)
           * 0.05,
           torch.zeros(3, N, H)] + ([torch.zeros(3, N, H)]
                                    if mode == "lstm" else [])
    key_h, key_d = _key(5, "cpu"), _key(5, card)
    want = tf.bernoulli(tf.fold_in(key_h, 1), 0.5, (T, N, H))
    got = tf.bernoulli(tf.fold_in(key_d, 1), 0.5, (T, N, H))
    assert torch.equal(got.cpu(), want)
    out_d = op.apply(params, [t.to(card) for t in ins], [], True, key_d)[0][0]
    out_h = op.apply(params, ins, [], True, key_h)[0][0]
    assert out_d.shape == out_h.shape == (T, N, H)
    assert torch.allclose(out_d.cpu(), out_h, rtol=1e-4, atol=1e-5)


def test_executor_dropout_masks_equal_on_card_and_host(card):
    """lstm_unroll(dropout=0.5) at bucket 10 and full width (200 hidden,
    200 embed, vocabulary 200, batch 32) bound on each device from the
    same arguments and ``random.seed(7)``: every Dropout node's mask is
    the same."""
    sym = mx.models.lstm_unroll(2, 10, 200, 200, 200, 200, dropout=0.5,
                                ignore_label=0)
    internals = sym.get_internals()
    names = [n for n in internals.list_outputs() if n.startswith("dropout")]
    group = mx.sym.Group([sym] + [internals[n] for n in names])
    shapes = {"data": (32, 10), "softmax_label": (32, 10)}
    shapes.update({"l%d_init_%s" % (i, s): (32, 200) for i in range(2)
                   for s in "ch"})
    arg_shapes, _, _ = group.infer_shape(**shapes)
    rng = np.random.RandomState(0)
    args = {n: (rng.randint(1, 200, s) if n in ("data", "softmax_label")
                else rng.randn(*s) * 0.1).astype(np.float32)
            for n, s in zip(group.list_arguments(), arg_shapes)}
    masks = []
    for ctx in (mx.gpu(0), mx.cpu()):
        exe = group.simple_bind(ctx, grad_req="null", **shapes)
        for n, v in args.items():
            exe.arg_dict[n][:] = v
        mx.random.seed(7)
        exe.forward(is_train=True)
        masks.append([o.asnumpy() != 0 for o in exe.outputs[1:]])
    assert len(masks[0]) == 11   # 10 steps' layer 1 and the decoder's
    for name, a, b in zip(names, *masks):
        np.testing.assert_array_equal(a, b, err_msg=name)
        assert abs(a.mean() - 0.5) < 4 * np.sqrt(0.25 / a.size), name


@pytest.mark.parametrize("rows", [320, 1920])
def test_k1_at_the_lstm_shapes(card, rows):
    g = torch.Generator(device=card).manual_seed(rows)
    x = torch.randn((rows, 200), generator=g, device=card) * 3
    before = sm.fused_softmax.launches
    y = sm.fused_softmax(x)
    assert sm.fused_softmax.launches == before + 1
    want = sm.softmax_reference(x)
    torch.cuda.synchronize()
    diff = (y - want).abs()
    assert (diff <= 1e-4 * (want.pow(2).mean().sqrt() + want.abs())).all()
