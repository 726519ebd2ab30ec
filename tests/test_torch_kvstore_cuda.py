"""The kvstore, data parallelism and group2ctx on the card.

Every test carries the ``cuda`` marker and skips without a GPU. The file
imports neither ``jax`` nor ``mxnet_tpu``, so it runs on a machine with
the card and no JAX; the repository's ``tests/conftest.py`` pins JAX,
so skip it there:

    python -m pytest --noconftest tests/test_torch_kvstore_cuda.py

- ``chip_smoke.kvstore_cases`` on four card contexts (a context repeats
  when there are fewer cards) against four host contexts: the sums
  bit-equal, SGD-momentum through ``set_optimizer`` within 1e-6, a
  one-value push owning its storage;
- a pull writes the executor's bound tensors in place on the card;
- a 2-context LeNet step on ``[gpu(0), gpu(0)]`` (or two cards) against
  the host's 2-context step (``chip_smoke.net_closeness``);
- the group2ctx LSTM on four card contexts against the unpartitioned
  net on one (``chip_smoke.mp_grad_check``: 1e-4 / 1e-5, each argument
  on its group's context);
- the backend rule: gloo for two ranks on one card.
"""
import pytest
import torch

import chip_smoke
import mxnet_tpu_torch as mx

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: these paths run on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def test_kvstore_cases_on_the_card_match_the_host(card):
    got = chip_smoke.kvstore_cases(mx, chip_smoke.card_contexts("cuda", 4))
    want = chip_smoke.kvstore_cases(mx, [mx.cpu(i) for i in range(4)])
    assert chip_smoke.kvstore_check(got, want) <= chip_smoke.KV_UPDATE_RTOL


def test_pull_writes_the_bound_tensor_in_place(card):
    exe = mx.models.get_lenet().simple_bind(mx.gpu(0), data=(4, 1, 28, 28))
    w = exe.arg_dict["fc2_weight"]
    ptr, tensor = w._data.data_ptr(), w._data
    kv = mx.kvstore.create("device")
    kv.init(0, mx.nd.ones(w.shape, mx.gpu(0)))
    kv.pull(0, out=w)
    assert w._data is tensor and w._data.data_ptr() == ptr
    assert bool((exe.arg_dict["fc2_weight"]._data == 1).all())


def test_two_context_lenet_step_matches_the_host(card):
    with mx.NameManager():
        sym = mx.models.get_lenet()
    shapes = {"data": (8, 1, 28, 28), "softmax_label": (8,)}
    args, aux = chip_smoke.zoo_params(sym, shapes, seed=3)
    ctxs = chip_smoke.dp_contexts("cuda")[:2]
    got = chip_smoke.dp_step(sym, shapes, args, aux, ctxs)
    want = chip_smoke.dp_step(sym, shapes, args, aux, [mx.cpu(0), mx.cpu(1)])
    nudged = chip_smoke.dp_step(sym, shapes, chip_smoke.nudge(args), aux,
                                ctxs)
    rec = chip_smoke.net_closeness(got, want, nudged)
    assert rec["ok"], rec


def test_group2ctx_lstm_on_the_card_matches_one_context(card):
    ctxs = chip_smoke.card_contexts("cuda", 4)
    rec = chip_smoke.mp_grad_check(mx, ctxs, ctxs[0], num_layers=2,
                                   seq_len=8, vocab=50, num_hidden=32,
                                   num_embed=16, batch=4)
    assert rec["outputs_context"] == str(ctxs[-1])
    assert max(rec["max_abs_err"].values()) < 1e-3


def test_backend_rule(card):
    n = torch.cuda.device_count()
    assert mx.kvstore._backend_rule(n + 1) == "gloo"
    assert mx.kvstore._backend_rule(n) == "cpu:gloo,cuda:nccl"
