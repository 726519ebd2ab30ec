"""The training guardian's sentinel on the card.

- the per-batch sentinel makes no host synchronisation: a guarded SGD
  update (finiteness and squared norm of the gradient, the update, the
  ``torch.where`` select of weight and momentum) is captured into a CUDA
  graph, and its replays equal the eager guarded updates, a NaN
  gradient's replay leaving weight and momentum as they were;
- the scanned fit's K guarded steps queue with no host synchronisation
  (``FitTrainer.run_chunk`` under ``set_sync_debug_mode("error")``), and
  the per-step verdicts come back with the chunk's one device-to-host
  pull: one pull and one guardian drain a chunk, the flags among the
  pulled tensors; the ``grad.nan`` step's verdict is the poisoned one
  and the weights stay finite.

Every test carries the ``cuda`` marker and skips without a GPU. The file
imports neither ``jax`` nor ``mxnet_tpu``:

    python -m pytest --noconftest tests/test_torch_guardian_cuda.py
"""

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import model as mt_model
from mxnet_tpu_torch.parallel import fit_trainer

pytestmark = pytest.mark.cuda


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the sentinel runs on the card")
    for k in ("MXNET_FAULT_SPEC", "MXNET_GUARDIAN_GRADNORM_MAX",
              "MXNET_PROF", "MXNET_TELEMETRY"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("MXNET_GUARDIAN", "1")
    mt.resilience.faults.clear()
    yield torch.device("cuda", 0)
    mt.resilience.faults.clear()


def _sgd_updater():
    return mt.optimizer.get_updater(mt.optimizer.create(
        "sgd", learning_rate=0.1, momentum=0.9, wd=1e-4))


def test_guarded_update_is_captured_in_a_cuda_graph(card):
    rng = np.random.RandomState(0)
    w0 = rng.randn(256, 128).astype(np.float32)
    grads = [rng.randn(256, 128).astype(np.float32) for _ in range(3)]
    grads[1][3, 7] = np.nan

    # eager reference: three guarded updates
    ref = _sgd_updater()
    w_ref = mt.nd.array(w0, ctx=mt.gpu(0))
    eager = []
    for g in grads:
        ref(0, mt.nd.array(g, ctx=mt.gpu(0)), w_ref)
        eager.append((w_ref.asnumpy().copy(), ref.states[0].asnumpy().copy(),
                      ref.sentinel.read_step()))
    assert eager[0][2][0] and not eager[1][2][0] and eager[2][2][0]
    assert np.array_equal(eager[1][0], eager[0][0])
    assert np.array_equal(eager[1][1], eager[0][1])

    upd = _sgd_updater()
    w = mt.nd.array(w0, ctx=mt.gpu(0))
    g_in = mt.nd.array(grads[0], ctx=mt.gpu(0))
    upd(0, g_in, w)                     # creates the momentum state
    upd.sentinel.read_step()
    w[:] = w0
    upd.states[0][:] = 0.0
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        with torch.cuda.graph(graph):
            upd(0, g_in, w)
            ok, gsq = upd.sentinel._ok, upd.sentinel._gsq
            upd.sentinel._ok = upd.sentinel._gsq = None
    torch.cuda.current_stream().wait_stream(side)
    for g, (w_want, m_want, (ok_want, norm_want)) in zip(grads, eager):
        g_in._data.copy_(torch.from_numpy(g))
        graph.replay()
        torch.cuda.synchronize()
        assert np.array_equal(w.asnumpy(), w_want)
        assert np.array_equal(upd.states[0].asnumpy(), m_want)
        assert bool(ok.cpu()) == ok_want
        if ok_want:
            assert float(gsq.cpu()) ** 0.5 == pytest.approx(norm_want,
                                                            rel=1e-6)


def _mlp():
    s = mt.sym
    h = s.FullyConnected(s.Variable("data"), num_hidden=64, name="fc1")
    h = s.Activation(h, act_type="relu", name="relu1")
    h = s.FullyConnected(h, num_hidden=10, name="fc2")
    return s.SoftmaxOutput(h, name="softmax")


def test_scanned_verdicts_ride_the_chunk_pull(card, monkeypatch):
    monkeypatch.setenv("MXNET_TRAIN_SCAN_K", "4")
    monkeypatch.delenv("MXNET_SCAN_TRAIN", raising=False)
    # the chunk trainer draws once a step: step 6 (chunk 2) is poisoned
    mt.resilience.faults.inject("grad.nan:error:skip=5:count=1")
    rng = np.random.RandomState(1)
    x = rng.randn(8 * 32, 20).astype(np.float32)
    y = rng.randint(0, 10, 8 * 32).astype(np.float32)
    pulls, drains, steps = [], [], []
    host_pull, run_chunk = mt_model._host_pull, fit_trainer.FitTrainer.run_chunk
    drain = mt.resilience.TrainingGuardian.drain_chunk

    def counted_pull(tensors):
        pulls.append(len(tensors))
        return host_pull(tensors)

    def strict_run_chunk(self, staged):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = run_chunk(self, staged)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        steps.append(self._last_flags)
        return out

    def counted_drain(self, flags, losses=None):
        drains.append(flags)
        return drain(self, flags, losses)

    monkeypatch.setattr(mt_model, "_host_pull", counted_pull)
    monkeypatch.setattr(fit_trainer.FitTrainer, "run_chunk", strict_run_chunk)
    monkeypatch.setattr(mt.resilience.TrainingGuardian, "drain_chunk",
                        counted_drain)
    m = mt.FeedForward(_mlp(), ctx=mt.gpu(0), num_epoch=1, learning_rate=0.1,
                       momentum=0.9, numpy_batch_size=32,
                       initializer=mt.initializer.Xavier())
    m.fit(mt.io.NDArrayIter(x, y, batch_size=32))
    # two chunks of 4: one pull each, holding the head and the two flags
    assert pulls == [3, 3] and len(drains) == 2
    oks = np.concatenate([np.asarray(f[0]) for f in drains])
    assert oks.tolist() == [True] * 5 + [False] + [True] * 2
    assert all(np.isfinite(v.asnumpy()).all() for v in m.arg_params.values())
    # the flags were device tensors when queued
    assert all(f[0].is_cuda and f[0].shape == (4,) for f in steps)
