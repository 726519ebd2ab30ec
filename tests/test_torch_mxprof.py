"""mxprof (``telemetry/prof.py``) of the port against the JAX package's,
on the CPU.

- ``graph_cost`` of LeNet (batch 64, 28x28), ResNet-50 and Inception-BN
  (batch 128, 224x224, 1000 classes) — analytic, so full width is cheap
  here: every node's FLOPs, bytes and output shape, the totals, the
  parameter bytes and the unresolved count equal the JAX package's;
- ``note_step``: the same phases give the same ``step_breakdown``
  journal records, key for key and value for value apart from the time
  stamp, the same classifications, histograms and ``step_summary``;
  with prof off it records nothing;
- ``symbol_fingerprint``/``graph_hash`` equal the JAX package's;
  ``attribute_program`` records a program once (a memo hit records
  nothing), its analytic FLOPs feed ``derived()``'s MFU against the
  H100's 989e12 (``MXNET_PROF_PEAK_FLOPS`` overrides), and the key scheme
  is ``<torch|cuda|device>|<site>|g=<graph>``;
- a scanned and a per-batch LeNet fit and a served request under
  ``MXNET_PROF=1``: ``train.scanned``, ``train.batch``, ``serve.prefill``
  and ``serve.decode`` land in ``step_summary`` with the JAX fit's step
  and batch counts (the first call of each program left out), the
  programs carry their analytic FLOPs, and ``/profilez``'s body is
  ``snapshot()``.
"""
import json
import os

import jax
import numpy as np
import pytest

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu.telemetry import prof as jprof
from mxnet_tpu_torch.telemetry import prof

BATCH = 16


@pytest.fixture(scope="module", autouse=True)
def _env():
    prev = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    with pytest.MonkeyPatch.context() as mp:
        for k in ("MXNET_ENGINE_VERIFY", "MXNET_PROF",
                  "MXNET_SCAN_TRAIN", "MXNET_GUARDIAN", "MXNET_FAULT_SPEC",
                  "MXNET_PROF_PEAK_FLOPS", "MXNET_PROF_HBM_GBPS",
                  "MXNET_COMPUTE_DTYPE"):
            mp.delenv(k, raising=False)
        mp.setenv("MXNET_TRAIN_SCAN_K", "4")
        yield
    jax.config.update("jax_disable_most_optimizations", prev)
    jax.clear_caches()


@pytest.fixture()
def prof_on(monkeypatch):
    """mxprof (and telemetry, journal-less) on in both packages; reset
    and restored after."""
    monkeypatch.setenv("MXNET_PROF", "1")
    monkeypatch.setenv("MXNET_TELEMETRY", "1")
    monkeypatch.delenv("MXNET_TELEMETRY_JOURNAL", raising=False)
    monkeypatch.delenv("MXNET_TELEMETRY_HTTP", raising=False)
    for t in (mj.telemetry, mt.telemetry):
        t.reset()
        t.reload()
    assert prof.ENABLED and jprof.ENABLED
    yield
    monkeypatch.undo()
    for t in (mj.telemetry, mt.telemetry):
        t.reset()
        t.reload()


NETS = {
    "lenet": (lambda pkg: pkg.models.get_lenet(),
              {"data": (64, 1, 28, 28), "softmax_label": (64,)}),
    "resnet50": (lambda pkg: pkg.models.get_resnet(1000, 50),
                 {"data": (128, 3, 224, 224), "softmax_label": (128,)}),
    "inception_bn": (lambda pkg: pkg.models.get_inception_bn(1000),
                     {"data": (128, 3, 224, 224), "softmax_label": (128,)}),
}


def _build(name, pkg):
    """The net under a fresh name scope: an unnamed node's automatic
    name counts the nodes built before it in the process."""
    with pkg.NameManager():
        return NETS[name][0](pkg)


@pytest.mark.parametrize("name", sorted(NETS))
def test_graph_cost_equals_jax(name):
    shapes = NETS[name][1]
    got = prof.graph_cost(_build(name, mt), shapes)
    want = jprof.graph_cost(_build(name, mj), shapes)
    assert got == want
    assert got["flops"] > 0 and got["unresolved"] == 0
    types = {"data": np.float32, "softmax_label": np.float32}
    assert prof.graph_cost(_build(name, mt), shapes, types) == \
        jprof.graph_cost(_build(name, mj), shapes, types)


def test_fingerprint_and_hash_equal_jax():
    assert prof.symbol_fingerprint(_build("lenet", mt)) == \
        jprof.symbol_fingerprint(_build("lenet", mj))
    assert prof.graph_hash("abc|1") == jprof.graph_hash("abc|1")


PHASE_SETS = [
    {"host": 0.010, "dispatch": 0.002, "device": 0.050, "d2h": 0.001},
    {"host": 0.030, "dispatch": 0.002, "device": 0.004, "d2h": 0.001},
    {"host": 0.001, "dispatch": 0.020, "device": 0.004, "d2h": 0.001},
    {"host": 0.001, "dispatch": 0.001, "device": 0.001, "d2h": 0.009,
     "update": 0.002},
    {"host": 0.001, "dispatch": 0.001, "device": 0.001, "update": 0.02},
]


def _records(p, monkeypatch):
    out = []
    from importlib import import_module

    exp = import_module(p.__name__.rsplit(".", 1)[0] + ".export")
    monkeypatch.setattr(exp, "emit", out.append)
    for i, ph in enumerate(PHASE_SETS):
        p.note_step("train.batch" if i % 2 else "serve.decode", ph,
                    key="k|%d" % (i % 2), batches=1 + i, samples=8 * i,
                    tokens=(4 if i == 2 else None),
                    d2h_bytes=(16 if i == 3 else None))
    return out


def test_note_step_records_equal_jax(prof_on, monkeypatch):
    got = _records(prof, monkeypatch)
    want = _records(jprof, monkeypatch)
    assert len(got) == len(want) == len(PHASE_SETS)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert {k: v for k, v in g.items() if k != "t"} == \
            {k: v for k, v in w.items() if k != "t"}
    assert [r["bound"] for r in got] == ["compute", "input", "host", "host",
                                         "host"]
    assert prof.step_summary() == jprof.step_summary()
    names = {n for n in mt.telemetry.snapshot()["histograms"]
             if n.startswith("prof.")}
    assert names == {n for n in mj.telemetry.snapshot()["histograms"]
                     if n.startswith("prof.")}
    assert "prof.step.update_secs" in names


def test_note_step_off_records_nothing():
    assert not prof.ENABLED
    assert prof.note_step("x", {"host": 1.0}) is None
    assert prof.step_summary() == {}


def test_attribute_program_and_derived(prof_on, monkeypatch):
    an = prof.graph_cost(mt.models.get_lenet(),
                         {"data": (64, 1, 28, 28), "softmax_label": (64,)})
    f = object()
    assert prof.attribute_program("site|x", f, site="s", analytic=an,
                                  graph_key="g1") is f
    n = prof.attribution_count()
    prof.attribute_program("site|x", f, site="s", analytic=an,
                           graph_key="g1")
    assert prof.attribution_count() == n
    key = prof.program_key_for("site|x", graph_key="g1")
    assert key == "%s|site|x|g=g1" % prof.config_key_prefix()
    # the compile layer's key, as the JAX package's prof keys programs
    from mxnet_tpu_torch import compile as mxc

    assert prof.config_key_prefix() == mxc.config_key()
    prof.note_step("train.batch", {"device": 0.5, "host": 0.1}, key=key)
    (rec,) = prof.program_records()
    assert rec["flops"] == an["flops"] and rec["calls"] == 1
    assert rec["analytic"]["flops_train"] == 3 * an["flops"]
    d = prof.derived()
    assert d["peak_flops"] == 989e12 and d["hbm_gbps"] == 3350.0
    assert d["mfu"] == pytest.approx(an["flops"] / 0.5 / 989e12)
    monkeypatch.setenv("MXNET_PROF_PEAK_FLOPS", "1e12")
    assert prof.derived()["mfu"] == pytest.approx(an["flops"] / 0.5 / 1e12)
    snap = prof.snapshot()
    assert set(snap) == set(jprof.snapshot())
    assert json.loads(json.dumps(snap))["enabled"] is True
    assert snap["hbm"]["source"] in ("none", "first_call_peak")


def _lenet_fit(pkg, scan):
    rng = np.random.RandomState(3)
    x = rng.rand(5 * BATCH, 1, 28, 28).astype(np.float32)
    y = rng.randint(0, 10, 5 * BATCH).astype(np.float32)
    os.environ["MXNET_SCAN_TRAIN"] = "1" if scan else "0"
    try:
        pkg.random.seed(0)
        m = pkg.FeedForward(pkg.models.get_lenet(), ctx=pkg.cpu(),
                            num_epoch=2, learning_rate=0.05,
                            initializer=pkg.initializer.Xavier(),
                            numpy_batch_size=BATCH)
        m.fit(pkg.io.NDArrayIter(x, y, batch_size=BATCH))
    finally:
        os.environ.pop("MXNET_SCAN_TRAIN", None)


def test_fits_and_serving_land_step_breakdowns(prof_on):
    for pkg in (mt, mj):
        _lenet_fit(pkg, scan=True)
        _lenet_fit(pkg, scan=False)
    got, want = prof.step_summary(), jprof.step_summary()
    assert set(got) == set(want) == {"train.scanned", "train.batch"}
    for path in got:
        assert (got[path]["count"], got[path]["batches"]) == \
            (want[path]["count"], want[path]["batches"]), path
    sites = {r["site"] for r in prof.program_records()}
    assert {"fit_trainer.scan", "executor.fwd_bwd"} <= sites
    for r in prof.program_records():
        assert r["flops"] > 0, r["site"]
    scans = {r["meta"]["K"]: r for r in prof.program_records()
             if r["site"] == "fit_trainer.scan"}
    assert sorted(scans) == [1, 4] and scans[4]["calls"] == 1
    assert scans[4]["flops"] == 4 * scans[1]["flops"]
    assert prof.derived()["mfu"] > 0

    from mxnet_tpu_torch.models import transformer as tt
    from mxnet_tpu_torch.serving import Engine, ServingConfig

    cfg = tt.TransformerConfig(vocab_size=61, num_layers=2, d_model=32,
                               num_heads=2, d_ff=64, max_seq_len=96,
                               dtype="float32")
    import torch

    params = tt.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    eng = Engine(params, cfg, ServingConfig(block_size=8, num_blocks=64,
                                            max_batch=4, prefill_chunk=16),
                 device="cpu")
    for _ in range(2):
        eng.submit(np.arange(1, 40, dtype=np.int32) % 61, max_new_tokens=6)
        eng.run_until_idle()
    steps = prof.step_summary()
    assert {"serve.prefill", "serve.decode"} <= set(steps)
    assert all(r["flops"] > 0 for r in prof.program_records()
               if r["site"] == "serving.step")
    from mxnet_tpu_torch.telemetry import server

    ctype, body = server._profilez({})
    assert json.loads(body)["steps"].keys() == prof.snapshot()["steps"].keys()
