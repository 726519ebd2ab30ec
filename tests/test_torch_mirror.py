"""Mirroring (gradient checkpointing) in the port's executor against the
JAX package's, on the CPU.

A small graph (two 3x3 convolutions of 8 filters, each with BatchNorm
and relu, a Dropout of 0.5 between them, max pooling, FC 10,
SoftmaxOutput; batch 4 at 12x12) under four settings: the
``force_mirroring`` attribute on the second block, ``MXNET_BACKWARD_
DO_MIRROR=1``, ``MXNET_BACKWARD_MIRROR_PATTERN="BatchNorm|Activation"``
and ``MXNET_BACKWARD_MIRROR_STEP=3`` with mirroring on:

- the port's plan equals the JAX executor's ``_plan``, item for item
  (serials, each segment's external inputs and live outputs as (serial,
  output), aux window, random serials);
- a mirrored step equals the unmirrored one bit for bit in the port
  (outputs, every gradient, BatchNorm's moving statistics, the Dropout
  output read by a monitor tap, which fires once a forward), at four
  torch threads, set and restored;
- a mirrored step matches the JAX package's mirrored step within rtol
  1e-4, atol 1e-5 (f32 both sides, summation order only; the JAX
  package's monitor replays the forward under a key of its own, so its
  taps are not compared);
- a counting ``CustomOp`` runs its forward once a step under
  ``MXNET_BACKWARD_DO_MIRROR=1``, and host ops and stateful torch
  modules close segments; SoftmaxOutput, a loss head ending a segment,
  runs once a mirrored step;
- the scanned ``FeedForward.fit`` (K = 4, 2 epochs of 5 batches) with
  mirroring matches the unmirrored fit within relative L2 1e-4 a
  parameter, and its trainer runs a mirror plan;
- ``examples/memcost_torch/lstm_memcost.py``'s ``remat_segments`` equal
  the JAX example's, and mirroring cuts the bytes saved for backward.
"""
import importlib.util
import os
from unittest import mock

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt

RTOL, ATOL = 1e-4, 1e-5
SHAPES = {"data": (4, 3, 12, 12), "softmax_label": (4,)}
ENV_KEYS = ("MXNET_BACKWARD_DO_MIRROR", "MXNET_BACKWARD_MIRROR_PATTERN",
            "MXNET_BACKWARD_MIRROR_STEP")
SETTINGS = {
    "force_mirroring": ({}, True),
    "do_mirror": ({"MXNET_BACKWARD_DO_MIRROR": "1"}, False),
    "pattern": ({"MXNET_BACKWARD_MIRROR_PATTERN": "BatchNorm|Activation"},
                False),
    "step": ({"MXNET_BACKWARD_DO_MIRROR": "1",
              "MXNET_BACKWARD_MIRROR_STEP": "3"}, False),
}


@pytest.fixture(scope="module", autouse=True)
def _env():
    """Four torch threads (the bitwise comparisons repeat only at one
    thread count), the mirror variables unset unless a test sets them,
    torch's CPU ``exp`` warmed (its first multithreaded call can err by
    1.5e-4), and the JAX references compiled without XLA's passes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    torch.exp(torch.randn(100000))
    prev = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    with pytest.MonkeyPatch.context() as mp:
        for k in ENV_KEYS:
            mp.delenv(k, raising=False)
        yield
    jax.config.update("jax_disable_most_optimizations", prev)
    jax.clear_caches()
    torch.set_num_threads(threads)


def _net(pkg, attr=False):
    s = pkg.sym
    with pkg.NameManager():
        x = s.Convolution(s.Variable("data"), num_filter=8, kernel=(3, 3),
                          pad=(1, 1), name="c1")
        x = s.Activation(s.BatchNorm(x, fix_gamma=False, name="bn1"),
                         act_type="relu", name="r1")
        x = s.Dropout(x, p=0.5, name="drop")
        scope = pkg.AttrScope(force_mirroring="True") if attr \
            else pkg.AttrScope()
        with scope:
            x = s.Convolution(x, num_filter=8, kernel=(3, 3), pad=(1, 1),
                              name="c2")
            x = s.Activation(s.BatchNorm(x, fix_gamma=False, name="bn2"),
                             act_type="relu", name="r2")
        x = s.Pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="max",
                      name="pool")
        x = s.FullyConnected(s.Flatten(x, name="flat"), num_hidden=10,
                             name="fc")
        return s.SoftmaxOutput(x, name="softmax")


def _values():
    sym = _net(mt)
    arg_shapes, _, aux_shapes = sym.infer_shape(**SHAPES)
    rng = np.random.RandomState(0)
    args = {}
    for n, shp in zip(sym.list_arguments(), arg_shapes):
        if n == "softmax_label":
            args[n] = rng.randint(0, 10, shp).astype(np.float32)
        elif n == "data":
            args[n] = rng.rand(*shp).astype(np.float32)
        else:
            args[n] = (rng.randn(*shp) * 0.3).astype(np.float32)
    aux = {n: (rng.rand(*shp) + 0.5 if n.endswith("var")
               else rng.randn(*shp) * 0.1).astype(np.float32)
           for n, shp in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


ARGS, AUX = _values()


def _bind(pkg, setting):
    env, attr = SETTINGS[setting] if setting else ({}, False)
    with mock.patch.dict(os.environ, env):
        exe = _net(pkg, attr).simple_bind(pkg.cpu(), grad_req="write",
                                          **SHAPES)
    for n, v in ARGS.items():
        exe.arg_dict[n][:] = v
    for n, v in AUX.items():
        exe.aux_dict[n][:] = v
    return exe


def _step(pkg, setting):
    """One training forward and backward under ``random.seed(3)``:
    (outputs, gradients, aux states, the Dropout outputs tapped)."""
    exe = _bind(pkg, setting)
    taps = []
    exe.set_monitor_callback(
        lambda name, arr: taps.append(arr.asnumpy())
        if name == "drop_output" else None)
    pkg.random.seed(3)
    exe.forward(is_train=True)
    exe.backward()
    return ([o.asnumpy() for o in exe.outputs],
            {n: g.asnumpy() for n, g in exe.grad_dict.items()},
            {n: a.asnumpy() for n, a in exe.aux_dict.items()}, taps)


def _plan(exe):
    serial = {id(n): i for i, n in enumerate(exe._nodes)}
    out = []
    for item in exe._plan:
        if item[0] == "node":
            out.append(item)
            continue
        _, serials, ext, outs, aux_ids, rng = item
        out.append(("seg", tuple(serials),
                    tuple((serial[k], i) for k, i in ext),
                    tuple((serial[k], i) for k, i in outs),
                    tuple(aux_ids), tuple(rng)))
    return out


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_plan_equals_the_jax_executors(setting):
    got, want = _plan(_bind(mt, setting)), _plan(_bind(mj, setting))
    assert any(item[0] == "seg" for item in got)
    assert got == want


def test_no_mirror_gives_a_plan_without_segments():
    exe = _bind(mt, None)
    assert not exe._remat
    assert exe._plan == [("node", i) for i in range(len(exe._nodes))]


@pytest.fixture(scope="module")
def unmirrored():
    return _step(mt, None)


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_mirrored_step_is_bit_equal_to_unmirrored(unmirrored, setting):
    outs, grads, aux, taps = _step(mt, setting)
    w_outs, w_grads, w_aux, w_taps = unmirrored
    for a, b in zip(outs, w_outs):
        np.testing.assert_array_equal(a, b)
    assert sorted(grads) == sorted(w_grads)
    for n in w_grads:
        np.testing.assert_array_equal(grads[n], w_grads[n], err_msg=n)
    for n in w_aux:
        np.testing.assert_array_equal(aux[n], w_aux[n], err_msg=n)
    assert len(taps) == len(w_taps) == 1   # a tap fires once a forward
    np.testing.assert_array_equal(taps[0], w_taps[0])
    assert (taps[0] == 0).mean() > 0.3     # the Dropout drew a mask


@pytest.mark.parametrize("setting", ["do_mirror", "force_mirroring"])
def test_mirrored_step_matches_jax(setting):
    got, want = _step(mt, setting), _step(mj, setting)
    for a, b in zip(got[0], want[0]):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    for part in (1, 2):
        for n in want[part]:
            np.testing.assert_allclose(got[part][n], want[part][n],
                                       rtol=RTOL, atol=ATOL, err_msg=n)


def test_loss_head_runs_once_a_mirrored_step():
    """SoftmaxOutput ends the last segment: it runs after the
    checkpointed part, so the backward does not run it (K1 on the card)
    again."""
    from mxnet_tpu_torch.ops import loss as loss_mod

    calls = []
    real = loss_mod._forward

    def counted(params, data):
        calls.append(1)
        return real(params, data)

    exe = _bind(mt, "do_mirror")
    with mock.patch.object(loss_mod, "_forward", counted):
        exe.forward(is_train=True)
        exe.backward()
    assert len(calls) == 1


# -- what must run once a step ------------------------------------------------
FORWARDS = []


class _Count(mt.operator.CustomOp):
    def forward(self, is_train, req, in_data, out_data, aux):
        FORWARDS.append(1)
        self.assign(out_data[0], req[0], in_data[0].asnumpy() * 2.0)

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        self.assign(in_grad[0], req[0], out_grad[0].asnumpy() * 2.0)


@mt.operator.register("t_mirror_count")
class _CountProp(mt.operator.CustomOpProp):
    def __init__(self):
        super().__init__(need_top_grad=True)

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]], []

    def create_operator(self, ctx, shapes, dtypes):
        return _Count()


def _host_net():
    s = mt.sym
    with mt.NameManager():
        x = s.FullyConnected(s.Variable("data"), num_hidden=16, name="fc1")
        x = s.Activation(x, act_type="tanh", name="t1")
        x = s.Custom(x, op_type="t_mirror_count", name="count")
        x = s.Activation(x, act_type="relu", name="r1")
        x = s.TorchModule(x, module_string="torch.nn.Linear(16, 16)",
                          num_data=1, num_params=2, num_outputs=1,
                          name="lin")
        x = s.Activation(x, act_type="relu", name="r2")
        x = s.TorchModule(x, module_string="torch.nn.BatchNorm1d(16)",
                          num_data=1, num_params=2, num_outputs=1,
                          name="bn")
        x = s.FullyConnected(x, num_hidden=4, name="fc2")
        return s.SoftmaxOutput(x, name="softmax")


def test_host_ops_and_stateful_modules_run_once_a_step():
    sym = _host_net()
    shapes = {"data": (6, 8), "softmax_label": (6,)}
    with mock.patch.dict(os.environ, {"MXNET_BACKWARD_DO_MIRROR": "1"}):
        exe = sym.simple_bind(mt.cpu(), grad_req="write", **shapes)
    ref = sym.simple_bind(mt.cpu(), grad_req="write", **shapes)
    rng = np.random.RandomState(1)
    for n, a in exe.arg_dict.items():
        v = (rng.randint(0, 4, a.shape) if n == "softmax_label"
             else rng.randn(*a.shape) * 0.5)
        a[:] = v
        ref.arg_dict[n][:] = v
    names = [n.name for n in exe._nodes]
    inside = {names[s] for item in exe._plan if item[0] == "seg"
              for s in item[1]}
    assert {"fc1", "t1", "r1", "lin", "r2", "fc2", "softmax"} <= inside
    assert not {"count", "bn"} & inside
    del FORWARDS[:]
    for _ in range(3):
        exe.forward(is_train=True)
        exe.backward()
    assert len(FORWARDS) == 3
    ref.forward(is_train=True)
    ref.backward()
    for n, g in ref.grad_dict.items():
        np.testing.assert_array_equal(exe.grad_dict[n].asnumpy(),
                                      g.asnumpy(), err_msg=n)


# -- the scanned fit ------------------------------------------------------------
def _fit(mirror):
    rng = np.random.RandomState(5)
    x = rng.rand(40, 3, 12, 12).astype(np.float32)
    y = rng.randint(0, 10, 40).astype(np.float32)
    it = mt.io.NDArrayIter(x, y, batch_size=8, shuffle=False)
    seen = []
    real = mt.parallel.fit_trainer.FitTrainer.__init__

    def init(self, *a, **kw):
        real(self, *a, **kw)
        seen.append(self._run.__self__._remat)

    env = {"MXNET_TRAIN_SCAN_K": "4"}
    if mirror:
        env["MXNET_BACKWARD_DO_MIRROR"] = "1"
    mt.random.seed(2)
    model = mt.FeedForward(
        _net(mt), ctx=mt.cpu(), num_epoch=2,
        optimizer=mt.optimizer.SGD(learning_rate=0.1, momentum=0.9,
                                   rescale_grad=1 / 8.0),
        arg_params={k: mt.nd.array(v, ctx=mt.cpu()) for k, v in ARGS.items()
                    if k not in SHAPES},
        aux_params={k: mt.nd.array(v, ctx=mt.cpu()) for k, v in AUX.items()})
    with mock.patch.dict(os.environ, env), mock.patch.object(
            mt.parallel.fit_trainer.FitTrainer, "__init__", init):
        os.environ.pop("MXNET_SCAN_TRAIN", None)
        model.fit(X=it)
    return model, seen


def test_scanned_mirrored_fit_matches_unmirrored():
    plain, seen_plain = _fit(False)
    mirrored, seen = _fit(True)
    assert seen_plain == [False] and seen == [True]
    for n, v in plain.arg_params.items():
        a, b = mirrored.arg_params[n].asnumpy(), v.asnumpy()
        assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b), n
    for n, v in plain.aux_params.items():
        a, b = mirrored.aux_params[n].asnumpy(), v.asnumpy()
        assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b), n


# -- examples/memcost_torch ----------------------------------------------------
def _example(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_lstm_memcost_matches_the_jax_example():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = _example(os.path.join(root, "examples", "memcost_torch",
                                 "lstm_memcost.py"), "memcost_port")
    ref = _example(os.path.join(root, "examples", "memcost",
                                "lstm_memcost.py"), "memcost_jax")
    got = {m: port.residual_bytes(port.build(8, m), 8, batch=4)
           for m in (False, True)}
    want = {m: ref.residual_bytes(ref.build(8, m), 8, batch=4)
            for m in (False, True)}
    assert got[False][1] == want[False][1] == 0
    assert got[True][1] == want[True][1] > 0
    assert 0 < got[True][0] < got[False][0]
