"""The port's host bridges against the JAX package's, on the CPU.

- ``Custom``: the same ``CustomOp``/``CustomOpProp`` classes, written once
  and registered in both packages, through a bound graph (a parameterised
  two-input op, a ``need_top_grad=False`` softmax loss as the head):
  outputs and every gradient within rtol 1e-5 (f32); a loss-semantics op
  that no gradient reaches still runs its backward; one operator per
  binding across forwards; ``is_train`` reaches the user's op; the
  monitor taps the host op's outputs; an argument written between the
  forward and ``backward`` leaves the gradients and the operator's draws
  as the JAX package's leave them, and ``backward`` after an inference
  forward, or a second time, raises as there;
- partial ``infer_shape`` (a label back-filled from the data) and the
  ``InferShapeFatal`` escalation of a prop's complaint;
- ``NumpyOp`` (the numpy-ops example's log-softmax loss) the same way;
- ``tojson()`` of graphs with ``Custom`` nodes and their keyword
  arguments, byte-equal;
- ``TorchModule`` and ``TorchCriterion`` from the same ``module_string``:
  outputs and gradients, and the 31 ``mx.th`` functions in both calling
  conventions; a TorchModule graph's ``FeedForward.fit`` on the port's
  scanned loop (the port's TorchModule is no host op) against the JAX
  package's per-batch fit, final parameters within relative L2 1e-5;
- the port's op registry holds the JAX package's 119 names;
- the port's gradients (the executor's ``backward`` and the symbol
  trainer's step) are taken with cuDNN held to its deterministic
  algorithms unless ``MXNET_ENFORCE_DETERMINISM=0``, and the flag is
  left as it was found.
"""
import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu.ops import registry as reg_j
from mxnet_tpu_torch.ops import registry as reg_t

RTOL, ATOL = 1e-5, 1e-6
PKGS = {"jax": mj, "port": mt}


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


def _register(mx):
    """The test's user ops, registered in ``mx``'s Custom registry;
    returns the list every created operator is appended to."""
    made = []

    class Affine(mx.operator.CustomOp):
        """y = data * gamma * factor + rng draw (a stateful operator)."""

        def __init__(self, factor):
            self.factor = factor
            self.rng = np.random.RandomState(5)
            self.seen = []
            made.append(self)

        def forward(self, is_train, req, in_data, out_data, aux):
            self.seen.append(bool(is_train))
            d, g = in_data[0].asnumpy(), in_data[1].asnumpy()
            noise = np.float32(self.rng.rand())
            self.assign(out_data[0], req[0],
                        d * g[None, :] * np.float32(self.factor) + noise)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            og = out_grad[0].asnumpy()
            d, g = in_data[0].asnumpy(), in_data[1].asnumpy()
            f = np.float32(self.factor)
            self.assign(in_grad[0], req[0], og * g[None, :] * f)
            self.assign(in_grad[1], req[1], (og * d).sum(axis=0) * f)

    @mx.operator.register("t_affine")
    class AffineProp(mx.operator.CustomOpProp):
        def __init__(self, factor="1.0"):
            super().__init__(need_top_grad=True)
            self.factor = float(factor)

        def list_arguments(self):
            return ["data", "gamma"]

        def infer_shape(self, in_shape):
            d = in_shape[0]
            return [d, [d[1]]], [d], []

        def create_operator(self, ctx, shapes, dtypes):
            return Affine(self.factor)

    class SoftmaxLoss(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            e = np.exp(x - x.max(axis=1, keepdims=True))
            self.assign(out_data[0], req[0], e / e.sum(axis=1, keepdims=True))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            lab = in_data[1].asnumpy().astype(int)
            g = out_data[0].asnumpy().copy()
            g[np.arange(len(lab)), lab] -= 1.0
            self.assign(in_grad[0], req[0], g)
            self.assign(in_grad[1], req[1], np.zeros_like(lab, np.float32))

    @mx.operator.register("t_softmax_loss")
    class SoftmaxLossProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            d = in_shape[0]
            return [d, [d[0]]], [d], []

        def create_operator(self, ctx, shapes, dtypes):
            return SoftmaxLoss()

    @mx.operator.register("t_even")
    class EvenProp(mx.operator.CustomOpProp):
        """Refuses an odd width: a complaint with every input known."""

        def infer_shape(self, in_shape):
            if in_shape[0][1] % 2:
                raise mx.base.MXNetError("width %d is odd" % in_shape[0][1])
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return SoftmaxLoss()

    class LogSoftmax(mx.operator.NumpyOp):
        """examples/numpy-ops' NumpyLogSoftmax over axis 1."""

        def __init__(self):
            super().__init__(False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]]

        def forward(self, in_data, out_data):
            x = in_data[0]
            shifted = x - x.max(axis=1, keepdims=True)
            out_data[0][:] = shifted - np.log(
                np.exp(shifted).sum(axis=1, keepdims=True))

        def backward(self, out_grad, in_data, out_data, in_grad):
            lab = in_data[1].astype(int)
            in_grad[0][:] = np.exp(out_data[0])
            in_grad[0][np.arange(len(lab)), lab] -= 1.0

    return made, LogSoftmax


@pytest.fixture(scope="module")
def ops():
    return {k: _register(mx) for k, mx in PKGS.items()}


def _net(mx, with_blocked_loss=False):
    x = mx.sym.Variable("x")
    fc = mx.sym.FullyConnected(x, num_hidden=6, name="fc")
    aff = mx.sym.Custom(data=fc, gamma=mx.sym.Variable("gamma"),
                        op_type="t_affine", factor="0.5", name="aff")
    act = mx.sym.Activation(aff, act_type="tanh", name="act")
    fc2 = mx.sym.FullyConnected(act, num_hidden=4, name="fc2")
    loss = mx.sym.Custom(data=fc2, label=mx.sym.Variable("label"),
                         op_type="t_softmax_loss", name="loss")
    if not with_blocked_loss:
        return loss
    # the loss's output reaches no head gradient: only its own backward
    # (need_top_grad=False) makes the gradients
    return mx.sym.Group([mx.sym.BlockGrad(loss, name="blocked"),
                         mx.sym.MakeLoss(mx.sym.sum(fc2) * 0.0, name="zero")])


def _values(net, seed=3):
    shapes, _, _ = net.infer_shape(x=(5, 7))
    rng = np.random.RandomState(seed)
    vals = {}
    for n, s in zip(net.list_arguments(), shapes):
        vals[n] = (rng.randint(0, 4, s).astype(np.float32) if n == "label"
                   else rng.randn(*s).astype(np.float32))
    return vals


def _bind(mx, net, vals, grad_req="write"):
    ctx = mx.cpu()
    args = {n: mx.nd.array(v, ctx=ctx) for n, v in vals.items()}
    grads = {n: mx.nd.zeros(v.shape, ctx=ctx) for n, v in vals.items()
             if n not in ("x", "label")}
    return net.bind(ctx, args, args_grad=grads, grad_req=grad_req)


def _step(mx, with_blocked_loss=False, monitor=None):
    net = _net(mx, with_blocked_loss)
    exe = _bind(mx, net, _values(net))
    if monitor is not None:
        exe.set_monitor_callback(monitor)
    outs = [o.asnumpy() for o in exe.forward(is_train=True)]
    exe.backward()
    return outs, {n: g.asnumpy() for n, g in exe.grad_dict.items()
                  if g is not None}


@pytest.mark.parametrize("blocked", [False, True],
                         ids=["loss_head", "no_top_grad_reaches_loss"])
def test_custom_graph_forward_backward_match_jax(ops, blocked):
    got = {k: _step(mx, blocked) for k, mx in PKGS.items()}
    (oj, gj), (ot, gt) = got["jax"], got["port"]
    for a, b in zip(ot, oj):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    assert sorted(gt) == sorted(gj)
    for n in gj:
        np.testing.assert_allclose(gt[n], gj[n], rtol=RTOL, atol=ATOL,
                                   err_msg=n)
    # the loss's own backward made real gradients, reached or not
    assert np.abs(gt["fc_weight"]).max() > 1e-3


def test_one_operator_per_binding_and_is_train(ops):
    seen = {}
    for k, mx in PKGS.items():
        made = ops[k][0]
        del made[:]
        net = _net(mx)
        exe = _bind(mx, net, _values(net))
        outs = []
        for is_train in (True, False, True):
            outs.append(exe.forward(is_train=is_train)[0].asnumpy())
        exe2 = _bind(mx, net, _values(net))
        exe2.forward(is_train=False)
        seen[k] = ([op.seen for op in made], outs)
    assert seen["port"][0] == seen["jax"][0] == [[True, False, True], [False]]
    for a, b in zip(seen["port"][1], seen["jax"][1]):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_monitor_taps_host_outputs(ops):
    taps = {}
    for k, mx in PKGS.items():
        got = {}
        mx.random.seed(0)
        _step(mx, monitor=lambda name, arr, got=got: got.setdefault(
            name, arr.asnumpy()))
        taps[k] = got
    assert "aff_output" in taps["port"] and "loss_output" in taps["port"]
    assert sorted(taps["port"]) == sorted(taps["jax"])
    # the JAX package's monitor replays the graph with a fresh operator,
    # whose first draw is the bound one's first: the taps agree
    for n in taps["jax"]:
        np.testing.assert_allclose(taps["port"][n], taps["jax"][n],
                                   rtol=RTOL, atol=ATOL, err_msg=n)


def test_written_argument_and_backward_order_follow_jax(ops):
    """An argument written between the forward and ``backward``: the
    gradients are the forward's and the operator draws nothing more; a
    second ``backward``, or one after an inference forward, raises."""
    res = {}
    for k, mx in PKGS.items():
        made = ops[k][0]
        del made[:]
        net = _net(mx)
        exe = _bind(mx, net, _values(net))
        exe.forward(is_train=True)
        exe.arg_dict["x"][:] = 7.0
        exe.arg_dict["fc_weight"][:] = 0.25
        exe.backward()
        grads = {n: g.asnumpy() for n, g in exe.grad_dict.items()
                 if g is not None}
        errs = []
        for first_forward in (None, False):
            if first_forward is not None:
                exe.forward(is_train=first_forward)
            with pytest.raises(mx.base.MXNetError) as e:
                exe.backward()
            errs.append(str(e.value))
        res[k] = grads, [len(op.seen) for op in made], errs
    gj, cj, ej = res["jax"]
    gt, ct, et = res["port"]
    assert ct == cj == [2]
    assert et == ej
    for n in gj:
        np.testing.assert_allclose(gt[n], gj[n], rtol=RTOL, atol=ATOL,
                                   err_msg=n)


def test_partial_infer_shape_back_fills_the_label(ops):
    res = {}
    for k, mx in PKGS.items():
        net = _net(mx)
        res[k] = net.infer_shape(x=(5, 7))
        part = net.infer_shape_partial(x=(5, 7))
        assert part == res[k]
    assert res["port"] == res["jax"]
    assert dict(zip(_net(mt).list_arguments(), res["port"][0]))["label"] \
        == (5,)


def test_prop_complaint_with_every_input_known_escalates(ops):
    msgs = {}
    for k, mx in PKGS.items():
        net = mx.sym.Custom(data=mx.sym.Variable("x"), op_type="t_even")
        assert net.infer_shape(x=(2, 4))[1] == [(2, 4)]
        with pytest.raises(mx.base.MXNetError) as e:
            net.infer_shape(x=(2, 3))
        msgs[k] = str(e.value)
    assert "Custom(t_even) infer_shape: width 3 is odd" in msgs["port"]
    assert msgs["port"] == msgs["jax"]


def test_numpy_op_matches_jax(ops):
    got = {}
    for k, mx in PKGS.items():
        op = ops[k][1]()
        x = mx.sym.Variable("x")
        fc = mx.sym.FullyConnected(x, num_hidden=5, name="fc")
        net = op(data=fc, label=mx.sym.Variable("label"), name="lsm")
        exe = _bind(mx, net, _values(net, seed=8))
        outs = exe.forward(is_train=True)[0].asnumpy()
        exe.backward()
        got[k] = outs, {n: g.asnumpy() for n, g in exe.grad_dict.items()
                        if g is not None}
        assert net.list_arguments() == ["x", "fc_weight", "fc_bias",
                                        "label"]
    np.testing.assert_allclose(got["port"][0], got["jax"][0], rtol=RTOL,
                               atol=ATOL)
    for n in got["jax"][1]:
        np.testing.assert_allclose(got["port"][1][n], got["jax"][1][n],
                                   rtol=RTOL, atol=ATOL, err_msg=n)
    assert mt.operator.NDArrayOp is mt.operator.NumpyOp
    assert mt.operator.PythonOp is mt.operator.NumpyOp


def test_custom_json_bytes_equal(ops):
    texts = {}
    for k, mx in PKGS.items():
        with mx.NameManager():
            texts[k] = (_net(mx).tojson(), _net(mx, True).tojson())
    assert texts["port"] == texts["jax"]
    assert '"op_type": "t_affine"' in texts["port"][0]
    back = mt.sym.load_json(texts["port"][0])
    assert back.tojson() == texts["port"][0]


def test_registry_holds_every_jax_op(ops):
    assert sorted(reg_t.REGISTRY) == sorted(reg_j.REGISTRY)
    assert len(reg_t.REGISTRY) == 119
    assert mt.ops.REGISTRY["Custom"].is_host_op
    # other test files in the process may register ops of their own in
    # either package: hold this file's to both registries
    for mx in PKGS.values():
        assert {"t_affine", "t_softmax_loss", "t_even"} <= set(
            mx.operator.get_all_registered())


# -- TorchModule, TorchCriterion, mx.th ----------------------------------------
MODULES = ["torch.nn.Linear(6, 4)",
           "torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.Tanh(), "
           "torch.nn.Linear(5, 3))",
           "torch.nn.Conv1d(2, 3, 2)"]


def _torch_module_step(mx, mstr, vals):
    data = mx.sym.Variable("data")
    out = mx.sym.TorchModule(data, module_string=mstr, num_data=1,
                             num_outputs=1, name="tm")
    net = mx.sym.MakeLoss(mx.sym.sum(mx.sym.square(out)), name="l")
    names = net.list_arguments()
    ctx = mx.cpu()
    args = {n: mx.nd.array(vals[n], ctx=ctx) for n in names}
    grads = {n: mx.nd.zeros(vals[n].shape, ctx=ctx) for n in names}
    exe = net.bind(ctx, args, args_grad=grads)
    exe.forward(is_train=True)
    exe.backward()
    inner = out.bind(ctx, args).forward()[0].asnumpy()
    return names, inner, {n: g.asnumpy() for n, g in grads.items()}


@pytest.mark.parametrize("mstr", MODULES, ids=["linear", "mlp", "conv1d"])
def test_torch_module_matches_jax(mstr):
    data_shape = (4, 2, 3) if "Conv1d" in mstr else (4, 6)
    net = mt.sym.TorchModule(mt.sym.Variable("data"), module_string=mstr,
                             num_outputs=1, name="tm")
    shapes, out_shapes, _ = net.infer_shape(data=data_shape)
    rng = np.random.RandomState(4)
    vals = {n: rng.randn(*s).astype(np.float32)
            for n, s in zip(net.list_arguments(), shapes)}
    nj, oj, gj = _torch_module_step(mj, mstr, vals)
    nt, ot, gt = _torch_module_step(mt, mstr, vals)
    assert nt == nj
    assert out_shapes == mj.sym.TorchModule(
        mj.sym.Variable("data"), module_string=mstr,
        num_outputs=1).infer_shape(data=data_shape)[1]
    np.testing.assert_allclose(ot, oj, rtol=RTOL, atol=ATOL)
    for n in nj:
        np.testing.assert_allclose(gt[n], gj[n], rtol=RTOL, atol=ATOL,
                                   err_msg=n)


@pytest.mark.parametrize("crit", ["torch.nn.MSELoss()",
                                  "torch.nn.SmoothL1Loss()"])
def test_torch_criterion_matches_jax(crit):
    rng = np.random.RandomState(6)
    d = rng.randn(5, 3).astype(np.float32)
    lab = rng.randn(5, 3).astype(np.float32)
    w = rng.randn(3, 3).astype(np.float32)
    got = {}
    for k, mx in PKGS.items():
        data = mx.sym.Variable("data")
        fc = mx.sym.FullyConnected(data, num_hidden=3, no_bias=True,
                                   name="fc")
        net = mx.sym.TorchCriterion(fc, mx.sym.Variable("label"),
                                    module_string=crit, grad_scale=0.5)
        ctx = mx.cpu()
        args = {"data": mx.nd.array(d, ctx=ctx),
                "fc_weight": mx.nd.array(w, ctx=ctx),
                "label": mx.nd.array(lab, ctx=ctx)}
        grads = {n: mx.nd.zeros(a.shape, ctx=ctx) for n, a in args.items()}
        exe = net.bind(ctx, args, args_grad=grads)
        out = exe.forward(is_train=True)[0].asnumpy()
        exe.backward()
        got[k] = out, {n: g.asnumpy() for n, g in grads.items()}
    assert got["port"][0].shape == (5,)
    np.testing.assert_allclose(got["port"][0], got["jax"][0], rtol=RTOL)
    for n in got["jax"][1]:
        np.testing.assert_allclose(got["port"][1][n], got["jax"][1][n],
                                   rtol=RTOL, atol=ATOL, err_msg=n)


def _th_inputs(name, arity, rng):
    if name in ("dot",):
        shapes = [(5,), (5,)]
    elif name == "mm":
        shapes = [(3, 4), (4, 2)]
    else:
        shapes = [(3, 4)] * arity
    vals = [rng.uniform(0.2, 0.9, s).astype(np.float32) for s in shapes]
    if name in ("round", "ceil", "floor", "trunc", "sign", "neg", "abs"):
        vals = [v * 6.0 - 3.0 for v in vals]
    return vals


@pytest.mark.parametrize("name", sorted(mt.torch_plugin._TH_FUNCS))
def test_th_function_matches_jax(name):
    assert mt.torch_plugin._TH_FUNCS == mj.torch_plugin._TH_FUNCS
    arity = mt.torch_plugin._TH_FUNCS[name]
    vals = _th_inputs(name, arity, np.random.RandomState(len(name)))
    got = {}
    for k, mx in PKGS.items():
        ins = [mx.nd.array(v, ctx=mx.cpu()) for v in vals]
        res = getattr(mx.th, name)(*ins).asnumpy()
        out = mx.nd.zeros(res.shape, ctx=mx.cpu())
        assert getattr(mx.th, name)(out, *ins) is out
        np.testing.assert_array_equal(out.asnumpy(), res)
        got[k] = res
    np.testing.assert_allclose(got["port"], got["jax"], rtol=RTOL, atol=ATOL)


def _torch_fit(pkg, monkeypatch):
    """A TorchModule layer under a native head through ``FeedForward.fit``
    from the same numpy parameters: 2 epochs of 4 batches, SGD with
    momentum; the port's default (scanned) loop against the JAX
    package's, which runs such a graph per batch."""
    monkeypatch.delenv("MXNET_SCAN_TRAIN", raising=False)
    monkeypatch.setenv("MXNET_TRAIN_SCAN_K", "4")
    s = pkg.sym
    with pkg.NameManager():
        h = s.TorchModule(s.Variable("data"), name="tfc1",
                          module_string="torch.nn.Linear(12, 16)")
        net = s.SoftmaxOutput(s.FullyConnected(
            s.Activation(h, act_type="relu"), num_hidden=4, name="fc2"),
            name="softmax")
    rng = np.random.RandomState(12)
    x = rng.randn(32, 12).astype(np.float32)
    y = rng.randint(0, 4, 32).astype(np.float32)
    shapes, _, _ = net.infer_shape(data=(8, 12))
    args = {n: (rng.randn(*sh) * 0.3).astype(np.float32)
            for n, sh in zip(net.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}
    built = []
    if pkg is mt:
        from mxnet_tpu_torch.parallel import fit_trainer
        real = fit_trainer.make_fit_trainer
        monkeypatch.setattr(fit_trainer, "make_fit_trainer",
                            lambda *a, **kw: built.append(1) or real(*a, **kw))
    model = pkg.FeedForward(
        net, ctx=pkg.cpu(), num_epoch=2, learning_rate=0.1, momentum=0.9,
        arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                    for k, v in args.items()})
    model.fit(X=pkg.io.NDArrayIter(x, y, batch_size=8, shuffle=False))
    monkeypatch.undo()
    return {k: v.asnumpy() for k, v in model.arg_params.items()}, built


def test_torch_module_scanned_fit_matches_jax_per_batch_fit(monkeypatch):
    (pj, _), (pt, built) = (_torch_fit(pkg, monkeypatch) for pkg in (mj, mt))
    assert built == [1]   # the port's scanned trainer takes the graph
    assert sorted(pt) == sorted(pj)
    for n in pj:
        rel = np.linalg.norm(pt[n] - pj[n]) / np.linalg.norm(pj[n])
        assert rel <= 1e-5, (n, rel)


DETERMINISM = [(None, True), ("1", True), ("0", False)]
DETERMINISM_IDS = ["default", "on", "off"]


def _determinism(monkeypatch, knob):
    if knob is None:
        monkeypatch.delenv("MXNET_ENFORCE_DETERMINISM", raising=False)
    else:
        monkeypatch.setenv("MXNET_ENFORCE_DETERMINISM", knob)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)


@pytest.mark.parametrize("knob,want", DETERMINISM, ids=DETERMINISM_IDS)
def test_executor_backward_holds_cudnn_deterministic(ops, monkeypatch,
                                                     knob, want):
    _determinism(monkeypatch, knob)
    seen = []
    real = reg_t._HostOpFn.backward

    def backward(ctx, *grads):
        seen.append(torch.backends.cudnn.deterministic)
        return real(ctx, *grads)

    monkeypatch.setattr(reg_t._HostOpFn, "backward", staticmethod(backward))
    _step(mt)
    assert seen and set(seen) == {want}
    assert torch.backends.cudnn.deterministic is False


@pytest.mark.parametrize("knob,want", DETERMINISM, ids=DETERMINISM_IDS)
def test_symbol_trainer_step_holds_cudnn_deterministic(monkeypatch, knob,
                                                       want):
    from mxnet_tpu_torch import threefry
    from mxnet_tpu_torch.parallel import make_symbol_train_step

    _determinism(monkeypatch, knob)
    seen = []
    real = torch.autograd.grad

    def grad(*a, **kw):
        seen.append(torch.backends.cudnn.deterministic)
        return real(*a, **kw)

    monkeypatch.setattr(torch.autograd, "grad", grad)
    net = mt.sym.SoftmaxOutput(mt.sym.FullyConnected(
        mt.sym.Variable("data"), num_hidden=3, name="fc"), name="softmax")
    step, st = make_symbol_train_step(
        net, {"data": (4, 5), "softmax_label": (4,)}, ctx=mt.cpu())
    step(st, {"data": np.ones((4, 5), np.float32),
              "softmax_label": np.zeros(4, np.float32)},
         threefry.prng_key(0, device="cpu"))
    assert seen and set(seen) == {want}
    assert torch.backends.cudnn.deterministic is False
