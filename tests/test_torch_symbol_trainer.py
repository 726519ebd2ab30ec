"""ResNet's s2d stem and the fused Symbol train step against the JAX
package's, on the CPU.

- ``Pad`` (constant on axes 2-3 and on all axes; edge and reflect on
  axes 2-3, pads longer than the axis included) and ``transpose``
  (``axes=()``, a 4-D swap, the stem's 6-D permutation): outputs equal
  to the JAX ops', input gradients of a random cotangent within 1e-6,
  inferred shapes equal;
- the s2d stem: at image 224, batch 1, its output equals the 7x7/s2
  stem's under ``fold_stem_weights`` (rtol/atol 1e-5, the JAX package's
  ``tests/unittest/test_models.py``); ``conv0_conv_weight`` infers
  ``(64, 12, 4, 4)`` in ResNet-50 (its JSON bytes are held in
  ``test_torch_symbol.py``);
- ``make_symbol_train_step`` on a small s2d net (the stem, BatchNorm,
  pooling, FC, SoftmaxOutput; image 32, batch 4) against the JAX step
  with ``optax.sgd(0.05, momentum=0.9)``: the initial state bit-equal for
  the same seed; three f32 steps, outputs rtol 1e-4 / atol 1e-5 and
  every parameter and aux state within relative L2 1e-5; three bf16 steps
  (bf16 images, ``compute_dtype="bfloat16"``), every head's dtype equal
  to JAX's, outputs and parameters within relative L2 2e-2 (BF16_TOL),
  each package's bf16-against-f32 gap within 2x of the other's;
- ``step.loop`` over K = 3 equals three ``step`` calls under
  ``threefry.split(key, 3)``; on a graph with ``Dropout`` the JAX
  ``loop``'s outputs and parameters (its masks) are met, and another key
  changes them;
- the refusals: a head that is not a loss op, a mesh of two devices.
"""
import jax
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu.models import resnet as resnet_j
from mxnet_tpu.ops import registry as reg_j
from mxnet_tpu.parallel.symbol_trainer import \
    make_symbol_train_step as make_step_j
from mxnet_tpu_torch import threefry
from mxnet_tpu_torch.models import resnet as resnet_t
from mxnet_tpu_torch.ops import registry as reg_t
from mxnet_tpu_torch.parallel import make_symbol_train_step as make_step_t

IMAGE, BATCH, CLASSES, STEPS, SEED = 32, 4, 10, 3, 3
SHAPES = {"data": (BATCH, 3, IMAGE, IMAGE), "softmax_label": (BATCH,)}
# bf16 against the JAX package's bf16: both round every product and
# activation to 8 bits of mantissa at slightly different points (torch
# sums bf16 reductions in f32, XLA's CPU pooling in bf16); measured over
# three steps: outputs 1.1e-2, parameters 7.8e-3 (fc1_weight), while
# each package's bf16 run sits 1.4e-2 (port) and 1.5e-2 (JAX) from its
# f32 run
BF16_TOL = 2e-2


@pytest.fixture(scope="module", autouse=True)
def _warm_cpu_math():
    """torch 2.13's CPU ``exp`` and ``tanh`` can err up to 1.5e-4 relative
    on their first multithreaded call in a process; one call of each on
    a large tensor first avoids it (ROADMAP, facts about the container)."""
    t = torch.randn(100000)
    torch.exp(t)
    torch.tanh(t)
    torch.rsqrt(t.abs() + 1)


@pytest.fixture(scope="module", autouse=True)
def _quick_jax_compiles():
    """The JAX references run a few times each: compile them without
    XLA's optimisation passes, and drop them when the module ends."""
    prev = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", prev)
    jax.clear_caches()


def _rel_l2(got, want):
    got, want = (np.asarray(a, np.float32) for a in (got, want))
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _np(t):
    """A port tensor or a JAX array as f32 numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t).astype(np.float32)


# -- Pad and transpose ---------------------------------------------------------
def _op_pair(name, params, x, seed=0):
    oj, ot = reg_j.get(name), reg_t.get(name)
    pj, pt = oj.parse_params(dict(params)), ot.parse_params(dict(params))
    yj, vjp = jax.vjp(lambda a: oj.apply(pj, [a], [], False, None)[0][0],
                      jax.numpy.asarray(x))
    cot = np.random.RandomState(seed).randn(*yj.shape).astype(np.float32)
    (gj,) = vjp(jax.numpy.asarray(cot))
    xt = torch.tensor(x, requires_grad=True)
    yt = ot.apply(pt, [xt], [], False, None)[0][0]
    (gt,) = torch.autograd.grad(yt, xt, torch.tensor(cot))
    np.testing.assert_array_equal(yt.detach().numpy(), np.asarray(yj))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-6,
                               atol=1e-6)
    assert ot.infer_shape(pt, [x.shape]) == oj.infer_shape(pj, [x.shape])


PADS = [("constant", (0, 0, 0, 0, 3, 3, 3, 3)),
        ("constant", (1, 2, 0, 1, 2, 1, 1, 3)),
        ("edge", (0, 0, 0, 0, 1, 2, 3, 1)),
        ("edge", (0, 0, 0, 0, 3, 3, 6, 7)),
        ("reflect", (0, 0, 0, 0, 1, 2, 3, 1)),
        ("reflect", (0, 0, 0, 0, 3, 3, 6, 7))]


@pytest.mark.parametrize("mode,pad_width", PADS,
                         ids=["%s-%d" % (m, i) for i, (m, _) in
                              enumerate(PADS)])
def test_pad_matches_jax(mode, pad_width):
    x = np.random.RandomState(1).randn(2, 3, 4, 5).astype(np.float32)
    _op_pair("Pad", {"mode": mode, "pad_width": pad_width,
                     "constant_value": 1.5}, x)


@pytest.mark.parametrize("axes,shape", [((), (2, 3, 4)),
                                        ((0, 2, 1, 3), (2, 3, 4, 5)),
                                        ((0, 1, 3, 5, 2, 4),
                                         (2, 3, 4, 2, 5, 2))])
def test_transpose_matches_jax(axes, shape):
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    _op_pair("transpose", {"axes": axes}, x)


# -- the s2d stem --------------------------------------------------------------
def test_s2d_stem_matches_conv7_under_folded_weights():
    rng = np.random.RandomState(0)
    x = rng.randn(1, 3, 224, 224).astype(np.float32)
    w7 = (rng.randn(64, 3, 7, 7) * 0.1).astype(np.float32)
    ref = mt.sym.Convolution(data=mt.sym.Variable("data"), num_filter=64,
                             kernel=(7, 7), stride=(2, 2), pad=(3, 3),
                             no_bias=True, name="conv0_conv")
    exe = ref.simple_bind(mt.cpu(), data=x.shape, grad_req="null")
    exe.arg_dict["conv0_conv_weight"][:] = w7
    y_ref = exe.forward(is_train=False, data=x)[0].asnumpy()
    s2d = resnet_t._s2d_stem(mt.sym.Variable("data"), "conv0")
    exe2 = s2d.simple_bind(mt.cpu(), data=x.shape, grad_req="null")
    assert exe2.arg_dict["conv0_conv_weight"].shape == (64, 12, 4, 4)
    exe2.arg_dict["conv0_conv_weight"][:] = resnet_t.fold_stem_weights(w7)
    y = exe2.forward(is_train=False, data=x)[0].asnumpy()
    assert y.shape == y_ref.shape == (1, 64, 112, 112)
    np.testing.assert_allclose(y, y_ref, rtol=1e-5, atol=1e-5)


def test_s2d_resnet50_infers_the_packed_stem_weight():
    sym = mt.models.get_resnet(1000, 50, stem="s2d")
    args, outs, _ = sym.infer_shape(data=(2, 3, 224, 224),
                                    softmax_label=(2,))
    arg = dict(zip(sym.list_arguments(), args))
    assert arg["conv0_conv_weight"] == (64, 12, 4, 4)
    assert outs == [(2, 1000)]


# -- make_symbol_train_step ----------------------------------------------------
def _s2d_net(pkg, resnet):
    s = pkg.sym
    with pkg.NameManager():
        conv = resnet._s2d_stem(s.Variable("data"), "conv0", image=IMAGE)
        bn = s.BatchNorm(data=conv, fix_gamma=False, eps=2e-5, momentum=0.9,
                         name="conv0_bn")
        act = s.Activation(data=bn, act_type="relu", name="conv0_relu")
        pool = s.Pooling(data=act, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                         pool_type="max", name="pool0")
        gap = s.Pooling(data=pool, global_pool=True, kernel=(7, 7),
                        pool_type="avg", name="pool1")
        fc = s.FullyConnected(data=s.Flatten(data=gap, name="flat"),
                              num_hidden=CLASSES, name="fc1")
        return s.SoftmaxOutput(data=fc, name="softmax")


def _batches(steps=STEPS, bf16=False):
    rng = np.random.RandomState(4)
    x = rng.rand(steps, BATCH, 3, IMAGE, IMAGE).astype(np.float32)
    y = rng.randint(0, CLASSES, (steps, BATCH)).astype(np.float32)
    if bf16:
        x = x.astype(ml_dtypes.bfloat16)
    return x, y


def _run_jax(cdt):
    step, state = make_step_j(
        _s2d_net(mj, resnet_j), SHAPES, optimizer=optax.sgd(0.05, momentum=0.9),
        compute_dtype=cdt, ctx=mj.cpu(), donate=False, seed=SEED)
    init = ({k: np.asarray(v) for k, v in state["params"].items()},
            [np.asarray(a) for a in state["aux"]])
    x, y = _batches(bf16=cdt is not None)
    outs = []
    for i in range(STEPS):
        state, o = step(state, {"data": x[i], "softmax_label": y[i]},
                        jax.random.PRNGKey(i))
        outs.append(o)
    return init, outs, state


def _run_port(cdt):
    step, state = make_step_t(_s2d_net(mt, resnet_t), SHAPES,
                              compute_dtype=cdt, ctx=mt.cpu(), seed=SEED)
    init = ({k: v.numpy().copy() for k, v in state["params"].items()},
            [a.numpy().copy() for a in state["aux"]])
    x, y = _batches(bf16=cdt is not None)
    outs = []
    for i in range(STEPS):
        state, o = step(state, {"data": x[i], "softmax_label": y[i]},
                        threefry.prng_key(i, device="cpu"))
        outs.append(o)
    return init, outs, state


@pytest.fixture(scope="module")
def runs():
    return {(pkg, cdt): run(cdt)
            for pkg, run in (("jax", _run_jax), ("port", _run_port))
            for cdt in (None, "bfloat16")}


def _final(state):
    return ({k: _np(v) for k, v in state["params"].items()},
            [_np(a) for a in state["aux"]])


def test_initial_state_bit_equal(runs):
    (pj, aj), _, _ = runs[("jax", None)]
    (pt, at), _, _ = runs[("port", None)]
    assert sorted(pt) == sorted(pj)
    for n in pj:
        assert pt[n].dtype == pj[n].dtype == np.float32
        np.testing.assert_array_equal(pt[n], pj[n], err_msg=n)
    for a, b in zip(at, aj):
        np.testing.assert_array_equal(a, b)


def test_f32_steps_match_jax(runs):
    _, outs_j, state_j = runs[("jax", None)]
    _, outs_t, state_t = runs[("port", None)]
    for oj, ot in zip(outs_j, outs_t):
        assert [o.dtype for o in ot] == [torch.float32]
        np.testing.assert_allclose(_np(ot[0]), _np(oj[0]), rtol=1e-4,
                                   atol=1e-5)
    (pj, aj), (pt, at) = _final(state_j), _final(state_t)
    for n in pj:
        assert _rel_l2(pt[n], pj[n]) <= 1e-5, n
    for a, b in zip(at, aj):
        assert _rel_l2(a, b) <= 1e-5


def test_bf16_steps_match_jax(runs):
    _, outs_j, state_j = runs[("jax", "bfloat16")]
    _, outs_t, state_t = runs[("port", "bfloat16")]
    for oj, ot in zip(outs_j, outs_t):
        assert [str(o.dtype) for o in ot] == \
            ["torch." + str(o.dtype) for o in oj] == ["torch.bfloat16"]
        assert _rel_l2(_np(ot[0]), _np(oj[0])) <= BF16_TOL
    (pj, aj), (pt, at) = _final(state_j), _final(state_t)
    for n in pj:
        assert pt[n].dtype == np.float32
        assert _rel_l2(pt[n], pj[n]) <= BF16_TOL, n
    for a, b in zip(at, aj):
        assert _rel_l2(a, b) <= BF16_TOL


def _gap(runs, pkg):
    """Relative L2 between a package's bf16 and f32 runs, over every
    step's outputs and every parameter's change over the three steps."""
    (p0, _), o16, s16 = runs[(pkg, "bfloat16")]
    _, o32, s32 = runs[(pkg, None)]
    p16, p32 = _final(s16)[0], _final(s32)[0]

    def flat(outs, params):
        return np.concatenate([_np(o[0]).ravel() for o in outs]
                              + [(params[n] - p0[n]).ravel() for n in p0])

    return _rel_l2(flat(o16, p16), flat(o32, p32))


def test_bf16_gap_to_f32_as_jax(runs):
    gap_t, gap_j = _gap(runs, "port"), _gap(runs, "jax")
    assert 0 < gap_t <= 2 * gap_j and gap_j <= 2 * gap_t, (gap_t, gap_j)


def test_loop_equals_steps_under_split_keys():
    x, y = _batches()
    step, state_a = make_step_t(_s2d_net(mt, resnet_t), SHAPES, ctx=mt.cpu(),
                                seed=7)
    key = threefry.prng_key(5, device="cpu")
    keys = threefry.split(key, STEPS)
    outs_a = []
    for i in range(STEPS):
        state_a, o = step(state_a, {"data": x[i], "softmax_label": y[i]},
                          keys[i])
        outs_a.append(o[0])
    step2, state_b = make_step_t(_s2d_net(mt, resnet_t), SHAPES,
                                 ctx=mt.cpu(), seed=7)
    state_b, outs_b = step2.loop(state_b, {"data": x, "softmax_label": y},
                                 key)
    assert len(outs_b) == 1 and outs_b[0].shape == (STEPS, BATCH, CLASSES)
    np.testing.assert_allclose(outs_b[0].numpy(), torch.stack(outs_a).numpy(),
                               rtol=2e-5, atol=2e-6)
    for n in state_a["params"]:
        np.testing.assert_allclose(state_b["params"][n].numpy(),
                                   state_a["params"][n].numpy(),
                                   rtol=2e-5, atol=2e-6, err_msg=n)


def _dropout_net(pkg):
    s = pkg.sym
    with pkg.NameManager():
        h = s.Activation(s.FullyConnected(s.Variable("data"), num_hidden=32,
                                          name="fc1"), act_type="relu")
        h = s.Dropout(h, p=0.5, name="drop")
        return s.SoftmaxOutput(s.FullyConnected(h, num_hidden=CLASSES,
                                                name="fc2"), name="softmax")


def test_dropout_loop_draws_jax_masks():
    shapes = {"data": (8, 16), "softmax_label": (8,)}
    rng = np.random.RandomState(6)
    batches = {"data": rng.randn(STEPS, 8, 16).astype(np.float32),
               "softmax_label": rng.randint(0, CLASSES, (STEPS, 8))
               .astype(np.float32)}
    step_j, state_j = make_step_j(_dropout_net(mj), shapes,
                                  optimizer=optax.sgd(0.05, momentum=0.9),
                                  ctx=mj.cpu(), donate=False, seed=2)
    state_j, outs_j = step_j.loop(state_j, batches, jax.random.PRNGKey(9))
    got = {}
    for k in (9, 10):
        step_t, state_t = make_step_t(_dropout_net(mt), shapes, ctx=mt.cpu(),
                                      seed=2)
        got[k] = step_t.loop(state_t, batches,
                             threefry.prng_key(k, device="cpu"))
    state_t, outs_t = got[9]
    np.testing.assert_allclose(_np(outs_t[0]), _np(outs_j[0]), rtol=1e-5,
                               atol=1e-6)
    for n, v in state_j["params"].items():
        assert _rel_l2(_np(state_t["params"][n]), v) <= 1e-5, n
    assert _rel_l2(_np(got[10][1][0]), _np(outs_j[0])) > 1e-2


def test_non_loss_head_and_multi_device_mesh_refused():
    fc = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=4,
                               name="fc")
    with pytest.raises(mt.MXNetError, match="loss-op heads"):
        make_step_t(fc, {"data": (2, 3)}, ctx=mt.cpu())

    class TwoDevices:
        size = 2

    with pytest.raises(NotImplementedError):
        make_step_t(_dropout_net(mt), {"data": (8, 16),
                                       "softmax_label": (8,)},
                    ctx=mt.cpu(), mesh=TwoDevices())
