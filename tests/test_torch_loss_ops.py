"""The port's loss-layer ops and ``smooth_l1``/``SoftmaxActivation``
against the JAX package's, on the CPU.

- forward and the input gradients (the loss ops ignore the random head
  cotangent and write their own gradient) within rtol 1e-4, atol 1e-5
  (f32): ``smooth_l1`` (two sigmas), ``SoftmaxActivation`` (both modes),
  ``MakeLoss`` (null, batch and valid normalisation, a ``valid_thresh``,
  ``grad_scale`` 0), the three regression outputs, ``SVMOutput`` (the L1
  and the squared hinge), ``WarpCTC`` (repeated labels, a zero in
  mid-row, an all-zero row, T = 2L + 1);
- ``ctc_loss`` itself on the same cases;
- shape inference and error messages equal to the JAX op's.
"""
import jax
import numpy as np
import pytest
import torch

from mxnet_tpu.base import MXNetError as ErrJ
from mxnet_tpu.ops import loss as loss_j
from mxnet_tpu.ops import registry as reg_j
from mxnet_tpu_torch.base import MXNetError as ErrT
from mxnet_tpu_torch.ops import loss as loss_t
from mxnet_tpu_torch.ops import registry as reg_t

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module", autouse=True)
def _warm_cpu_math():
    """torch 2.13's CPU ``exp`` and ``tanh`` can err up to 1.5e-4 relative
    on their first multithreaded call in a process; one call of each on
    a large tensor first avoids it."""
    t = torch.randn(100000)
    torch.exp(t)
    torch.tanh(t)
    torch.sigmoid(t)


@pytest.fixture(scope="module", autouse=True)
def _quick_jax_compiles():
    """The JAX references run once each: compile them without XLA's
    optimisation passes, and drop what was compiled when the module
    ends."""
    prev = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", prev)
    jax.clear_caches()


def _ops(name, params):
    oj, ot = reg_j.get(name), reg_t.get(name)
    return oj, oj.parse_params(dict(params)), ot, ot.parse_params(dict(params))


def _check(name, params, inputs, diff=(0,)):
    """Outputs and the gradients of the inputs at ``diff`` for one random
    cotangent an output, the port's against the JAX op's."""
    oj, pj, ot, pt = _ops(name, params)

    def fj(*xs):
        full = list(inputs)
        for k, x in zip(diff, xs):
            full[k] = x
        return oj.apply(pj, [jax.numpy.asarray(v) for v in full], [],
                        True, None)[0]

    outs_j, vjp = jax.vjp(jax.jit(fj),
                          *[jax.numpy.asarray(inputs[k]) for k in diff])
    rng = np.random.RandomState(7)
    cots = [rng.randn(*o.shape).astype(np.float32) for o in outs_j]
    grads_j = vjp([jax.numpy.asarray(c) for c in cots])
    xs = [torch.tensor(x, requires_grad=k in diff)
          for k, x in enumerate(inputs)]
    outs_t, _ = ot.apply(pt, xs, [], True, None)
    grads_t = torch.autograd.grad(outs_t, [xs[k] for k in diff],
                                  [torch.tensor(c) for c in cots])
    for a, b in zip(outs_t + list(grads_t), list(outs_j) + list(grads_j)):
        a = a.detach().numpy()
        assert a.shape == b.shape
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=ATOL)
    return [np.asarray(g) for g in grads_j]


def _x(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


@pytest.mark.parametrize("scalar", [1.0, 3.0])
def test_smooth_l1_matches_jax(scalar):
    _check("smooth_l1", {"scalar": scalar}, [_x(4, 7, scale=1.5)])


@pytest.mark.parametrize("mode", ["instance", "channel"])
def test_softmax_activation_matches_jax(mode):
    _check("SoftmaxActivation", {"mode": mode}, [_x(3, 4, 5, scale=2.0)])


@pytest.mark.parametrize("params", [
    {},
    {"grad_scale": 2.5, "normalization": "batch"},
    {"normalization": "valid"},
    {"normalization": "valid", "valid_thresh": 0.5, "grad_scale": 0.3},
    {"normalization": "valid", "valid_thresh": 100.0},   # no valid input
    {"grad_scale": 0.0},
])
def test_make_loss_matches_jax(params):
    x = np.abs(_x(4, 6))
    x[:, ::2] = 0.0
    _check("MakeLoss", params, [x])


@pytest.mark.parametrize("name", ["LinearRegressionOutput",
                                  "LogisticRegressionOutput",
                                  "MAERegressionOutput"])
@pytest.mark.parametrize("grad_scale", [1.0, 0.25])
def test_regression_outputs_match_jax(name, grad_scale):
    data, label = _x(5, 3), _x(5, 3, seed=1)
    _check(name, {"grad_scale": grad_scale}, [data, label])
    oj, pj, ot, pt = _ops(name, {})
    assert ot.infer_shape(pt, [(5, 3), None]) == \
        oj.infer_shape(pj, [(5, 3), None])


@pytest.mark.parametrize("use_linear", [False, True])
@pytest.mark.parametrize("margin,reg", [(1.0, 1.0), (0.5, 0.3)])
def test_svm_output_matches_jax(use_linear, margin, reg):
    data = _x(6, 5)
    label = np.array([0, 4, 2, 2, 1, 3], np.float32)
    _check("SVMOutput", {"use_linear": use_linear, "margin": margin,
                         "regularization_coefficient": reg}, [data, label])
    oj, pj, ot, pt = _ops("SVMOutput", {})
    assert ot.infer_shape(pt, [(6, 5), None]) == \
        oj.infer_shape(pj, [(6, 5), None])


# -- WarpCTC -------------------------------------------------------------------
CTC_CASES = {
    # T, alphabet, label rows (0 = padding)
    "repeats": (6, 5, [[1, 1, 2, 0], [3, 3, 3, 0]]),
    "zero_mid_row": (7, 5, [[2, 0, 3, 1], [0, 4, 0, 4]]),
    "all_zero_row": (5, 4, [[0, 0, 0], [1, 2, 3]]),
    "t_2l_plus_1": (9, 6, [[1, 2, 1, 2], [5, 5, 1, 1]]),   # T = 2L + 1
}


def _ctc_inputs(case):
    T, A, rows = CTC_CASES[case]
    lab = np.array(rows, np.float32)
    B, L = lab.shape
    return T, L, _x(T * B, A, seed=3, scale=1.5), lab.reshape(-1)


@pytest.mark.parametrize("case", sorted(CTC_CASES))
def test_warpctc_matches_jax(case):
    T, L, data, label = _ctc_inputs(case)
    params = {"input_length": T, "label_length": L}
    _check("WarpCTC", params, [data, label])
    oj, pj, ot, pt = _ops("WarpCTC", params)
    assert ot.infer_shape(pt, [data.shape, None]) == \
        oj.infer_shape(pj, [data.shape, None])


@pytest.mark.parametrize("case", sorted(CTC_CASES))
def test_ctc_loss_matches_jax(case):
    T, L, data, label = _ctc_inputs(case)
    A = data.shape[1]
    logp = torch.log_softmax(torch.tensor(data).reshape(T, -1, A), dim=-1)
    lab = label.reshape(-1, L)
    got = loss_t.ctc_loss(logp, torch.tensor(lab)).numpy()
    want = np.asarray(jax.jit(loss_j.ctc_loss)(
        jax.numpy.asarray(logp.numpy()), jax.numpy.asarray(lab)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("params,shape", [
    ({"input_length": 0, "label_length": 2}, (12, 5)),
    ({"input_length": 5, "label_length": 2}, (12, 5)),
    ({"input_length": 4, "label_length": 2}, None),
])
def test_warpctc_errors_match_jax(params, shape):
    oj, pj, ot, pt = _ops("WarpCTC", params)
    with pytest.raises(ErrJ) as ej:
        oj.infer_shape(pj, [shape, None])
    with pytest.raises(ErrT) as et:
        ot.infer_shape(pt, [shape, None])
    assert str(et.value) == str(ej.value)
    if shape is not None:
        x = np.zeros(shape, np.float32)
        y = np.zeros(shape[0], np.float32)
        with pytest.raises(ErrJ) as ej:
            oj.apply(pj, [jax.numpy.asarray(x), jax.numpy.asarray(y)])
        with pytest.raises(ErrT) as et:
            ot.apply(pt, [torch.tensor(x), torch.tensor(y)])
        assert str(et.value) == str(ej.value)


def test_warpctc_rejects_non_2d_data_as_jax_does():
    oj, pj, ot, pt = _ops("WarpCTC", {"input_length": 2, "label_length": 1})
    x, y = np.zeros((2, 2, 3), np.float32), np.zeros(2, np.float32)
    with pytest.raises(ErrJ) as ej:
        oj.apply(pj, [jax.numpy.asarray(x), jax.numpy.asarray(y)])
    with pytest.raises(ErrT) as et:
        ot.apply(pt, [torch.tensor(x), torch.tensor(y)])
    assert str(et.value) == str(ej.value)


# -- integer data into the softmaxes (a fault of the port, repaired) ---------
SOFTMAX_INT_CASES = [("SoftmaxOutput", {}), ("Softmax", {}),
                     ("SoftmaxOutput", {"multi_output": True}),
                     ("SoftmaxOutput", {"preserve_shape": True}),
                     ("SoftmaxActivation", {"mode": "instance"}),
                     ("SoftmaxActivation", {"mode": "channel"})]


@pytest.mark.parametrize("dtype", ["int32", "uint8"])
@pytest.mark.parametrize("name,params", SOFTMAX_INT_CASES,
                         ids=["%s%s" % (n, sorted(p)) for n, p in
                              SOFTMAX_INT_CASES])
def test_softmaxes_of_integer_data_give_float32_as_jax(dtype, name, params):
    """Integer data gives float32 probabilities, the JAX ops' values
    within the file's tolerance (the port's SoftmaxOutput reads the
    rows converted to float32; SoftmaxActivation no longer raises).
    Over uint8 the JAX ops subtract the row's maximum in uint8, which
    wraps, and give NaN (a divergence the port does not copy): there
    the port is held to the JAX op on the same values as int32."""
    x = np.random.RandomState(4).randint(0, 6, (3, 4, 5)).astype(dtype)
    label = np.random.RandomState(5).randint(0, 4, (3, 5) if params.get(
        "multi_output") else (3, 4) if params.get("preserve_shape")
        else (3,)).astype(np.float32)
    oj, pj, ot, pt = _ops(name, params)
    ins = [x] if name == "SoftmaxActivation" else [x, label]
    if dtype == "uint8":
        wrapped = oj.apply(pj, [jax.numpy.asarray(v) for v in ins], [],
                           False, None)[0][0]
        assert not np.isfinite(np.asarray(wrapped)).all()
        ins_j = [ins[0].astype(np.int32)] + ins[1:]
    else:
        ins_j = ins
    out_j = oj.apply(pj, [jax.numpy.asarray(v) for v in ins_j], [], False,
                     None)[0][0]
    out_t = ot.apply(pt, [torch.from_numpy(v) for v in ins], [], False,
                     None)[0][0]
    assert out_t.dtype == torch.float32 and out_j.dtype == np.float32
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               rtol=RTOL, atol=ATOL)
