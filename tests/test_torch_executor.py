"""The port's Executor against the JAX package's, on the CPU.

LeNet (batch 8) and ResNet-small (n=1, batch 4, 3x28x28) are bound in
both packages with the same numpy arguments and aux states; after one
``forward(is_train=True)`` and ``backward()`` the outputs, every
gradient and the BatchNorm moving stats must agree (rtol 1e-4, atol
1e-5: f32 on both sides, the packages differ in summation order and
in XLA's fusion of the BatchNorm arithmetic). Also: ``grad_req``
add/null, Pooling's ``full`` convention with padding (forward and input
gradient through ``backward(out_grads)``), and a ResNet-50 forward at a
small image as a shape check of the port alone.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module", autouse=True)
def _warm_cpu_math():
    """torch 2.13's CPU ``exp`` and ``tanh`` sometimes return errors up to
    1.5e-4 relative on their first multithreaded call in a process (plain
    torch reproduces it: ``torch.exp`` twice on the same [64, 1000]
    tensor, the first result off); one call of each on a large tensor
    first avoids it, so the comparisons see the port's arithmetic."""
    t = torch.randn(100000)
    torch.exp(t)
    torch.tanh(t)
    torch.rsqrt(t.abs() + 1)


def _inputs(sym, shapes, seed):
    """numpy arguments (data uniform, labels integer classes, weights
    N(0, 0.1^2)) and aux states (moving_var positive)."""
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    args = {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name.endswith("label"):
            args[name] = rng.randint(0, 10, shape).astype(np.float32)
        elif name == "data":
            args[name] = rng.rand(*shape).astype(np.float32)
        else:
            args[name] = (rng.randn(*shape) * 0.1).astype(np.float32)
    aux = {}
    for name, shape in zip(sym.list_auxiliary_states(), aux_shapes):
        aux[name] = (rng.rand(*shape) + 0.5 if name.endswith("var")
                     else rng.randn(*shape) * 0.1).astype(np.float32)
    return args, aux


def _step(pkg, sym, shapes, args, aux, grad_req="write"):
    exe = sym.simple_bind(pkg.cpu(), grad_req=grad_req, **shapes)
    for name, value in args.items():
        exe.arg_dict[name][:] = value
    for name, value in aux.items():
        exe.aux_dict[name][:] = value
    exe.forward(is_train=True)
    exe.backward()
    return exe


def _snapshot(exe):
    return {"outputs": [o.asnumpy() for o in exe.outputs],
            "grads": {n: g.asnumpy() for n, g in exe.grad_dict.items()
                      if g is not None},
            "aux": {n: a.asnumpy() for n, a in exe.aux_dict.items()}}


NETS = {
    "lenet": (lambda pkg: pkg.models.get_lenet(),
              {"data": (8, 1, 28, 28), "softmax_label": (8,)}),
    "resnet_small": (lambda pkg: pkg.models.get_resnet_small(n=1),
                     {"data": (4, 3, 28, 28), "softmax_label": (4,)}),
}


@pytest.fixture(scope="module")
def runs():
    """Both packages' executor step on both nets, computed once."""
    out = {}
    for i, (key, (build, shapes)) in enumerate(NETS.items()):
        with mj.NameManager():
            sym_j = build(mj)
        with mt.NameManager():
            sym_t = build(mt)
        args, aux = _inputs(sym_t, shapes, seed=i)
        out[key] = (_snapshot(_step(mj, sym_j, shapes, args, aux)),
                    _step(mt, sym_t, shapes, args, aux), args, aux, sym_t)
    return out


@pytest.mark.parametrize("net", sorted(NETS))
def test_outputs_match(runs, net):
    want, exe, *_ = runs[net]
    got = _snapshot(exe)
    assert len(got["outputs"]) == len(want["outputs"]) == 1
    np.testing.assert_allclose(got["outputs"][0], want["outputs"][0],
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("net", sorted(NETS))
def test_every_gradient_matches(runs, net):
    want, exe, *_ = runs[net]
    got = _snapshot(exe)["grads"]
    assert sorted(got) == sorted(want["grads"])
    for name in want["grads"]:
        np.testing.assert_allclose(got[name], want["grads"][name],
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_batchnorm_moving_stats_match(runs):
    want, exe, _, aux, _ = runs["resnet_small"]
    got = _snapshot(exe)["aux"]
    assert sorted(got) == sorted(want["aux"]) and got
    for name in want["aux"]:
        # one is_train forward moved every stat off its starting value
        assert not np.allclose(got[name], aux[name]), name
        np.testing.assert_allclose(got[name], want["aux"][name],
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_grad_req_add_accumulates_and_null_leaves_none(runs):
    _, exe, args, aux, sym = runs["lenet"]
    shapes = NETS["lenet"][1]
    write = {n: g.asnumpy() for n, g in exe.grad_dict.items()}
    req = {n: ("null" if n in ("data", "softmax_label", "fc2_bias")
               else "add") for n in sym.list_arguments()}
    acc = _step(mt, sym, shapes, args, aux, grad_req=req)
    acc.backward()   # a second backward after the same forward
    for name, g in acc.grad_dict.items():
        if req[name] == "null":
            assert g is None, name
        else:
            np.testing.assert_allclose(g.asnumpy(), 2 * write[name],
                                       rtol=1e-6, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("pool_type", ["avg", "max", "sum"])
def test_pooling_full_convention_with_padding(pool_type):
    """Windows overhang the high side under the ``full`` convention:
    avg still divides by the whole kernel area, max pads with -inf."""
    shape = (2, 3, 10, 10)
    rng = np.random.RandomState(7)
    x = rng.randn(*shape).astype(np.float32)
    head = rng.randn(2, 3, 6, 6).astype(np.float32)
    res = []
    for pkg in (mj, mt):
        sym = pkg.sym.Pooling(data=pkg.sym.Variable("data"), kernel=(3, 3),
                              stride=(2, 2), pad=(1, 1), pool_type=pool_type,
                              pooling_convention="full", name="pool")
        exe = sym.simple_bind(pkg.cpu(), grad_req="write", data=shape)
        exe.arg_dict["data"][:] = x
        exe.forward(is_train=True)
        exe.backward(out_grads=[pkg.nd.array(head, ctx=pkg.cpu())])
        res.append((exe.outputs[0].asnumpy(),
                    exe.grad_dict["data"].asnumpy()))
    assert res[1][0].shape == (2, 3, 6, 6)
    for want, got in zip(res[0], res[1]):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_resnet50_forward_shape():
    """The flagship graph binds and runs in the port (3x64x64, batch 2,
    Xavier weights): a probability row per image."""
    sym = mt.models.get_resnet(num_classes=1000, num_layers=50)
    exe = sym.simple_bind(mt.cpu(), grad_req="null", data=(2, 3, 64, 64))
    mt.random.seed(0)
    init = mt.initializer.Xavier()
    for name, arr in exe.arg_dict.items():
        if name not in ("data", "softmax_label"):
            init(name, arr)
    exe.arg_dict["data"][:] = np.random.RandomState(0).rand(2, 3, 64, 64)
    out = exe.forward(is_train=False)[0].asnumpy()
    assert out.shape == (2, 1000) and np.isfinite(out).all()
    np.testing.assert_allclose(out.sum(axis=1), 1.0, rtol=1e-5)
