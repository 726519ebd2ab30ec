"""K1's plain version and SoftmaxOutput against the JAX package, on the
CPU.

- :func:`softmax_reference` (what ``fused_softmax`` runs on a CPU
  tensor) against the JAX ``fused_softmax`` in Pallas interpret mode
  (``MXNET_PALLAS=1``): [64, 1000] f32 within 1e-6 (as
  ``tests/unittest/test_pallas.py`` holds the Pallas kernel to
  ``jax.nn.softmax``), [37, 1001] bf16 within one bf16 step, [3, 1];
- SoftmaxOutput's forward and its gradient with respect to ``data``
  against the JAX op through the JAX Executor, for the plain,
  ``multi_output`` and ``preserve_shape`` modes, ``use_ignore`` and the
  three normalizations, within 1e-6 (f32). All cases sit in one grouped
  graph, one head each, so each package binds it once.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops.softmax import fused_softmax, softmax_reference


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


@pytest.fixture(autouse=True)
def _pallas(monkeypatch):
    monkeypatch.setenv("MXNET_PALLAS", "1")


def _bf16_step(w):
    """The spacing of bf16 numbers at |w| (8 significant bits)."""
    a = np.abs(w)
    return np.where(a > 0, 2.0 ** (np.floor(np.log2(np.where(a > 0, a, 1)))
                                   - 7), 0.0)


@pytest.mark.parametrize("shape,dtype", [((64, 1000), "float32"),
                                         ((37, 1001), "bfloat16"),
                                         ((3, 1), "float32")])
def test_plain_version_matches_pallas_kernel(shape, dtype):
    import jax.numpy as jnp
    from mxnet_tpu.ops import pallas_kernels as pk

    x = (np.random.RandomState(3).randn(*shape) * 3).astype(np.float32)
    want = np.asarray(pk.fused_softmax(jnp.asarray(x, dtype)), np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got_t = fused_softmax(xt)
    assert got_t.dtype == xt.dtype and got_t.shape == shape
    assert torch.equal(got_t, softmax_reference(xt))
    got = got_t.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        assert (np.abs(got - want) <= _bf16_step(want)).all()


# (name, data shape, label values, params)
CASES = [
    ("plain", (6, 10), [1, 2, 3, 4, 5, 6], {}),
    ("plain_batch", (6, 10), [0, 9, 3, 3, 5, 1],
     {"normalization": "batch", "grad_scale": 2.0}),
    ("plain_ignore", (6, 10), [1, -1, 3, 4, -1, 6], {"use_ignore": True}),
    ("plain_valid", (6, 10), [1, -1, 3, 4, -1, 6],
     {"use_ignore": True, "normalization": "valid"}),
    ("plain_4d", (4, 2, 3, 2), [0, 11, 5, 7], {}),
    ("multi", (3, 4, 5), [[0, 1, 2, 3, 0], [3, 3, 2, 1, 0], [1, 1, 1, 2, 2]],
     {"multi_output": True, "normalization": "batch"}),
    ("multi_valid", (3, 4, 5),
     [[0, -1, 2, 3, 0], [3, 3, -1, 1, 0], [1, -1, 1, 2, 2]],
     {"multi_output": True, "use_ignore": True,
      "normalization": "valid"}),
    ("preserve", (2, 3, 7), [[0, 6, 2], [5, 4, 3]],
     {"preserve_shape": True}),
    ("preserve_batch", (2, 3, 7), [[0, 6, 2], [5, 4, 3]],
     {"preserve_shape": True, "normalization": "batch",
      "grad_scale": 0.5}),
]


def _run(pkg):
    heads, values = [], {}
    rng = np.random.RandomState(11)
    for name, shape, label, params in CASES:
        d, lab = pkg.sym.Variable("%s_data" % name), \
            pkg.sym.Variable("%s_label" % name)
        heads.append(pkg.sym.SoftmaxOutput(data=d, label=lab, name=name,
                                           **params))
        values["%s_data" % name] = (rng.randn(*shape) * 2).astype(np.float32)
        values["%s_label" % name] = np.asarray(label, np.float32)
    group = pkg.sym.Group(heads)
    shapes = {k: v.shape for k, v in values.items()}
    req = {k: ("write" if k.endswith("_data") else "null") for k in values}
    exe = group.simple_bind(pkg.cpu(), grad_req=req, **shapes)
    for k, v in values.items():
        exe.arg_dict[k][:] = v
    exe.forward(is_train=True)
    exe.backward()
    return ([o.asnumpy() for o in exe.outputs],
            {k: g.asnumpy() for k, g in exe.grad_dict.items()
             if g is not None})


@pytest.fixture(scope="module")
def runs():
    mp = pytest.MonkeyPatch()
    mp.setenv("MXNET_PALLAS", "1")
    try:
        return _run(mj), _run(mt)
    finally:
        mp.undo()


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_softmax_output_forward_and_gradient(runs, case):
    (out_j, grad_j), (out_t, grad_t) = runs
    i = [c[0] for c in CASES].index(case)
    np.testing.assert_allclose(out_t[i], out_j[i], rtol=0, atol=1e-6)
    key = "%s_data" % case
    assert np.abs(grad_j[key]).max() > 0
    np.testing.assert_allclose(grad_t[key], grad_j[key], rtol=0, atol=1e-6)


def test_variant_is_the_first_that_holds_the_row():
    """The kernel's variant for a row width: the first whose capacity
    (``csrc/softmax.cu``'s table) holds the row, 0 past the last, the same
    limits a row of 16-byte vectors counts for f32 and for bf16/f16."""
    from mxnet_tpu_torch.ops import softmax as sm

    for elem in (4, 2):
        v = 16 // elem
        limits = list(sm.SCALAR_CAPACITY) + [cap * v + v - 1
                                             for cap in sm.VECTOR_CAPACITY]
        for i, limit in enumerate(limits):
            assert sm.variant(limit, elem) == i + 1
            assert sm.variant(limit + 1, elem) == (
                i + 2 if i + 1 < len(limits) else 0)
        assert [sm.variant(c, elem) for c in (1, 2, 10, 31, 32, 33)] == \
            [1, 1, 1, 1, 1, 2]
    # the paths' shapes: LeNet [64, 10] f32, ResNet-50 [128, 1000] f32,
    # the LM-sized [4096, 32000] bf16 check, the [8, 2097152] f32 check
    assert (sm.variant(10, 4), sm.variant(1000, 4), sm.variant(32000, 2),
            sm.variant(2097152, 4)) == (1, 2, 3, 0)


def test_loaded_library_lookup_takes_no_lock(monkeypatch):
    """Once a kernel library is loaded, a wrapper's lookup of it takes no
    lock (it runs on every launch)."""
    from mxnet_tpu_torch.ops import _build

    class NoLock:
        def __enter__(self):
            raise AssertionError("the lookup took the build lock")

        def __exit__(self, *exc):
            return False

    lib = object()
    monkeypatch.setitem(_build._libs, "softmax", lib)
    monkeypatch.setattr(_build, "_lock", NoLock())
    assert _build.library("softmax") is lib
