"""How far the f32 summation order moves ``Deconvolution``'s results on
the CPU: for each case of ``test_torch_nn_ops.DECONV_CASES`` and each
torch thread count, the rtol that ``assert_allclose`` at the test's atol
needs between the port's forward and gradients and the JAX op's
(compiled as the test compiles it), and the rtol each side needs
against the port's op run in float64. The bound ``SUM_ORDER_1T`` of
``test_deconvolution_matches_jax`` comes from this.

    JAX_PLATFORMS=cpu python tests/torch_deconv_sum_order.py
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import test_torch_nn_ops as T  # noqa: E402


def outputs(case):
    """(JAX's outputs and gradients, a function of (dtype, threads)
    giving the port's) for one case, under the test's cotangent."""
    dshape, params = T.DECONV_CASES[case]
    oj, ot = T.reg_j.get("Deconvolution"), T.reg_t.get("Deconvolution")
    pj, pt = oj.parse_params(dict(params)), ot.parse_params(dict(params))
    ins, _, _ = ot.infer_shape(pt, [dshape, None] + (
        [] if params.get("no_bias") else [None]))
    inputs = [T._x(*s, seed=i) for i, s in enumerate(ins)]

    def fj(*xs):
        return oj.apply(pj, list(xs), [], True, None)[0]

    outs_j, vjp = jax.vjp(jax.jit(fj), *[jnp.asarray(v) for v in inputs])
    cot = np.random.RandomState(7).randn(*outs_j[0].shape).astype(
        np.float32)
    want = [np.asarray(outs_j[0])] + [np.asarray(g) for g in vjp(
        [jnp.asarray(cot)])]

    def port(dtype, threads):
        torch.set_num_threads(threads)
        xs = [torch.tensor(x, dtype=dtype, requires_grad=True)
              for x in inputs]
        o, _ = ot.apply(pt, xs, [], True, None)
        gs = torch.autograd.grad([o[0]], xs, [torch.tensor(cot, dtype=dtype)])
        return [o[0].detach().numpy()] + [g.numpy() for g in gs]

    return want, port


def worst_rel(got, want, atol):
    """The least rtol for which every ``got`` is within
    ``atol + rtol |want|`` of ``want``."""
    rel = 0.0
    for a, b in zip(got, want):
        d = np.abs(a.astype(np.float64) - b.astype(np.float64)) - atol
        rel = max(rel, float(np.max(d / np.maximum(np.abs(b), 1e-30))))
    return rel


def main():
    jax.config.update("jax_disable_most_optimizations", True)
    t = torch.randn(100000)
    torch.exp(t)
    torch.tanh(t)
    atol = T.REDUCE[1]
    for case in sorted(T.DECONV_CASES):
        want, port = outputs(case)
        exact = port(torch.float64, 1)
        line = {"case": case,
                "jax_vs_f64": worst_rel(want, exact, atol)}
        for threads in (1, 2, 4, 8):
            got = port(torch.float32, threads)
            line["port_%dt_vs_jax" % threads] = worst_rel(got, want, atol)
            line["port_%dt_vs_f64" % threads] = worst_rel(got, exact, atol)
        print(line, flush=True)


if __name__ == "__main__":
    main()
