"""K6's plain version against the JAX package's Pallas kernel, on the CPU.

The Pallas kernel is ``make_pallas``, a closure inside ``main()`` of
``tools/probe_matmul_stats.py``; the file is parsed with ``ast``, the
``make_pallas`` definition taken out of ``main`` and run with ``jax``,
``jnp``, ``pl`` and ``interpret=True`` bound, so it runs here in Pallas
interpret mode and the probe stays as it is.

- :func:`matmul_stats_reference` (what ``matmul_stats`` runs on CPU
  tensors, leaving ``launches`` alone) against that kernel on the same bf16
  inputs (numpy seeds), at three small shapes, one with a nonzero-mean x.
  Summation order is the only difference, so: y within one bf16 step
  (the spacing of bf16 numbers at the Pallas value, 2^-8 to 2^-7 of it:
  the two f32 sums can fall either side of a rounding boundary) plus
  1e-6; each column of s within 1e-5 of that column's
  sum of |acc|; s2 within rtol 1e-5.
- ``tools/torch_probe_matmul_stats.py --device cpu`` runs its checks at
  its CPU shapes, and exits 2 without CUDA when asked for the card.
"""
import ast
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from chip_smoke import load_probe
from mxnet_tpu_torch.ops.matmul_stats import (matmul_stats,
                                              matmul_stats_reference)

ROOT = Path(__file__).resolve().parents[1]


def _bf16_step(w):
    """The spacing of bf16 numbers at |w| (8 significant bits)."""
    a = np.abs(w)
    return np.where(a > 0, 2.0 ** (np.floor(np.log2(np.where(a > 0, a, 1)))
                                   - 7), 0.0)


def _make_pallas():
    path = ROOT / "tools" / "probe_matmul_stats.py"
    tree = ast.parse(path.read_text(), filename=str(path))
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    fn = next(n for n in main.body
              if isinstance(n, ast.FunctionDef) and n.name == "make_pallas")
    ns = {"jax": jax, "jnp": jnp, "pl": pl, "interpret": True}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), str(path), "exec"),
         ns)
    return ns["make_pallas"]


@pytest.mark.parametrize("m,k,n,bm,mean", [(1024, 64, 128, 256, 0.0),
                                           (2048, 256, 64, 512, 0.0),
                                           (1024, 256, 128, 256, 0.5)])
def test_plain_version_matches_pallas_kernel(m, k, n, bm, mean):
    rng = np.random.RandomState(m + k + n)
    x32 = rng.randn(m, k).astype(np.float32) + np.float32(mean)
    w32 = (rng.randn(k, n) * 0.05).astype(np.float32)
    xj, wj = jnp.asarray(x32, jnp.bfloat16), jnp.asarray(w32, jnp.bfloat16)
    xt = torch.from_numpy(x32).to(torch.bfloat16)
    wt = torch.from_numpy(w32).to(torch.bfloat16)
    # both packages round the same f32 values to the same bf16 inputs
    assert np.array_equal(np.asarray(xj, np.float32), xt.float().numpy())
    assert np.array_equal(np.asarray(wj, np.float32), wt.float().numpy())

    yj, sj, s2j = (np.asarray(a, np.float32)
                   for a in _make_pallas()(m, k, n, bm)(xj, wj))
    before = matmul_stats.launches
    y, s, s2 = matmul_stats(xt, wt)
    assert matmul_stats.launches == before
    for got, want in zip((y, s, s2), matmul_stats_reference(xt, wt)):
        assert torch.equal(got, want)
    assert (y.dtype, tuple(y.shape)) == (torch.bfloat16, (m, n))
    assert (s.dtype, tuple(s.shape)) == (torch.float32, (1, n))
    assert (s2.dtype, tuple(s2.shape)) == (torch.float32, (1, n))
    assert yj.shape == (m, n) and sj.shape == s2j.shape == (1, n)

    assert (np.abs(y.float().numpy() - yj) <= _bf16_step(yj) + 1e-6).all()
    acc_abs = (xt.float() @ wt.float()).abs().sum(0, keepdim=True).numpy()
    assert (np.abs(s.numpy() - sj) <= 1e-5 * acc_abs).all()
    np.testing.assert_allclose(s2.numpy(), s2j, rtol=1e-5, atol=0)
    if mean:
        # the column sums are far from zero, so the limit on s would see a
        # row tile of 64 dropped
        tile = (xt[:64].float() @ wt.float()).sum(0, keepdim=True).numpy()
        assert (np.abs(s.numpy() - tile - sj) > 1e-5 * acc_abs).all()


def test_probe_runs_on_the_cpu(capsys):
    probe = load_probe()
    assert probe.main(["--device", "cpu"]) == 0
    lines = [json.loads(line) for line in
             capsys.readouterr().out.strip().splitlines()]
    assert [r["shape"] for r in lines] == [list(s) for s in probe.CPU_SHAPES]
    for r in lines:
        assert max(r["probe_checks"].values()) <= 1.0
        assert r["plain_check"]["ok"] and r["plain_check"]["worst"] == 0.0
        assert r["ms"] is None and r["sequence_over_kernel"] is None
        assert r["bound_by"] == "bytes" and r["bound_ms"] > 0


def test_probe_without_a_card_exits_2(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert load_probe().main([]) == 2
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("m,k,n,grid,np_", [
    (128 * 56 * 56, 64, 256, 132, 256),     # A
    (128 * 56 * 56, 256, 64, 132, 64),      # B
    (128 * 28 * 28, 512, 128, 132, 128),    # C
    (128 * 14 * 14, 1024, 256, 132, 256),   # D
    (1000, 64, 256, 16, 256),               # fewer tiles than SMs
    (1, 16, 8, 1, 64),
    (8447, 64, 136, 132, 256),              # M not a multiple of 64
    (8448, 48, 72, 132, 128),               # 132 tiles, one a block
])
def test_plan(m, k, n, grid, np_):
    """The kernel's launch plan on the H100's 132 SMs: 64-row tiles, the
    persistent grid (the partials are [2, grid, n]), the wgmma width; on
    a card of 8 SMs the grid follows the SM count."""
    from mxnet_tpu_torch.ops import matmul_stats as ms

    p = ms.plan(m, k, n)
    assert p == {"np": np_, "tiles": -(-m // ms.ROW_TILE), "grid": grid}
    assert p["np"] >= n and (p["np"] == 64 or p["np"] // 2 < n)
    assert ms.plan(m, k, n, sms=8)["grid"] == min(8, p["tiles"])
