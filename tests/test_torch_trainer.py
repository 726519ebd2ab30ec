"""mxnet_tpu_torch training against the JAX package's.

Params are built by the JAX package and carried across with
``params_from_numpy``; batches are made with numpy. In f32 on the CPU:

- ``loss_fn`` and every gradient against ``jax.value_and_grad`` of the
  JAX ``loss_fn`` (its CPU path: XLA attention; the Pallas backward is
  held against the port's in ``test_torch_flash_backward.py``);
- 3 steps of ``make_train_step`` with SGD-momentum and with Adam
  against ``mxnet_tpu.parallel.make_train_step`` with the matching
  optax optimizer.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mxnet_tpu.models import transformer as jt
from mxnet_tpu.parallel import make_train_step as jax_make_train_step
from mxnet_tpu_torch.models import transformer as tt
from mxnet_tpu_torch.parallel import (ShardedTrainer, create_mesh,
                                      data_parallel_spec, make_train_step)

KW = dict(vocab_size=64, num_layers=2, d_model=64, num_heads=2, d_ff=128,
          max_seq_len=128, dtype="float32")


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = jt.TransformerConfig(**KW), tt.TransformerConfig(**KW)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    tokens = np.random.RandomState(0).randint(0, 64, (2, 129)).astype(
        np.int32)
    return jcfg, tcfg, jp, {"tokens": tokens}


def test_loss_and_grads_match_jax(setup):
    jcfg, tcfg, jp, batch = setup
    want_loss, want_grads = jax.jit(jax.value_and_grad(jt.loss_fn(jcfg)))(
        jp, {"tokens": jnp.asarray(batch["tokens"])}, jax.random.PRNGKey(1))
    tp = tt.params_from_numpy(_np_tree(jp), device="cpu")
    _, init_state = make_train_step(tt.loss_fn(tcfg))
    init_state(tp)
    loss = tt.loss_fn(tcfg)(tp, batch, torch.Generator())
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= 1e-6
    grads = tt.params_to_numpy(jax.tree_util.tree_map(
        lambda t: t.grad, tp))
    flat_w = jax.tree_util.tree_leaves(_np_tree(want_grads))
    flat_g = jax.tree_util.tree_leaves(grads)
    assert len(flat_w) == len(flat_g) == 4 + 8 * KW["num_layers"]
    for g, w in zip(flat_g, flat_w):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["sgd_momentum", "adam"])
def test_three_steps_match_optax(setup, name):
    jcfg, tcfg, jp, batch = setup
    opt = {"sgd_momentum": (optax.sgd(0.1, momentum=0.9),
                            lambda ps: torch.optim.SGD(ps, lr=0.1,
                                                       momentum=0.9)),
           "adam": (optax.adam(1e-3),
                    lambda ps: torch.optim.Adam(ps, lr=1e-3))}[name]
    jstep, jinit = jax_make_train_step(jt.loss_fn(jcfg), opt[0],
                                       donate=False)
    tstep, tinit = make_train_step(tt.loss_fn(tcfg), opt[1])
    tp = tt.params_from_numpy(_np_tree(jp), device="cpu")
    js, ts = jinit(jp), tinit(tp)
    jparams, g = jp, torch.Generator()
    for i in range(3):
        jparams, js, jl = jstep(jparams, js, batch, jax.random.PRNGKey(i))
        tp, ts, tl = tstep(tp, ts, batch, g)
        assert abs(tl.item() - float(jl)) <= 1e-5
    flat_j = jax.tree_util.tree_leaves(_np_tree(jparams))
    flat_t = jax.tree_util.tree_leaves(tt.params_to_numpy(tp))
    for a, b in zip(flat_t, flat_j):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def test_sharded_trainer_loss_decreases():
    def loss_fn(params, batch, rng):
        h = torch.relu(batch["x"] @ params["w1"])
        return ((h @ params["w2"] - batch["y"]) ** 2).mean()

    rng = np.random.RandomState(1)
    params = {"w1": torch.from_numpy(rng.rand(6, 16).astype("f") * 0.3),
              "w2": torch.from_numpy(rng.rand(16, 1).astype("f") * 0.3)}
    trainer = ShardedTrainer(loss_fn, params,
                             lambda ps: torch.optim.Adam(ps, lr=1e-2),
                             mesh=create_mesh((1,), ("data",),
                                              devices=["cpu"]))
    x = rng.rand(32, 6).astype("f")
    y = (x.sum(1, keepdims=True) > 3).astype("f")
    losses = [float(trainer.step({"x": x, "y": y})) for _ in range(40)]
    assert losses[-1] < losses[0] * 0.5, losses[::10]


def test_multi_device_mesh_and_shardings_raise():
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        create_mesh((2,), ("data",), devices=["cpu", "cpu"])
    mesh = create_mesh((1,), ("data",), devices=["cpu"])
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        data_parallel_spec(mesh)
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        make_train_step(lambda p, b, r: 0, mesh=mesh, param_spec=object())
