"""The port's DP×TP trainer against the JAX package's, on a 4 × 2
``node × model`` mesh.

The port runs on 8 virtual ``cpu`` shards, JAX on the 8 CPU devices
``tests/conftest.py`` forces; params (JAX's ``init_mlp``, carried across
with ``params_from_numpy``) and batches are seeded numpy, with invalid
workloads spread unevenly over the node shards. Tolerances: at the
default bf16 trunk, every step's loss within rtol 1e-2 of JAX's and of
the port's single-device ``make_train_step(predict_mlp)`` (the bf16
bound of ``test_torch_train``; measured 1.9e-5), the params after five
steps within rtol 1e-3, atol 1e-3 of both (measured 2.3e-4: bf16
operand rounding after sums in another order); at f32 compute the
losses within rtol 1e-5 of the single-device step and the params within
rtol 1e-5, atol 1e-6 (measured 1.1e-7 and 3.0e-8).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kepler_tpu.models import train as jtrain
from kepler_tpu.models.mlp import init_mlp as jinit_mlp
from kepler_tpu.parallel import make_distributed_train_step as jmake_step
from kepler_tpu.parallel import make_mesh as jmake_mesh
from kepler_tpu.parallel import shard_train_state as jshard
from kepler_tpu_torch.models import estimator as port_est
from kepler_tpu_torch.models import train as ptrain
from kepler_tpu_torch.models.mlp import predict_mlp
from kepler_tpu_torch.parallel import (gather_params,
                                       make_distributed_train_step,
                                       make_mesh, mlp_param_shardings,
                                       shard_train_state)

LR = 1e-2
Z = 2


def grid_mesh(shape=(4, 2)):
    return make_mesh(list(shape), ["node", "model"],
                     devices=["cpu"] * (shape[0] * shape[1]))


def mlp_params(seed: int = 0, hidden: int = 32) -> dict:
    return {k: np.asarray(v) for k, v in
            jinit_mlp(jax.random.PRNGKey(seed), Z, hidden=hidden).items()}


def batch(seed: int, b: int = 16, w: int = 8):
    rng = np.random.default_rng(seed)
    feats = rng.uniform(0.0, 3.0, (b, w, 7)).astype(np.float32)
    valid = rng.random((b, w)) > 0.3
    valid[:4] = False  # the first node shard has no valid workload
    valid[4:8, :2] = False
    targets = (feats[..., :1] * np.array([4.0, 9.0], np.float32)
               + rng.normal(0, 0.1, (b, w, Z))).astype(np.float32)
    return feats, valid, targets


def t_(x):
    return torch.from_numpy(x)


def port_run(params, steps, mesh=None, cd=torch.bfloat16, seed=1):
    """Per-step losses and the final whole params, on the mesh (or one
    shard when ``mesh`` is None)."""
    state = ptrain.create_train_state(
        port_est.params_from_numpy("mlp", params), ptrain.make_optimizer(LR))
    if mesh is None:
        step = ptrain.make_train_step(functools.partial(
            predict_mlp, compute_dtype=cd))
    else:
        state = shard_train_state(state, mesh)
        step = make_distributed_train_step(mesh, compute_dtype=cd)
    losses = []
    for s in range(steps):
        args = [t_(x) for x in batch(seed + s)]
        state, loss = step(state, *args)
        losses.append(float(loss))
    whole = (gather_params(state) if mesh is not None
             else ptrain.detached(state.params))
    return np.asarray(losses), whole, state


def test_losses_match_jax_and_params_match_one_shard():
    params = mlp_params()
    jmesh = jmake_mesh([4, 2], ["node", "model"])
    jopt = jtrain.make_optimizer(LR)
    jstate = jshard(jtrain.create_train_state(
        jax.tree.map(jnp.asarray, params), jopt), jmesh)
    jstep = jmake_step(jmesh, jopt)
    want = []
    for s in range(5):
        jstate, loss = jstep(jstate, *(jnp.asarray(x) for x in
                                       batch(1 + s)))
        want.append(float(loss))
    got, whole, state = port_run(params, 5, grid_mesh())
    assert state.step == 5
    np.testing.assert_allclose(got, want, rtol=1e-2)
    assert got[-1] < got[0]
    one, one_params, _ = port_run(params, 5)
    np.testing.assert_allclose(got, one, rtol=1e-2)
    for k, v in one_params.items():
        np.testing.assert_allclose(whole[k].numpy(), v.numpy(), rtol=1e-3,
                                   atol=1e-3, err_msg=k)
        np.testing.assert_allclose(whole[k].numpy(),
                                   np.asarray(jstate.params[k]), rtol=1e-3,
                                   atol=1e-3, err_msg=k)


@pytest.mark.parametrize("shape", [(4, 2), (8, 1), (1, 8), (2, 4)])
def test_f32_losses_equal_one_shard(shape):
    """At f32 compute the mesh changes only summation orders."""
    params = mlp_params(3)
    got, whole, _ = port_run(params, 5, grid_mesh(shape), torch.float32)
    want, ref, _ = port_run(params, 5, None, torch.float32)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for k, v in ref.items():
        np.testing.assert_allclose(whole[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_layout_and_shard_placement():
    layout = mlp_param_shardings()
    assert layout["w0"] == (None, "model")
    assert layout["w1"] == ("model", None)
    assert layout["b0"] == ("model",)
    for k in ("b1", "w2", "b2", "w_skip"):
        assert "model" not in layout[k]
    params = mlp_params(hidden=32)
    state = shard_train_state(ptrain.create_train_state(
        port_est.params_from_numpy("mlp", params),
        ptrain.make_optimizer(LR)), grid_mesh())
    assert len(state.params) == 4 and len(state.params[0]) == 2
    shard = state.params[2][1]
    assert shard["w0"].shape == (7, 16) and shard["b0"].shape == (16,)
    assert shard["w1"].shape == (16, 32) and shard["w2"].shape == (32, Z)
    np.testing.assert_array_equal(shard["w0"].detach().numpy(),
                                  params["w0"][:, 16:])
    np.testing.assert_array_equal(shard["w1"].detach().numpy(),
                                  params["w1"][16:])
    assert all(v.requires_grad for v in shard.values())
    whole = gather_params(state)
    for k, v in params.items():
        np.testing.assert_array_equal(whole[k].numpy(), v)


def test_resharding_a_trained_state_keeps_its_moments():
    """Two steps on one shard, then three on the mesh, equal five on one
    shard at f32: the moments move with their slices."""
    params = mlp_params(5)
    state = ptrain.create_train_state(
        port_est.params_from_numpy("mlp", params), ptrain.make_optimizer(LR))
    one = ptrain.make_train_step(functools.partial(
        predict_mlp, compute_dtype=torch.float32))
    for s in range(2):
        state, _ = one(state, *(t_(x) for x in batch(1 + s)))
    sharded = shard_train_state(state, grid_mesh())
    assert sharded.step == 2
    step = make_distributed_train_step(grid_mesh(),
                                       compute_dtype=torch.float32)
    got = []
    for s in range(2, 5):
        sharded, loss = step(sharded, *(t_(x) for x in batch(1 + s)))
        got.append(float(loss))
    want, ref, _ = port_run(params, 5, None, torch.float32)
    np.testing.assert_allclose(got, want[2:], rtol=1e-5)
    whole = gather_params(sharded)
    for k, v in ref.items():
        np.testing.assert_allclose(whole[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_batch_must_divide_over_node():
    state = shard_train_state(ptrain.create_train_state(
        port_est.params_from_numpy("mlp", mlp_params()),
        ptrain.make_optimizer(LR)), grid_mesh())
    feats, valid, targets = batch(0, b=6)
    with pytest.raises(ValueError, match="does not divide"):
        make_distributed_train_step(grid_mesh())(
            state, t_(feats), t_(valid), t_(targets))
    with pytest.raises(ValueError, match="2-D mesh"):
        make_distributed_train_step(make_mesh([8], devices=["cpu"] * 8))
