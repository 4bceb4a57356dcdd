"""The port's expert-parallel MoE against the JAX package's, on 8 shards.

The port runs on 8 virtual ``cpu`` shards, JAX on the 8 CPU devices
``tests/conftest.py`` forces; params (JAX's initialiser, non-zero output
layers) and rows are seeded numpy. Tolerances: at f32 compute rtol
1e-5, atol 1e-6 against JAX and against dense evaluation of the same
routing; at the default bf16 rtol 2e-3, atol 1e-4 (``tests/
test_expert.py``'s). The port dispatches by index where JAX uses
one-hot einsums: the same values for finite rows, and a NaN row stays in
its own row (a known difference, pinned below).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kepler_tpu.models.moe import init_moe as jinit_moe
from kepler_tpu.parallel import make_expert_parallel_moe as jmake_ep
from kepler_tpu.parallel import make_mesh as jmake_mesh
from kepler_tpu.parallel import top1_route as jtop1_route
from kepler_tpu_torch.models import estimator as port_est
from kepler_tpu_torch.models.moe import expert_forward, predict_moe
from kepler_tpu_torch.parallel import (make_expert_parallel_moe, make_mesh,
                                       top1_route)

Z = 2
F = 7


def expert_mesh(n: int = 8):
    return make_mesh([n], ["expert"], devices=["cpu"] * n)


def params_and_rows(n_experts: int = 8, b: int = 64, seed: int = 0):
    params = jax.tree.map(np.asarray, jinit_moe(
        jax.random.PRNGKey(seed), Z, n_experts=n_experts, hidden=32))
    rng = np.random.default_rng(seed + 7)
    params["w1"] = rng.normal(0, 0.3, params["w1"].shape).astype(np.float32)
    params["w_skip"] = rng.normal(0, 0.2, params["w_skip"].shape).astype(
        np.float32)
    feats = rng.uniform(0.0, 2.0, (b, F)).astype(np.float32)
    return params, feats


def run_both(params, feats, eid, gate, cd: str = "f32", **kw):
    jcd = jnp.float32 if cd == "f32" else jnp.bfloat16
    tcd = torch.float32 if cd == "f32" else torch.bfloat16
    want = np.asarray(jmake_ep(jmake_mesh([8], ["expert"]),
                               compute_dtype=jcd, **kw)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(feats),
        jnp.asarray(eid), jnp.asarray(gate)))
    got = make_expert_parallel_moe(expert_mesh(), compute_dtype=tcd, **kw)(
        port_est.params_from_numpy("moe", params), torch.from_numpy(feats),
        torch.from_numpy(eid), torch.from_numpy(gate)).numpy()
    return got, want


def assert_close(got, want, cd: str) -> None:
    if cd == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-4)


@pytest.mark.parametrize("cd", ["f32", "bf16"])
@pytest.mark.parametrize("n_experts", [8, 16])
def test_explicit_routing_matches_jax_and_dense(cd, n_experts):
    """E = 16 on 8 shards: two experts a shard."""
    params, feats = params_and_rows(n_experts, seed=n_experts)
    eid = (np.arange(64) * 7 % n_experts).astype(np.int32)
    gate = np.ones(64, np.float32)
    got, want = run_both(params, feats, eid, gate, cd)
    assert got.shape == (64, Z)
    assert_close(got, want, cd)
    tcd = torch.float32 if cd == "f32" else torch.bfloat16
    dense = predict_moe(port_est.params_from_numpy("moe", params),
                        torch.from_numpy(feats)[:, None],
                        torch.ones((64, 1), dtype=torch.bool),
                        clamp=False, compute_dtype=tcd,
                        expert_id=torch.from_numpy(eid))[:, 0].numpy()
    assert_close(got, dense, cd)


@pytest.mark.parametrize("cd", ["f32", "bf16"])
def test_learned_top1_matches_jax(cd):
    params, feats = params_and_rows(8, b=32, seed=3)
    eid, prob = top1_route(port_est.params_from_numpy("moe", params),
                           torch.from_numpy(feats))
    jeid, jprob = jtop1_route(jax.tree.map(jnp.asarray, params),
                              jnp.asarray(feats))
    assert eid.dtype == torch.int32
    np.testing.assert_array_equal(eid.numpy(), np.asarray(jeid))
    np.testing.assert_allclose(prob.numpy(), np.asarray(jprob), rtol=1e-6)
    got, want = run_both(params, feats, eid.numpy(), prob.numpy(), cd)
    assert_close(got, want, cd)
    # dense top-1: each row's argmax expert, weighted by its probability
    tcd = torch.float32 if cd == "f32" else torch.bfloat16
    per = expert_forward(port_est.params_from_numpy("moe", params),
                         torch.from_numpy(feats).expand(8, 32, F),
                         tcd).numpy()
    dense = per[eid.numpy(), np.arange(32)] * prob.numpy()[:, None]
    assert_close(got, dense, cd)


@pytest.mark.parametrize("factor,dropped", [(0.5, 4), (0.25, 6),
                                            (1.0, 0)])
def test_capacity_overflow_drops_to_zero(factor, dropped):
    """Every row to expert 0: per shard 8 rows and capacity
    ceil(8 · factor), the rest zero watts, as JAX's."""
    params, feats = params_and_rows(8, seed=5)
    eid = np.zeros(64, np.int32)
    got, want = run_both(params, feats, eid, np.ones(64, np.float32),
                         capacity_factor=factor)
    assert_close(got, want, "f32")
    zero = np.all(got == 0.0, axis=-1).reshape(8, 8)
    np.testing.assert_array_equal(zero.sum(axis=1), np.full(8, dropped))
    # the first rows of each shard keep their slots
    assert not zero[:, : 8 - dropped].any()


def test_ids_outside_the_experts_get_zero_watts():
    params, feats = params_and_rows(8, seed=9)
    eid = (np.arange(64) % 8).astype(np.int32)
    eid[[3, 17, 40]] = [-1, 8, 99]
    got, want = run_both(params, feats, eid, np.ones(64, np.float32))
    assert_close(got, want, "f32")
    assert np.all(got[[3, 17, 40]] == 0.0)


def test_nan_row_stays_in_its_own_row():
    """Known difference: JAX's one-hot einsums multiply the NaN row's
    slot by 0 for every other row of its shard (and of its expert's
    capacity buffer), so NaN spreads; index dispatch keeps it in its
    row. Every finite row equals JAX's where JAX's is finite."""
    params, feats = params_and_rows(8, seed=11)
    feats[10] = np.nan  # shard 1
    eid = (np.arange(64) % 8).astype(np.int32)
    got, want = run_both(params, feats, eid, np.ones(64, np.float32))
    nan_got = np.isnan(got).any(axis=-1)
    assert nan_got.nonzero()[0].tolist() == [10]
    nan_want = np.isnan(want).any(axis=-1)
    assert nan_want.sum() > 1 and nan_want[10]
    ok = ~nan_want
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-5, atol=1e-6)


def test_rows_and_experts_must_divide():
    params, feats = params_and_rows(8, b=60)
    ep = make_expert_parallel_moe(expert_mesh())
    with pytest.raises(ValueError, match="must divide"):
        ep(port_est.params_from_numpy("moe", params),
           torch.from_numpy(feats), torch.zeros(60, dtype=torch.int32),
           torch.ones(60))
