"""The port's GPipe pipeline against the JAX package's, on 8 stages.

The port runs on 8 virtual ``cpu`` shards, JAX on the 8 CPU devices
``tests/conftest.py`` forces; params and inputs are seeded numpy (JAX's
initialiser). Tolerances, as ``tests/test_pipeline.py``'s: rtol 1e-5,
atol 1e-5 at f32 against JAX and against the sequential stack; the
pipelined deep estimator at the default bf16 within rtol 1e-2, atol
1e-2 · max|watts| of JAX's (bf16 operand rounding after f32 sums).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kepler_tpu.models.deep import block_fn as jblock_fn
from kepler_tpu.models.deep import init_deep as jinit_deep
from kepler_tpu.parallel import make_mesh as jmake_mesh
from kepler_tpu.parallel import make_pipeline as jmake_pipeline
from kepler_tpu.parallel import make_pipelined_deep as jmake_pipelined_deep
from kepler_tpu_torch.models import estimator as port_est
from kepler_tpu_torch.models.deep import block_fn, predict_deep
from kepler_tpu_torch.parallel import (make_mesh, make_pipeline,
                                       make_pipelined_deep)

D = 32
Z = 2


def stage_mesh(n: int = 8):
    return make_mesh([n], ["stage"], devices=["cpu"] * n)


def deep_params(n_stages: int, seed: int = 0) -> dict:
    """JAX-initialised deep params as numpy, with non-zero heads."""
    rng = np.random.default_rng(seed)
    p = jax.tree.map(np.asarray, jinit_deep(jax.random.PRNGKey(seed), Z,
                                            n_stages=n_stages, d_model=D))
    p["w_head"] = rng.normal(0, 0.2, p["w_head"].shape).astype(np.float32)
    p["w_skip"] = rng.normal(0, 0.2, p["w_skip"].shape).astype(np.float32)
    return p


def jstage(blk, h):
    return jblock_fn(blk, h, jnp.float32)


def pstage(blk, h):
    return block_fn(blk, h, torch.float32)


@pytest.mark.parametrize("n_microbatches", [1, 2, 4, 8])
@pytest.mark.parametrize("n_stages", [8, 16])
def test_pipeline_matches_jax_and_the_sequential_stack(n_microbatches,
                                                       n_stages):
    """S = 16 on 8 shards: two consecutive blocks a shard."""
    params = deep_params(n_stages, seed=n_stages)
    x = np.random.default_rng(n_microbatches).normal(
        size=(16, D)).astype(np.float32)
    want = np.asarray(jmake_pipeline(
        jmake_mesh([8], ["stage"]), jstage, n_microbatches=n_microbatches)(
        jax.tree.map(jnp.asarray, params["blocks"]), jnp.asarray(x)))
    blocks = port_est.params_from_numpy("deep", params)["blocks"]
    got = make_pipeline(stage_mesh(), pstage,
                        n_microbatches=n_microbatches)(
        blocks, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    seq = torch.from_numpy(x)
    for s in range(n_stages):
        seq = pstage({k: v[s] for k, v in blocks.items()}, seq)
    np.testing.assert_allclose(got, seq.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_fewer_stages_than_blocks(n):
    params = port_est.params_from_numpy("deep", deep_params(4, seed=3))
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(12, D)).astype(np.float32))
    got = make_pipeline(stage_mesh(n), pstage, n_microbatches=3)(
        params["blocks"], x)
    seq = x
    for s in range(4):
        seq = pstage({k: v[s] for k, v in params["blocks"].items()}, seq)
    np.testing.assert_allclose(got.numpy(), seq.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_indivisible_batch_and_stack_raise():
    blocks = port_est.params_from_numpy("deep", deep_params(8))["blocks"]
    pipe = make_pipeline(stage_mesh(), pstage, n_microbatches=3)
    with pytest.raises(ValueError, match="not divisible"):
        pipe(blocks, torch.zeros((16, D)))
    six = {k: v[:6] for k, v in blocks.items()}
    with pytest.raises(ValueError, match="do not divide"):
        make_pipeline(stage_mesh(), pstage)(six, torch.zeros((16, D)))


@pytest.mark.parametrize("cd", ["f32", "bf16"])
def test_pipelined_deep_matches_jax_and_dense(cd):
    params = deep_params(8, seed=5)
    rng = np.random.default_rng(6)
    feats = rng.uniform(0.0, 2.0, (24, 7)).astype(np.float32)
    valid = np.arange(24) % 5 != 0
    jcd = jnp.float32 if cd == "f32" else jnp.bfloat16
    tcd = torch.float32 if cd == "f32" else torch.bfloat16
    want = np.asarray(jmake_pipelined_deep(
        jmake_mesh([8], ["stage"]), n_microbatches=4, compute_dtype=jcd)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(feats),
        jnp.asarray(valid)))
    pp = port_est.params_from_numpy("deep", params)
    args = (torch.from_numpy(feats), torch.from_numpy(valid))
    got = make_pipelined_deep(stage_mesh(), n_microbatches=4,
                              compute_dtype=tcd)(pp, *args).numpy()
    dense = functools.partial(predict_deep, compute_dtype=tcd)(
        pp, *args).numpy()
    if cd == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-2,
                                   atol=1e-2 * float(np.abs(want).max()))
    np.testing.assert_allclose(got, dense, rtol=1e-5, atol=1e-5)
    assert np.all(got[~valid] == 0.0) and np.all(got >= 0.0)
