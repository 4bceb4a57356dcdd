"""The port's Ulysses (all-to-all) context parallelism against the JAX
package's, on 2 and 4 shards.

The port runs on virtual ``cpu`` shards, JAX on as many of the CPU
devices ``tests/conftest.py`` forces; inputs are seeded numpy.
Tolerances, as ``tests/test_ulysses.py``'s: attention at f32 rtol 1e-5,
atol 1e-5 (against JAX, dense attention and the port's ring); the
temporal program at f32 rtol 1e-4, atol 1e-5; at bf16 rtol 1e-2, atol
1e-2 · max|out|.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kepler_tpu.parallel import make_mesh as jmake_mesh
from kepler_tpu.parallel.ulysses import make_ulysses_attention as july
from kepler_tpu.parallel.ulysses import \
    make_ulysses_temporal_program as july_program
from kepler_tpu_torch.models import estimator as port_est
from kepler_tpu_torch.models.temporal import predict_temporal
from kepler_tpu_torch.parallel import (full_attention, make_mesh,
                                       make_ring_attention,
                                       make_ulysses_attention,
                                       make_ulysses_temporal_program,
                                       ulysses_attention_shardmap)
from tests.test_torch_ring import DTYPES, LENGTHS, qkv, t_, valid_of
from tests.test_torch_temporal import jax_params


def seq_mesh(n: int):
    return make_mesh([n], ["seq"], devices=["cpu"] * n)


def jseq_mesh(n: int):
    return jmake_mesh([n], ["seq"], devices=jax.devices()[:n])


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("cd", ["f32", "bf16"])
@pytest.mark.parametrize("lengths", ["full", "ragged", "fully_masked"])
def test_ulysses_matches_jax_dense_and_the_ring(n, causal, cd, lengths):
    q, k, v = qkv(n + 3 * causal)
    tv = valid_of(LENGTHS[lengths])
    jcd, tcd = DTYPES[cd]
    want = np.asarray(july(jseq_mesh(n), causal=causal, compute_dtype=jcd)(
        *(jnp.asarray(x) for x in (q, k, v, tv))))
    args = [t_(x) for x in (q, k, v, tv)]
    got = make_ulysses_attention(seq_mesh(n), causal=causal,
                                 compute_dtype=tcd)(*args).numpy()
    dense = full_attention(*args[:3], causal=causal, t_valid=args[3],
                           compute_dtype=tcd).numpy()
    ring = make_ring_attention(seq_mesh(n), causal=causal,
                               compute_dtype=tcd)(*args).numpy()
    for ref in (want, dense, ring):
        if cd == "f32":
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-2,
                                       atol=1e-2 * float(np.abs(ref).max()))
    # Ulysses attends densely per head: bit-equal to dense attention
    np.testing.assert_array_equal(got, dense)


def test_more_shards_than_heads_fails_loudly():
    q, k, v = qkv(1, h=4)
    attn = ulysses_attention_shardmap(seq_mesh(8),
                                      compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="ring for more parallelism"):
        attn(*(t_(x) for x in (q, k, v, valid_of(LENGTHS["full"]))))
    with pytest.raises(ValueError, match="does not divide"):
        make_ulysses_attention(seq_mesh(4))(*(t_(x) for x in qkv(2, t=6)),
                                            t_(np.ones((3, 6), bool)))


@pytest.mark.parametrize("cd", ["f32", "bf16"])
def test_ulysses_temporal_program_matches_jax_and_dense_serving(cd):
    params = jax_params(d_model=32, t_max=32, seed=21)
    rng = np.random.default_rng(22)
    hist = rng.uniform(0.0, 3.0, (6, 32, 7)).astype(np.float32)
    wv = np.array([True] * 5 + [False])
    tv = valid_of([32, 20, 32, 7, 32, 0])
    jcd, tcd = DTYPES[cd]
    want = np.asarray(july_program(jseq_mesh(4), compute_dtype=jcd)(
        jax.tree.map(jnp.asarray, params),
        *(jnp.asarray(x) for x in (hist, wv, tv))))
    pp = port_est.params_from_numpy("temporal", params)
    args = [t_(x) for x in (hist, wv, tv)]
    got = make_ulysses_temporal_program(seq_mesh(4), compute_dtype=tcd)(
        pp, *args).numpy()
    dense = predict_temporal(pp, *args, compute_dtype=tcd).numpy()
    for ref in (want, dense):
        if cd == "f32":
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-2,
                                       atol=1e-2 * float(np.abs(ref).max()))
    assert np.all(got[~wv] == 0.0)


# -- the per-shard program (the trunk on each shard's T/n block) --------------

@pytest.mark.parametrize("cd", ["f32", "bf16"])
def test_per_shard_ulysses_program_matches_jax_and_dense(cd):
    """The Ulysses program on 4 shards (blocks of 16 ticks, windows
    ending on a block boundary, one empty) against JAX's
    ``make_ulysses_temporal_program`` on 4 devices and the dense path:
    f32 within rtol = atol = 1e-5, bf16 within 1e-2 · max|watts|."""
    from tests.test_torch_ring import BLOCK_T_MAX, assert_watts, block_inputs

    params = jax_params(d_model=32, t_max=BLOCK_T_MAX, seed=43)
    hist, wv, tv, _ = block_inputs(44)
    jcd, tcd = DTYPES[cd]
    want = np.asarray(july_program(jseq_mesh(4), compute_dtype=jcd)(
        jax.tree.map(jnp.asarray, params),
        *(jnp.asarray(x) for x in (hist, wv, tv))))
    pp = port_est.params_from_numpy("temporal", params)
    args = [t_(x) for x in (hist, wv, tv)]
    got = make_ulysses_temporal_program(seq_mesh(4), compute_dtype=tcd)(
        pp, *args).numpy()
    dense = predict_temporal(pp, *args, compute_dtype=tcd).numpy()
    for ref in (want, dense):
        assert_watts(got, ref, cd)
    assert np.all(got[~wv] == 0.0)


def test_per_shard_ulysses_program_refuses_more_shards_than_heads():
    from tests.test_torch_ring import BLOCK_T_MAX, block_inputs

    pp = port_est.params_from_numpy(
        "temporal", jax_params(d_model=32, t_max=BLOCK_T_MAX, seed=45))
    hist, wv, tv, _ = block_inputs(46)
    with pytest.raises(ValueError, match="ring for more parallelism"):
        make_ulysses_temporal_program(seq_mesh(8))(
            pp, *(t_(x) for x in (hist, wv, tv)))


@pytest.mark.parametrize("cd", ["f32", "bf16"])
def test_ulysses_blocks_equal_the_whole_tensor_form(cd):
    from kepler_tpu_torch.parallel.ring import join_blocks, split_blocks
    from kepler_tpu_torch.parallel.ulysses import ulysses_blocks

    q, k, v = qkv(47)
    tv = valid_of(LENGTHS["ragged"])
    _, tcd = DTYPES[cd]
    mesh = seq_mesh(4)
    devices = list(mesh.devices)
    whole = make_ulysses_attention(mesh, compute_dtype=tcd)(
        *(t_(x) for x in (q, k, v, tv)))
    out = ulysses_blocks(*(split_blocks(t_(x), devices)
                           for x in (q, k, v, tv)),
                         devices=devices, compute_dtype=tcd)
    assert [o.shape for o in out] == [(3, 8, 4, 16)] * 4
    assert torch.equal(join_blocks(out, devices[0]), whole)
