"""The parallel families across two processes: the ring, its serving
program and train step, Ulysses and the DP×TP step, against the same
mesh in one process and against JAX's 8-device programs.

Two ranks join a gloo job on 127.0.0.1 (``tests/torch_dist_worker.py``,
each spawn under its own 60 s limit), each owning half of the mesh's
shards in blocks (ranks 0 and 1: shards 0-3 and 4-7 of the ring's 8,
0-1 and 2-3 of Ulysses' 4, node rows 0-1 and 2-3 of the trainer's 4 × 2
grid); the ring and its serving program also run with the shards
interleaved (even and odd). Every rank computes the whole outputs. Held
to:

- the same mesh in one process: bit-equal at f32 and bf16, outputs,
  losses, gradients and updated params alike (the collectives move the
  same values and add in the same order);
- JAX on the 8 CPU devices ``tests/conftest.py`` forces (Ulysses on 4)
  with the tolerances of ``tests/test_torch_ring.py``,
  ``tests/test_torch_ulysses.py`` and ``tests/test_torch_trainer.py``:
  attention f32 rtol = atol = 1e-5, bf16 rtol 1e-2, atol 1e-2 · max|out|;
  serving watts f32 rtol = atol = 1e-5, bf16 atol 1e-2 · max|watts|; the
  sequence-parallel train step's losses rtol 1e-5, params rtol 1e-4,
  atol 1e-5; the DP×TP step (bf16) losses rtol 1e-2, params rtol = atol
  = 1e-3.

A peer that joins and never calls the ring makes the ring raise within
the group's timeout; a peer that never joins makes the join fail within
its timeout and the ring over both ranks' shards refuse to build.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kepler_tpu.models import train as jtrain
from kepler_tpu.parallel import make_distributed_train_step as jdp_step
from kepler_tpu.parallel import make_mesh as jmake_mesh
from kepler_tpu.parallel import make_ring_attention as jring
from kepler_tpu.parallel import make_sequence_parallel_train_step as jsp_step
from kepler_tpu.parallel import make_temporal_program as jsp_program
from kepler_tpu.parallel import shard_train_state as jshard
from kepler_tpu.parallel.ulysses import make_ulysses_attention as july
from kepler_tpu.parallel.ulysses import \
    make_ulysses_temporal_program as july_program
from tests import torch_dist_worker as worker
from tests.test_torch_ring import (BLOCK_T_MAX, LENGTHS, assert_out,
                                   assert_watts, block_inputs, jax_params,
                                   qkv, valid_of)
from tests.test_torch_trainer import batch, mlp_params

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def inputs() -> dict:
    """Every input of the families suite, seeded numpy."""
    a: dict = {}
    q, k, v = qkv(21)
    a.update({"ring/q": q, "ring/k": k, "ring/v": v,
              "ring/tv": valid_of(LENGTHS["ragged"])})
    uq, uk, uv = qkv(22)
    a.update({"uly/q": uq, "uly/k": uk, "uly/v": uv,
              "uly/tv": valid_of(LENGTHS["full"])})
    a.update({f"tp/{k}": v for k, v in jax_params(
        d_model=32, t_max=BLOCK_T_MAX, seed=31).items()})
    for key, x in zip(("hist", "wv", "tv", "targets"), block_inputs(32)):
        a[f"sp/{key}"] = x
    a.update({f"mp/{k}": v for k, v in mlp_params(3).items()})
    for s in range(3):
        for key, x in zip(("x", "valid", "y"), batch(1 + s)):
            a[f"dp/{key}{s}"] = x
    return a


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, one-process outputs, [rank 0's, rank 1's] outputs)."""
    tmp = tmp_path_factory.mktemp("dist_families")
    a = inputs()
    np.savez(tmp / "in.npz", **a)
    ranks = worker.spawn("families", "blocks", tmp / "in.npz", tmp)
    return a, worker.run_families(a, None), ranks


KEYS = ["ring_f32", "ring_bf16", "ring_pallas_f32", "ring_f32_interleaved",
        "serve_f32", "serve_bf16", "serve_f32_interleaved", "ulysses_f32",
        "ulysses_bf16", "ulysses_serve_f32", "sp_remat0", "sp_remat1",
        "dp_tp_bf16", "dp_tp_f32"]


@pytest.mark.parametrize("case", KEYS)
def test_across_ranks_equals_one_process(runs, case):
    """Every output of ``case`` (a train step's losses, params and
    gradients too) bit-equal on both ranks and to one process's."""
    _, one, ranks = runs
    keys = sorted(k for k in one if k == case or k.startswith(case + "/"))
    assert keys
    for out in ranks:
        assert out["leaked"].size == 0, out["leaked"]
        for key in keys:
            np.testing.assert_array_equal(out[key], one[key], err_msg=key)


def jax_params_of(a: dict, prefix: str) -> dict:
    return {k[len(prefix):]: jnp.asarray(v) for k, v in a.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("cd", ["f32", "bf16"])
def test_ring_and_its_serving_program_match_jax(runs, cd):
    a, _, ranks = runs
    mesh8 = jmake_mesh([8], ["seq"])
    args = [jnp.asarray(a[f"ring/{k}"]) for k in ("q", "k", "v", "tv")]
    want = np.asarray(jring(mesh8, compute_dtype=JDT[cd])(*args))
    serve = [jnp.asarray(a[f"sp/{k}"]) for k in ("hist", "wv", "tv")]
    watts = np.asarray(jsp_program(mesh8, compute_dtype=JDT[cd])(
        jax_params_of(a, "tp/"), *serve))
    for out in ranks:
        assert_out(out[f"ring_{cd}"], want, cd)
        assert_watts(out[f"serve_{cd}"], watts, cd)
        if cd == "f32":
            assert_out(out["ring_pallas_f32"], want, cd)
            assert_out(out["ring_f32_interleaved"], want, cd)
            assert_watts(out["serve_f32_interleaved"], watts, cd)


@pytest.mark.parametrize("cd", ["f32", "bf16"])
def test_ulysses_matches_jax_on_four_devices(runs, cd):
    a, _, ranks = runs
    mesh4 = jmake_mesh([4], ["seq"], devices=jax.devices()[:4])
    args = [jnp.asarray(a[f"uly/{k}"]) for k in ("q", "k", "v", "tv")]
    want = np.asarray(july(mesh4, compute_dtype=JDT[cd])(*args))
    for out in ranks:
        assert_out(out[f"ulysses_{cd}"], want, cd)
    if cd == "f32":
        serve = [jnp.asarray(a[f"sp/{k}"]) for k in ("hist", "wv", "tv")]
        watts = np.asarray(july_program(mesh4, compute_dtype=jnp.float32)(
            jax_params_of(a, "tp/"), *serve))
        for out in ranks:
            assert_watts(out["ulysses_serve_f32"], watts, cd)


@pytest.mark.parametrize("remat", [0, 1])
def test_sequence_parallel_train_steps_match_jax(runs, remat):
    a, _, ranks = runs
    jopt = jtrain.make_optimizer(1e-2)
    jstep = jsp_step(jmake_mesh([8], ["seq"]), jopt, remat=bool(remat))
    jstate = jtrain.create_train_state(jax_params_of(a, "tp/"), jopt)
    losses = []
    for _ in range(2):
        jstate, loss = jstep(jstate, *(jnp.asarray(a[f"sp/{k}"]) for k in
                                       ("hist", "wv", "tv", "targets")))
        losses.append(float(loss))
    for out in ranks:
        np.testing.assert_allclose(out[f"sp_remat{remat}/losses"], losses,
                                   rtol=1e-5)
        for key, val in jstate.params.items():
            np.testing.assert_allclose(out[f"sp_remat{remat}/{key}"],
                                       np.asarray(val), rtol=1e-4,
                                       atol=1e-5, err_msg=key)


def test_dp_tp_steps_match_jax(runs):
    a, _, ranks = runs
    jmesh = jmake_mesh([4, 2], ["node", "model"])
    jopt = jtrain.make_optimizer(1e-2)
    jstate = jshard(jtrain.create_train_state(jax_params_of(a, "mp/"),
                                              jopt), jmesh)
    jstep = jdp_step(jmesh, jopt)
    losses = []
    for s in range(3):
        jstate, loss = jstep(jstate, *(jnp.asarray(a[f"dp/{k}{s}"])
                                       for k in ("x", "valid", "y")))
        losses.append(float(loss))
    for out in ranks:
        np.testing.assert_allclose(out["dp_tp_bf16/losses"], losses,
                                   rtol=1e-2)
        assert out["dp_tp_bf16/losses"][-1] < out["dp_tp_bf16/losses"][0]
        for key, val in jstate.params.items():
            np.testing.assert_allclose(out[f"dp_tp_bf16/{key}"],
                                       np.asarray(val), rtol=1e-3, atol=1e-3,
                                       err_msg=key)


def test_traffic_crossed_on_every_rank(runs):
    """The ring hops, the all-to-alls, the all-gathers and the psums
    all crossed between the ranks."""
    _, _, ranks = runs
    for out in ranks:
        for name in ("ppermute", "all_to_all", "all_gather", "psum"):
            assert int(out[f"crossing/{name}/calls"]) > 0, name


def test_device_tier_sees_each_crossing_as_one_op(runs):
    """Under the device tier's recorder the serving program reports the
    collectives it reports in one process, and each cross-process leg is
    one ``crossing:<name>`` op: 7 hops × (k, v, validity) ring shifts and
    the two psums, on each rank (none in one process)."""
    _, one, ranks = runs
    assert one["recorded/collectives"].tolist() == ["ppermute", "psum"]
    assert one["recorded/crossings"].tolist() == [0, 0]
    for out in ranks:
        assert (out["recorded/collectives"].tolist()
                == one["recorded/collectives"].tolist())
        assert out["recorded/crossings"].tolist() == [21, 2]


@pytest.mark.parametrize("suite", ["hang", "alone"])
def test_a_missing_peer_raises_within_the_timeout(tmp_path, suite):
    """``hang``: rank 1 joins and never calls the ring, and rank 0's
    ring raises within the group's timeout (plus its start-up);
    ``alone``: rank 1 never starts, rank 0's join fails within its
    timeout and the ring over both ranks' shards is refused."""
    np.savez(tmp_path / "in.npz", **{k: v for k, v in inputs().items()
                                     if k.startswith("ring/")})
    out = worker.spawn(suite, "blocks", tmp_path / "in.npz", tmp_path)[0]
    bound = worker.HANG_TIMEOUT_S + 10
    if suite == "hang":
        assert str(out["error"]) != "no error"
        assert float(out["seconds"]) < bound, float(out["seconds"])
    else:
        assert str(out["join"]) != "joined"
        assert float(out["join_s"]) < bound, float(out["join_s"])
        assert "cross-process collectives" in str(out["error"])
