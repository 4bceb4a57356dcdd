"""The GPipe pipeline, expert parallelism and the DP×TP step across two
processes, against the same mesh in one process and against JAX's
8-device programs.

Two ranks join a gloo job on 127.0.0.1 (``tests/torch_dist_worker.py``,
suite ``stages``, one spawn per layout, each under its own 60 s limit).
In the ``blocks`` layout each rank owns half of a mesh's shards in order
(stages 0-3 and 4-7 of 8, experts' shards likewise, node rows 0-1 and
2-3 of the trainer's 4 × 2 grid); in ``interleaved`` shard k belongs to
rank k % 2, so every pipeline hop crosses and every node row of the
trainer spans both ranks. Every rank computes the whole outputs. Held
to:

- the same mesh in one process: bit-equal at f32 and bf16, outputs,
  losses and gathered params alike (the collectives move the same values
  and add in the same order);
- JAX on the 8 CPU devices ``tests/conftest.py`` forces (the 4-stage
  pipeline on 4) with the tolerances of ``tests/test_torch_pipeline.py``
  (f32 rtol = atol = 1e-5; the bf16 deep estimator rtol 1e-2, atol
  1e-2 · max|watts|), ``tests/test_torch_expert.py`` (f32 rtol 1e-5,
  atol 1e-6; bf16 rtol 2e-3, atol 1e-4) and
  ``tests/test_torch_trainer.py`` (bf16 losses rtol 1e-2, params rtol =
  atol = 1e-3).

A batch that does not divide raises the same ValueError on both ranks
at once, and the ranks stay in step for the next call.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kepler_tpu.models import train as jtrain
from kepler_tpu.parallel import make_distributed_train_step as jdp_step
from kepler_tpu.parallel import make_expert_parallel_moe as jmake_ep
from kepler_tpu.parallel import make_mesh as jmake_mesh
from kepler_tpu.parallel import make_pipeline as jmake_pipeline
from kepler_tpu.parallel import make_pipelined_deep as jmake_pipelined_deep
from kepler_tpu.parallel import shard_train_state as jshard
from kepler_tpu.parallel import top1_route as jtop1_route
from tests import torch_dist_worker as worker
from tests.test_torch_expert import assert_close as expert_close
from tests.test_torch_expert import params_and_rows
from tests.test_torch_pipeline import D, deep_params, jstage
from tests.test_torch_trainer import batch, mlp_params

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
LAYOUTS = list(worker.LAYOUTS)


def inputs() -> dict:
    """Every input of the stages suite, seeded numpy."""
    a: dict = {}
    for key, val in deep_params(8, seed=5).items():
        if key == "blocks":
            a.update({f"pp/blocks/{k}": v for k, v in val.items()})
        else:
            a[f"pp/{key}"] = val
    rng = np.random.default_rng(6)
    a["pp_in/feats"] = rng.uniform(0.0, 2.0, (24, 7)).astype(np.float32)
    a["pp_in/valid"] = np.arange(24) % 5 != 0
    a["pp_in/x"] = np.random.default_rng(4).normal(
        size=(16, D)).astype(np.float32)
    moe, feats = params_and_rows(8, seed=9)
    a.update({f"ep/{k}": v for k, v in moe.items()})
    a["ep_in/feats"] = feats
    a["ep_in/eid"] = (np.arange(64) * 7 % 8).astype(np.int32)
    outside = (np.arange(64) % 8).astype(np.int32)
    outside[[3, 17, 40]] = [-1, 8, 99]
    a["ep_in/outside"] = outside
    nan = feats.copy()
    nan[10] = np.nan  # shard 1
    a["ep_in/nan_feats"] = nan
    a.update({f"mp/{k}": v for k, v in mlp_params(3).items()})
    for s in range(3):
        for key, x in zip(("x", "valid", "y"), batch(1 + s)):
            a[f"dp/{key}{s}"] = x
    return a


@pytest.fixture(scope="module")
def stage_inputs(tmp_path_factory):
    """(inputs, their .npz, one process's outputs)."""
    tmp = tmp_path_factory.mktemp("dist_stages")
    a = inputs()
    np.savez(tmp / "in.npz", **a)
    return a, tmp / "in.npz", worker.run_stages(a, None)


@pytest.fixture(scope="module", params=LAYOUTS)
def ranks(request, stage_inputs, tmp_path_factory):
    """[rank 0's, rank 1's] outputs of the stages suite in one layout."""
    _, path, _ = stage_inputs
    return worker.spawn("stages", request.param, path,
                        tmp_path_factory.mktemp(f"stages_{request.param}"))


KEYS = ["pipeline_8", "pipeline_4", "deep_f32", "deep_bf16",
        "expert_explicit_f32", "expert_explicit_bf16", "expert_top1",
        "expert_overflow", "expert_outside", "expert_nan", "dp_tp_bf16",
        "dp_tp_f32"]


@pytest.mark.parametrize("case", KEYS)
def test_across_ranks_equals_one_process(stage_inputs, ranks, case):
    """Every output of ``case`` (the DP×TP step's losses and gathered
    params too) bit-equal on both ranks and to one process's."""
    _, _, one = stage_inputs
    keys = sorted(k for k in one if k == case or k.startswith(case + "/"))
    assert keys
    for out in ranks:
        assert out["leaked"].size == 0, out["leaked"]
        for key in keys:
            np.testing.assert_array_equal(out[key], one[key], err_msg=key)


def jax_params_of(a: dict, prefix: str) -> dict:
    out: dict = {}
    for key, val in a.items():
        if key.startswith(prefix):
            *outer, leaf = key[len(prefix):].split("/")
            node = out
            for part in outer:
                node = node.setdefault(part, {})
            node[leaf] = jnp.asarray(val)
    return out


@pytest.mark.parametrize("n", [8, 4])
def test_pipeline_matches_jax(stage_inputs, ranks, n):
    """8 stages of one block, 4 stages of two (JAX on 4 devices)."""
    a, _, _ = stage_inputs
    want = np.asarray(jmake_pipeline(
        jmake_mesh([n], ["stage"], devices=jax.devices()[:n]), jstage,
        n_microbatches=4)(jax_params_of(a, "pp/")["blocks"],
                          jnp.asarray(a["pp_in/x"])))
    for out in ranks:
        np.testing.assert_allclose(out[f"pipeline_{n}"], want, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("cd", ["f32", "bf16"])
def test_pipelined_deep_matches_jax(stage_inputs, ranks, cd):
    a, _, _ = stage_inputs
    want = np.asarray(jmake_pipelined_deep(
        jmake_mesh([8], ["stage"]), n_microbatches=4, compute_dtype=JDT[cd])(
        jax_params_of(a, "pp/"), jnp.asarray(a["pp_in/feats"]),
        jnp.asarray(a["pp_in/valid"])))
    for out in ranks:
        got = out[f"deep_{cd}"]
        if cd == "f32":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-2,
                                       atol=1e-2 * float(np.abs(want).max()))
        assert np.all(got[~a["pp_in/valid"]] == 0.0)


def jax_expert(a: dict, case: str) -> np.ndarray:
    """JAX's expert-parallel MoE on 8 devices for ``case``."""
    params = jax_params_of(a, "ep/")
    feats = jnp.asarray(a["ep_in/nan_feats" if case == "nan"
                          else "ep_in/feats"])
    ones = jnp.ones(feats.shape[0])
    kw = {"capacity_factor": 0.5} if case == "overflow" else {}
    cd = jnp.bfloat16 if case == "explicit_bf16" else jnp.float32
    if case == "top1":
        route = jtop1_route(params, feats)
    elif case == "overflow":
        route = (jnp.zeros(feats.shape[0], jnp.int32), ones)
    else:
        route = (jnp.asarray(a["ep_in/outside" if case == "outside"
                               else "ep_in/eid"]), ones)
    return np.asarray(jmake_ep(jmake_mesh([8], ["expert"]), compute_dtype=cd,
                               **kw)(params, feats, *route))


@pytest.mark.parametrize("case", ["explicit_f32", "explicit_bf16", "top1",
                                  "overflow", "outside"])
def test_expert_parallelism_matches_jax(stage_inputs, ranks, case):
    """Capacity 0.5 with every row on expert 0 keeps 4 of each shard's 8
    rows and zeroes the rest; ids -1, 8 and 99 get zero watts."""
    a, _, _ = stage_inputs
    want = jax_expert(a, case)
    for out in ranks:
        got = out[f"expert_{case}"]
        expert_close(got, want, "bf16" if case == "explicit_bf16" else "f32")
        if case == "overflow":
            zero = np.all(got == 0.0, axis=-1).reshape(8, 8)
            np.testing.assert_array_equal(zero.sum(axis=1), np.full(8, 4))
        if case == "outside":
            assert np.all(got[[3, 17, 40]] == 0.0)


def test_expert_nan_row_stays_in_its_own_row(stage_inputs, ranks):
    """The one-process port's known difference, across ranks too: the
    NaN row alone is NaN, and every other row equals JAX's where JAX's
    is finite."""
    a, _, _ = stage_inputs
    want = jax_expert(a, "nan")
    ok = ~np.isnan(want).any(axis=-1)
    for out in ranks:
        got = out["expert_nan"]
        assert np.isnan(got).any(axis=-1).nonzero()[0].tolist() == [10]
        np.testing.assert_allclose(got[ok], want[ok], rtol=1e-5, atol=1e-6)


def test_dp_tp_steps_match_jax(stage_inputs, ranks):
    a, _, _ = stage_inputs
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


def test_node_rows_across_ranks_as_the_layout_says(ranks):
    """The trainer's 4 × 2 grid as the ranks built it: under
    ``interleaved`` all 4 node rows hold shards of both ranks, under
    ``blocks`` none does."""
    for out in ranks:
        want = {"interleaved": 4, "blocks": 0}[str(out["layout"])]
        assert int(out["dp_tp_rows_across_ranks"]) == want


def test_device_tier_sees_each_crossing_as_one_op(stage_inputs, ranks):
    """Under the device tier's recorder the pipelined deep reports its
    ring shifts (and, across ranks, the broadcast of the last stage's
    output) and the experts their all-to-alls (and the all-gather of the
    row blocks); each cross-process leg is one ``crossing:<name>`` op:
    M + n − 1 = 11 shifts and 1 broadcast, 2 all-to-alls and 1
    all-gather on each rank, none in one process."""
    _, _, one = stage_inputs
    assert one["recorded_pipeline/collectives"].tolist() == ["ppermute"]
    assert one["recorded_expert/collectives"].tolist() == ["all_to_all"]
    for label in ("pipeline", "expert"):
        assert one[f"recorded_{label}/crossings"].tolist() == [0, 0]
    for out in ranks:
        assert (out["recorded_pipeline/collectives"].tolist()
                == ["broadcast", "ppermute"])
        assert out["recorded_pipeline/crossings"].tolist() == [11, 1]
        assert (out["recorded_expert/collectives"].tolist()
                == ["all_gather", "all_to_all"])
        assert out["recorded_expert/crossings"].tolist() == [2, 1]


def test_traffic_crossed_on_every_rank(ranks):
    """The hops, the broadcast, the all-to-alls, the all-gathers and the
    psums all crossed between the ranks."""
    for out in ranks:
        for name in ("ppermute", "broadcast", "all_to_all", "all_gather",
                     "psum"):
            assert int(out[f"crossing/{name}/calls"]) > 0, name


def test_indivisible_batch_raises_on_both_ranks(stage_inputs, tmp_path):
    """16 rows in 3 microbatches, 60 rows over 8 expert shards and 6
    nodes over 4 node rows: each raises its ValueError on both ranks
    before any collective (well inside the short group timeout, so no
    rank waits on the other), and the next call runs in step on both."""
    a, path, one = stage_inputs
    words = {"pipeline": "not divisible by 3 microbatches",
             "expert": "must divide", "trainer": "does not divide"}
    for out in worker.spawn("indivisible", "interleaved", path, tmp_path):
        for name, said in words.items():
            error = str(out[f"{name}/error"])
            assert error.startswith("ValueError") and said in error, error
            assert float(out[f"{name}/seconds"]) < worker.HANG_TIMEOUT_S
        np.testing.assert_array_equal(out["after"], one["pipeline_8"])
