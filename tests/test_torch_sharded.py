"""The port's sharded fleet window against the JAX package's, on the CPU.

``kepler_tpu_torch.fleet.window.ShardedWindowEngine`` over 8 virtual
``cpu`` shards is fed the same rows as the JAX ``ShardedWindowEngine``
over the 8 CPU devices ``tests/conftest.py`` gives JAX, window by window,
through one churn schedule: a full pack, changed rows, a drop, a rejoin
and a join, a bucket overflow that rebalances every shard, and a
zone-axis change. At every window both engines hold the same sticky
node→shard map, the same per-shard H2D counts and the same introspection
(sticky map, bucket ladders with the per-shard delta ladders).

Tolerances, per window:

- ratio-only fleets (einsum and pallas — the pallas program launches
  B1's plain version once per shard here, the JAX one its Pallas kernel
  in interpret mode per shard): the f16 plane bit-equal;
- mixed MLP fleets (einsum: the sparse program on shard-local model
  rows; pallas: the dense program): ratio rows bit-equal, model rows
  within rtol 1e-3 (atol 1e-3 W) on the f16 plane — one f16 ulp plus
  matmul summation order.

The port's sharded engine is also held, node by node, against its own
single-device ``PackedWindowEngine`` (ratio rows bit-equal), and the
Aggregator's sharded rung 0 against the JAX Aggregator on the same
meshes (the pipeline tests' sticky-assignment, changed-row and overflow
cases, with equal per-shard H2D every window).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

from kepler_tpu.fleet.window import RowInput as JaxRow
from kepler_tpu.fleet.window import ShardedWindowEngine as JaxSharded
from kepler_tpu.models.mlp import init_mlp
from kepler_tpu.parallel.mesh import make_mesh as jax_mesh
from kepler_tpu_torch.fleet.window import (PackedWindowEngine,
                                           ShardedWindowEngine,
                                           fetch_plane)
from kepler_tpu_torch.parallel.fleet import MODE_MODEL, MODE_RATIO
from kepler_tpu_torch.parallel.mesh import make_mesh
from kepler_tpu_torch.parallel.packed import make_packed_fleet_program
from tests.test_torch_aggregator import Pair, assert_same_window
from tests.test_torch_window import to_port
from tests.test_window_pipeline import ZONES, ZONES_WIDE, make_report

N_SHARDS = 8


def port_mesh(n: int = N_SHARDS):
    return make_mesh([n], devices=["cpu"] * n)


def churn_plan() -> list[dict]:
    """Per window {name: (seed, zones, mode, seq)}; a node's content
    (and so its ``(run, seq)`` identity) changes only where its seq
    moves."""
    base = {f"n{i:02d}": (i, ZONES, MODE_MODEL if i % 2 else MODE_RATIO, 1)
            for i in range(10)}
    w = [dict(base)]                                  # full pack, sb = 2
    w1 = dict(base)
    for name in ("n01", "n04"):                       # changed rows
        seed, z, m, seq = w1[name]
        w1[name] = (seed + 500, z, m, seq + 1)
    w.append(w1)
    w.append({k: v for k, v in w1.items() if k != "n03"})  # drop
    w3 = dict(w1)
    w3["n03"] = (333, ZONES, MODE_MODEL, 7)           # rejoin, new data
    w3["n10"] = (10, ZONES, MODE_RATIO, 1)            # join
    w.append(w3)
    w4 = dict(w3)                                     # 19 nodes > 16
    w4.update({f"m{i:02d}": (40 + i, ZONES,
                             MODE_MODEL if i % 3 else MODE_RATIO, 1)
               for i in range(8)})                    # rows: rebalance
    w.append(w4)
    w.append(dict(w4))                                # steady
    w6 = dict(w4)
    w6["n02"] = (222, ZONES_WIDE, MODE_RATIO, 2)      # zone-axis change
    w.append(w6)
    w7 = dict(w6)
    seed, z, m, seq = w7["m03"]
    w7["m03"] = (seed + 900, z, m, seq + 1)
    w.append(w7)
    return w


def windows(plan: list[dict]) -> list[tuple[list, tuple]]:
    """The plan as the JAX engines' rows → [(rows, canonical zones)]."""
    out = []
    for sched in plan:
        rows = [JaxRow(name=name,
                       report=make_report(name, seed, zones=zones,
                                          mode=mode),
                       zone_names=tuple(zones), ident=("r1", seq))
                for name, (seed, zones, mode, seq) in sorted(sched.items())]
        wide = any(len(r.zone_names) == 3 for r in rows)
        out.append((rows, ZONES_WIDE if wide else ZONES))
    return out


def mlp_params(n_zones: int) -> dict:
    return {k: np.asarray(v) for k, v in
            init_mlp(jax.random.PRNGKey(n_zones), n_zones=n_zones).items()}


PARAMS = {2: mlp_params(2), 3: mlp_params(3)}


def assert_plane(port: np.ndarray, ref: np.ndarray, mode: np.ndarray,
                 model: bool, what: str) -> None:
    assert port.dtype == np.float16 and port.shape == ref.shape, what
    ratio = mode != MODE_MODEL
    np.testing.assert_array_equal(port[ratio], ref[ratio], err_msg=what)
    if model:
        np.testing.assert_allclose(
            port[~ratio].astype(np.float32), ref[~ratio].astype(np.float32),
            rtol=1e-3, atol=1e-3, err_msg=what)
    else:
        np.testing.assert_array_equal(port, ref, err_msg=what)


CASES = [(None, "einsum"), (None, "pallas"), ("mlp", "einsum"),
         ("mlp", "pallas")]


@pytest.mark.parametrize("model_mode,backend", CASES)
def test_sharded_engine_matches_jax_under_churn(model_mode, backend):
    ref = JaxSharded(jax_mesh(), backend=backend, model_mode=model_mode,
                     node_bucket=16, workload_bucket=8)
    eng = ShardedWindowEngine(port_mesh(), backend=backend,
                              model_mode=model_mode, node_bucket=16,
                              workload_bucket=8)
    for win, (rows, zones) in enumerate(windows(churn_plan())):
        params = PARAMS[len(zones)] if model_mode else None
        jp = ref.plan_window(rows, zones, params)
        want = jp.fetch(jp.program(*jp.args))
        plan = eng.plan_window(to_port(rows), zones, params)
        got = fetch_plane(eng.dispatch_window(plan))
        what = f"window {win}"
        assert eng._shard_of == ref._shard_of, what
        assert plan.h2d_shards == jp.h2d_shards, what
        assert plan.n_shards == jp.n_shards == N_SHARDS
        assert plan.meta.rows == jp.meta.rows, what
        mine, theirs = eng.introspect(), ref.introspect()
        assert mine["sticky"] == theirs["sticky"], what
        assert mine["buckets"] == theirs["buckets"], what
        assert mine["shards"] == theirs["shards"], what
        assert_plane(got, np.asarray(want), jp.meta.mode,
                     model_mode is not None, what)
    # the schedule reached every case it names
    assert eng._ladder_n.bucket == 4  # grew 2 → 4 on the overflow


@pytest.mark.parametrize("model_mode,backend", CASES)
def test_sharded_engine_matches_its_single_device_engine(model_mode,
                                                         backend):
    """Node by node, the 8-shard plane equals the port's single-device
    engine's (ratio rows bit-equal; model rows within 1e-3)."""
    sharded = ShardedWindowEngine(port_mesh(), backend=backend,
                                  model_mode=model_mode, node_bucket=16,
                                  workload_bucket=8)
    single = PackedWindowEngine(device="cpu", backend=backend,
                                model_mode=model_mode, node_bucket=16,
                                workload_bucket=8)
    for win, (rows, zones) in enumerate(windows(churn_plan())):
        params = PARAMS[len(zones)] if model_mode else None
        a = sharded.plan_window(to_port(rows), zones, params)
        b = single.plan_window(to_port(rows), zones, params)
        pa = fetch_plane(sharded.dispatch_window(a))
        pb = fetch_plane(single.dispatch_window(b))
        for name, i in a.meta.rows.items():
            j = b.meta.rows[name]
            assert a.meta.mode[i] == b.meta.mode[j]
            if a.meta.mode[i] == MODE_MODEL:
                np.testing.assert_allclose(
                    pa[i].astype(np.float32), pb[j].astype(np.float32),
                    rtol=1e-3, atol=1e-3, err_msg=f"{name} @ {win}")
            else:
                np.testing.assert_array_equal(pa[i], pb[j],
                                              err_msg=f"{name} @ {win}")


def test_sharded_engine_refuses_one_shard_and_2d_meshes():
    for mesh in (port_mesh(1),
                 make_mesh([4, 2], ("node", "model"), devices=["cpu"] * 8)):
        with pytest.raises(ValueError, match="needs a 1-D mesh over the "
                                             "node axis"):
            ShardedWindowEngine(mesh)


def test_sparse_over_a_mesh_needs_shard_local_rows():
    """Sparse + pallas keeps the reference's ValueError; a sparse program
    over a mesh takes shard-local model rows only."""
    with pytest.raises(ValueError, match="requires the einsum backend"):
        make_packed_fleet_program(8, 2, model_mode="mlp", backend="pallas",
                                  model_bucket=8, mesh=port_mesh())
    with pytest.raises(ValueError, match="local_model_rows"):
        make_packed_fleet_program(8, 2, model_mode="mlp", model_bucket=8,
                                  mesh=port_mesh())


def test_unchanged_fleet_stages_nothing_on_any_shard():
    """After every ring slot has served, an unchanged fleet stages zero
    rows on every shard (no H2D, no launch of the scatter)."""
    eng = ShardedWindowEngine(port_mesh(), node_bucket=16,
                              workload_bucket=8)
    rows, zones = windows(churn_plan())[0]
    for _ in range(3):
        plan = eng.plan_window(to_port(rows), zones, None)
        fetch_plane(eng.dispatch_window(plan))
    assert plan.h2d_shards == (0,) * N_SHARDS
    assert eng.introspect()["resident"]["slots"] == 2


# -- the Aggregator's sharded rung 0 against the JAX Aggregator ----------------


def sharded_pair(**kw) -> Pair:
    """Both aggregators over 8 shards: JAX's 8 CPU devices, the port's 8
    virtual cpu shards."""
    pair = Pair(**kw)
    pair.jax._mesh = jax_mesh()
    pair.port._mesh = port_mesh()
    return pair


def agg_schedule(plan: list[dict]) -> list[dict]:
    return [{name: (seed, zones, mode, seq, "r1")
             for name, (seed, zones, mode, seq) in sched.items()}
            for sched in plan]


@pytest.mark.parametrize("model_mode", [None, "mlp"])
def test_aggregator_sharded_rung0_matches_jax(model_mode):
    pair = sharded_pair(model_mode=model_mode, node_bucket=16)
    out_j, out_p = [], []
    for sched in agg_schedule(churn_plan()):
        pair.seed(sched)
        out_j.append(pair.jax.aggregate_once())
        out_p.append(pair.port.aggregate_once())
        for key in ("window_shards", "last_h2d_shards", "last_h2d_rows"):
            assert pair.port._stats[key] == pair.jax._stats[key], key
    for ref, got in zip(out_j, out_p):
        assert_same_window(ref, got,
                           model="packed" if model_mode else "exact")
    for agg in (pair.jax, pair.port):
        assert agg._rung_display(0) == "packed-sharded-pipelined"
        assert agg.window_health()["shards"] == N_SHARDS
    assert type(pair.port._engine) is ShardedWindowEngine
    families = {f.name: f for f in pair.port.collect()}
    assert families["kepler_fleet_window_shards"].samples[0].value == \
        N_SHARDS
    pair.jax.shutdown()
    pair.port.shutdown()


def test_aggregator_2d_mesh_runs_the_unsharded_engine():
    pair = Pair(model_mode=None)
    pair.jax._mesh = jax_mesh([4, 2], ["node", "model"])
    pair.port._mesh = make_mesh([4, 2], ("node", "model"),
                                devices=["cpu"] * 8)
    out_j, out_p = pair.run(agg_schedule(churn_plan())[:3])
    for ref, got in zip(out_j, out_p):
        assert_same_window(ref, got)
    assert type(pair.port._engine) is PackedWindowEngine
    for agg in (pair.jax, pair.port):
        assert agg._stats["window_shards"] == 1
        assert agg.window_health()["rung_name"] == "packed-pipelined"
    # buckets aligned to 8; the batch cut into one block per node row,
    # each on its row's first shard (shards 0, 2, 4, 6), every ring slot
    eng = pair.port._engine
    assert eng._ladder_n.align == 8
    assert [b.shard for b in eng._blocks] == [0, 2, 4, 6]
    nb = eng._key[0]
    for slot in eng._buffers:
        assert [t.shape for t in slot] == [(nb // 4, eng._empty_row.size)] * 4
        assert all(t.device == pair.port._mesh.shards[b.shard].device
                   for t, b in zip(slot, eng._blocks))


def test_sticky_join_drop_rejoin_touch_one_shard_as_jax():
    """The pipeline tests' sticky case through both Aggregators: a join,
    a drop and a rejoin each stage on exactly the owning shard, with the
    same per-shard H2D every window."""
    pair = sharded_pair(node_bucket=32)
    base = {f"n{i:02d}": (i, ZONES, i % 2, 1, "r1") for i in range(10)}
    warm = {n: (s + 1000, z, m, 2, r) for n, (s, z, m, _q, r) in
            base.items()}
    joined = dict(warm)
    joined["n99"] = (99, ZONES, MODE_RATIO, 1, "r1")
    rejoined = dict(warm)
    rejoined["n99"] = (123, ZONES, MODE_RATIO, 2, "r1")
    plan = [base] + [warm] * 4 + [joined] * 3 + [warm] * 3 + [rejoined]
    touched = []
    for sched in plan:
        pair.seed(sched)
        ref, got = pair.jax.aggregate_once(), pair.port.aggregate_once()
        assert_same_window(ref, got)
        assert pair.port._stats["last_h2d_shards"] == \
            pair.jax._stats["last_h2d_shards"]
        touched.append({k for k, n in
                        enumerate(pair.port._stats["last_h2d_shards"])
                        if n})
    home = pair.port._engine._shard_of["n99"]
    assert touched[5] == {home} and touched[-1] == {home}
    assert pair.port._engine._shard_of == pair.jax._engine._shard_of


def test_bucket_overflow_rebalances_all_shards_as_jax():
    pair = sharded_pair(node_bucket=8)
    sched = {f"n{i:02d}": (i, ZONES, i % 2, 1, "r1") for i in range(8)}
    grown = dict(sched)
    grown.update({f"m{i:02d}": (50 + i, ZONES, i % 2, 1, "r1")
                  for i in range(4)})
    out_j, out_p = pair.run([sched, grown, grown])
    for ref, got in zip(out_j, out_p):
        assert_same_window(ref, got)
    eng = pair.port._engine
    sb = eng._ladder_n.bucket
    per_shard_model = [sum(1 for r in range(k * sb, (k + 1) * sb)
                           if eng._mode[r] == MODE_MODEL)
                       for k in range(eng.n_shards)]
    assert max(per_shard_model) - min(per_shard_model) <= 1
    assert eng._shard_of == pair.jax._engine._shard_of
