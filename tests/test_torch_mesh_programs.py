"""The Aggregator's whole-mesh programs per node block, against JAX's.

The port runs the serial and temporal fleet programs
(``parallel.aggregator_core``), the fused window loop
(``parallel.packed.make_fused_window_program``) and the unsharded window
engines once per NODE BLOCK of a mesh: one block per shard of a 1-D
``node`` mesh, one per node row of a ``node × model`` mesh, each on its
row's first shard. JAX shards the same programs by node with
``NamedSharding`` (and ``shard_map`` with ``backend="pallas"``).

Here the port runs on 8 virtual ``cpu`` shards, as an 8-shard ``node``
mesh and as a 4 × 2 ``node × model`` mesh, against JAX on the 8 CPU
devices ``tests/conftest.py`` forces, on the same two mesh shapes. JAX's
Pallas kernels run in interpret mode; the port's kernel wrappers run
their plain versions (CPU tensors). Inputs are seeded numpy with pad
rows, empty workload slots (NaN in the packed layout), ``dt = 0``, zero
denominators, mixed modes and pad delta indices.

Tolerances:

- fleet and temporal programs (f32 outputs): ratio rows within rtol
  1e-6 of JAX (XLA's fused einsum order) and bit-equal to the port's
  one-device program; model rows as the one-device parity tests hold
  them (bf16 trunks rtol 1e-2 with atol 1e-2 · max|watts|, f32 rtol
  1e-4);
- fused loop (f16 planes): ratio rows bit-equal, model rows within
  rtol 1e-3 (atol 1e-3 W) — one f16 ulp plus summation order;
- the Aggregator's fused tier bit-equal, its temporal window as the
  serial-rung temporal test (ratio rtol 1e-6, bf16 model rows).

Structural checks: the recorder sees one shard body per node block, B2
once per block per flush, and no float op of a block's program returns
an axis of the whole batch's rows.
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kepler_tpu.parallel import aggregator_core as jcore
from kepler_tpu.parallel import packed as jp
from kepler_tpu.parallel.fleet import NodeReport as JaxReport
from kepler_tpu.parallel.fleet import assemble_fleet_batch as jax_assemble
from kepler_tpu.parallel.mesh import make_mesh as jax_mesh
from kepler_tpu_torch.fleet.window import (FusedWindowEngine,
                                           PackedWindowEngine,
                                           block_local_rows,
                                           copy_plane_to_host_async,
                                           fetch_plane)
from kepler_tpu_torch.models import estimator as port_est
from kepler_tpu_torch.ops import recorder
from kepler_tpu_torch.parallel import aggregator_core as tcore
from kepler_tpu_torch.parallel import packed as tp
from kepler_tpu_torch.parallel.fleet import (MODE_MODEL, NodeReport,
                                             assemble_fleet_batch)
from kepler_tpu_torch.parallel.mesh import make_mesh
from tests.test_torch_aggregator import Pair, assert_same_window
from tests.test_torch_packed import _random_packed, assert_plane_matches
from tests.test_torch_packed import jax_params as packed_params
from tests.test_torch_sharded import agg_schedule, churn_plan
from tests.test_torch_temporal import (assert_fleet_results, history_for,
                                       jax_params as temporal_params)
from tests.test_torch_window import to_port
from tests.test_window_pipeline import churn_schedule

# mesh name → (port mesh shape and axes, node blocks)
MESHES = {"node8": ([8], ("node",), 8),
          "node4_model2": ([4, 2], ("node", "model"), 4)}


def port_mesh(name: str):
    shape, axes, _ = MESHES[name]
    return make_mesh(shape, axes, devices=["cpu"] * 8)


def ref_mesh(name: str):
    shape, axes, _ = MESHES[name]
    return jax_mesh(shape, list(axes))


class Seen:
    """A recorder that keeps the shard bodies and kernel calls a run
    reports (``ops.recorder``)."""

    def __init__(self) -> None:
        self.shards: list[int] = []
        self.kernels: dict[str, int] = {}

    @contextlib.contextmanager
    def kernel(self, name: str):
        self.kernels[name] = self.kernels.get(name, 0) + 1
        yield

    def shard(self, index: int) -> None:
        self.shards.append(index)

    def collective(self, name: str, n_shards: int) -> None:
        raise AssertionError(f"a fleet program ran the collective {name}")


def fleet_reports(seed: int, n: int, z: int) -> list[dict]:
    """Mixed ratio/model nodes, one with no workloads (a zero
    denominator), dt of 0 on some nodes, usage ratios outside [0, 1]."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        w = 0 if i == 3 else int(rng.integers(1, 9))
        cpu = rng.uniform(0.1, 5.0, w).astype(np.float32)
        out.append(dict(
            node_name=f"n{i:02d}",
            zone_deltas_uj=rng.uniform(1e7, 1e8, z).astype(np.float32),
            zone_valid=rng.uniform(size=z) > 0.2,
            usage_ratio=float(rng.uniform(-0.1, 1.1)), cpu_deltas=cpu,
            workload_ids=[f"n{i}-w{j}" for j in range(w)],
            node_cpu_delta=float(cpu.sum()),
            dt_s=float(rng.choice([0.0, 5.0, 2.5])),
            mode=MODE_MODEL if i % 2 else 0))
    return out


# 5 or 10 rows a block, 16 workload slots: no axis of a block's program
# is 40 (a flattened [rows · W] axis is 80 or 160)
N_BATCH = 40


def batches(seed: int, z: int = 3, n_live: int = 37):
    """(port FleetBatch, JAX FleetBatch) of ``n_live`` nodes padded to 40
    rows (three pad rows)."""
    kw = fleet_reports(seed, n_live, z)
    port = assemble_fleet_batch([NodeReport(**k) for k in kw], n_zones=z,
                                node_bucket=N_BATCH, workload_bucket=16)
    ref = jax_assemble([JaxReport(**k) for k in kw], n_zones=z,
                       node_bucket=N_BATCH, workload_bucket=16)
    assert port.cpu_deltas.shape[0] == N_BATCH
    return port, ref


def joined(blocks) -> tcore.FleetResult:
    """Per-block results → one FleetResult over the whole batch."""
    return tcore.FleetResult(*(torch.cat(f) for f in zip(*blocks)))


def no_axis_of(shapes, n: int) -> list:
    """The recorded ops that returned an axis of ``n`` rows."""
    return [(op, shape) for op, shape in shapes if n in shape]


# -- node blocks -----------------------------------------------------------------

@pytest.mark.parametrize("shape,axes,shards", [
    ([8], ("node",), [0, 1, 2, 3, 4, 5, 6, 7]),
    ([4, 2], ("node", "model"), [0, 2, 4, 6]),
    ([2, 4], ("node", "model"), [0, 4]),
    ([1], ("node",), [0]),
])
def test_node_blocks_are_the_first_shard_of_each_node_row(shape, axes,
                                                          shards):
    mesh = make_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))
    blocks = tcore.node_blocks(mesh)
    assert [b.index for b in blocks] == list(range(len(shards)))
    assert [b.shard for b in blocks] == shards
    assert all(b.device == mesh.shards[b.shard].device for b in blocks)


def test_put_blocks_moves_each_block_in_one_piece():
    mesh = port_mesh("node4_model2")
    rng = np.random.default_rng(0)
    arrays = [rng.normal(size=(8, 3)).astype(np.float32),
              rng.uniform(size=(8, 5)) < 0.5,
              np.arange(8, dtype=np.int32),
              rng.normal(size=(8, 2, 3, 7)).astype(np.float32)]
    blocks = tcore.put_blocks(arrays, mesh)
    assert len(blocks) == 4
    for b, parts in enumerate(blocks):
        base = parts[0].untyped_storage().data_ptr()
        for a, t in zip(arrays, parts):
            np.testing.assert_array_equal(t.numpy(), a[2 * b:2 * b + 2])
            # every array of the block views one buffer: one copy a block
            assert t.untyped_storage().data_ptr() == base


def cut_by_block(deltas: np.ndarray, idx: np.ndarray, n_rows: int,
                 n_blocks: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """A flush's padded delta sets ``[K, DB, width]``/``[K, DB]`` cut
    per node block as the fused engine stages them → per block
    ``(rows [K, db, width], idx [K, db])``, ``db`` the least width."""
    db = max(1, tp.block_delta_width(list(idx), n_rows, n_blocks))
    k, _, width = deltas.shape
    rows = np.empty((n_blocks, k, db, width), np.float32)
    ids = np.empty((n_blocks, k, db), np.int32)
    tp.cut_deltas_by_block(list(zip(deltas, idx)), n_rows, rows, ids)
    return list(zip(rows, ids))


@pytest.mark.parametrize("n_blocks,want", [
    (1, [[7, 0, 3, 8, 4]]),
    (2, [[4, 0, 3, 4, 4], [3, 4, 4, 4, 0]]),
    (4, [[2, 0, 2, 2, 2], [2, 2, 1, 2, 2], [2, 2, 2, 2, 0],
         [1, 2, 2, 2, 2]]),
])
def test_block_local_index_subtracts_the_block_start_and_pads(n_blocks,
                                                              want):
    idx = np.asarray([7, 0, 3, 8, 4], np.int32)  # 8: the batch's pad
    local = tcore.block_local_index(idx, 8, n_blocks)
    assert local.dtype == np.int32
    np.testing.assert_array_equal(local, want)
    # leading axes are kept: [n_blocks, K, D]
    stacked = tcore.block_local_index(np.stack([idx, idx]), 8, n_blocks)
    np.testing.assert_array_equal(stacked, np.stack([want, want], axis=1))


def test_cut_deltas_by_block_keeps_order_local_indices_and_pads():
    rng = np.random.default_rng(1)
    rows = rng.normal(size=(2, 5, 4)).astype(np.float32)
    idx = np.asarray([[7, 0, 3, 8, 4], [5, 6, 2, 8, 8]], np.int32)
    assert tp.block_delta_width(list(idx), 8, 2) == 2
    assert tp.block_delta_width([np.zeros(0, np.int32)], 8, 2) == 0
    (r0, i0), (r1, i1) = cut_by_block(rows, idx, 8, 2)
    assert i0.shape == i1.shape == (2, 2)  # at most 2 rows land in a block
    np.testing.assert_array_equal(i0, [[0, 3], [2, 4]])
    np.testing.assert_array_equal(i1, [[3, 0], [1, 2]])
    np.testing.assert_array_equal(r0[0], rows[0, [1, 2]])
    np.testing.assert_array_equal(r0[1, 0], rows[1, 2])
    np.testing.assert_array_equal(r1[0], rows[0, [0, 4]])
    np.testing.assert_array_equal(r1[1], rows[1, [0, 1]])
    assert not r0[1, 1:].any()
    # a wider slot with a step past the flush's (a no-op tail interval),
    # over stale bytes: zero rows at the block's pad everywhere unused
    wide_r = np.full((2, 3, 4, 4), 9.0, np.float32)
    wide_i = np.full((2, 3, 4), 9, np.int32)
    tp.cut_deltas_by_block([(rows[s][:4], idx[s][:4]) for s in range(2)],
                           8, wide_r, wide_i)
    np.testing.assert_array_equal(wide_i[0], [[0, 3, 4, 4], [2, 4, 4, 4],
                                              [4, 4, 4, 4]])
    np.testing.assert_array_equal(wide_r[1, 0, :1], rows[0, :1])
    assert not wide_r[1, 0, 1:].any() and not wide_r[:, 2].any()
    local = block_local_rows([np.asarray([1, 4, 6, 8])], 8, 2, 3)
    np.testing.assert_array_equal(local, [[[1, 4, 4]], [[0, 2, 4]]])


def test_copy_blocks_to_host_async_joins_fields_in_block_order():
    from kepler_tpu_torch.fleet.window import copy_blocks_to_host_async

    rng = np.random.default_rng(3)
    planes = [torch.from_numpy(rng.normal(size=(3, 2, 5)).astype(
        np.float16)) for _ in range(4)]
    rows = [torch.from_numpy(rng.normal(size=(3, 2)).astype(np.float32))
            for _ in range(4)]
    # block 2 launched by another process: skipped
    blocks = [(p, r) for p, r in zip(planes, rows)]
    blocks[2] = None
    plane, row = copy_blocks_to_host_async(blocks, axis=1).wait()
    keep = [0, 1, 3]
    np.testing.assert_array_equal(
        plane, np.concatenate([planes[b].numpy() for b in keep], axis=1))
    np.testing.assert_array_equal(
        row, np.concatenate([rows[b].numpy() for b in keep], axis=1))
    (one,) = copy_plane_to_host_async(planes[:1], axis=1).wait()
    np.testing.assert_array_equal(one, planes[0].numpy())


# -- the serial and temporal fleet programs ------------------------------------------

CASES = [(None, "einsum"), (None, "pallas"), ("mlp", "einsum"),
         ("mlp", "pallas")]


@pytest.mark.parametrize("model_mode,backend", CASES)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_fleet_program_over_a_mesh_matches_jax(mesh_name, model_mode,
                                               backend):
    port_batch, ref_batch = batches(seed=41)
    params = packed_params(model_mode, 3)
    want = jcore.run_fleet_attribution(
        jcore.make_fleet_program(ref_mesh(mesh_name), model_mode=model_mode,
                                 backend=backend),
        ref_batch, None if params is None else {
            k: jnp.asarray(v) for k, v in params.items()})
    tparams = (None if params is None
               else port_est.params_from_numpy(model_mode, params))
    program = tcore.make_fleet_program(model_mode=model_mode,
                                       backend=backend,
                                       mesh=port_mesh(mesh_name))
    seen = Seen()
    with recorder.recording(seen):
        blocks = tcore.run_fleet_attribution(program, port_batch, tparams)
    n_blocks = MESHES[mesh_name][2]
    assert len(blocks) == n_blocks
    assert seen.shards == list(range(n_blocks))
    assert seen.kernels == ({"outer_product_attribution": n_blocks}
                            if backend == "pallas" else {})
    sb = N_BATCH // n_blocks
    assert all(r.workload_power_uw.shape[0] == sb for r in blocks)
    got = joined(blocks)
    mode = port_batch.mode if model_mode else np.zeros_like(port_batch.mode)
    assert_fleet_results(got, want, mode, "bf16")
    # the ratio rows bit-equal to the one-device program's
    single = tcore.run_fleet_attribution(
        tcore.make_fleet_program(device="cpu", model_mode=model_mode,
                                 backend=backend), port_batch, tparams)
    ratio = mode != MODE_MODEL
    for a, b in zip(got, single):
        np.testing.assert_array_equal(a.numpy()[ratio], b.numpy()[ratio])


@pytest.mark.parametrize("accuracy", [False, True])
@pytest.mark.parametrize("backend", ["einsum", "pallas"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_temporal_fleet_program_over_a_mesh_matches_jax(mesh_name, backend,
                                                        accuracy):
    port_batch, ref_batch = batches(seed=43)
    params = temporal_params(z=3, seed=44)
    hist, tv = history_for(port_batch, 5, seed=45)
    want = jcore.run_fleet_attribution(
        jcore.make_temporal_fleet_program(ref_mesh(mesh_name),
                                          backend=backend,
                                          accuracy_mode=accuracy),
        ref_batch, {k: jnp.asarray(v) for k, v in params.items()}, hist, tv)
    tparams = port_est.params_from_numpy("temporal", params)
    program = tcore.make_temporal_fleet_program(
        backend=backend, accuracy_mode=accuracy, mesh=port_mesh(mesh_name))
    seen = Seen()
    with recorder.recording(seen), recorder.OutputShapes() as shapes:
        blocks = tcore.run_fleet_attribution(program, port_batch, tparams,
                                             hist, tv)
    n_blocks = MESHES[mesh_name][2]
    assert seen.shards == list(range(n_blocks))
    assert seen.kernels == ({"outer_product_attribution": n_blocks}
                            if backend == "pallas" else {})
    # no op of a block's program saw the whole batch's rows
    assert no_axis_of(shapes.shapes, N_BATCH) == []
    got = joined(blocks)
    assert_fleet_results(got, want, port_batch.mode,
                         "f32" if accuracy else "bf16")
    single = tcore.run_fleet_attribution(
        tcore.make_temporal_fleet_program(device="cpu", backend=backend,
                                          accuracy_mode=accuracy),
        port_batch, tparams, hist, tv)
    ratio = port_batch.mode != MODE_MODEL
    for a, b in zip(got, single):
        np.testing.assert_array_equal(a.numpy()[ratio], b.numpy()[ratio])


def test_fleet_program_ops_stay_inside_their_block():
    """Under ``OutputShapes``, no float op of the mixed-fleet program
    (mlp estimator, B1's plain version) returns an axis of the batch's
    40 rows: each block's ops see 5 or 10."""
    port_batch, _ = batches(seed=47)
    params = port_est.params_from_numpy("mlp", packed_params("mlp", 3))
    for name in MESHES:
        program = tcore.make_fleet_program(model_mode="mlp",
                                           backend="pallas",
                                           mesh=port_mesh(name))
        with recorder.OutputShapes() as shapes:
            tcore.run_fleet_attribution(program, port_batch, params)
        sb = N_BATCH // MESHES[name][2]
        assert shapes.shapes and no_axis_of(shapes.shapes, N_BATCH) == []
        assert max(s[0] for _, s in shapes.shapes if s) >= sb


# -- the fused window loop ---------------------------------------------------------

FUSED_CASES = [(None, "einsum", False), (None, "pallas", False),
               ("mlp", "einsum", True)]


@pytest.mark.parametrize("mode,backend,sparse", FUSED_CASES)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_fused_program_over_a_mesh_matches_jax(mesh_name, mode, backend,
                                               sparse):
    wb, z, nb, k, db = 8, 2, 40, 4, 9
    n_blocks = MESHES[mesh_name][2]
    sb = nb // n_blocks
    rng = np.random.default_rng(7)
    resident = _random_packed(rng, 33, nb, 6, wb, z, 0.5)
    deltas = np.stack([_random_packed(rng, db, db, 6, wb, z, 0.5)
                       for _ in range(k)])
    idx = np.stack([rng.permutation(nb)[:db] for _ in range(k)]).astype(
        np.int32)
    idx[1, 0] = nb  # pads: dropped
    idx[3, -2:] = nb
    mb = 8 if sparse else None
    params = packed_params(mode, z)
    jprog = jp.make_fused_window_program(
        ref_mesh(mesh_name), n_workloads=wb, n_zones=z, model_mode=mode,
        backend=backend, model_bucket=mb)
    args = [jnp.asarray(resident), jnp.asarray(deltas), jnp.asarray(idx)]
    model_idx = []
    if sparse:
        mrows = np.full((k, mb), nb, np.int32)
        for s in range(k):
            mi = np.sort(rng.choice(nb, 6, replace=False))
            mrows[s, :6] = mi
            model_idx.append(mi)
        args.append(jnp.asarray(mrows))
    j_res, j_outs = jprog(params, *args)

    mesh = port_mesh(mesh_name)
    tprog = tp.make_fused_window_program(wb, z, model_mode=mode,
                                         backend=backend, model_bucket=mb,
                                         mesh=mesh)
    tparams = (port_est.params_from_numpy(mode, params) if mode else None)
    cuts = cut_by_block(deltas, idx, nb, n_blocks)
    res_blocks = [torch.from_numpy(resident[b * sb:(b + 1) * sb].copy())
                  for b in range(n_blocks)]
    targs = [[tparams] * n_blocks, res_blocks,
             [torch.from_numpy(r) for r, _ in cuts],
             [torch.from_numpy(i) for _, i in cuts]]
    if sparse:
        local = block_local_rows(model_idx, nb, n_blocks, mb)
        targs.append([torch.from_numpy(m) for m in local])
    seen = Seen()
    with recorder.recording(seen), recorder.OutputShapes() as shapes:
        t_res, t_outs = tprog(*targs)
    assert seen.shards == list(range(n_blocks))
    if backend == "pallas":  # one B2 launch per block per flush
        assert seen.kernels == {"fused_window_step": n_blocks}
    else:
        assert seen.kernels == {"scatter_rows": n_blocks * k}
    assert no_axis_of(shapes.shapes, nb) == []
    # the residents are updated in place, block by block
    assert all(a is b for a, b in zip(t_res, res_blocks))
    np.testing.assert_array_equal(torch.cat(list(t_res)).numpy(),
                                  np.asarray(j_res))
    assert all(o.shape == (k, sb, wb + 2, z) for o in t_outs)
    outs = torch.cat(list(t_outs), dim=1).numpy()
    lay = jp.PackedLayout(wb, z)
    replay = resident.copy()
    for s in range(k):
        hit = idx[s] < nb
        replay[idx[s][hit]] = deltas[s][hit]
        step_mode = (replay[:, lay.col_mode] if mode
                     else np.zeros(nb, np.float32))
        assert_plane_matches(outs[s], np.asarray(j_outs[s]), step_mode)


def test_fused_program_over_a_mesh_skips_blocks_of_other_processes():
    wb, z, nb, k = 4, 2, 16, 2
    mesh = port_mesh("node8")
    rng = np.random.default_rng(9)
    resident = _random_packed(rng, 12, nb, 4, wb, z, 0.0)
    deltas = np.stack([_random_packed(rng, 3, 3, 4, wb, z, 0.0)
                       for _ in range(k)])
    idx = np.asarray([[0, 5, 16], [9, 16, 16]], np.int32)
    cuts = cut_by_block(deltas, idx, nb, 8)
    owned = {0, 2, 4}
    prog = tp.make_fused_window_program(wb, z, backend="pallas", mesh=mesh)

    def mine(xs):
        return [x if b in owned else None for b, x in enumerate(xs)]

    res, outs = prog(mine([None] * 8),
                     mine([torch.from_numpy(resident[2 * b:2 * b + 2].copy())
                           for b in range(8)]),
                     mine([torch.from_numpy(r) for r, _ in cuts]),
                     mine([torch.from_numpy(i) for _, i in cuts]))
    assert [b for b, o in enumerate(outs) if o is not None] == [0, 2, 4]
    assert [b for b, r in enumerate(res) if r is not None] == [0, 2, 4]


# -- the engines over node blocks --------------------------------------------------

def packed_rows(plan: list[dict]):
    from tests.test_torch_sharded import windows

    return [(to_port(rows), zones) for rows, zones in windows(plan)]


@pytest.mark.parametrize("model_mode,backend",
                         [(None, "pallas"), ("mlp", "einsum"),
                          ("mlp", "pallas")])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_unsharded_engine_over_blocks_equals_one_device(mesh_name,
                                                        model_mode,
                                                        backend):
    """The unsharded engine with its resident batch cut into node
    blocks: the same plane as its one-device form every window (ratio
    rows bit-equal, model rows within 1e-3), the same H2D rows, and one
    scatter launch and one program body per block."""
    from tests.test_torch_sharded import PARAMS

    mesh = port_mesh(mesh_name)
    n_blocks = MESHES[mesh_name][2]
    blocked = PackedWindowEngine(device=mesh, backend=backend,
                                 model_mode=model_mode, node_bucket=16,
                                 workload_bucket=8)
    single = PackedWindowEngine(device="cpu", backend=backend,
                                model_mode=model_mode, node_bucket=16,
                                workload_bucket=8)
    for win, (rows, zones) in enumerate(packed_rows(churn_plan())):
        params = PARAMS[len(zones)] if model_mode else None
        seen = Seen()
        with recorder.recording(seen):
            a = blocked.plan_window(rows, zones, params)
            pa = fetch_plane(blocked.dispatch_window(a))
        b = single.plan_window(rows, zones, params)
        pb = fetch_plane(single.dispatch_window(b))
        assert a.h2d_rows == b.h2d_rows and a.n_shards == 1
        assert a.meta.rows == b.meta.rows
        nb = a.meta.n_rows
        resident = blocked._buffers[blocked._buf_i]
        assert len(resident) == n_blocks
        assert all(t.shape[0] == nb // n_blocks for t in resident)
        # the program once per block, after the delta update's scatter
        # once per block on windows that stage rows into the ring
        assert seen.shards[-n_blocks:] == list(range(n_blocks))
        assert seen.shards[:-n_blocks] in ([], list(range(n_blocks)))
        assert_plane_matches(pa, pb, a.meta.mode) if model_mode else \
            np.testing.assert_array_equal(pa, pb, err_msg=f"window {win}")


@pytest.mark.parametrize("model_mode,backend",
                         [(None, "pallas"), (None, "einsum"),
                          ("mlp", "einsum")])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_fused_engine_over_blocks_equals_one_device(mesh_name, model_mode,
                                                    backend):
    """The fused engine over node blocks against its one-device form
    through the churn plan at K = 4: the same planes, and with pallas one
    B2 launch per block per flush."""
    from tests.test_torch_sharded import PARAMS

    mesh = port_mesh(mesh_name)
    n_blocks = MESHES[mesh_name][2]
    kw = dict(backend=backend, model_mode=model_mode, node_bucket=16,
              workload_bucket=8, fused_k=4)
    blocked = FusedWindowEngine(device=mesh, **kw)
    single = FusedWindowEngine(device="cpu", **kw)
    flushes = 0
    plan = churn_plan()
    if model_mode:  # a flush cut at the zone change takes no model params
        plan = plan[:6]
    wins = packed_rows(plan + plan[-1:] * 3)
    for step in wins + [None]:
        if step is None:  # a forced flush of a part-filled ring
            fa, fb = blocked.flush(params), single.flush(params)
            assert fa.k_live < fa.k
        else:
            rows, zones = step
            params = PARAMS[len(zones)] if model_mode else None
            _, fa = blocked.stage(rows, zones, params)
            _, fb = single.stage(rows, zones, params)
        assert (fa is None) == (fb is None)
        if fa is None:
            continue
        flushes += 1
        assert fa.metas[-1].rows == fb.metas[-1].rows
        seen = Seen()
        with recorder.recording(seen):
            outs = blocked.dispatch(fa)
        assert len(outs) == n_blocks
        if backend == "pallas" and model_mode is None:
            assert seen.kernels == {"fused_window_step": n_blocks}
        (got,) = copy_plane_to_host_async(outs, axis=1).wait()
        want = single.dispatch(fb).numpy()
        assert got.shape == want.shape
        for j, meta in enumerate(fa.metas):
            if model_mode:
                assert_plane_matches(got[j], want[j], meta.mode)
            else:
                np.testing.assert_array_equal(got[j], want[j])
    assert flushes >= 3


# -- the Aggregator ----------------------------------------------------------------

def mesh_pair(mesh_name: str, **kw) -> Pair:
    pair = Pair(**kw)
    pair.jax._mesh = ref_mesh(mesh_name)
    pair.port._mesh = port_mesh(mesh_name)
    return pair


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_aggregator_fused_tier_over_a_mesh_matches_jax(mesh_name):
    pair = mesh_pair(mesh_name, backend="pallas", fused_window_k=4,
                     node_bucket=16)
    seen = Seen()
    with recorder.recording(seen):
        out_j, out_p = pair.run(agg_schedule(churn_plan()))
    published = [r for r in out_p if r is not None]
    assert len(published) >= 2
    for ref, got in zip(out_j, out_p):
        assert_same_window(ref, got)
    for agg in (pair.jax, pair.port):
        assert agg.window_health()["rung_name"] == "packed-fused-scan"
    eng = pair.port._engine_fused
    n_blocks = MESHES[mesh_name][2]
    assert len(eng._blocks) == n_blocks
    assert len(eng._buffers[0]) == n_blocks
    # B2 once per node block per flush (two flushes and the drain)
    assert seen.kernels["fused_window_step"] % n_blocks == 0
    assert seen.kernels["fused_window_step"] >= 2 * n_blocks


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_aggregator_temporal_window_over_a_mesh_matches_jax(mesh_name):
    pair = mesh_pair(mesh_name, model_mode="temporal", history_window=4,
                     backend="pallas")
    seen = Seen()
    with recorder.recording(seen):
        out_j, out_p = pair.run(churn_schedule(6))
    assert sum(r is not None for r in out_p) == 6
    for ref, got in zip(out_j, out_p):
        assert_same_window(ref, got, model="bf16", ratio="serial")
    n_blocks = MESHES[mesh_name][2]
    # B1 once per node block per window
    assert seen.kernels["outer_product_attribution"] == 6 * n_blocks
    assert pair.port._program.mesh is pair.port._mesh


def test_aggregator_einsum_serial_rung_spans_the_mesh():
    """Two dispatch errors walk the 4 × 2 mesh's window down to the
    einsum-serial rung, whose program runs over the node blocks (B1 once
    per block); every window equals JAX's on its 4 × 2 mesh."""
    from tests.test_torch_aggregator import faults

    pair = mesh_pair("node4_model2", model_mode="mlp", backend="pallas",
                     repromote_after=2)
    with faults(site="device.dispatch_error", skip=2, count=2):
        out_j, out_p = pair.run(churn_schedule(6))
    for ref, got in zip(out_j, out_p):
        assert_same_window(ref, got, model="bf16", ratio="serial")
    names = [e["rung_name"] for e in pair.port._rung_timeline]
    assert "einsum-serial" in names
    assert names == [e["rung_name"] for e in pair.jax._rung_timeline]
    assert pair.port._program is None or pair.port._program.mesh is \
        pair.port._mesh
