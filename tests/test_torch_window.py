"""The port's window engines against the JAX package's, on the CPU.

``kepler_tpu_torch.fleet.window.FusedWindowEngine`` (K ∈ {1, 2, 4}) and
``PackedWindowEngine`` (depth 2: window i+1 is planned before window i
is fetched), both with ``backend="pallas"``, are fed the same rows as
the JAX engines on a one-device mesh — where the JAX fused program takes
its Pallas kernel B2 (interpret mode) in every interval. Over the shape
sweep of ``tests/test_fused_window.py`` and the churn schedule of
``tests/test_window_pipeline.py`` every published f16 plane must be
bit-equal; model rows of a mixed fleet (MLP, f32 on both sides) are held
to rtol 1e-3 on the f16 plane, one f16 ulp plus matmul summation order.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from kepler_tpu.fleet.window import FusedWindowEngine as JaxFused
from kepler_tpu.fleet.window import PackedWindowEngine as JaxPacked
from kepler_tpu.fleet.window import RowInput as JaxRow
from kepler_tpu.models.mlp import init_mlp
from kepler_tpu.parallel.mesh import make_mesh
from kepler_tpu_torch import fault
from kepler_tpu_torch.fault import FaultPlan, FaultSpec
from kepler_tpu_torch.fleet.window import (DeviceWindowError,
                                           FusedWindowEngine,
                                           PackedWindowEngine, RowInput,
                                           fetch_plane)
from kepler_tpu_torch.ops import cuda_attribution as ca
from kepler_tpu_torch.parallel.fleet import MODE_MODEL, MODE_RATIO
from kepler_tpu_torch.parallel.fleet import NodeReport
from tests import test_fused_window
from tests.test_window_pipeline import (ZONES, ZONES_WIDE, churn_schedule,
                                        make_report)

SHAPES = test_fused_window.TestEngineBitExact.SHAPES


def one_device_mesh():
    return make_mesh(devices=jax.devices()[:1])


def to_port(rows: list[JaxRow]) -> list[RowInput]:
    """The same rows as the port's NodeReport (a field-for-field copy)."""
    out = []
    for r in rows:
        rep = r.report
        out.append(RowInput(
            name=r.name,
            report=NodeReport(
                node_name=rep.node_name, zone_deltas_uj=rep.zone_deltas_uj,
                zone_valid=rep.zone_valid, usage_ratio=rep.usage_ratio,
                cpu_deltas=rep.cpu_deltas, workload_ids=rep.workload_ids,
                node_cpu_delta=rep.node_cpu_delta, dt_s=rep.dt_s,
                mode=rep.mode, workload_kinds=rep.workload_kinds,
                meta=dict(rep.meta)),
            zone_names=r.zone_names, ident=r.ident))
    return out


def sweep_windows(n_nodes: int, w: int, n_win: int) -> list:
    """Per window: (jax rows, zones) — every row changes every window."""
    names = [f"n{i}" for i in range(n_nodes)]
    return [([JaxRow(name=n, report=make_report(n, i * 1000 + k, w=w),
                     zone_names=ZONES, ident=("run", i))
              for k, n in enumerate(names)], ZONES)
            for i in range(n_win)]


def churn_windows(n_win: int = 10) -> list:
    """The pipeline tests' churn: joins, drops, a restart, a zone-axis
    change and mixed modes."""
    out = []
    for sched in churn_schedule(n_win):
        rows = [JaxRow(name=name,
                       report=make_report(name, seed, zones=zones,
                                          mode=mode),
                       zone_names=tuple(zones), ident=(run, seq))
                for name, (seed, zones, mode, seq, run)
                in sorted(sched.items())]
        wide = any(len(r.zone_names) == 3 for r in rows)
        out.append((rows, ZONES_WIDE if wide else ZONES))
    return out


def run_fused(eng, windows, params, fetch) -> list[np.ndarray]:
    published = []

    def take(flush):
        outs = fetch(eng.dispatch(flush))
        published.extend(outs[j] for j in range(flush.k_live))

    for rows, zones in windows:
        _meta, flush = eng.stage(rows, zones, params)
        if flush is not None:
            take(flush)
    flush = eng.flush(params)
    if flush is not None:
        take(flush)
    assert eng.pending_occupancy() == 0
    return published


def run_jax_packed(eng, windows, params) -> list[np.ndarray]:
    out = []
    for rows, zones in windows:
        plan = eng.plan_window(rows, zones, params)
        out.append(np.asarray(plan.program(*plan.args)))
    return out


def run_port_packed_depth2(eng, windows, params) -> list[np.ndarray]:
    """Depth-2 pipeline: plan + launch window i, then fetch window i−1."""
    out, inflight = [], None
    for rows, zones in windows:
        plan = eng.plan_window(to_port(rows), zones, params)
        launched = eng.dispatch_window(plan)
        if inflight is not None:
            out.append(fetch_plane(inflight))
        inflight = launched
    out.append(fetch_plane(inflight))
    return out


def assert_planes_equal(port: list, ref: list) -> None:
    assert len(port) == len(ref)
    for i, (a, b) in enumerate(zip(port, ref)):
        assert a.dtype == np.float16 and a.shape == b.shape, i
        np.testing.assert_array_equal(a, b, err_msg=f"window {i}")


@pytest.mark.parametrize("n_nodes,w,n_win", SHAPES)
@pytest.mark.parametrize("k", [1, 2, 4])
def test_fused_engine_bit_equal_to_jax(n_nodes, w, n_win, k):
    windows = sweep_windows(n_nodes, w, n_win)
    ref = run_fused(JaxFused(one_device_mesh(), backend="pallas",
                             fused_k=k), windows, None, np.asarray)
    eng = FusedWindowEngine(device="cpu", backend="pallas", fused_k=k)
    port = run_fused(eng, [(to_port(r), z) for r, z in windows], None,
                     fetch_plane)
    assert_planes_equal(port, ref)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_fused_engine_churn_bit_equal_to_jax(k):
    windows = churn_windows()
    ref = run_fused(JaxFused(one_device_mesh(), backend="pallas",
                             fused_k=k), windows, None, np.asarray)
    eng = FusedWindowEngine(device="cpu", backend="pallas", fused_k=k)
    before = ca.LAUNCHES["fused_window_step"]
    port = run_fused(eng, [(to_port(r), z) for r, z in windows], None,
                     fetch_plane)
    assert_planes_equal(port, ref)
    # the plain version serves CPU tensors: no kernel launch is counted
    assert ca.LAUNCHES["fused_window_step"] == before


@pytest.mark.parametrize("n_nodes,w,n_win", SHAPES)
def test_packed_engine_depth2_bit_equal_to_jax(n_nodes, w, n_win):
    windows = sweep_windows(n_nodes, w, n_win)
    ref = run_jax_packed(JaxPacked(one_device_mesh(), backend="pallas"),
                         windows, None)
    port = run_port_packed_depth2(
        PackedWindowEngine(device="cpu", backend="pallas"), windows, None)
    assert_planes_equal(port, ref)


def test_packed_engine_churn_bit_equal_to_jax():
    windows = churn_windows()
    ref = run_jax_packed(JaxPacked(one_device_mesh(), backend="pallas"),
                         windows, None)
    port = run_port_packed_depth2(
        PackedWindowEngine(device="cpu", backend="pallas"), windows, None)
    assert_planes_equal(port, ref)


@pytest.mark.parametrize("backend", ["einsum", "pallas"])
def test_mixed_fleet_engines_match_jax(backend):
    """MLP mixed fleet: ratio rows bit-equal, model rows within rtol 1e-3
    (einsum runs the sparse estimator gather, pallas the dense one)."""
    windows = churn_windows(8)
    params = {k: np.asarray(v) for k, v in
              init_mlp(jax.random.PRNGKey(3), n_zones=3).items()}
    params["w2"] = np.random.default_rng(0).normal(
        0.0, 0.05, params["w2"].shape).astype(np.float32)
    params["b2"] = np.full(params["b2"].shape, 0.5, np.float32)

    def zone_params(zones):
        return {k: (v[..., :len(zones)] if k in ("w2", "b2", "w_skip")
                    else v) for k, v in params.items()}

    jax_eng = JaxPacked(one_device_mesh(), backend=backend,
                        model_mode="mlp")
    port_eng = PackedWindowEngine(device="cpu", backend=backend,
                                  model_mode="mlp")
    for rows, zones in windows:
        p = zone_params(zones)
        plan = jax_eng.plan_window(rows, zones, p)
        ref = np.asarray(plan.program(*plan.args))
        port_plan = port_eng.plan_window(to_port(rows), zones, p)
        out = fetch_plane(port_eng.dispatch_window(port_plan))
        assert out.shape == ref.shape
        mode = port_plan.meta.mode
        ratio_rows = mode == MODE_RATIO
        np.testing.assert_array_equal(out[ratio_rows], ref[ratio_rows])
        model_rows = mode == MODE_MODEL
        assert model_rows.any()
        np.testing.assert_allclose(out[model_rows].astype(np.float32),
                                   ref[model_rows].astype(np.float32),
                                   rtol=1e-3, atol=1e-3)


def test_dispatch_error_resets_the_ring():
    """An injected ``device.dispatch_error`` abandons the resident ring
    and the pending windows; the next stage re-packs in full and keeps
    publishing planes bit-equal to an undisturbed JAX engine."""
    windows = sweep_windows(5, 17, 6)
    eng = FusedWindowEngine(device="cpu", backend="pallas", fused_k=2)
    port_windows = [(to_port(r), z) for r, z in windows]
    plan = FaultPlan([FaultSpec(site="device.dispatch_error", skip=1,
                                count=1)])
    published = []
    with fault.installed(plan):
        for i, (rows, zones) in enumerate(port_windows):
            _meta, flush = eng.stage(rows, zones, None)
            if flush is None:
                continue
            try:
                outs = fetch_plane(eng.dispatch(flush))
            except DeviceWindowError as err:
                assert err.reason == "dispatch_error"
                assert eng._buffers == [] and eng.pending_occupancy() == 0
                assert eng.introspect()["resident"]["rows"] == 0
                continue
            published.append((i, outs[flush.k_live - 1]))
    assert [i for i, _ in published] == [1, 5]
    ref = run_fused(JaxFused(one_device_mesh(), backend="pallas",
                             fused_k=1), windows, None, np.asarray)
    for i, plane in published:
        np.testing.assert_array_equal(plane, ref[i])


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FusedWindowEngine()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PackedWindowEngine(backend="pallas")


def test_introspection_and_cost_stats_keys():
    windows = sweep_windows(3, 4, 5)
    eng = FusedWindowEngine(device="cpu", backend="pallas", fused_k=2)
    run_fused(eng, [(to_port(r), z) for r, z in windows], None, fetch_plane)
    info = eng.introspect()
    assert {"engine", "n_shards", "window_seq", "buckets", "resident",
            "shards", "programs", "updates", "compile_count",
            "fused"} <= set(info)
    assert info["compile_count"] == eng.compile_count >= 1
    stats = eng.cost_stats()
    label = "fused_n8_w256_z2_ratio_k2_d8"
    assert label in stats
    s = stats[label]
    width = 256 + 2 * 2 + 4
    assert s["argument_bytes"] == 4 * (8 * width + 2 * 8 * width + 2 * 8)
    assert s["output_bytes"] == 4 * 8 * width + 2 * 2 * 8 * 258 * 2
    assert s["bound_by"] == "bytes" and s["bound_ms"] > 0
