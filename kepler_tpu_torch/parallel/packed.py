"""Packed-transfer fleet attribution: one H2D, one program, one D2H.

The whole fleet window travels as ONE f32 input array and comes back as
ONE f16 output array, in the layouts of ``kepler_tpu.parallel.packed``:

  input  [N, W + 2Z + 4]  — cpu | zone | zone_valid | ratio, denom, dt, mode
  output [N, W + 2, Z]    — per-workload watts, with node ACTIVE watts and
                            node TOTAL watts as the two extra rows (f16:
                            watts stay well inside half range; µW or µJ
                            would overflow)

Programs here are plain Python callables over tensors that run on the
device their inputs lie on. With ``backend="pallas"`` they launch the
hand-written CUDA kernels of ``ops.cuda_attribution`` (B1 in the
per-window program, B2 once per flush of the fused window loop);
``backend="einsum"`` composes plain tensor ops. The builders take an
explicit ``device`` (default ``"cuda"``) and raise when it is missing;
the per-window program also runs over a node mesh, once per shard
(B1 once per shard per window with ``backend="pallas"``).

Sparse model evaluation (``model_bucket``, einsum backend only): the
estimator runs only on the gathered MODE_MODEL rows named by a bucketed
``model_rows`` index vector (padded with N — the gather clamps, the
scatter drops), bit-identical to the dense program at a fraction of the
estimator work on a mixed fleet.

The host-side helpers (``PackedLayout``, ``pack_fleet_inputs``,
``pack_reports_into``, ``numpy_fleet_window``, the unpackers) are NumPy
and are copies of the JAX package's, so the two packages pack and read
the same bytes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Sequence

import numpy as np
import torch

from kepler_tpu_torch.device import resolve_device
from kepler_tpu_torch.models.estimator import predictor
from kepler_tpu_torch.models.features import build_features
from kepler_tpu_torch.ops.attribution import scatter_rows_
from kepler_tpu_torch.parallel.aggregator_core import (
    FleetResult,
    fleet_attribution_program,
    mix_model_watts,
    resolve_attribute_fn,
    shard_by_node,
)
from kepler_tpu_torch.parallel.fleet import MODE_MODEL, FleetBatch, NodeReport
from kepler_tpu_torch.parallel.mesh import Mesh

# packed output layout: the two synthetic rows appended after the W
# workload rows (kept as named offsets so unpackers and the window
# engine agree by construction)
ROW_NODE_ACTIVE = -2
ROW_NODE_TOTAL = -1


# keplint: layout-definition
@dataclass(frozen=True)
class PackedLayout:
    """THE packed input-row layout — the single source of truth.

    One f32 row is ``cpu[W] | zone[Z] | zone_valid[Z] | ratio, denom,
    dt, mode``. Every producer and consumer of packed rows — the device
    programs here, the CUDA kernel B2, the ``fleet.window`` staging
    engines, and the pure-NumPy mirror (:func:`numpy_fleet_window`) —
    derives its offsets from this class.
    """

    n_workloads: int
    n_zones: int

    @property
    def width(self) -> int:
        """Total packed row width."""
        return self.n_workloads + 2 * self.n_zones + 4

    @property
    def cpu(self) -> slice:
        """Per-workload cpu-delta columns (NaN = invalid slot)."""
        return slice(0, self.n_workloads)

    @property
    def zone(self) -> slice:
        """Per-zone energy-delta columns (µJ)."""
        return slice(self.n_workloads, self.n_workloads + self.n_zones)

    @property
    def zone_valid(self) -> slice:
        """Per-zone validity columns (0.0/1.0)."""
        return slice(self.n_workloads + self.n_zones,
                     self.n_workloads + 2 * self.n_zones)

    @property
    def col_ratio(self) -> int:
        return self.n_workloads + 2 * self.n_zones + 0

    @property
    def col_denom(self) -> int:
        return self.n_workloads + 2 * self.n_zones + 1

    @property
    def col_dt(self) -> int:
        return self.n_workloads + 2 * self.n_zones + 2

    @property
    def col_mode(self) -> int:
        return self.n_workloads + 2 * self.n_zones + 3

    def empty_row(self) -> np.ndarray:
        """One packed row holding no node: zeros, cpu columns NaN (no
        valid workload slots) — what cleared resident rows scatter."""
        row = np.zeros(self.width, np.float32)
        row[self.cpu] = np.nan
        return row


def packed_width(n_workloads: int, n_zones: int) -> int:
    """Row width of the packed INPUT layout."""
    return PackedLayout(n_workloads, n_zones).width


def pack_fleet_inputs(batch: FleetBatch,
                      out: np.ndarray | None = None) -> np.ndarray:
    """FleetBatch → one f32 [N, W + 2Z + 4] host array (one H2D).

    ``out``: optional preallocated destination; a fresh array is returned
    when absent or mis-shaped.
    """
    n, w, z = batch.shape
    lay = PackedLayout(w, z)
    if out is None or out.shape != (n, lay.width):
        out = np.empty((n, lay.width), np.float32)
    # invalid workload slots ride as NaN in the cpu column — no separate
    # mask plane needed in the packed layout
    out[:, lay.cpu] = np.where(batch.workload_valid, batch.cpu_deltas,
                               np.nan)
    out[:, lay.zone] = batch.zone_deltas_uj
    out[:, lay.zone_valid] = batch.zone_valid
    out[:, lay.col_ratio] = batch.usage_ratio
    out[:, lay.col_denom] = batch.node_cpu_delta
    out[:, lay.col_dt] = batch.dt_s
    out[:, lay.col_mode] = batch.mode
    return out


def pack_reports_into(out: np.ndarray, reports: Sequence[NodeReport],
                      zone_deltas_mat: np.ndarray,
                      zone_valid_mat: np.ndarray,
                      n_workloads: int) -> None:
    """Pack ragged reports straight into ``out[:len(reports)]`` (packed
    row layout) without materializing an intermediate FleetBatch. Rows
    beyond each report's workload count stay NaN (invalid)."""
    n = len(reports)
    lay = PackedLayout(n_workloads, zone_deltas_mat.shape[1])
    out[:n, lay.cpu] = np.nan
    lengths = np.fromiter((len(r.cpu_deltas) for r in reports),
                          np.int64, n)
    total = int(lengths.sum())
    if total:
        flat = np.concatenate(
            [np.asarray(r.cpu_deltas, np.float32) for r in reports])
        rows = np.repeat(np.arange(n), lengths)
        starts = np.concatenate(([0], np.cumsum(lengths)[:-1]))
        cols = np.arange(total) - np.repeat(starts, lengths)
        out[rows, cols] = flat
    out[:n, lay.zone] = zone_deltas_mat
    out[:n, lay.zone_valid] = zone_valid_mat
    out[:n, lay.col_ratio] = np.fromiter(
        (r.usage_ratio for r in reports), np.float64, n)
    out[:n, lay.col_denom] = np.fromiter(
        (r.node_cpu_delta for r in reports), np.float64, n)
    out[:n, lay.col_dt] = np.fromiter(
        (r.dt_s for r in reports), np.float64, n)
    out[:n, lay.col_mode] = np.fromiter(
        (r.mode for r in reports), np.int64, n)


def _unpack_fields(packed: torch.Tensor, w: int, z: int) -> tuple[
        torch.Tensor, ...]:
    """Packed rows → (cpu, workload_valid, zone, zone_valid, ratio,
    denom, dt, mode), as views and masks over ``packed``."""
    lay = PackedLayout(w, z)
    cpu_nan = packed[:, lay.cpu]
    workload_valid = ~torch.isnan(cpu_nan)
    cpu = torch.where(workload_valid, cpu_nan, 0.0)
    zone = packed[:, lay.zone]
    zone_valid = packed[:, lay.zone_valid] > 0.5
    ratio = packed[:, lay.col_ratio]
    denom = packed[:, lay.col_denom]
    dt = packed[:, lay.col_dt]
    mode = packed[:, lay.col_mode].to(torch.int32)
    return cpu, workload_valid, zone, zone_valid, ratio, denom, dt, mode


def _pack_watts_f16(res: FleetResult) -> torch.Tensor:
    """FleetResult → one f16 [N, W+2, Z] output (one D2H), in watts."""
    watts = res.workload_power_uw * 1e-6  # µW → W for f16 range
    active = res.node_active_power_uw[:, None, :] * 1e-6
    total = res.node_power_uw[:, None, :] * 1e-6
    return torch.cat([watts, active, total], dim=1).to(torch.float16)


def _window_step_fns(n_workloads: int, n_zones: int,
                     model_mode: str | None, backend: str,
                     model_bucket: int | None) -> tuple[
                         Callable, Callable | None]:
    """The shared packed window-step bodies → (dense, sparse).

    ``sparse`` is None unless ``model_bucket`` is set with a model mode
    (einsum backend required). The per-window builder and the fused
    K-window loop compose these same closures, so the two programs
    cannot drift. Estimators compute in f32 (TF32 off: ``device``): a
    trunk's ``compute_dtype`` is set to f32 explicitly, as the JAX packed
    programs do off the TPU."""
    predict_fn = predictor(model_mode) if model_mode else None
    if predict_fn is not None and model_mode != "linear":
        base_fn = predict_fn

        def predict_fn(params: Any, feats: torch.Tensor, valid: torch.Tensor,
                       _fn: Callable = base_fn) -> torch.Tensor:
            return _fn(params, feats, valid, compute_dtype=torch.float32)

    w, z = n_workloads, n_zones
    attribute_fn = resolve_attribute_fn(backend)
    sparse = model_bucket is not None and predict_fn is not None
    if sparse and backend != "einsum":
        raise ValueError(
            "sparse model evaluation (model_bucket) requires the einsum "
            f"backend; got {backend!r}")

    def unpack_and_attribute(model_params: Any,
                             packed: torch.Tensor) -> torch.Tensor:
        cpu, workload_valid, zone, zone_valid, ratio, denom, dt, mode = \
            _unpack_fields(packed, w, z)
        res = fleet_attribution_program(
            model_params, zone, zone_valid, ratio, cpu, workload_valid,
            denom, dt, mode, predict_fn=predict_fn,
            attribute_fn=attribute_fn)
        return _pack_watts_f16(res)

    def unpack_and_attribute_sparse(model_params: Any, packed: torch.Tensor,
                                    model_rows: torch.Tensor) -> torch.Tensor:
        cpu, workload_valid, zone, zone_valid, ratio, denom, dt, mode = \
            _unpack_fields(packed, w, z)
        n = packed.shape[0]
        ratio_res = attribute_fn(zone, zone_valid, ratio, cpu,
                                 workload_valid, denom, dt)
        rows = model_rows.to(torch.int64)
        take = rows.clamp(max=n - 1)  # pad N → gather-clamped
        sub_valid = workload_valid[take]
        feats = build_features(cpu[take], sub_valid, denom[take],
                               ratio[take], dt[take])
        sub_watts = predict_fn(model_params, feats, sub_valid)
        # padding entries land in the spare slot N and are dropped;
        # MODE_RATIO rows keep zeros, which mix_model_watts never selects
        model_watts = torch.zeros((n + 1, w, z), dtype=torch.float32,
                                  device=packed.device)
        model_watts.index_copy_(0, rows.clamp(max=n), sub_watts)
        return _pack_watts_f16(mix_model_watts(ratio_res, model_watts[:n],
                                               mode, dt))

    return unpack_and_attribute, (unpack_and_attribute_sparse
                                  if sparse else None)


def make_packed_fleet_program(n_workloads: int, n_zones: int,
                              model_mode: str | None = None,
                              backend: str = "einsum",
                              model_bucket: int | None = None,
                              device: str | torch.device = "cuda",
                              mesh: Mesh | None = None,
                              local_model_rows: bool = False
                              ) -> Callable:
    """→ ``program(params, packed [N, W+2Z+4][, model_rows]) →
    packed_watts f16 [N, W+2, Z]`` on ``device``.

    ``model_bucket``: when given (and ``model_mode`` is set), the program
    takes a third ``model_rows`` int32 [model_bucket] argument and
    evaluates the estimator ONLY on those rows; entries ≥ N are padding.

    ``mesh``: the SHARDED program over the mesh's node axis
    (:func:`~kepler_tpu_torch.parallel.aggregator_core.shard_by_node`).
    Every argument is then a sequence with one entry per shard — the
    shard's params, its ``[sb, W+2Z+4]`` block and, sparse, its
    ``model_rows`` segment — and the result is the tuple of the shards'
    ``[sb, W+2, Z]`` planes, in shard order. Every case runs per shard:
    the dense body (with ``backend="pallas"``, kernel B1 once per
    shard), and the sparse body, which needs ``local_model_rows``: each
    shard's ``model_bucket`` segment holds SHARD-LOCAL row indices (pad
    = the shard's row count, gather-clamped and scatter-dropped per
    shard), so the gather, the estimator and the scatter-back stay on
    the shard.
    """
    dense, sparse = _window_step_fns(n_workloads, n_zones, model_mode,
                                     backend, model_bucket)
    if mesh is None:
        resolve_device(device)
        return sparse if sparse is not None else dense
    if sparse is not None and not local_model_rows:
        raise ValueError(
            "sparse model evaluation over a mesh needs shard-local "
            "model rows (local_model_rows=True)")
    return shard_by_node(sparse if sparse is not None else dense, mesh)


def make_fused_window_program(n_workloads: int, n_zones: int,
                              model_mode: str | None = None,
                              backend: str = "einsum",
                              model_bucket: int | None = None,
                              device: str | torch.device = "cuda"
                              ) -> Callable:
    """→ the DEVICE-RESIDENT window loop: one host sync per K windows.

    ``fused(params, resident, delta_rows, delta_idx[, model_rows])``:

      resident    f32 [N, width]      — updated IN PLACE
      delta_rows  f32 [K, DB, width]  — per-interval staged delta rows
      delta_idx   i32 [K, DB]         — target rows (pad = N → dropped)
      model_rows  i32 [K, MB]         — sparse variant only (pad = N)

      → (resident, outs f16 [K, N, W+2, Z])

    Each interval applies its delta rows to the resident block and runs
    the packed window body on the result, all enqueued on the current
    stream: the host syncs once, when it fetches ``outs``. The resident
    block is rewritten in place — the port's form of the JAX program's
    donated carry; stream order keeps every earlier reader ahead of it.

    With ``backend="pallas"`` and no model, the whole flush is ONE launch
    of kernel B2 (``ops.cuda_attribution.fused_window_steps``): the K
    intervals' scatter + unpack + attribution in one kernel body.
    Everywhere else each interval composes the drop-mode scatter with
    the shared window body.
    """
    resolve_device(device)
    dense_fn, sparse_fn = _window_step_fns(
        n_workloads, n_zones, model_mode, backend, model_bucket)
    lay = PackedLayout(n_workloads, n_zones)
    out_rows = n_workloads + 2

    def alloc(resident: torch.Tensor, k: int) -> torch.Tensor:
        return torch.empty((k, resident.shape[0], out_rows, n_zones),
                           dtype=torch.float16, device=resident.device)

    if sparse_fn is not None:
        def fused_sparse(model_params: Any, resident: torch.Tensor,
                         delta_rows: torch.Tensor, delta_idx: torch.Tensor,
                         model_rows: torch.Tensor) -> tuple[
                             torch.Tensor, torch.Tensor]:
            outs = alloc(resident, delta_rows.shape[0])
            for k in range(delta_rows.shape[0]):
                scatter_rows_(resident, delta_rows[k], delta_idx[k])
                outs[k] = sparse_fn(model_params, resident, model_rows[k])
            return resident, outs

        return fused_sparse

    if backend == "pallas" and model_mode is None:
        from kepler_tpu_torch.ops.cuda_attribution import fused_window_steps

        def fused_kernel(model_params: Any, resident: torch.Tensor,
                         delta_rows: torch.Tensor,
                         delta_idx: torch.Tensor) -> tuple[
                             torch.Tensor, torch.Tensor]:
            return fused_window_steps(resident, delta_rows, delta_idx, lay,
                                      out=alloc(resident,
                                                delta_rows.shape[0]))

        return fused_kernel

    def fused_dense(model_params: Any, resident: torch.Tensor,
                    delta_rows: torch.Tensor,
                    delta_idx: torch.Tensor) -> tuple[
                        torch.Tensor, torch.Tensor]:
        outs = alloc(resident, delta_rows.shape[0])
        for k in range(delta_rows.shape[0]):
            scatter_rows_(resident, delta_rows[k], delta_idx[k])
            outs[k] = dense_fn(model_params, resident)
        return resident, outs

    return fused_dense


def _numpy_gelu(x: np.ndarray) -> np.ndarray:
    """jax.nn.gelu's default (tanh-approximate) formulation in NumPy."""
    c = np.float32(np.sqrt(2.0 / np.pi))
    return np.float32(0.5) * x * (
        np.float32(1.0) + np.tanh(c * (x + np.float32(0.044715) * x ** 3)))


def _numpy_features(cpu: np.ndarray, valid: np.ndarray, denom: np.ndarray,
                    ratio: np.ndarray, dt: np.ndarray) -> np.ndarray:
    """NumPy mirror of models.features.build_features → f32 [N, W, F]."""
    deltas = np.where(valid, cpu, 0.0).astype(np.float32)
    d = denom[:, None]
    share = np.where(d > 0.0, deltas / np.maximum(d, 1e-30), 0.0)
    dtc = dt[:, None]
    rate = np.where(dtc > 0.0, deltas / np.maximum(dtc, 1e-30), 0.0)
    w_shape = deltas.shape
    node_log = np.log1p(np.maximum(denom, 0.0))
    feats = np.stack([
        deltas,
        share,
        np.broadcast_to(ratio[:, None], w_shape),
        np.broadcast_to(dt[:, None], w_shape),
        rate,
        np.ones_like(deltas),
        np.broadcast_to(node_log[:, None], w_shape),
    ], axis=-1).astype(np.float32)
    return np.where(valid[..., None], feats, 0.0)


def _numpy_model_watts(model_mode: str, params: Any, feats: np.ndarray,
                       valid: np.ndarray) -> np.ndarray | None:
    """NumPy forward for the estimators the host rung can serve (linear,
    mlp). → watts f32 [N, W, Z], or None when the mode has no NumPy
    mirror."""
    if params is None:
        return None
    try:
        p = {k: np.asarray(v, np.float32) for k, v in dict(params).items()}
    except Exception:
        return None
    if model_mode == "linear":
        if "weight" not in p or "bias" not in p:
            return None
        watts = feats @ p["weight"] + p["bias"]
    elif model_mode == "mlp":
        if any(k not in p for k in ("w0", "b0", "w1", "b1", "w2", "b2",
                                    "w_skip")):
            return None
        h = _numpy_gelu(feats @ p["w0"] + p["b0"])
        h = _numpy_gelu(h @ p["w1"] + p["b1"])
        watts = h @ p["w2"] + feats @ p["w_skip"] + p["b2"]
    else:
        return None
    watts = np.maximum(watts.astype(np.float32), 0.0)
    return np.where(valid[..., None], watts, 0.0)


def numpy_fleet_window(packed: np.ndarray, n_workloads: int, n_zones: int,
                       params: Any = None,
                       model_mode: str | None = None) -> np.ndarray:
    """Pure-NumPy mirror of the packed fleet program — the aggregator's
    host-fallback rung: same packed input layout in, same ``[N, W+2, Z]``
    watts layout out (f32, not f16), touching no device at all so it
    keeps publishing with the device plane completely dead.

    Ratio-node attribution is exact. Model rows are served for the
    NumPy-mirrored estimators (linear, mlp); other modes publish zero
    watts for their model rows — absence, not fabrication.
    """
    w, z = n_workloads, n_zones
    lay = PackedLayout(w, z)
    cpu_nan = packed[:, lay.cpu]
    valid = ~np.isnan(cpu_nan)
    cpu = np.where(valid, cpu_nan, 0.0).astype(np.float32)
    zone = packed[:, lay.zone]
    zone_valid = packed[:, lay.zone_valid] > 0.5
    ratio = packed[:, lay.col_ratio]
    denom = packed[:, lay.col_denom]
    dt = packed[:, lay.col_dt]
    mode = packed[:, lay.col_mode].astype(np.int32)

    # node split (ops.attribution._node_split, NumPy)
    deltas = np.where(zone_valid, zone, 0.0).astype(np.float32)
    r = np.clip(ratio, 0.0, 1.0)[:, None]
    active = deltas * r
    dtc = dt[:, None]
    safe_dt = np.where(dtc > 0.0, dtc, 1.0)
    total_power_uw = np.where(dtc > 0.0, deltas / safe_dt, 0.0)
    active_power_uw = np.where(dtc > 0.0, active / safe_dt, 0.0)
    # workload ratios + the [W] ⊗ [Z] outer product, batched
    d = denom[:, None]
    ratios = np.where(d > 0.0,
                      cpu / np.maximum(d, 1e-30), 0.0).astype(np.float32)
    wl_power_uw = np.einsum("nw,nz->nwz", ratios, active_power_uw)

    node_active_w = active_power_uw * 1e-6  # µW → W (packed wire unit)
    node_total_w = total_power_uw * 1e-6
    wl_watts = wl_power_uw * 1e-6

    model_rows = np.flatnonzero(mode == MODE_MODEL)
    if model_rows.size and model_mode:
        feats = _numpy_features(cpu[model_rows], valid[model_rows],
                                denom[model_rows], ratio[model_rows],
                                dt[model_rows])
        watts = _numpy_model_watts(model_mode, params, feats,
                                   valid[model_rows])
        if watts is None:
            watts = np.zeros((model_rows.size, w, z), np.float32)
        wl_watts[model_rows] = watts
        est_node = watts.sum(axis=1)
        node_active_w[model_rows] = est_node
        node_total_w[model_rows] = est_node
    return np.concatenate(
        [wl_watts, node_active_w[:, None, :], node_total_w[:, None, :]],
        axis=1).astype(np.float32)


def unpack_fleet_watts(packed_watts: np.ndarray) -> tuple[np.ndarray,
                                                          np.ndarray]:
    """One D2H array → (workload_watts [N, W, Z], node_active_watts [N, Z])."""
    return packed_watts[:, :ROW_NODE_ACTIVE, :], \
        packed_watts[:, ROW_NODE_ACTIVE, :]


def unpack_fleet_window(packed_watts: np.ndarray) -> tuple[
        np.ndarray, np.ndarray, np.ndarray]:
    """One D2H array → (workload_watts [N, W, Z], node_active_watts [N, Z],
    node_total_watts [N, Z]) — the aggregator's scatter-back triple."""
    return (packed_watts[:, :ROW_NODE_ACTIVE, :],
            packed_watts[:, ROW_NODE_ACTIVE, :],
            packed_watts[:, ROW_NODE_TOTAL, :])
