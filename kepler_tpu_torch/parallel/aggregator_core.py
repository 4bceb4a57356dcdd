"""The cluster-attribution program, on one device.

BASELINE.json north star: gather per-node feature rows, evaluate
ratio-attribution AND learned estimators as one batched computation over
``[nodes × pods × features]``, scatter watts back per node.

Mixed fleets (config 5): both paths evaluate for every node and a
``torch.where`` on the per-node mode code selects the result. RAPL nodes get
ratio watts, non-RAPL nodes get model watts on their zone axis.

The temporal fleet program (the aggregator's ``model: temporal``) takes
each workload's feature history ``[N, W, T, F]`` beside the window and
serves the temporal estimator's single-query fast path.

Programs are plain callables over tensors (:class:`FleetProgram`);
:func:`run_fleet_attribution` moves a host batch there and runs one
step. The ``make_*`` functions take ``device`` (default ``"cuda"``) and
raise when it is missing, or a ``mesh``: the program then runs once per
NODE BLOCK of the mesh, as the reference's programs shard their batch by
node. Node row ``i`` of the mesh (its first axis, ``node``) owns rows
``[i·N/n, (i+1)·N/n)`` of the batch, and the block lives on the device
of the row's first shard (model index 0): these programs have no
model-axis math and replicated params, so the port computes each block
once where the reference replicates it over ``model``
(:func:`node_blocks`, :func:`shard_by_node`; the packed window programs
use them too).

Telemetry spans (profiler ranges while a profiler records, stages of the
aggregator's ``aggregator.window`` cycle where a recorder is installed):
:func:`run_fleet_attribution` opens ``fleet.pack`` (the host pack of a
node block), ``fleet.h2d`` (its copy to the device) and ``fleet.launch``
(the program call); the programs open ``fleet.attribute`` (B1 or its
plain version), ``fleet.estimator`` and ``fleet.mix``.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch

from kepler_tpu_torch import telemetry
from kepler_tpu_torch.device import resolve_device
from kepler_tpu_torch.models.estimator import (LINEAR, TEMPORAL, params_to,
                                               predictor)
from kepler_tpu_torch.models.features import build_features
from kepler_tpu_torch.models.temporal import predict_temporal
from kepler_tpu_torch.ops import recorder
from kepler_tpu_torch.ops.attribution import AttributionResult, attribute_fleet
from kepler_tpu_torch.parallel.fleet import MODE_MODEL, FleetBatch
from kepler_tpu_torch.parallel.mesh import NODE_AXIS, Mesh


class FleetResult(NamedTuple):
    node_energy_uj: torch.Tensor  # [N, Z]
    node_active_uj: torch.Tensor  # [N, Z]
    node_idle_uj: torch.Tensor  # [N, Z]
    node_power_uw: torch.Tensor  # [N, Z]
    node_active_power_uw: torch.Tensor  # [N, Z]
    node_idle_power_uw: torch.Tensor  # [N, Z]
    workload_energy_uj: torch.Tensor  # [N, W, Z]
    workload_power_uw: torch.Tensor  # [N, W, Z]


def _ratio_only_result(ratio: AttributionResult) -> FleetResult:
    return FleetResult(
        node_energy_uj=ratio.node.energy_uj,
        node_active_uj=ratio.node.active_uj,
        node_idle_uj=ratio.node.idle_uj,
        node_power_uw=ratio.node.power_uw,
        node_active_power_uw=ratio.node.active_power_uw,
        node_idle_power_uw=ratio.node.idle_power_uw,
        workload_energy_uj=ratio.workloads.energy_uj,
        workload_power_uw=ratio.workloads.power_uw,
    )


def mix_model_watts(
    ratio: AttributionResult,
    model_watts: torch.Tensor,  # f32 [N, W, Z] estimator output (watts)
    mode: torch.Tensor,  # int32 [N]
    dt_s: torch.Tensor,  # f32 [N]
) -> FleetResult:
    """Per-node select: RAPL nodes keep ratio watts, MODE_MODEL nodes take
    the estimator's."""
    model_power_uw = model_watts * 1e6  # watts → µW
    model_energy_uj = model_power_uw * dt_s[:, None, None]  # µW·s = µJ
    is_model = (mode == MODE_MODEL)[:, None, None]
    wl_power = torch.where(is_model, model_power_uw,
                           ratio.workloads.power_uw)
    wl_energy = torch.where(is_model, model_energy_uj,
                            ratio.workloads.energy_uj)
    # model-mode nodes have no RAPL; their node totals are the sum of
    # model-estimated workload power (active == total, idle unknown → 0)
    est_node_power = torch.sum(model_power_uw, dim=1)  # [N, Z]
    est_node_energy = torch.sum(model_energy_uj, dim=1)
    is_model_nz = (mode == MODE_MODEL)[:, None]
    return FleetResult(
        node_energy_uj=torch.where(is_model_nz, est_node_energy,
                                   ratio.node.energy_uj),
        node_active_uj=torch.where(is_model_nz, est_node_energy,
                                   ratio.node.active_uj),
        node_idle_uj=torch.where(is_model_nz, 0.0, ratio.node.idle_uj),
        node_power_uw=torch.where(is_model_nz, est_node_power,
                                  ratio.node.power_uw),
        node_active_power_uw=torch.where(is_model_nz, est_node_power,
                                         ratio.node.active_power_uw),
        node_idle_power_uw=torch.where(is_model_nz, 0.0,
                                       ratio.node.idle_power_uw),
        workload_energy_uj=wl_energy,
        workload_power_uw=wl_power,
    )


def fleet_attribution_program(
    model_params: Any,
    zone_deltas_uj: torch.Tensor,  # f32 [N, Z]
    zone_valid: torch.Tensor,  # bool [N, Z]
    usage_ratio: torch.Tensor,  # f32 [N]
    cpu_deltas: torch.Tensor,  # f32 [N, W]
    workload_valid: torch.Tensor,  # bool [N, W]
    node_cpu_delta: torch.Tensor,  # f32 [N]
    dt_s: torch.Tensor,  # f32 [N]
    mode: torch.Tensor,  # int32 [N] MODE_RATIO / MODE_MODEL
    *,
    predict_fn: Callable | None,
    attribute_fn: Callable = attribute_fleet,
) -> FleetResult:
    """Ratio attribution for every node, plus the estimator for mixed
    fleets when ``predict_fn`` is given."""
    with telemetry.span("fleet.attribute"):
        ratio = attribute_fn(
            zone_deltas_uj, zone_valid, usage_ratio, cpu_deltas,
            workload_valid, node_cpu_delta, dt_s,
        )
    if predict_fn is None:
        return _ratio_only_result(ratio)
    with telemetry.span("fleet.estimator"):
        feats = build_features(cpu_deltas, workload_valid, node_cpu_delta,
                               usage_ratio, dt_s)
        model_watts = predict_fn(model_params, feats, workload_valid)
    with telemetry.span("fleet.mix"):
        return mix_model_watts(ratio, model_watts, mode, dt_s)


def temporal_fleet_program(
    model_params: Any,
    zone_deltas_uj: torch.Tensor,  # f32 [N, Z]
    zone_valid: torch.Tensor,  # bool [N, Z]
    usage_ratio: torch.Tensor,  # f32 [N]
    cpu_deltas: torch.Tensor,  # f32 [N, W]
    workload_valid: torch.Tensor,  # bool [N, W]
    node_cpu_delta: torch.Tensor,  # f32 [N]
    dt_s: torch.Tensor,  # f32 [N]
    mode: torch.Tensor,  # int32 [N]
    feat_hist: torch.Tensor,  # f32 [N, W, T, F] per-workload history
    t_valid: torch.Tensor,  # bool [N, W, T]
    *,
    attribute_fn: Callable = attribute_fleet,
    accuracy_mode: bool = False,
) -> FleetResult:
    """Mixed fleet with the TEMPORAL estimator: the model predicts each
    workload's watts from its whole history window (``monitor.history``)
    instead of the last tick."""
    with telemetry.span("fleet.attribute"):
        ratio = attribute_fn(
            zone_deltas_uj, zone_valid, usage_ratio, cpu_deltas,
            workload_valid, node_cpu_delta, dt_s,
        )
    pfn = (accuracy_mode_predictor(predict_temporal, TEMPORAL)
           if accuracy_mode else predict_temporal)
    with telemetry.span("fleet.estimator"):
        watts = pfn(model_params, feat_hist, workload_valid,
                    t_valid=t_valid)
    with telemetry.span("fleet.mix"):
        return mix_model_watts(ratio, watts, mode, dt_s)


def resolve_attribute_fn(backend: str) -> Callable:
    """→ the fleet-attribution contraction for ``backend``: "einsum" is
    plain tensor ops, "pallas" the hand-written CUDA kernel B1 (its plain
    version for tensors on the CPU)."""
    if backend == "pallas":
        from kepler_tpu_torch.ops.cuda_attribution import (
            attribute_fleet_pallas)

        return attribute_fleet_pallas
    if backend == "einsum":
        return attribute_fleet
    raise ValueError(f"unknown attribution backend {backend!r}; "
                     "valid: einsum, pallas")


def on_device(device: torch.device) -> contextlib.AbstractContextManager:
    """Make ``device`` current for the launches inside (a no-op off
    CUDA): a hand kernel launches on the current device's stream."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class NodeBlock(NamedTuple):
    """One node block of a mesh: its index, the index of the shard it
    runs on (its node row's first shard) and that shard's device."""

    index: int
    shard: int
    device: torch.device


def node_blocks(mesh: Mesh) -> tuple[NodeBlock, ...]:
    """The node blocks of ``mesh``, in row order: one per shard of a 1-D
    mesh, one per node row of a ``node × …`` mesh (shards are row-major,
    so row ``i`` starts at shard ``i · size / n_node``). A mesh without a
    ``node`` axis takes its first axis for it."""
    n_node = mesh.axis_size(NODE_AXIS) or mesh.shape[0]
    per_row = mesh.size // n_node
    return tuple(NodeBlock(i, i * per_row, mesh.shards[i * per_row].device)
                 for i in range(n_node))


def block_local_index(idx: np.ndarray, n_rows: int,
                      n_blocks: int) -> np.ndarray:
    """Global row ids → ``[n_blocks, *idx.shape]`` BLOCK-LOCAL ones, in
    place: block ``b`` owns rows ``[b·sb, (b+1)·sb)`` (``sb = n_rows /
    n_blocks``) and sees each id that lands there less ``b·sb``, every
    other id (another block's row, or a pad outside ``[0, n_rows)``) as
    ``sb``, its own pad (gather-clamped, scatter-dropped). One block
    leaves the ids in range as they are and pads with ``n_rows``."""
    idx = np.asarray(idx)
    sb = n_rows // n_blocks
    first = sb * np.arange(n_blocks).reshape((n_blocks,) + (1,) * idx.ndim)
    local = idx[None] - first
    return np.where((local >= 0) & (local < sb), local, sb).astype(np.int32)


def shard_by_node(fn: Callable, mesh: Mesh) -> Callable:
    """Run ``fn`` once per node block of ``mesh`` (:func:`node_blocks`).

    ``sharded(*args)`` takes each argument as a sequence with one entry
    per block (that block's rows, on its device) and returns a tuple of
    ``fn``'s outputs in block order. A block whose arguments are all
    None is not run here (another process owns it) and its output is
    None. The fleet forward has no cross-node math, so running it per
    block changes layout, not semantics, and needs no collective.
    """
    blocks = node_blocks(mesh)

    def sharded(*args: Sequence[Any]) -> tuple:
        out = []
        for b in blocks:
            if all(a[b.index] is None for a in args):
                out.append(None)
                continue
            recorder.shard(b.index)
            with on_device(b.device):
                out.append(fn(*(a[b.index] for a in args)))
        return tuple(out)

    return sharded


def put_blocks(arrays: Sequence[np.ndarray], mesh: Mesh
               ) -> list[list[torch.Tensor]]:
    """Host arrays with a leading node axis → per node block, each
    array's block on the block's device, with ONE host-to-device copy
    per block: the block's slices are packed into one byte buffer, which
    moves once and is viewed back into the arrays' dtypes and shapes."""
    blocks = node_blocks(mesh)
    arrays = [np.asarray(a) for a in arrays]
    n_rows = arrays[0].shape[0]
    if n_rows % len(blocks):  # node buckets are aligned to the mesh size
        raise ValueError(f"{n_rows} rows do not divide into {len(blocks)} "
                         "node blocks")
    sb = n_rows // len(blocks)
    out = []
    for b in blocks:
        with telemetry.span("fleet.pack"):
            parts = [np.ascontiguousarray(a[b.index * sb:(b.index + 1) * sb])
                     for a in arrays]
            offsets, size = [], 0
            for p in parts:
                offsets.append(size)
                size += -(-p.nbytes // 16) * 16  # 16-byte aligned segments
            buf = np.empty(size, np.uint8)
            for p, off in zip(parts, offsets):
                buf[off:off + p.nbytes] = p.reshape(-1).view(np.uint8)
        with telemetry.span("fleet.h2d"):
            dev_buf = torch.from_numpy(buf).to(b.device)
        out.append([
            dev_buf[off:off + p.nbytes].view(torch.from_numpy(p[:0]).dtype
                                             ).view(p.shape)
            for p, off in zip(parts, offsets)])
    return out


def accuracy_mode_predictor(predict_fn: Callable,
                            model_mode: str) -> Callable:
    """Wrap a predictor for ACCURACY-mode serving: f32 compute (bf16
    trunks carry ~1e-3 relative noise). TF32 is already off
    (``device.resolve_device``), so f32 products run in full f32. As in
    JAX, every mode but "linear" (which has no trunk and no
    ``compute_dtype``) gets ``compute_dtype=torch.float32``."""
    if model_mode == LINEAR:
        return predict_fn

    def wrapped(params: Any, feats: torch.Tensor,
                workload_valid: torch.Tensor, **extra: Any) -> torch.Tensor:
        return predict_fn(params, feats, workload_valid,
                          compute_dtype=torch.float32, **extra)

    return wrapped


@dataclass(frozen=True)
class FleetProgram:
    """A fleet program bound to the device its inputs must lie on, or,
    with ``mesh``, run once per node block of the mesh: it then takes
    every argument as a per-block sequence and returns the blocks'
    :class:`FleetResult` s in block order."""

    fn: Callable[..., Any]
    device: torch.device
    mesh: Mesh | None = None

    def __call__(self, *args: Any) -> Any:
        return self.fn(*args)


def _bind(body: Callable, device: str | torch.device,
          mesh: Mesh | None) -> FleetProgram:
    if mesh is None:
        return FleetProgram(body, resolve_device(device))
    return FleetProgram(shard_by_node(body, mesh), mesh.devices[0], mesh)


def make_fleet_program(device: str | torch.device = "cuda",
                       model_mode: str | None = None,
                       backend: str = "einsum",
                       accuracy_mode: bool = False,
                       mesh: Mesh | None = None) -> FleetProgram:
    """The single-tick fleet program on ``device`` (the aggregator's
    serial rung), or over ``mesh``'s node blocks.

    ``model_mode``: None = ratio only; "linear"/"mlp" evaluates that
    predictor for mixed fleets. ``backend``: "einsum" (plain tensor ops)
    or "pallas" (the attribution contraction as kernel B1, once per
    node block over a mesh).
    """
    predict_fn = predictor(model_mode) if model_mode else None
    if predict_fn is not None and accuracy_mode:
        predict_fn = accuracy_mode_predictor(predict_fn, model_mode)
    attribute_fn = resolve_attribute_fn(backend)

    def program(model_params: Any, *data: torch.Tensor) -> FleetResult:
        return fleet_attribution_program(model_params, *data,
                                         predict_fn=predict_fn,
                                         attribute_fn=attribute_fn)

    return _bind(program, device, mesh)


def make_temporal_fleet_program(device: str | torch.device = "cuda",
                                backend: str = "einsum",
                                accuracy_mode: bool = False,
                                mesh: Mesh | None = None) -> FleetProgram:
    """The TEMPORAL fleet program on ``device``, or over ``mesh``'s node
    blocks (extra ``feat_hist`` and ``t_valid`` inputs). With
    ``backend="pallas"`` its attribution runs as kernel B1 (once per
    block); the estimator's fast path launches no kernel."""
    attribute_fn = resolve_attribute_fn(backend)

    def program(model_params: Any, *data: torch.Tensor) -> FleetResult:
        return temporal_fleet_program(model_params, *data,
                                      attribute_fn=attribute_fn,
                                      accuracy_mode=accuracy_mode)

    return _bind(program, device, mesh)


def run_fleet_attribution(
    program: FleetProgram,
    batch: FleetBatch,
    model_params: Any = None,
    feat_hist: np.ndarray | torch.Tensor | None = None,  # [N, W, T, F]
    t_valid: np.ndarray | torch.Tensor | None = None,  # [N, W, T]
) -> FleetResult | tuple[FleetResult, ...]:
    """Host entry: move the padded batch (and the params, and for temporal
    programs the history windows) to the program's device, run one step.

    Over a mesh the batch is cut into the program's node blocks, each
    moved to its block's device in one copy, with the params once per
    distinct device; → the blocks' results in block order."""
    data = [batch.zone_deltas_uj, batch.zone_valid, batch.usage_ratio,
            batch.cpu_deltas, batch.workload_valid, batch.node_cpu_delta,
            batch.dt_s, batch.mode]
    if feat_hist is not None:
        data += [feat_hist, t_valid]
    mesh = program.mesh
    if mesh is None:
        dev = program.device
        with telemetry.span("fleet.h2d"):
            params = (params_to(model_params, dev)
                      if model_params is not None else None)
            args = [torch.as_tensor(x).to(dev) for x in data]
        with telemetry.span("fleet.launch"):
            return program(params, *args)
    blocks = put_blocks([np.asarray(x) for x in data], mesh)
    on: dict[torch.device, Any] = {}
    params = []
    with telemetry.span("fleet.h2d"):
        for b in node_blocks(mesh):
            if model_params is not None and b.device not in on:
                on[b.device] = params_to(model_params, b.device)
            params.append(on.get(b.device))
    with telemetry.span("fleet.launch"):
        return program(params, *zip(*blocks))
