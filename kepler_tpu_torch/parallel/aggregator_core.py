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

Programs are plain callables over tensors on one device
(:class:`FleetProgram`); :func:`run_fleet_attribution` moves a host
batch there and runs one step. The ``make_*`` functions take ``device``
(default ``"cuda"``) and raise when it is missing. Over a node mesh,
:func:`shard_by_node` runs a single-shard body once per shard, on that
shard's block and device (the packed window programs use it).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch

from kepler_tpu_torch.device import resolve_device
from kepler_tpu_torch.models.estimator import (LINEAR, TEMPORAL, params_to,
                                               predictor)
from kepler_tpu_torch.models.features import build_features
from kepler_tpu_torch.models.temporal import predict_temporal
from kepler_tpu_torch.ops.attribution import AttributionResult, attribute_fleet
from kepler_tpu_torch.parallel.fleet import MODE_MODEL, FleetBatch
from kepler_tpu_torch.parallel.mesh import Mesh


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
    ratio = attribute_fn(
        zone_deltas_uj, zone_valid, usage_ratio, cpu_deltas,
        workload_valid, node_cpu_delta, dt_s,
    )
    if predict_fn is None:
        return _ratio_only_result(ratio)
    feats = build_features(cpu_deltas, workload_valid, node_cpu_delta,
                           usage_ratio, dt_s)
    model_watts = predict_fn(model_params, feats, workload_valid)
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
    ratio = attribute_fn(
        zone_deltas_uj, zone_valid, usage_ratio, cpu_deltas,
        workload_valid, node_cpu_delta, dt_s,
    )
    pfn = (accuracy_mode_predictor(predict_temporal, TEMPORAL)
           if accuracy_mode else predict_temporal)
    watts = pfn(model_params, feat_hist, workload_valid, t_valid=t_valid)
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


def shard_by_node(fn: Callable, mesh: Mesh) -> Callable:
    """Run ``fn`` once per shard of ``mesh``'s node axis.

    ``sharded(*args)`` takes each argument as a sequence with one entry
    per shard (that shard's block, on its device) and returns a tuple of
    ``fn``'s outputs in shard order. A shard whose arguments are all None
    is not run here (another process owns it) and its output is None.
    The fleet forward has no cross-node math, so running it per shard
    changes layout, not semantics, and needs no collective.
    """
    devices = mesh.devices

    def sharded(*args: Sequence[Any]) -> tuple:
        out = []
        for k, dev in enumerate(devices):
            if all(a[k] is None for a in args):
                out.append(None)
                continue
            with on_device(dev):
                out.append(fn(*(a[k] for a in args)))
        return tuple(out)

    return sharded


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
    """A fleet program bound to the device its inputs must lie on."""

    fn: Callable[..., FleetResult]
    device: torch.device

    def __call__(self, *args: Any) -> FleetResult:
        return self.fn(*args)


def make_fleet_program(device: str | torch.device = "cuda",
                       model_mode: str | None = None,
                       backend: str = "einsum",
                       accuracy_mode: bool = False) -> FleetProgram:
    """The single-tick fleet program on ``device`` (the aggregator's
    serial rung).

    ``model_mode``: None = ratio only; "linear"/"mlp" evaluates that
    predictor for mixed fleets. ``backend``: "einsum" (plain tensor ops)
    or "pallas" (the attribution contraction as kernel B1).
    """
    dev = resolve_device(device)
    predict_fn = predictor(model_mode) if model_mode else None
    if predict_fn is not None and accuracy_mode:
        predict_fn = accuracy_mode_predictor(predict_fn, model_mode)
    attribute_fn = resolve_attribute_fn(backend)

    def program(model_params: Any, *data: torch.Tensor) -> FleetResult:
        return fleet_attribution_program(model_params, *data,
                                         predict_fn=predict_fn,
                                         attribute_fn=attribute_fn)

    return FleetProgram(program, dev)


def make_temporal_fleet_program(device: str | torch.device = "cuda",
                                backend: str = "einsum",
                                accuracy_mode: bool = False
                                ) -> FleetProgram:
    """The TEMPORAL fleet program on ``device`` (extra ``feat_hist`` and
    ``t_valid`` inputs). With ``backend="pallas"`` its attribution runs as
    kernel B1; the estimator's fast path launches no kernel."""
    dev = resolve_device(device)
    attribute_fn = resolve_attribute_fn(backend)

    def program(model_params: Any, *data: torch.Tensor) -> FleetResult:
        return temporal_fleet_program(model_params, *data,
                                      attribute_fn=attribute_fn,
                                      accuracy_mode=accuracy_mode)

    return FleetProgram(program, dev)


def run_fleet_attribution(
    program: FleetProgram,
    batch: FleetBatch,
    model_params: Any = None,
    feat_hist: np.ndarray | torch.Tensor | None = None,  # [N, W, T, F]
    t_valid: np.ndarray | torch.Tensor | None = None,  # [N, W, T]
) -> FleetResult:
    """Host entry: move the padded batch (and the params, and for temporal
    programs the history windows) to the program's device, run one step."""
    dev = program.device

    def put(x: Any) -> torch.Tensor:
        return torch.as_tensor(x).to(dev)

    params = (params_to(model_params, dev)
              if model_params is not None else None)
    args = [put(batch.zone_deltas_uj), put(batch.zone_valid),
            put(batch.usage_ratio), put(batch.cpu_deltas),
            put(batch.workload_valid), put(batch.node_cpu_delta),
            put(batch.dt_s), put(batch.mode)]
    if feat_hist is not None:
        args += [put(feat_hist), put(t_valid)]
    return program(params, *args)
