"""The cluster-attribution program, on one device.

BASELINE.json north star: gather per-node feature rows, evaluate
ratio-attribution AND learned estimators as one batched computation over
``[nodes × pods × features]``, scatter watts back per node.

Mixed fleets (config 5): both paths evaluate for every node and a
``torch.where`` on the per-node mode code selects the result. RAPL nodes get
ratio watts, non-RAPL nodes get model watts on their zone axis.

Single device: the JAX package's node-axis sharding (``shard_by_node``,
the mesh builders) comes with the port's multi-GPU slice.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from kepler_tpu_torch.models.features import build_features
from kepler_tpu_torch.ops.attribution import AttributionResult, attribute_fleet
from kepler_tpu_torch.parallel.fleet import MODE_MODEL


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
