"""The attribution math: Kepler's power split as plain tensor ops.

Reference parity (semantics, not structure):

- ``internal/monitor/node.go:10-84``  — per-zone: split the window's energy
  delta into ``active = Δ × usage_ratio`` and ``idle = Δ − active``; power =
  Δenergy / Δt.
- ``internal/monitor/process.go:123-145`` (and container.go/vm.go/pod.go —
  identical formula per workload kind) — per workload w, zone z:
  ``ratio_w = Δcpu_w / Δcpu_node``; ``energy[w,z] = ratio_w × active[z]``;
  ``power[w,z] = ratio_w × active_power[z]``.

The whole thing is a rank-1 outer product ``ratio[W] ⊗ active[Z]``;
batched over nodes it is ``[N, W, 1] × [N, 1, Z]`` (``attribute_fleet``).
The hand-written CUDA form of that product lives in
``kepler_tpu_torch.ops.cuda_attribution``.

Masking: invalid workload rows (padding) and invalid zones (read errors —
reference node.go:39-44 skips failed zones) contribute exactly zero.

Every function keeps the f32 operation order of ``kepler_tpu.ops.attribution``
so the two packages agree bit for bit on the same inputs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class NodeAttribution(NamedTuple):
    """Per-zone node-level results (reference NodeUsage, monitor/types.go)."""

    energy_uj: torch.Tensor  # [..., Z] total Δenergy this window
    active_uj: torch.Tensor  # [..., Z] Δ × usage_ratio
    idle_uj: torch.Tensor  # [..., Z] Δ − active
    power_uw: torch.Tensor  # [..., Z] Δ / Δt
    active_power_uw: torch.Tensor  # [..., Z]
    idle_power_uw: torch.Tensor  # [..., Z]


class WorkloadAttribution(NamedTuple):
    """Per-workload per-zone results (reference Usage maps)."""

    energy_uj: torch.Tensor  # [..., W, Z]
    power_uw: torch.Tensor  # [..., W, Z]
    cpu_ratio: torch.Tensor  # [..., W] attribution ratios (diagnostics)


class AttributionResult(NamedTuple):
    node: NodeAttribution
    workloads: WorkloadAttribution


def _node_split(
    zone_deltas_uj: torch.Tensor,
    zone_valid: torch.Tensor,
    usage_ratio: torch.Tensor,
    dt_s: torch.Tensor,
) -> NodeAttribution:
    deltas = torch.where(zone_valid, zone_deltas_uj, 0.0)
    ratio = torch.clamp(usage_ratio, 0.0, 1.0)[..., None]  # broadcast over Z
    active = deltas * ratio
    idle = deltas - active
    # dt <= 0 (first window, or a clock anomaly) → power 0, never inf
    dt = dt_s[..., None]
    pos = dt > 0.0
    safe_dt = torch.where(pos, dt, 1.0)
    return NodeAttribution(
        energy_uj=deltas,
        active_uj=active,
        idle_uj=idle,
        power_uw=torch.where(pos, deltas / safe_dt, 0.0),  # µJ/s == µW
        active_power_uw=torch.where(pos, active / safe_dt, 0.0),
        idle_power_uw=torch.where(pos, idle / safe_dt, 0.0),
    )


def _workload_ratios(
    cpu_deltas: torch.Tensor,
    workload_valid: torch.Tensor,
    node_cpu_delta: torch.Tensor,
) -> torch.Tensor:
    deltas = torch.where(workload_valid, cpu_deltas, 0.0)
    denom = node_cpu_delta[..., None]
    return torch.where(denom > 0.0,
                       deltas / torch.clamp(denom, min=1e-30), 0.0)


def attribute(
    zone_deltas_uj: torch.Tensor,  # f32 [Z]
    zone_valid: torch.Tensor,  # bool [Z]
    usage_ratio: torch.Tensor,  # f32 scalar
    cpu_deltas: torch.Tensor,  # f32 [W]
    workload_valid: torch.Tensor,  # bool [W]
    node_cpu_delta: torch.Tensor,  # f32 scalar
    dt_s: torch.Tensor,  # f32 scalar
) -> AttributionResult:
    """Single-node attribution: the reference's entire hot loop.

    Invariant (conservation, the executable spec of
    ``monitor_snapshot_integration_test.go``): for any subset S of workloads
    with ``Σ_{w∈S} Δcpu_w == node_cpu_delta``,
    ``Σ_{w∈S} energy[w,z] == active[z]`` (up to f32 rounding).
    """
    node = _node_split(zone_deltas_uj, zone_valid, usage_ratio, dt_s)
    ratios = _workload_ratios(cpu_deltas, workload_valid, node_cpu_delta)
    energy = ratios[..., :, None] * node.active_uj[..., None, :]
    power = ratios[..., :, None] * node.active_power_uw[..., None, :]
    return AttributionResult(
        node=node,
        workloads=WorkloadAttribution(
            energy_uj=energy, power_uw=power, cpu_ratio=ratios
        ),
    )


def attribute_fleet(
    zone_deltas_uj: torch.Tensor,  # f32 [N, Z]
    zone_valid: torch.Tensor,  # bool [N, Z]
    usage_ratio: torch.Tensor,  # f32 [N]
    cpu_deltas: torch.Tensor,  # f32 [N, W]
    workload_valid: torch.Tensor,  # bool [N, W]
    node_cpu_delta: torch.Tensor,  # f32 [N]
    dt_s: torch.Tensor,  # f32 [N]
) -> AttributionResult:
    """Cluster-batched attribution over ``[nodes × workloads × zones]``
    in plain tensor ops (the ``einsum`` backend). Missing/late nodes are
    handled by zeroed masks."""
    node = _node_split(zone_deltas_uj, zone_valid, usage_ratio, dt_s)
    ratios = _workload_ratios(cpu_deltas, workload_valid, node_cpu_delta)
    energy = ratios[:, :, None] * node.active_uj[:, None, :]
    power = ratios[:, :, None] * node.active_power_uw[:, None, :]
    return AttributionResult(
        node=node,
        workloads=WorkloadAttribution(
            energy_uj=energy, power_uw=power, cpu_ratio=ratios
        ),
    )


def scatter_rows_(resident: torch.Tensor, rows: torch.Tensor,
                  idx: torch.Tensor) -> torch.Tensor:
    """``resident[idx[j]] = rows[j]`` in place; entries of ``idx`` outside
    ``[0, N)`` are dropped (the pad value is N). Valid indices must be
    unique. → ``resident``.

    No host sync and no nondeterminism: a row → delta-row map is built
    with a deterministic ``amax`` scatter (pads land in a spare slot N that
    is never read), then every row takes its delta row or keeps its own,
    written in place (``out=resident``: no whole-batch temporary).
    """
    n = resident.shape[0]
    if idx.numel() == 0:
        return resident
    idx = idx.to(torch.int64)
    slot = torch.where((idx >= 0) & (idx < n), idx, n)
    src = torch.full((n + 1,), -1, dtype=torch.int64, device=resident.device)
    src.scatter_reduce_(0, slot, torch.arange(idx.numel(),
                                              device=resident.device),
                        reduce="amax")
    src = src[:n]
    torch.where((src >= 0)[:, None], rows[src.clamp(min=0)], resident,
                out=resident)
    return resident


def pad_to_bucket(n: int, bucket: int) -> int:
    """Next multiple of ``bucket`` ≥ max(n, 1) — bounds the set of padded
    shapes a ragged fleet produces."""
    n = max(n, 1)
    return ((n + bucket - 1) // bucket) * bucket
