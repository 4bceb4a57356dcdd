"""Immutable snapshot types.

Reference parity: ``internal/monitor/types.go`` — ``Usage`` (cumulative
energy + instantaneous power), ``NodeUsage`` (adds active/idle splits),
``Snapshot`` (node + running/terminated maps for each workload kind) with
deep ``Clone`` so collectors read race-free.

Design: per-workload numbers live in dense f64 numpy columns
(``WorkloadTable``) aligned to an id list — the exporter iterates rows only
at scrape-render time; the monitor updates them with vectorized ops, never a
per-workload Python loop.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, Mapping

import numpy as np


@dataclass(frozen=True)
class NodeUsage:
    """Per-zone node energy/power, arrays indexed by zone (``zone_names``).

    Cumulative counters are f64 µJ (sub-µJ exact for centuries of uptime);
    powers are f64 µW.
    """

    zone_names: tuple[str, ...]
    energy_uj: np.ndarray  # [Z] cumulative Δ-sum since start
    active_uj: np.ndarray  # [Z] cumulative active split
    idle_uj: np.ndarray  # [Z] cumulative idle split
    power_uw: np.ndarray  # [Z] last-window total power
    active_power_uw: np.ndarray  # [Z]
    idle_power_uw: np.ndarray  # [Z]
    # last-window active energy — the attribution numerator (private in the
    # reference: NodeUsage.activeEnergy, types.go:27-40)
    window_active_uj: np.ndarray = field(default_factory=lambda: np.zeros(0))
    # node CPU usage ratio over the last window (from /proc/stat deltas)
    usage_ratio: float = 0.0

    def clone(self) -> "NodeUsage":
        return NodeUsage(
            zone_names=self.zone_names,
            energy_uj=self.energy_uj.copy(),
            active_uj=self.active_uj.copy(),
            idle_uj=self.idle_uj.copy(),
            power_uw=self.power_uw.copy(),
            active_power_uw=self.active_power_uw.copy(),
            idle_power_uw=self.idle_power_uw.copy(),
            window_active_uj=self.window_active_uj.copy(),
            usage_ratio=self.usage_ratio,
        )


@dataclass(frozen=True)
class WorkloadRow:
    """One workload's view over a table (returned by iteration, not stored)."""

    id: str
    meta: Mapping[str, str]
    energy_uj: np.ndarray  # [Z] cumulative
    power_uw: np.ndarray  # [Z]


@dataclass(frozen=True)
class WorkloadTable:
    """Dense per-workload columns for one kind (process/container/vm/pod)."""

    ids: tuple[str, ...]
    meta: tuple[Mapping[str, str], ...]  # exporter labels (comm, runtime, …)
    energy_uj: np.ndarray  # [W, Z] cumulative f64
    power_uw: np.ndarray  # [W, Z] f64
    # process kind only: cumulative CPU seconds per row (the
    # kepler_process_cpu_seconds_total column); None for other kinds
    seconds: np.ndarray | None = None

    @staticmethod
    def empty(n_zones: int) -> "WorkloadTable":
        return WorkloadTable(
            ids=(), meta=(),
            energy_uj=np.zeros((0, n_zones)),
            power_uw=np.zeros((0, n_zones)),
        )

    def __len__(self) -> int:
        return len(self.ids)

    def rows(self) -> Iterator[WorkloadRow]:
        for i, wid in enumerate(self.ids):
            yield WorkloadRow(
                id=wid, meta=self.meta[i],
                energy_uj=self.energy_uj[i], power_uw=self.power_uw[i],
            )

    def clone(self) -> "WorkloadTable":
        return WorkloadTable(
            ids=self.ids,
            meta=tuple(dict(m) for m in self.meta),
            energy_uj=self.energy_uj.copy(),
            power_uw=self.power_uw.copy(),
            seconds=(self.seconds.copy()
                     if self.seconds is not None else None),
        )


@dataclass(frozen=True)
class Snapshot:
    """One consistent view of node + workload power (reference Snapshot,
    types.go:224-238)."""

    timestamp: float
    node: NodeUsage
    processes: WorkloadTable
    containers: WorkloadTable
    virtual_machines: WorkloadTable
    pods: WorkloadTable
    terminated_processes: WorkloadTable
    terminated_containers: WorkloadTable
    terminated_virtual_machines: WorkloadTable
    terminated_pods: WorkloadTable

    def clone(self) -> "Snapshot":
        return Snapshot(
            timestamp=self.timestamp,
            node=self.node.clone(),
            processes=self.processes.clone(),
            containers=self.containers.clone(),
            virtual_machines=self.virtual_machines.clone(),
            pods=self.pods.clone(),
            terminated_processes=self.terminated_processes.clone(),
            terminated_containers=self.terminated_containers.clone(),
            terminated_virtual_machines=self.terminated_virtual_machines.clone(),
            terminated_pods=self.terminated_pods.clone(),
        )
