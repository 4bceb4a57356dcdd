"""Terminated-workload tracker: top-N by primary-zone energy.

Reference parity: ``internal/monitor/terminated_resource_tracker.go`` —
generic tracker keyed on primary-zone energy with a min-energy threshold;
``max_size`` semantics: 0 = tracking off, <0 = unbounded, >0 = keep top-N;
``clear()`` after the exporter has consumed the data.

Instead of a per-item min-heap, candidates accumulate in dense columns and
one masked top-k (``ops.topk``) selects survivors per refresh, on the
tracker's device (the monitor's).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from kepler_tpu_torch.device import resolve_device
from kepler_tpu_torch.monitor.snapshot import WorkloadTable
from kepler_tpu_torch.ops.topk import top_k_by_energy


class TerminatedTracker:
    def __init__(
        self,
        n_zones: int,
        primary_zone_index: int,
        max_size: int = 500,
        min_energy_uj: float = 10e6,  # 10 J default (config.go:210-211)
        device: str | torch.device = "cuda",
    ) -> None:
        self._device = resolve_device(device)
        self._n_zones = n_zones
        self._primary = primary_zone_index
        self._max_size = max_size
        self._min_energy = min_energy_uj
        self._ids: list[str] = []
        self._meta: list[Mapping[str, str]] = []
        self._energy: list[np.ndarray] = []
        self._power: list[np.ndarray] = []
        self._seconds: list[float] = []  # process kind; 0.0 elsewhere
        self._has_seconds = False
        self._known: set[str] = set()

    def __len__(self) -> int:
        return len(self._ids)

    def add_batch(self, table: WorkloadTable) -> None:
        """Add terminated workloads (with their final cumulative usage)."""
        if self._max_size == 0:
            return
        if table.seconds is not None:
            self._has_seconds = True
        for i, wid in enumerate(table.ids):
            if wid in self._known:
                continue
            energy = table.energy_uj[i]
            if energy[self._primary] < self._min_energy:
                continue
            self._known.add(wid)
            self._ids.append(wid)
            self._meta.append(table.meta[i])
            self._energy.append(np.asarray(energy, dtype=np.float64))
            self._power.append(np.asarray(table.power_uw[i], np.float64))
            self._seconds.append(float(table.seconds[i])
                                 if table.seconds is not None else 0.0)
        self._compact()

    def _compact(self) -> None:
        if self._max_size < 0 or len(self._ids) <= self._max_size:
            return
        primary = np.array([e[self._primary] for e in self._energy])
        keep = top_k_by_energy(primary, self._max_size, self._min_energy,
                               device=self._device)
        keep_set = sorted(keep.tolist())
        self._ids = [self._ids[i] for i in keep_set]
        self._meta = [self._meta[i] for i in keep_set]
        self._energy = [self._energy[i] for i in keep_set]
        self._power = [self._power[i] for i in keep_set]
        self._seconds = [self._seconds[i] for i in keep_set]
        self._known = set(self._ids)

    def items(self) -> WorkloadTable:
        if not self._ids:
            return WorkloadTable.empty(self._n_zones)
        return WorkloadTable(
            ids=tuple(self._ids),
            meta=tuple(self._meta),
            energy_uj=np.stack(self._energy),
            power_uw=np.stack(self._power),
            seconds=(np.asarray(self._seconds)
                     if self._has_seconds else None),
        )

    def clear(self) -> None:
        self._ids.clear()
        self._meta.clear()
        self._energy.clear()
        self._power.clear()
        self._seconds.clear()
        self._known.clear()
