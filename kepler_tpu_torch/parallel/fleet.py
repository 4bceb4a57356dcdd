"""Fleet batch assembly: ragged per-node reports → one padded tensor.

SURVEY §7 hard part (a): pods-per-node varies wildly; shapes must come from
a small bucket set or every fleet composition change recompiles. Nodes pad
to ``node_bucket`` multiples, workloads to ``workload_bucket`` multiples;
masks make padding contribute exact zeros (the batched analog of the
reference's skip-on-error, SURVEY §5).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping, Sequence

import numpy as np

from kepler_tpu_torch.ops.attribution import pad_to_bucket

# estimator-mode codes carried in the fleet tensor (models/estimator.py)
MODE_RATIO = 0
MODE_MODEL = 1


@dataclass
class NodeReport:
    """One node's feature rows for one window (the gRPC wire payload)."""

    node_name: str
    zone_deltas_uj: np.ndarray  # f32/f64 [Z]
    zone_valid: np.ndarray  # bool [Z]
    usage_ratio: float
    cpu_deltas: np.ndarray  # f32 [w] (ragged)
    workload_ids: list[str]
    node_cpu_delta: float
    dt_s: float
    mode: int = MODE_RATIO  # MODE_RATIO on RAPL nodes, MODE_MODEL otherwise
    workload_kinds: np.ndarray | None = None  # int8 [w], optional
    meta: Mapping[str, str] = field(default_factory=dict)


@dataclass
class FleetBatch:
    """Dense padded arrays, shapes [N, ...] with N/W bucketed."""

    node_names: list[str]  # first n_nodes entries real, rest ""
    n_nodes: int  # real node count
    workload_counts: list[int]  # real workload count per node row
    workload_ids: list[list[str]]
    zone_deltas_uj: np.ndarray  # f32 [N, Z]
    zone_valid: np.ndarray  # bool [N, Z]
    usage_ratio: np.ndarray  # f32 [N]
    cpu_deltas: np.ndarray  # f32 [N, W]
    workload_valid: np.ndarray  # bool [N, W]
    node_cpu_delta: np.ndarray  # f32 [N]
    dt_s: np.ndarray  # f32 [N]
    mode: np.ndarray  # int32 [N]

    @property
    def shape(self) -> tuple[int, int, int]:
        n, w = self.cpu_deltas.shape
        return n, w, self.zone_deltas_uj.shape[1]


def assemble_fleet_batch(
    reports: Sequence[NodeReport],
    n_zones: int,
    node_bucket: int = 8,
    workload_bucket: int = 256,
    zone_deltas_mat: np.ndarray | None = None,
    zone_valid_mat: np.ndarray | None = None,
) -> FleetBatch:
    """Pad/mask ragged node reports into one rectangular batch.

    Missing nodes simply aren't rows; a node that reported unreadable zones
    keeps its row with those zones masked. Shapes are
    ``[pad(N), pad(max_w)]`` so the jit cache sees O(buckets²) shapes, not
    O(fleet compositions).

    ``zone_deltas_mat`` / ``zone_valid_mat``: optional pre-aligned
    ``[n_real, n_zones]`` matrices (the aggregator's grouped zone-align
    produces them directly); when given, the per-report zone arrays are
    not touched.
    """
    n_real = len(reports)
    n = pad_to_bucket(max(n_real, 1), node_bucket)
    max_w = max((len(r.cpu_deltas) for r in reports), default=1)
    w = pad_to_bucket(max_w, workload_bucket)

    cpu = np.zeros((n, w), np.float32)
    valid = np.zeros((n, w), bool)
    if n_real:
        zone_deltas = np.zeros((n, n_zones), np.float32)
        zone_valid = np.zeros((n, n_zones), bool)
        if zone_deltas_mat is not None:
            if zone_deltas_mat.shape != (n_real, n_zones):
                raise ValueError(
                    f"zone matrix shape {zone_deltas_mat.shape}, expected "
                    f"({n_real}, {n_zones})")
            zone_deltas[:n_real] = zone_deltas_mat
            zone_valid[:n_real] = zone_valid_mat
        else:
            for r in reports:
                zd = np.asarray(r.zone_deltas_uj)
                if zd.shape != (n_zones,):
                    raise ValueError(
                        f"node {r.node_name}: {zd.shape} zones, expected "
                        f"({n_zones},)")
                zv = np.asarray(r.zone_valid)
                if zv.shape != (n_zones,):
                    raise ValueError(
                        f"node {r.node_name}: zone_valid shape {zv.shape}, "
                        f"expected ({n_zones},)")
            zone_deltas[:n_real] = np.stack(
                [np.asarray(r.zone_deltas_uj, np.float32)
                 for r in reports])
            zone_valid[:n_real] = np.stack(
                [np.asarray(r.zone_valid, bool) for r in reports])
        usage = np.zeros(n, np.float32)
        usage[:n_real] = np.fromiter((r.usage_ratio for r in reports),
                                     np.float64, n_real)
        node_delta = np.zeros(n, np.float32)
        node_delta[:n_real] = np.fromiter(
            (r.node_cpu_delta for r in reports), np.float64, n_real)
        dt = np.zeros(n, np.float32)
        dt[:n_real] = np.fromiter((r.dt_s for r in reports), np.float64,
                                  n_real)
        mode = np.zeros(n, np.int32)
        mode[:n_real] = np.fromiter((r.mode for r in reports), np.int64,
                                    n_real)
        # ragged cpu rows → one flat concat + a vectorized 2-D scatter
        # (the per-row python assignments used to dominate 1k-node windows)
        lengths = np.fromiter((len(r.cpu_deltas) for r in reports),
                              np.int64, n_real)
        total = int(lengths.sum())
        if total:
            flat = np.concatenate(
                [np.asarray(r.cpu_deltas, np.float32) for r in reports])
            rows = np.repeat(np.arange(n_real), lengths)
            starts = np.concatenate(([0], np.cumsum(lengths)[:-1]))
            cols = np.arange(total) - np.repeat(starts, lengths)
            cpu[rows, cols] = flat
            valid[rows, cols] = True
        counts = lengths.tolist()
        names = [r.node_name for r in reports]
        # id lists are referenced, not copied — callers treat reports as
        # immutable once handed over (the wire decoder builds fresh lists)
        ids = [r.workload_ids for r in reports]
    else:
        zone_deltas = np.zeros((n, n_zones), np.float32)
        zone_valid = np.zeros((n, n_zones), bool)
        usage = np.zeros(n, np.float32)
        node_delta = np.zeros(n, np.float32)
        dt = np.zeros(n, np.float32)
        mode = np.zeros(n, np.int32)
        names, counts, ids = [], [], []

    names += [""] * (n - n_real)
    counts += [0] * (n - n_real)
    ids += [[] for _ in range(n - n_real)]

    return FleetBatch(
        node_names=names, n_nodes=n_real, workload_counts=counts,
        workload_ids=ids, zone_deltas_uj=zone_deltas, zone_valid=zone_valid,
        usage_ratio=usage, cpu_deltas=cpu, workload_valid=valid,
        node_cpu_delta=node_delta, dt_s=dt, mode=mode,
    )
