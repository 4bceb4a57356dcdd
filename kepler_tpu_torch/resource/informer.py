"""The informer's dense per-window feature columns.

A copy of ``FeatureBatch`` from ``kepler_tpu/resource/informer.py`` (the
rest of the informer, the /proc scan, is the node agent's and is not
ported here): the aggregator builds one per node report to advance that
node's feature history (``monitor.history``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class FeatureBatch:
    """Dense per-workload feature columns for one refresh window.

    Row order is stable for the lifetime of a workload (rows are appended on
    first sight and compacted on termination), so downstream per-row energy
    accumulators can be gathered/scattered by index on device. Rows are
    kind-major: all processes, then containers, then VMs, then pods
    (``kind_offsets`` marks the boundaries).
    """

    kinds: np.ndarray  # int8 [W]: 0=process 1=container 2=vm 3=pod
    ids: list[str]  # [W] workload ids (str(pid) for processes)
    cpu_deltas: np.ndarray  # f32 [W] seconds
    node_cpu_delta: float  # Σ process deltas (attribution denominator)
    usage_ratio: float  # node active/total CPU ratio
    # cumulative CPU seconds per row (f64; the process rows back
    # kepler_process_cpu_seconds_total). Optional: wire payloads omit it.
    cpu_totals: np.ndarray | None = None
    # kind-major boundaries: (0, P, P+C, P+C+V, W). Optional convenience;
    # derivable from ``kinds``.
    kind_offsets: tuple[int, int, int, int, int] | None = None

    KIND_PROCESS = 0
    KIND_CONTAINER = 1
    KIND_VM = 2
    KIND_POD = 3
