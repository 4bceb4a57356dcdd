"""Monitor layer: the attribution service, its snapshots and the feature
history (reference ``internal/monitor/``)."""

from kepler_tpu_torch.monitor.history import HistoryBuffer
from kepler_tpu_torch.monitor.monitor import PowerMonitor
from kepler_tpu_torch.monitor.snapshot import (
    NodeUsage,
    Snapshot,
    WorkloadRow,
    WorkloadTable,
)
from kepler_tpu_torch.monitor.terminated import TerminatedTracker
from kepler_tpu_torch.monitor.watchdog import MonitorWatchdog

__all__ = [
    "HistoryBuffer",
    "MonitorWatchdog",
    "NodeUsage",
    "PowerMonitor",
    "Snapshot",
    "TerminatedTracker",
    "WorkloadRow",
    "WorkloadTable",
]
