"""Hardware-meter abstractions.

Reference parity: ``internal/device/cpu_power_meter.go:10-40`` — a power meter
exposes named ``EnergyZone``s with monotonically-increasing, wrapping µJ
counters, and designates one "primary" zone used for terminated-workload
ranking (priority psys > package > core > dram > uncore,
``rapl_sysfs_power_meter.go:197-231``).
"""

from __future__ import annotations

from typing import Protocol, Sequence, runtime_checkable

from kepler_tpu_torch.device.energy import Energy


@runtime_checkable
class EnergyZone(Protocol):
    """One measurable energy domain (e.g. RAPL package/core/dram)."""

    def name(self) -> str: ...
    def index(self) -> int: ...
    def path(self) -> str: ...
    def energy(self) -> Energy:
        """Current cumulative counter in µJ; wraps at ``max_energy()``."""
        ...
    def max_energy(self) -> Energy:
        """Wraparound point of the counter (``max_energy_range_uj``)."""
        ...


@runtime_checkable
class CPUPowerMeter(Protocol):
    def name(self) -> str: ...
    def zones(self) -> Sequence[EnergyZone]: ...
    def primary_energy_zone(self) -> EnergyZone:
        """Highest-priority zone representing overall package energy."""
        ...


# Zone-name priority for primary-zone selection (reference
# rapl_sysfs_power_meter.go:197-231). Lower rank = higher priority.
ZONE_PRIORITY = ("psys", "package", "core", "dram", "uncore")


def zone_rank(zone_name: str) -> int:
    """Rank of a zone name for primary selection; unknown names rank last.

    Package zones appear as "package-0"/"package-1" in sysfs — match by
    prefix, case-insensitive.
    """
    lowered = zone_name.lower()
    for i, prio in enumerate(ZONE_PRIORITY):
        if lowered == prio or lowered.startswith(prio + "-"):
            return i
    return len(ZONE_PRIORITY)
