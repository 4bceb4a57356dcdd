"""Intel RAPL sysfs power meter.

Reference parity: ``internal/device/rapl_sysfs_power_meter.go`` — dynamic zone
discovery under ``<sysfs>/class/powercap``, optional zone-name filtering
(``rapl.zones`` config), dedup of zones exposing the same name+path shape,
multi-socket aggregation of same-named zones via ``AggregatedZone``, and
primary-zone selection by priority (psys > package > core > dram > uncore).

Layout read (standard Linux powercap):
    /sys/class/powercap/intel-rapl:0/name                → "package-0"
    /sys/class/powercap/intel-rapl:0/energy_uj           → cumulative µJ
    /sys/class/powercap/intel-rapl:0/max_energy_range_uj → wrap point
    /sys/class/powercap/intel-rapl:0:0/...               → subzones (core/dram)
"""

from __future__ import annotations

import logging
import os
import re
from collections import defaultdict
from typing import Sequence

from kepler_tpu_torch.device.aggregated import AggregatedZone
from kepler_tpu_torch.device.energy import Energy
from kepler_tpu_torch.device.meter import EnergyZone, zone_rank

log = logging.getLogger("kepler.device.rapl")

_ZONE_DIR_RE = re.compile(r"^intel-rapl(:\d+)+$")

# sentinel the native batch reader writes for unreadable counter files
_READ_FAILED = 2**64 - 1


class SysfsRaplZone:
    """A single powercap zone directory (reference sysfsRaplZone, :259-287)."""

    def __init__(self, path: str) -> None:
        self._path = path
        with open(os.path.join(path, "name"), encoding="ascii") as f:
            self._name = f.read().strip()
        # index = last numeric component of the dir name (intel-rapl:0:1 → 1)
        base = os.path.basename(path)
        self._index = int(base.rsplit(":", 1)[-1])
        self._max_energy = self._read_int("max_energy_range_uj")

    def _read_int(self, filename: str) -> int:
        with open(os.path.join(self._path, filename), encoding="ascii") as f:
            return int(f.read().strip())

    def name(self) -> str:
        return self._name

    def index(self) -> int:
        return self._index

    def path(self) -> str:
        return self._path

    def energy(self) -> Energy:
        return Energy(self._read_int("energy_uj"))

    def max_energy(self) -> Energy:
        return Energy(self._max_energy)

    # -- batched-read support (native fast path) ---------------------------

    def energy_paths(self) -> list[str]:
        """Counter files backing this zone — lets the monitor batch ALL
        zones' reads into one native call (native.read_counters)."""
        return [os.path.join(self._path, "energy_uj")]

    def energy_from_raw(self, values: Sequence[int]) -> Energy:
        """Interpret raw values batch-read from :meth:`energy_paths`."""
        (v,) = values
        if v == _READ_FAILED:
            raise OSError(f"batched read of {self._path}/energy_uj failed")
        return Energy(int(v))


def canonical_zone_key(name: str) -> str:
    """Normalize multi-socket names: package-0/package-1 → package.

    Grouping key for aggregation (reference groupZonesByName, :157).
    """
    lowered = name.lower()
    return re.sub(r"-\d+$", "", lowered)


class RaplPowerMeter:
    """Reads energy from Intel RAPL via sysfs (reference raplPowerMeter)."""

    def __init__(self, sysfs_path: str = "/sys",
                 zone_filter: Sequence[str] = ()) -> None:
        self._powercap = os.path.join(sysfs_path, "class", "powercap")
        self._filter = {z.lower() for z in zone_filter}
        self._zones: list[EnergyZone] = []
        self._primary: EnergyZone | None = None

    def name(self) -> str:
        return "rapl"

    # -- service lifecycle ------------------------------------------------

    def init(self) -> None:
        """Probe zones and take a first reading (reference Init, :76)."""
        self._zones = self._discover()
        if not self._zones:
            raise RuntimeError(
                f"no RAPL zones found under {self._powercap} "
                "(is intel-rapl available? try dev.fake-cpu-meter for dev)"
            )
        for z in self._zones:
            z.energy()  # probe readability early
        self._primary = self._select_primary()
        log.info("RAPL meter initialized: zones=%s primary=%s",
                 [z.name() for z in self._zones], self._primary.name())

    # -- discovery --------------------------------------------------------

    def _discover(self) -> list[EnergyZone]:
        if not os.path.isdir(self._powercap):
            raise RuntimeError(f"powercap sysfs not found: {self._powercap}")
        raw: list[SysfsRaplZone] = []
        seen_paths: set[str] = set()
        for entry in sorted(os.listdir(self._powercap)):
            if not _ZONE_DIR_RE.match(entry):
                continue
            path = os.path.realpath(os.path.join(self._powercap, entry))
            if path in seen_paths:  # dedup non-standard symlinked paths
                continue
            seen_paths.add(path)
            try:
                raw.append(SysfsRaplZone(path))
            except (OSError, ValueError) as err:
                log.warning("skipping unreadable zone %s: %s", entry, err)
        if self._filter:
            raw = [z for z in raw
                   if canonical_zone_key(z.name()) in self._filter
                   or z.name().lower() in self._filter]
        # multi-socket aggregation: same canonical name → one logical zone
        groups: dict[str, list[SysfsRaplZone]] = defaultdict(list)
        for z in raw:
            groups[canonical_zone_key(z.name())].append(z)
        zones: list[EnergyZone] = []
        for _, members in sorted(groups.items()):
            if len(members) == 1:
                zones.append(members[0])
            else:
                zones.append(AggregatedZone(members))
        return zones

    def _select_primary(self) -> EnergyZone:
        return min(self._zones, key=lambda z: (zone_rank(z.name()), z.name()))

    # -- CPUPowerMeter ----------------------------------------------------

    def zones(self) -> Sequence[EnergyZone]:
        if not self._zones:
            self.init()
        return self._zones

    def primary_energy_zone(self) -> EnergyZone:
        if self._primary is None:
            self.init()
        assert self._primary is not None
        return self._primary
