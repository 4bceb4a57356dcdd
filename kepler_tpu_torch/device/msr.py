"""MSR RAPL power meter — the fallback the reference only proposed.

Implements the reference's `docs/developer/proposal/
EP-002-MSR-Fallback-Power-Meter.md`: when the powercap sysfs tree is
unavailable (disabled kernels, restricted containers) but the MSR device
files are, read the RAPL energy counters straight from the CPU registers:

    UNIT   0x606  IA32_RAPL_POWER_UNIT   (bits 12:8 = energy-status unit:
                                          1 / 2^ESU joules per count)
    PKG    0x611  MSR_PKG_ENERGY_STATUS
    PP0    0x639  MSR_PP0_ENERGY_STATUS  → "core"
    DRAM   0x619  MSR_DRAM_ENERGY_STATUS
    PP1    0x641  MSR_PP1_ENERGY_STATUS  → "uncore"

Counters are 32-bit and wrap at 2^32 counts; values convert to µJ via the
unit register so the monitor's wraparound delta math works unchanged
(``max_energy`` = 2^32 counts in µJ). Multi-socket CPUs read each
package's lowest-numbered CPU's MSR device and aggregate same-named
zones via :class:`AggregatedZone` — identical zone semantics to the
sysfs meter, so everything downstream (primary-zone priority, the jitted
attribution, exporters) is unaware of the backend.

SECURITY: MSR access enables PLATYPUS-class attacks (CVE-2020-8694/95);
the backend is strictly opt-in (``device.msr.enabled``, YAML-only — no
CLI flag, per the proposal) and logs a warning when it activates.
"""

from __future__ import annotations

import logging
import os
import re
import struct
from collections import defaultdict
from typing import Sequence

from kepler_tpu_torch.device.aggregated import AggregatedZone
from kepler_tpu_torch.device.energy import Energy
from kepler_tpu_torch.device.meter import EnergyZone, zone_rank

log = logging.getLogger("kepler.device.msr")

MSR_RAPL_POWER_UNIT = 0x606
_ENERGY_MSRS = (
    # (register, zone name stem) — names match the sysfs meter's so the
    # primary-zone priority and metric labels are backend-independent
    (0x611, "package"),
    (0x639, "core"),
    (0x619, "dram"),
    (0x641, "uncore"),
)
_COUNTER_BITS = 32
_CPU_DIR_RE = re.compile(r"^\d+$")


def read_msr(path: str, register: int) -> int:
    """One 8-byte little-endian read of ``register`` from an MSR device."""
    fd = os.open(path, os.O_RDONLY)
    try:
        raw = os.pread(fd, 8, register)
    finally:
        os.close(fd)
    if len(raw) != 8:
        raise OSError(f"short MSR read from {path}@{register:#x}")
    return struct.unpack("<Q", raw)[0]


def energy_unit_uj(unit_raw: int) -> float:
    """µJ per counter unit from IA32_RAPL_POWER_UNIT bits 12:8."""
    esu = (unit_raw >> 8) & 0x1F
    return 1e6 / (1 << esu)


class MsrZone:
    """One energy MSR on one package (reference proposal §3)."""

    def __init__(self, msr_path: str, register: int, name: str,
                 package: int, unit_uj: float) -> None:
        self._path = msr_path
        self._register = register
        self._name = name
        self._package = package
        self._unit_uj = unit_uj

    def name(self) -> str:
        return self._name

    def index(self) -> int:
        return self._package

    def path(self) -> str:
        return f"{self._path}#{self._register:#x}"

    def energy(self) -> Energy:
        raw = read_msr(self._path, self._register) & ((1 << _COUNTER_BITS)
                                                      - 1)
        return Energy(int(raw * self._unit_uj))

    def max_energy(self) -> Energy:
        return Energy(int((1 << _COUNTER_BITS) * self._unit_uj))


def _package_of_cpu(topology_root: str, cpu: int) -> int:
    path = os.path.join(topology_root, f"cpu{cpu}", "topology",
                        "physical_package_id")
    try:
        with open(path, encoding="ascii") as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return 0  # single-package fallback (also: minimal fake trees)


class MsrPowerMeter:
    """CPUPowerMeter over ``/dev/cpu/*/msr`` (reference proposal EP-002).

    ``device_path``: the MSR device tree (``/dev/cpu``).
    ``topology_path``: sysfs CPU topology root used to find one CPU per
    package (``/sys/devices/system/cpu``); injectable for fake trees.
    """

    def __init__(self, device_path: str = "/dev/cpu",
                 topology_path: str = "/sys/devices/system/cpu",
                 zone_filter: Sequence[str] = ()) -> None:
        self._device_path = device_path
        self._topology_path = topology_path
        self._filter = {z.lower() for z in zone_filter}
        self._zones: list[EnergyZone] = []
        self._primary: EnergyZone | None = None

    def name(self) -> str:
        return "rapl-msr"

    @staticmethod
    def available(device_path: str = "/dev/cpu") -> bool:
        """Any readable MSR device present? (the fallback predicate)"""
        try:
            for entry in os.listdir(device_path):
                if _CPU_DIR_RE.match(entry):
                    msr = os.path.join(device_path, entry, "msr")
                    if os.path.exists(msr) and os.access(msr, os.R_OK):
                        return True
        except OSError:
            pass
        return False

    # -- service lifecycle -------------------------------------------------

    def init(self) -> None:
        log.warning(
            "MSR power meter active: raw MSR reads enable PLATYPUS-class "
            "side channels (CVE-2020-8694/8695) — ensure this node's "
            "threat model allows it (device.msr is opt-in for that reason)")
        self._zones = self._discover()
        if not self._zones:
            raise RuntimeError(
                f"no readable RAPL MSRs under {self._device_path} "
                "(is the msr kernel module loaded and CAP_SYS_RAWIO held?)")
        for z in self._zones:
            z.energy()  # probe readability early
        self._primary = self._select_primary()
        log.info("MSR meter initialized: zones=%s primary=%s",
                 [z.name() for z in self._zones], self._primary.name())

    # -- discovery ---------------------------------------------------------

    def _package_cpus(self) -> dict[int, int]:
        """package id → lowest-numbered CPU with a present MSR device."""
        packages: dict[int, int] = {}
        try:
            entries = sorted((int(e) for e in os.listdir(self._device_path)
                              if _CPU_DIR_RE.match(e)))
        except OSError as err:
            raise RuntimeError(
                f"MSR device tree not found: {self._device_path}") from err
        for cpu in entries:
            if not os.path.exists(os.path.join(self._device_path, str(cpu),
                                               "msr")):
                continue
            pkg = _package_of_cpu(self._topology_path, cpu)
            packages.setdefault(pkg, cpu)
        return packages

    def _discover(self) -> list[EnergyZone]:
        groups: dict[str, list[MsrZone]] = defaultdict(list)
        for pkg, cpu in sorted(self._package_cpus().items()):
            msr_path = os.path.join(self._device_path, str(cpu), "msr")
            try:
                unit_uj = energy_unit_uj(read_msr(msr_path,
                                                  MSR_RAPL_POWER_UNIT))
            except OSError as err:
                log.warning("cannot read power-unit MSR on cpu%d: %s",
                            cpu, err)
                continue
            for register, stem in _ENERGY_MSRS:
                # accept the bare stem OR the exact suffixed spelling for
                # THIS package ("package-0") — matching any "stem-*"
                # would let a 'package-1' filter enable the zone on every
                # socket, diverging from the sysfs meter's
                # canonical_zone_key semantics on multi-socket hosts
                if (self._filter and stem not in self._filter
                        and f"{stem}-{pkg}" not in self._filter):
                    continue
                try:
                    read_msr(msr_path, register)
                except OSError:
                    continue  # register not implemented on this CPU
                groups[stem].append(MsrZone(
                    msr_path, register, f"{stem}-{pkg}", pkg, unit_uj))
        zones: list[EnergyZone] = []
        for stem, members in sorted(groups.items()):
            if len(members) == 1:
                # single socket: drop the -0 suffix like powercap's
                # top-level package naming keeps socket suffixes — keep
                # them for parity with the sysfs meter's aggregation key
                zones.append(members[0])
            else:
                zones.append(AggregatedZone(members))
        return zones

    def _select_primary(self) -> EnergyZone:
        return min(self._zones, key=lambda z: (zone_rank(z.name()), z.name()))

    # -- CPUPowerMeter -----------------------------------------------------

    def zones(self) -> Sequence[EnergyZone]:
        if not self._zones:
            self.init()
        return self._zones

    def primary_energy_zone(self) -> EnergyZone:
        if self._primary is None:
            self.init()
        assert self._primary is not None
        return self._primary
