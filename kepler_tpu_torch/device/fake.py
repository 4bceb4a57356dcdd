"""Fake CPU power meter for dev/test.

Reference parity: ``internal/device/fake_cpu_power_meter.go`` — synthetic
monotonic zones whose counters advance by a random increment per read and
wrap at 1 MJ; enabled via ``dev.fake-cpu-meter`` config (never a CLI flag).

Determinism: pass a seeded ``random.Random`` for reproducible tests; the
increment scales with elapsed wall time so derived power is plausible.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Sequence

from kepler_tpu_torch.device.energy import JOULE, Energy
from kepler_tpu_torch.device.meter import EnergyZone, zone_rank

FAKE_MAX_ENERGY = 1_000_000 * JOULE  # 1 MJ wrap point (reference :30)
DEFAULT_FAKE_ZONES = ("package", "core", "dram", "uncore")


class FakeEnergyZone:
    """Monotonic synthetic counter (reference fakeEnergyZone, :52-60)."""

    def __init__(self, name: str, index: int = 0,
                 rng: random.Random | None = None,
                 watts_range: tuple[float, float] = (5.0, 50.0)) -> None:
        self._name = name
        self._index = index
        self._rng = rng or random.Random()
        self._watts_range = watts_range
        self._counter = self._rng.randrange(0, FAKE_MAX_ENERGY)
        self._last_read = time.monotonic()
        self._lock = threading.Lock()

    def name(self) -> str:
        return self._name

    def index(self) -> int:
        return self._index

    def path(self) -> str:
        return f"fake://{self._name}"

    def max_energy(self) -> Energy:
        return Energy(FAKE_MAX_ENERGY)

    def energy(self) -> Energy:
        with self._lock:
            now = time.monotonic()
            dt = max(now - self._last_read, 1e-3)
            self._last_read = now
            watts = self._rng.uniform(*self._watts_range)
            self._counter = int(
                (self._counter + watts * dt * JOULE) % FAKE_MAX_ENERGY
            )
            return Energy(self._counter)


class FakeCPUMeter:
    def __init__(self, zones: Sequence[str] = (), seed: int | None = None):
        names = list(zones) or list(DEFAULT_FAKE_ZONES)
        rng = random.Random(seed)
        self._zones: list[EnergyZone] = [
            FakeEnergyZone(n, i, random.Random(rng.random()))
            for i, n in enumerate(names)
        ]

    def name(self) -> str:
        return "fake-cpu-meter"

    def init(self) -> None:
        pass

    def zones(self) -> Sequence[EnergyZone]:
        return self._zones

    def primary_energy_zone(self) -> EnergyZone:
        return min(self._zones, key=lambda z: (zone_rank(z.name()), z.name()))
