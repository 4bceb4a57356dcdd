"""AggregatedZone: N same-named zones (multi-socket) as one logical zone.

Reference parity: ``internal/device/energy_zone.go:47-155`` — per-subzone
wraparound handling, combined ``max_energy`` with overflow clamp, and a lock
so concurrent readers see consistent state.

The aggregate counter is the *sum of per-zone deltas* accumulated since the
first read — each subzone's wrap is detected and corrected independently
(a subzone wrapping must not make the aggregate jump backwards).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Sequence

_log = logging.getLogger("kepler.device")

from kepler_tpu_torch.device.energy import Energy
from kepler_tpu_torch.device.meter import EnergyZone

_UINT64_MAX = 2**64 - 1


class AggregatedZone:
    def __init__(self, zones: Sequence[EnergyZone]) -> None:
        if not zones:
            raise ValueError("AggregatedZone requires at least one zone")
        self._zones = list(zones)
        self._name = zones[0].name()
        self._lock = threading.Lock()
        self._last: dict[int, int] = {}  # per-zone previous raw reading
        self._warn_logged = float("-inf")  # stale-read warning throttle
        self._total: int = 0  # accumulated aggregate µJ
        self._path_counts: list[int] | None = None  # per-subzone, cached

    def name(self) -> str:
        return self._name

    def index(self) -> int:
        return -1  # aggregated zones have no single hardware index

    def path(self) -> str:
        return ""

    def max_energy(self) -> Energy:
        total = 0
        for z in self._zones:
            total += int(z.max_energy())
            if total > _UINT64_MAX:  # overflow clamp (energy_zone.go:152)
                return Energy(_UINT64_MAX)
        return Energy(total)

    def energy(self) -> Energy:
        # subzone reads happen INSIDE the lock: an interleaved pair of
        # readers could otherwise regress a subzone counter and fake a
        # wraparound (the documented concurrent-reader guarantee)
        with self._lock:
            return self._combine_locked([int(z.energy())
                                         for z in self._zones])

    def _combine_locked(self, currents: Sequence[int]) -> Energy:
        for i, (z, current) in enumerate(zip(self._zones, currents)):
            if i in self._last:
                prev = self._last[i]
                if current >= prev:
                    delta = current - prev
                elif prev - current > int(z.max_energy()) // 2:
                    # genuine wraparound: counters wrap from near-max to
                    # near-zero, so the regression spans most of the range
                    delta = (int(z.max_energy()) - prev) + current
                else:
                    # small regression = a stale reading (e.g. a batched
                    # raw value sampled before a concurrent energy() call
                    # advanced _last) — counting it as a wrap would inject
                    # ~max_energy of phantom µJ; skip the window instead.
                    # Ambiguity caveat: a GENUINE wrap where the subzone
                    # accumulated more than max_energy/2 between reads
                    # (~430 W sustained on a 2^32 µJ zone at a 5 s
                    # interval) is indistinguishable and also lands here,
                    # undercounting one wrap — hence the (throttled)
                    # warning, so sustained-high-power fleets can detect
                    # the miscount. Concurrent-reader races hit this
                    # branch benignly, so throttle to one line per 30 s.
                    now = time.monotonic()
                    if now - self._warn_logged >= 30.0:
                        self._warn_logged = now
                        _log.warning(
                            "zone %s subzone %d: counter regressed %d µJ "
                            "(< half max_energy %d); treating as stale "
                            "read and dropping the window — if this node "
                            "sustains >max_energy/2 per interval, raise "
                            "the read rate", self._name, i,
                            prev - current, int(z.max_energy()))
                    delta = 0
                    current = prev  # keep the newer reading as the anchor
                self._total += delta
            else:
                # First read seeds the aggregate at the sum of current
                # readings so restarts resume from hardware counters.
                self._total += current
            self._last[i] = current
        # The aggregate itself wraps at combined max_energy so downstream
        # wraparound math (ops.deltas) stays uniform across zone kinds.
        max_e = int(self.max_energy())
        if max_e and self._total >= max_e:
            self._total %= max_e
        return Energy(self._total)

    # -- batched-read support (native fast path) ---------------------------

    def energy_paths(self) -> list[str]:
        """Concatenated subzone counter files (order matches
        :meth:`energy_from_raw`'s expectation). Raises AttributeError when
        a subzone can't be batch-read — callers treat that as 'no fast
        path' and fall back to :meth:`energy`."""
        per_zone = [z.energy_paths() for z in self._zones]
        if self._path_counts is None:
            self._path_counts = [len(p) for p in per_zone]
        return [p for zone_paths in per_zone for p in zone_paths]

    def energy_from_raw(self, values: Sequence[int]) -> Energy:
        """Combine raw batch-read subzone values with the same per-subzone
        wraparound handling as :meth:`energy`.

        The values were read OUTSIDE the lock (one native call covering
        every zone) — safe because batched reads come only from the
        monitor's single refresh task (singleflight); the lock still
        serialises against any concurrent :meth:`energy` caller."""
        if self._path_counts is None:
            self.energy_paths()  # populate the per-subzone counts once
        currents = []
        offset = 0
        for z, n in zip(self._zones, self._path_counts):
            currents.append(int(z.energy_from_raw(values[offset:offset + n])))
            offset += n
        with self._lock:
            return self._combine_locked(currents)
