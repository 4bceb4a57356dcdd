"""Energy-counter delta math with wraparound.

Reference parity: ``internal/monitor/node.go:87-98`` ``calculateEnergyDelta``:
``delta = current - prev``, or ``(max - prev) + current`` when the counter
wrapped (current < prev).

Counters are µJ values up to 2^64; delta math must be exact, so it runs
host-side on numpy uint64/object ints (Z is ~4 — this is scalar work, not the
hot loop). The resulting float32 deltas (< 2^32 µJ per 5 s window) feed the
device kernel.
"""

from __future__ import annotations

import numpy as np


def energy_delta(current: int, prev: int, max_energy: int) -> int:
    """Single-counter delta with wraparound (exact integer math)."""
    if current >= prev:
        return current - prev
    if max_energy <= 0:
        return 0  # cannot disambiguate a wrap without a wrap point
    return (max_energy - prev) + current


def energy_deltas(
    current: np.ndarray, prev: np.ndarray, max_energy: np.ndarray
) -> np.ndarray:
    """Vectorized wraparound delta over aligned uint64 arrays → float64 µJ.

    Used by the fleet aggregator when nodes ship raw counters instead of
    precomputed deltas.
    """
    current = np.asarray(current, dtype=np.uint64)
    prev = np.asarray(prev, dtype=np.uint64)
    max_energy = np.asarray(max_energy, dtype=np.uint64)
    wrapped = current < prev
    normal = (current - prev).astype(np.float64)
    wrap = (max_energy - prev).astype(np.float64) + current.astype(np.float64)
    out = np.where(wrapped, wrap, normal)
    return np.where(wrapped & (max_energy == 0), 0.0, out)
