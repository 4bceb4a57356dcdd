"""Energy and Power unit types.

Reference parity: ``internal/device/energy.go:14,41`` — ``Energy`` is a uint64
microjoule counter, ``Power`` a float64 microwatt value, with display helpers.

These wrappers are *host-side* bookkeeping types. On the device,
energy deltas travel as float32 arrays in microjoules (a 5 s RAPL delta is
< 2^30 µJ, so f32 keeps ~1e-7 relative error) while cumulative accumulators
stay in numpy int64/float64 on the host.
"""

from __future__ import annotations

# Unit constants, µJ-denominated (reference energy.go:16-20).
MICRO_JOULE = 1
MILLI_JOULE = 1_000 * MICRO_JOULE
JOULE = 1_000 * MILLI_JOULE
KILO_JOULE = 1_000 * JOULE

# µW-denominated (reference energy.go:43-47).
MICRO_WATT = 1.0
MILLI_WATT = 1_000 * MICRO_WATT
WATT = 1_000 * MILLI_WATT
KILO_WATT = 1_000 * WATT


class Energy(int):
    """A cumulative energy counter in microjoules.

    Subclasses ``int`` so arithmetic/wraparound math stays exact (the
    reference uses uint64; Python ints are unbounded, wraparound is handled
    explicitly where counters wrap — see ``kepler_tpu_torch.ops.deltas``).
    """

    __slots__ = ()

    @property
    def micro_joules(self) -> int:
        return int(self)

    @property
    def joules(self) -> float:
        return int(self) / JOULE

    def __str__(self) -> str:  # reference energy.go String(): "1.23J"
        return f"{self.joules:.2f}J"


class Power(float):
    """Instantaneous power in microwatts (reference energy.go:41)."""

    __slots__ = ()

    @property
    def micro_watts(self) -> float:
        return float(self)

    @property
    def watts(self) -> float:
        return float(self) / WATT

    def __str__(self) -> str:
        return f"{self.watts:.2f}W"
