"""Metrics-level bitmask.

Reference parity: ``config/level.go:12-24`` — a bitmask selecting which metric
families are exported (node / process / container / vm / pod), with parsing of
cumulative ``--metrics`` flag values and "all" shorthand.
"""

from __future__ import annotations

import enum
from typing import Iterable


class Level(enum.IntFlag):
    """Which workload granularities to export metrics for."""

    NODE = 1 << 0
    PROCESS = 1 << 1
    CONTAINER = 1 << 2
    VM = 1 << 3
    POD = 1 << 4

    @classmethod
    def all(cls) -> "Level":
        return cls.NODE | cls.PROCESS | cls.CONTAINER | cls.VM | cls.POD

    def __str__(self) -> str:
        if self == Level.all():
            return "all"
        names = [m.name.lower() for m in Level if m in self and m.name]
        return "|".join(names) if names else "none"


_NAME_TO_LEVEL = {
    "node": Level.NODE,
    "process": Level.PROCESS,
    "container": Level.CONTAINER,
    "vm": Level.VM,
    "pod": Level.POD,
    "all": Level.all(),
}


def parse_level(values: Iterable[str]) -> Level:
    """Parse a list of level names into a combined bitmask.

    Accepts case-insensitive names; raises ``ValueError`` on unknown names
    (reference ``config/level.go`` ParseLevel).
    """
    combined = Level(0)
    for v in values:
        key = v.strip().lower()
        if key not in _NAME_TO_LEVEL:
            raise ValueError(
                f"invalid metrics level {v!r}; valid: "
                f"{', '.join(_NAME_TO_LEVEL)}"
            )
        combined |= _NAME_TO_LEVEL[key]
    return combined
