"""Hybrid Logical Clock for the fleet black box (causal event order).

A fleet incident — lease succession, membership epoch bump, rung
demotion cascade — spans processes whose wall clocks disagree. An HLC
stamp ``(phys_us, logical, node)`` gives every journal event a total
order that (a) never runs backwards on one node, (b) respects causality
across nodes whenever a message carries the sender's stamp, and (c)
stays within bounded skew of real time, so a merged fleet timeline reads
like a wall-clock trace with ties broken deterministically.

Threat model (KTL112 taint discipline, same as ring epochs): the stamp
rides the wire, so a hostile or broken peer can present an arbitrary
clock. :func:`parse_hlc` launders the wire text (bounded digits, bounded
printable node id, bools rejected) and :meth:`HlcClock.observe` clamps a
remote physical component more than ``max_drift_s`` ahead of the local
wall clock — the merge still advances causally past the clamped value,
but a single vaulted stamp can never drag the whole fleet's clocks years
into the future. Clamp events and the last observed offset are exported
(``kepler_fleet_hlc_clamped_total`` / ``kepler_fleet_hlc_drift_seconds``
via the journal collector).

Determinism: all wall reads go through the injected ``clock`` seam, so
kepchaos runs the HLC on the conductor's virtual clock and the merged
journal is bit-replayable.
"""

from __future__ import annotations

import re
import threading
import time
from typing import Callable, NamedTuple

__all__ = ["HLC", "HlcClock", "MAX_NODE_LEN", "parse_hlc"]

# wire-field bounds (laundering caps, not protocol limits)
MAX_NODE_LEN = 128          # matches the wire name cap's order of magnitude
_MAX_PHYS_DIGITS = 17       # < 2**56 µs ≈ year 4254; rejects vault-to-inf
_MAX_LOGICAL = 1 << 20      # ties within one µs; a hostile 2**63 is clamped
DEFAULT_MAX_DRIFT_S = 60.0

_PHYS_RE = re.compile(r"^[0-9]{1,%d}$" % _MAX_PHYS_DIGITS)
_LOGICAL_RE = re.compile(r"^[0-9]{1,9}$")


class HLC(NamedTuple):
    """One stamp. NamedTuple ordering IS the causal total order:
    ``(phys_us, logical, node)`` lexicographic."""

    phys_us: int
    logical: int
    node: str

    def encode(self) -> str:
        """Wire text ``phys_us:logical:node`` (node may itself contain
        colons — parse splits from the left)."""
        return f"{self.phys_us}:{self.logical}:{self.node}"

    def to_dict(self) -> dict[str, object]:
        return {"phys_us": self.phys_us, "logical": self.logical,
                "node": self.node}


def _sane_node(node: str) -> bool:
    if len(node) > MAX_NODE_LEN:
        return False
    return all(" " < ch <= "~" for ch in node)


def parse_hlc(text: object) -> HLC | None:
    """Launder a wire-borne HLC stamp; hostile input → ``None``, never an
    exception and never a poisoned value.

    Rejected: non-strings (incl. bools/ints), wrong field count,
    signed/float/overlong numerics, logical above the tie cap, node ids
    that are overlong or non-printable.
    """
    # keplint: sanitizes
    if not isinstance(text, str):
        return None
    parts = text.split(":", 2)
    if len(parts) != 3:
        return None
    phys_s, logical_s, node = parts
    if not _PHYS_RE.match(phys_s) or not _LOGICAL_RE.match(logical_s):
        return None
    logical = int(logical_s)
    if logical > _MAX_LOGICAL:
        return None
    if not _sane_node(node):
        return None
    return HLC(int(phys_s), logical, node)


class HlcClock:
    """The per-process clock: ``now()`` to stamp a local event or an
    outgoing message, ``observe()`` to merge an inbound stamp."""

    __slots__ = ("_clock", "_last_drift_s", "_clamped", "_lock",
                 "_logical", "_max_drift_s", "_node", "_phys_us")

    def __init__(self, node: str = "", *,
                 clock: Callable[[], float] = time.time,
                 max_drift_s: float = DEFAULT_MAX_DRIFT_S) -> None:
        self._node = node
        self._clock = clock
        self._max_drift_s = float(max_drift_s)
        self._lock = threading.Lock()
        self._phys_us = 0
        self._logical = 0
        self._last_drift_s = 0.0
        self._clamped = 0

    @property
    def node(self) -> str:
        return self._node

    def now(self) -> HLC:
        """Advance for a local/send event."""
        with self._lock:
            wall_us = int(self._clock() * 1e6)
            if wall_us > self._phys_us:
                self._phys_us = wall_us
                self._logical = 0
            else:
                self._logical += 1
            return HLC(self._phys_us, self._logical, self._node)

    def observe(self, remote: HLC) -> HLC:
        """Merge an inbound stamp (receive event). A remote physical
        component more than ``max_drift_s`` ahead of the local wall
        clock is clamped to the drift bound before merging, so a
        vaulted peer advances us at most one drift window."""
        with self._lock:
            wall_us = int(self._clock() * 1e6)
            limit_us = wall_us + int(self._max_drift_s * 1e6)
            self._last_drift_s = (remote.phys_us - wall_us) / 1e6
            r_phys, r_logical = remote.phys_us, remote.logical
            if r_phys > limit_us:
                self._clamped += 1
                r_phys, r_logical = limit_us, 0
            prev_phys, prev_logical = self._phys_us, self._logical
            phys = max(prev_phys, r_phys, wall_us)
            if phys == prev_phys and phys == r_phys:
                logical = max(prev_logical, r_logical) + 1
            elif phys == prev_phys:
                logical = prev_logical + 1
            elif phys == r_phys:
                logical = r_logical + 1
            else:
                logical = 0
            self._phys_us, self._logical = phys, logical
            return HLC(phys, logical, self._node)

    def drift_seconds(self) -> float:
        """Signed offset (remote − local wall) of the last observed
        stamp; the ``kepler_fleet_hlc_drift_seconds`` gauge."""
        with self._lock:
            return self._last_drift_s

    def clamped_total(self) -> int:
        with self._lock:
            return self._clamped
