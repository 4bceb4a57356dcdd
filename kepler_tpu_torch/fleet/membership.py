"""Elastic fleet membership: coordinator lease, succession, autoscale.

ROADMAP item 1 makes the fleet's scaling axes elastic: replicas join
and leave the ingest ring at runtime, a host death at ANY mesh size is
healed by exactly one survivor, and replica count follows load instead
of an operator constant. This module holds the pure decision layer —
no sockets, no locks, no clocks — so every rule here is deterministic
and property-testable; ``fleet.aggregator`` wires the decisions to the
ring, the engines, and the ``/v1/membership`` plane.

Three pieces:

* **Succession** (:func:`elect_successor`, :func:`plan_succession`):
  who is entitled to issue the next membership. The rule is a pure
  function of the survivor set — the incumbent lease holder while it
  survives, else the LOWEST surviving peer in sorted order — so every
  survivor computes the same issuer with no coordination protocol,
  and exactly one of them bumps the epoch (no split-brain by
  construction; the epoch monotonicity check at apply catches any
  disagreement a partitioned prober could still produce).
* **:class:`CoordinatorLease`**: the (holder, epoch) pair a replica
  believes in. ``adopt`` enforces epoch monotonicity and rejects an
  equal-epoch holder conflict — a rejoining peer adopts the incumbent
  from the join reply and therefore never self-elects over a live
  lease, even when it sorts lowest.
* **:class:`AutoscalePolicy`**: replica-count recommendations from
  signals the fleet already records (admission load ratio, shed
  deltas, ingest-latency EWMA, scoreboard states). A pure hysteresis
  machine over the observation SEQUENCE — seedable and replayable: the
  same signal trace always yields the same decisions.

Wire laundering: join/leave/apply payloads arrive over HTTP from peers
that are untrusted until proven otherwise. Every field passes the ring
sanitizers (:func:`~kepler_tpu_torch.fleet.ring.sanitize_peer`,
:func:`~kepler_tpu_torch.fleet.ring.coerce_epoch`) or the lease-id one here
(:func:`sanitize_lease_id`) before it can steer membership, become a
log field, or key a metric — the KTL112 contract the ring established
for redirect owners, applied to the lease-registration fields.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping, Sequence

from kepler_tpu_torch.fleet.ring import (
    MAX_PEER_NAME,
    coerce_epoch,
    sanitize_peer,
)
from kepler_tpu_torch.telemetry.hlc import parse_hlc

__all__ = [
    "AutoscaleDecision",
    "AutoscalePolicy",
    "AutoscaleSignals",
    "CoordinatorLease",
    "MembershipDecision",
    "MembershipError",
    "elect_successor",
    "lease_id_of",
    "plan_membership_apply",
    "plan_succession",
    "sanitize_lease_id",
    "validate_membership_payload",
]

# "epoch:holder" — epoch digits + separator + a peer name
MAX_LEASE_ID = MAX_PEER_NAME + 24

#: the membership operations /v1/membership accepts (a bounded set so a
#: hostile op string can never mint a metric label or log vocabulary)
MEMBERSHIP_OPS = ("apply", "join", "leave")


class MembershipError(ValueError):
    """Structured membership rejection. ``reason`` is drawn from a
    bounded vocabulary and keys the
    ``kepler_fleet_membership_rejected_total{reason}`` counter label;
    the message carries the operator-facing detail."""

    def __init__(self, reason: str, detail: str) -> None:
        super().__init__(detail)
        self.reason = reason


# -- lease identity ---------------------------------------------------------

def lease_id_of(holder: str, epoch: int) -> str:
    """The canonical lease id for a (holder, epoch) pair."""
    return f"{epoch}:{holder}"


# keplint: sanitizes — the chokepoint that launders a wire-derived
# lease id ("epoch:holder"): bounded length, a non-negative int epoch,
# and a holder that passes the ring's peer sanitizer — or nothing
def sanitize_lease_id(value: object) -> str | None:
    """``value`` as a canonical lease id, or None when it is not one."""
    if not isinstance(value, str) or not value:
        return None
    if len(value) > MAX_LEASE_ID:
        return None
    epoch_s, sep, holder = value.partition(":")
    if not sep or not epoch_s.isdigit():
        return None
    holder = sanitize_peer(holder)
    if holder is None:
        return None
    return lease_id_of(holder, int(epoch_s))


# -- succession -------------------------------------------------------------

def elect_successor(survivors: Iterable[str]) -> str:
    """The successor among ``survivors``: the lowest peer in sorted
    order. Deterministic and total — any two replicas that agree on
    the survivor set agree on the successor."""
    peers = sorted(set(survivors))
    if not peers:
        raise MembershipError("no_survivors",
                              "cannot elect a successor from an empty "
                              "survivor set")
    return peers[0]


def plan_succession(holder: str, survivors: Iterable[str]) -> str:
    """The ONE peer entitled to issue the next membership over
    ``survivors``: the incumbent lease ``holder`` while it survives
    (a non-holder death never re-elects), else the elected successor.
    Every survivor evaluates this identically, so on any host death
    exactly one of them bumps the epoch."""
    alive = set(survivors)
    if holder in alive:
        return holder
    return elect_successor(alive)


class CoordinatorLease:
    """The coordinator lease one replica believes in: who may issue
    membership, and at which epoch that belief was established.

    The lease is NOT an extra consensus protocol — it is derived state,
    advanced in lock-step with the ring epoch by ``apply_membership``.
    ``adopt`` enforces the two invariants that make succession safe:
    the epoch never moves backwards, and two writers at the SAME epoch
    naming different holders are a conflict, never a silent overwrite.
    A rejoining peer adopts the incumbent holder from the join reply —
    it never self-elects over a live lease, even when it sorts lowest
    (succession only runs when the holder is among the dead)."""

    __slots__ = ("_holder", "_epoch")

    # keplint: protocol-transition — birth of a lease belief
    def __init__(self, holder: str, epoch: int = 1) -> None:
        cleaned = sanitize_peer(holder)
        if cleaned is None:
            raise MembershipError("bad_peer",
                                  f"invalid lease holder {holder!r}")
        ep = coerce_epoch(epoch)
        if ep is None or ep < 1:
            raise MembershipError("bad_epoch",
                                  f"lease epoch must be an int >= 1, "
                                  f"got {epoch!r}")
        self._holder = cleaned
        self._epoch = ep

    @property
    def holder(self) -> str:
        return self._holder

    @property
    def epoch(self) -> int:
        return self._epoch

    @property
    def lease_id(self) -> str:
        return lease_id_of(self._holder, self._epoch)

    def issuer_for(self, survivors: Iterable[str]) -> str:
        """Who issues the next membership over ``survivors``."""
        return plan_succession(self._holder, survivors)

    # keplint: protocol-transition — the ONLY way a lease belief moves
    def adopt(self, holder: str, epoch: int) -> None:
        """Advance the lease to ``(holder, epoch)``. Monotonic: a stale
        epoch is rejected, and an equal-epoch HOLDER conflict (two
        writers won the same epoch) is rejected loudly rather than
        letting the later writer silently win."""
        cleaned = sanitize_peer(holder)
        if cleaned is None:
            raise MembershipError("bad_peer",
                                  f"invalid lease holder {holder!r}")
        ep = coerce_epoch(epoch)
        if ep is None:
            raise MembershipError("bad_epoch",
                                  f"invalid lease epoch {epoch!r}")
        if ep < self._epoch:
            raise MembershipError(
                "stale_epoch",
                f"lease epoch {ep} is behind the adopted epoch "
                f"{self._epoch}")
        if ep == self._epoch and cleaned != self._holder:
            raise MembershipError(
                "equal_epoch_conflict",
                f"lease at epoch {ep} already names holder "
                f"{self._holder!r}; a second writer named {cleaned!r}")
        self._holder = cleaned
        self._epoch = ep

    def describe(self) -> dict:
        return {"holder": self._holder, "epoch": self._epoch,
                "lease_id": self.lease_id}


# -- membership apply -------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MembershipDecision:
    """The pure verdict on one membership proposal against the current
    ring: apply it (at ``epoch`` over ``peers``, possibly retiring this
    replica) or treat it as an idempotent replay. Rejections are raised,
    never returned — a decision object always means "safe to act"."""

    action: str  # "apply" | "replay"
    epoch: int
    peers: tuple[str, ...]
    retired: bool = False


def plan_membership_apply(current_epoch: int,
                          current_peers: Sequence[str],
                          current_digest: str,
                          epoch: object, peers: Iterable[object],
                          self_peer: str,
                          source: str) -> MembershipDecision:
    """Decide one membership proposal. Pure: the whole epoch/peer-set
    state machine — epoch coercion, peer laundering + order-preserving
    dedupe, the stale/replay/equal-epoch-conflict ladder, and the
    retirement-vs-typo rule for a set that excludes ``self_peer`` —
    with no ring, lock, or counter in sight, so kepmc can walk every
    proposal order a fleet of replicas could produce.

    Raises :class:`MembershipError` (``bad_epoch`` / ``bad_peer`` /
    ``stale_epoch`` / ``equal_epoch_conflict`` / ``self_excluded``) on
    any proposal that must not touch the ring."""
    ep = coerce_epoch(epoch)
    if ep is None or ep < 1:
        raise MembershipError(
            "bad_epoch",
            f"membership epoch must be a positive int, got {epoch!r}")
    cleaned: list[str] = []
    for raw in peers:
        peer = sanitize_peer(raw)
        if peer is None:
            raise MembershipError(
                "bad_peer", f"invalid membership peer {raw!r}")
        if peer not in cleaned:
            cleaned.append(peer)
    if not cleaned:
        raise MembershipError("bad_peer",
                              "membership needs at least one peer")
    if ep < current_epoch:
        raise MembershipError(
            "stale_epoch",
            f"membership epoch {ep} is behind the current epoch "
            f"{current_epoch}")
    if ep == current_epoch:
        if set(cleaned) == set(current_peers):
            # idempotent replay: a re-delivered broadcast, or an
            # operator re-running the change they already made
            return MembershipDecision(action="replay", epoch=ep,
                                      peers=tuple(cleaned))
        raise MembershipError(
            "equal_epoch_conflict",
            f"membership at epoch {ep} already applied with a "
            f"DIFFERENT peer set (digest {current_digest}); a second "
            f"writer proposed {sorted(set(cleaned))!r}")
    retired = self_peer not in cleaned
    if retired and source == "operator":
        raise MembershipError(
            "self_excluded",
            f"self peer {self_peer!r} is not in the new membership "
            f"{sorted(cleaned)!r}")
    return MembershipDecision(action="apply", epoch=ep,
                              peers=tuple(cleaned), retired=retired)


# -- membership wire payloads ----------------------------------------------

# keplint: sanitizes — the /v1/membership chokepoint: every field of a
# join/leave/apply payload (op, peers, epoch, issuer/holder, lease id)
# is wire input and is laundered here before the aggregator lets it
# steer the ring, reach a log line, or key a metric label
def validate_membership_payload(payload: object) -> dict:
    """Launder one ``/v1/membership`` payload (or join reply) into a
    normalized dict. Raises :class:`MembershipError` with a bounded
    ``reason`` (``bad_payload`` / ``bad_op`` / ``bad_peer`` /
    ``bad_epoch`` / ``bad_lease``) on the first malformed field."""
    if not isinstance(payload, Mapping):
        raise MembershipError("bad_payload",
                              "membership payload must be a JSON object")
    out: dict = {}
    op = payload.get("op")
    if op is not None:
        if op not in MEMBERSHIP_OPS:
            raise MembershipError(
                "bad_op", f"membership op must be one of "
                f"{list(MEMBERSHIP_OPS)}")
        out["op"] = op
    peers = payload.get("peers")
    if peers is not None:
        if not isinstance(peers, Sequence) or isinstance(peers, (str,
                                                                 bytes)):
            raise MembershipError("bad_peer",
                                  "membership peers must be a list")
        cleaned = []
        for raw in peers:
            peer = sanitize_peer(raw)
            if peer is None:
                raise MembershipError(
                    "bad_peer", f"invalid membership peer {raw!r}")
            cleaned.append(peer)
        out["peers"] = cleaned
    for field in ("peer", "issuer", "holder"):
        raw = payload.get(field)
        if raw is None:
            continue
        peer = sanitize_peer(raw)
        if peer is None:
            raise MembershipError("bad_peer",
                                  f"invalid membership {field} {raw!r}")
        out[field] = peer
    raw_epoch = payload.get("epoch")
    if raw_epoch is not None:
        epoch = coerce_epoch(raw_epoch)
        if epoch is None:
            raise MembershipError(
                "bad_epoch",
                f"membership epoch must be a non-negative int, got "
                f"{raw_epoch!r}")
        out["epoch"] = epoch
    raw_lease = payload.get("lease")
    if raw_lease is not None:
        lease = sanitize_lease_id(raw_lease)
        if lease is None:
            raise MembershipError("bad_lease",
                                  f"invalid lease id {raw_lease!r}")
        out["lease"] = lease
    raw_hlc = payload.get("hlc")
    if raw_hlc is not None:
        # the black-box HLC piggyback: laundered to a parsed stamp (the
        # observer's drift clamp bounds it further); a malformed stamp
        # rejects the payload like every other hostile field
        hlc = parse_hlc(raw_hlc)
        if hlc is None:
            raise MembershipError(
                "bad_payload",
                f"invalid membership hlc stamp {raw_hlc!r:.64}")
        out["hlc"] = hlc
    # a bool flag, clamped (any other JSON type reads as absent/false —
    # it steers only whether a mesh restore is ATTEMPTED, which is
    # further gated on local topology state)
    out["mesh"] = payload.get("mesh") is True
    return out


# -- autoscale --------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AutoscaleSignals:
    """One window's recorded inputs to the autoscale policy — all of
    them signals the fleet already measures (admission controller,
    scoreboard, ring), so a decision trace is replayable from metrics
    alone."""

    #: admission load ratio (max of inflight/latency pressure; 1.0 = at
    #: budget, >= 1.0 sheds) — 0.0 with admission off
    load: float = 0.0
    #: reports shed since the previous observation
    shed_delta: int = 0
    #: admission ingest-latency EWMA (seconds)
    ingest_latency_s: float = 0.0
    #: nodes in the live report store this window
    live_nodes: int = 0
    #: scoreboard rows out of the healthy state
    flagged_nodes: int = 0
    #: current ring membership size
    replicas: int = 1


@dataclasses.dataclass(frozen=True)
class AutoscaleDecision:
    """One observation's outcome: the recommended replica count, which
    way it moved, and the operator-facing reason."""

    replicas: int
    direction: str  # "up" | "down" | "hold"
    reason: str
    streak: int = 0


class AutoscalePolicy:
    """Hysteresis replica-count policy over recorded fleet signals.

    Pure in the sense that matters for replay: ``observe`` is a
    deterministic function of the constructor parameters and the
    SEQUENCE of :class:`AutoscaleSignals` fed so far — no wall clock,
    no RNG, no hidden I/O. Feeding the same recorded trace to a fresh
    policy reproduces the same decisions, which is what the tests pin.

    Hysteresis is asymmetric by default: scaling up needs
    ``up_windows`` CONSECUTIVE overloaded observations (load at or
    past ``scale_up_load``, or any shedding), scaling down needs
    ``down_windows`` consecutive idle ones (load at or under
    ``scale_down_load`` and no shedding) — so flapping load never
    thrashes the mesh, and a recommendation is always one step at a
    time. A streak resets after it fires: the next step needs fresh
    evidence at the new size."""

    def __init__(self, scale_up_load: float = 1.0,
                 scale_down_load: float = 0.25,
                 up_windows: int = 3, down_windows: int = 12,
                 min_replicas: int = 1,
                 max_replicas: int = 0) -> None:
        if scale_up_load <= 0:
            raise ValueError("scale_up_load must be > 0")
        if not 0 <= scale_down_load < scale_up_load:
            raise ValueError(
                "scale_down_load must be >= 0 and below scale_up_load")
        if up_windows < 1 or down_windows < 1:
            raise ValueError("hysteresis windows must be >= 1")
        if min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if max_replicas < 0:
            raise ValueError("max_replicas must be >= 0 (0 = unbounded)")
        self._up_load = float(scale_up_load)
        self._down_load = float(scale_down_load)
        self._up_windows = int(up_windows)
        self._down_windows = int(down_windows)
        self._min = int(min_replicas)
        self._max = int(max_replicas)
        self._up_streak = 0
        self._down_streak = 0

    def observe(self, sig: AutoscaleSignals) -> AutoscaleDecision:
        """Fold one window's signals into the streaks and answer the
        current recommendation."""
        overloaded = sig.load >= self._up_load or sig.shed_delta > 0
        idle = (sig.load <= self._down_load and sig.shed_delta == 0
                and sig.flagged_nodes == 0)
        if overloaded:
            self._up_streak += 1
            self._down_streak = 0
        elif idle:
            self._down_streak += 1
            self._up_streak = 0
        else:
            # the hysteresis dead band: neither streak advances, both
            # survive — a single mid-band window never erases evidence
            pass
        cap = self._max if self._max > 0 else sig.replicas + 1
        if (self._up_streak >= self._up_windows
                and sig.replicas < cap):
            streak, self._up_streak = self._up_streak, 0
            return AutoscaleDecision(
                replicas=sig.replicas + 1, direction="up",
                reason=(f"load {sig.load:.2f} >= {self._up_load:g} "
                        f"(shed {sig.shed_delta}) for {streak} "
                        f"window(s)"),
                streak=streak)
        if (self._down_streak >= self._down_windows
                and sig.replicas > self._min):
            streak, self._down_streak = self._down_streak, 0
            return AutoscaleDecision(
                replicas=sig.replicas - 1, direction="down",
                reason=(f"load {sig.load:.2f} <= {self._down_load:g} "
                        f"for {streak} window(s)"),
                streak=streak)
        return AutoscaleDecision(
            replicas=sig.replicas, direction="hold",
            reason=(f"load {sig.load:.2f}, streaks "
                    f"up={self._up_streak}/{self._up_windows} "
                    f"down={self._down_streak}/{self._down_windows}"),
            streak=max(self._up_streak, self._down_streak))

    def describe(self) -> dict:
        return {
            "scale_up_load": self._up_load,
            "scale_down_load": self._down_load,
            "up_windows": self._up_windows,
            "down_windows": self._down_windows,
            "min_replicas": self._min,
            "max_replicas": self._max,
            "up_streak": self._up_streak,
            "down_streak": self._down_streak,
        }
