"""The kepmc protocol registry: which models run at which scopes.

One :class:`ProtocolSpec` per fleet protocol (mirroring the kepljax
``ProgramSpec`` pattern), each with declared exploration cases — the
scope bounds (replica count, epoch caps, window counts, message caps)
at which the state space is BOTH exhaustively explorable and large
enough to contain every schedule class the protocol distinguishes
(crash/heal orderings, duplicate and reordered broadcasts, response
loss, ownership flaps, partitioned probes). Every case here explores
the SHIPPED transition code; the bug variants (``models.py``) exist
only for the negative-path tests.

``invariants`` documents, per spec, which safety properties the
model's :meth:`violations` checks — the strings match the
counterexample ``invariant`` field, and ``checks.INVARIANT_RULE`` maps
each to its KTL rule id. A spec's ``source`` anchors its diagnostics
at the module whose transition rules the model drives.

Scope discipline: ``max_states`` is a hard cap, not a budget — an
exploration that hits it raises instead of truncating, because a
truncated "all clear" is a false negative. The caps here sit ~10x
above the measured reachable counts so model growth trips loudly.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

__all__ = [
    "PROTOCOL_SPECS",
    "ProtocolCase",
    "ProtocolSpec",
    "spec_by_name",
]


@dataclass(frozen=True)
class ProtocolCase:
    """One exploration scope for a spec (name + model build knobs)."""

    name: str
    note: str = ""
    params: dict[str, Any] = field(default_factory=dict)
    max_states: int = 250_000


@dataclass(frozen=True)
class ProtocolSpec:
    """One registered protocol + its declared exploration contract."""

    name: str
    source: str  # repo-relative module whose transitions the model drives
    description: str
    model: str  # key into models.MODEL_BUILDERS
    cases: tuple[ProtocolCase, ...]
    invariants: tuple[str, ...]


PROTOCOL_SPECS: tuple[ProtocolSpec, ...] = (
    ProtocolSpec(
        name="lease.succession",
        source="kepler_tpu_torch/fleet/membership.py",
        description="coordinator lease adopt/succession + membership "
                    "apply/replay under crash, true-death notice, "
                    "graceful leave, restart-join and duplicated/"
                    "reordered broadcasts (plan_succession, "
                    "plan_membership_apply, CoordinatorLease.adopt)",
        model="lease",
        cases=(
            ProtocolCase("n2_e4",
                         "the 2-replica fleet: every pairwise "
                         "crash/leave/heal ordering",
                         params={"replicas": 2, "epoch_cap": 4}),
            ProtocolCase("n3_e5",
                         "full 3-replica scope: concurrent notice, "
                         "competing issuers, restart-join races",
                         params={"replicas": 3, "epoch_cap": 5},
                         max_states=60_000),
        ),
        invariants=("no-split-brain", "holder-in-peers",
                    "contiguous-epochs", "no-await-wedge"),
    ),
    ProtocolSpec(
        name="lease.partitioned",
        source="kepler_tpu_torch/fleet/membership.py",
        description="the same lease machine with a partitioned prober "
                    "that falsely suspects its live holder — transient "
                    "dual holders are legal here; the invariant is "
                    "that equal-epoch conflicts stay REJECTED and "
                    "epochs stay contiguous",
        model="lease",
        cases=(
            ProtocolCase("n3_e4_suspects",
                         params={"replicas": 3, "epoch_cap": 4,
                                 "suspects": True},
                         max_states=200_000),
        ),
        invariants=("holder-in-peers", "contiguous-epochs"),
    ),
    ProtocolSpec(
        name="seq.delivery",
        source="kepler_tpu_torch/fleet/delivery.py",
        description="per-node seq dedup/gap/watermark accounting under "
                    "FIFO delivery, response loss, bounded spool "
                    "rewind, ownership scale-flaps and replica "
                    "restarts (SeqTracker, seed_fresh_tracker, "
                    "reseed_on_ownership_return)",
        model="seq",
        cases=(
            ProtocolCase("k6_w2_e4",
                         "6 windows, dedup window 2, 4 ring epochs "
                         "across 2 replicas",
                         params={}, max_states=400_000),
        ),
        invariants=("no-fabricated-loss", "replay-idempotent"),
    ),
    ProtocolSpec(
        name="spool.cursor",
        source="kepler_tpu_torch/fleet/delivery.py",
        description="spool durability-cursor math under append/rotate, "
                    "in-order + segment-hop acks, stale acks racing "
                    "cap eviction, peek hops and bounded rewind "
                    "(plan_ack_cursor, plan_rewind_tail)",
        model="spool",
        cases=(
            ProtocolCase("r5_s2",
                         "5 records over 2-record segments, rewind "
                         "tail 2",
                         params={}),
        ),
        invariants=("cursor-no-skip", "stale-ack-rejected",
                    "rewind-bounded"),
    ),
    ProtocolSpec(
        name="keyframe.delta",
        source="kepler_tpu_torch/fleet/delivery.py",
        description="wire-v2 base-row machine: keyframe/delta "
                    "selection, server-side base matching, 409 "
                    "needs-keyframe recovery, duplicate keyframe "
                    "replay, owner hand-off and base eviction "
                    "(keyframe_wanted, delta_base_matches)",
        model="keyframe",
        cases=(
            ProtocolCase("k4_every2",
                         "4 windows at keyframe cadence 2 across 2 "
                         "replicas",
                         params={}),
        ),
        invariants=("409-converges", "dup-keyframe-plants-base"),
    ),
)


def spec_by_name(name: str) -> ProtocolSpec:
    for spec in PROTOCOL_SPECS:
        if spec.name == name:
            return spec
    raise KeyError(name)
