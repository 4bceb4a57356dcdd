"""Pure delivery-plane decision layer: seq dedup, watermark seeding,
keyframe/delta choice, spool-cursor math.

Elastic membership surfaced three ordering bugs that only specific event schedules
expose, and every one of them lived in a transition tangled into an
I/O path (`fleet/aggregator.py` ingest, `fleet/agent.py` send,
`fleet/spool.py` ack). Following the shape `fleet/membership.py`
proved — decisions as pure functions of explicit state, wiring kept in
the I/O modules — this module holds the delivery plane's transition
rules so the kepmc protocol model checker
(the reference package's ``analysis.protocol``) can drive the SAME functions
production runs, exhaustively, over every interleaving of a small
fleet. No sockets, no locks, no clocks, no file handles.

Every function (and mutating method) here that writes protocol state —
seq watermarks, dedup windows, ack cursors — is marked ``# keplint:
protocol-transition``; the KTL133 rule enforces that such writes happen
nowhere else in ``kepler_tpu_torch/fleet/``.
"""

from __future__ import annotations

import collections
from typing import Sequence

__all__ = [
    "SeqTracker",
    "delta_base_matches",
    "keyframe_wanted",
    "plan_ack_cursor",
    "plan_rewind_tail",
    "reseed_on_ownership_return",
    "seed_fresh_tracker",
]


class SeqTracker:
    """Per-(node, run) sequence accounting: a bounded window of recently
    seen seqs (dedup — spool replays are idempotent) plus gap detection
    (a seq jump is LOST windows, surfaced as a per-node counter instead
    of silence). The aggregator holds its store lock around every call.
    """

    __slots__ = ("run", "max_seen", "seen", "order", "window", "touched",
                 "ring_epoch")

    # keplint: protocol-transition — birth state of the dedup window
    def __init__(self, run: str, window: int) -> None:
        self.run = run
        self.max_seen = 0
        self.seen: set[int] = set()
        self.order: collections.deque[int] = collections.deque()
        self.window = max(1, window)
        self.touched = 0.0  # aggregator clock; drives cap eviction
        self.ring_epoch = 0  # ring epoch at last observe (ownership-return)

    # keplint: protocol-transition
    def observe(self, seq: int) -> tuple[bool, int]:
        """→ (is_duplicate, windows_lost_by_this_arrival).

        A seq inside the dedup window that was already seen — or one so
        old it fell out of the window — is a duplicate (at-least-once
        redelivery): ack-worthy but not ingestable. A seq jumping past
        ``max_seen + 1`` reports the skipped windows as lost; a late
        out-of-order FILL of a previously-counted gap is ingested but
        cannot retroactively decrement the loss counter (counters only
        go up; ordered spool replay makes real fills rare).

        Accounting is CONSERVATIVE: loss = windows this tracker never
        saw. A fresh aggregator meeting a mid-run stream (aggregator
        restart) counts the pre-restart windows as a one-time spike —
        indistinguishable, from seq alone, from an agent whose first
        windows died before delivery, and the latter must be counted."""
        if seq in self.seen:
            return True, 0
        if seq <= self.max_seen - self.window:
            return True, 0  # beyond the window: can't tell — stay idempotent
        self.seen.add(seq)
        self.order.append(seq)
        while len(self.order) > self.window:
            self.seen.discard(self.order.popleft())
        lost = 0
        if seq > self.max_seen + 1:
            # seq numbers start at 1 within a run: a first-seen seq of N
            # means windows 1..N-1 died before delivery (ring overflow,
            # spool eviction, disk failure)
            lost = seq - self.max_seen - 1
        self.max_seen = max(self.max_seen, seq)
        return False, lost


# keplint: protocol-transition — the hand-off / restart seeding rule
def seed_fresh_tracker(tracker: SeqTracker, acked_through: int,
                       seq: int) -> None:
    """Seed a FRESH tracker's watermark from the agent's delivered
    watermark: the agent asserts every seq ≤ ``acked_through`` got a
    2xx from SOME replica — delivered to a previous owner (or a
    previous incarnation of this one), not lost. ``min()`` clamps a
    stale or hostile watermark to this report's own leading gap, so an
    agent can only vouch for (or hide) its OWN stream."""
    if acked_through > 0 and seq > 0:
        tracker.max_seen = min(acked_through, seq - 1)


# keplint: protocol-transition — the ownership-return re-seed
def reseed_on_ownership_return(tracker: SeqTracker, ring_epoch: int,
                               acked_through: int, seq: int) -> None:
    """Ownership RETURN (elastic membership): this replica owned the
    node under an earlier epoch, lost it to a join/scale-up, and got
    it back on a leave/succession. Its tracker slept through the away
    period, but the agent's watermark vouches those windows were 2xx'd
    by the interim owner — delivered, not lost. Gated on an actual
    epoch advance and ``min()``-clamped exactly like fresh-tracker
    seeding, so with membership at rest an inflated watermark still
    hides nothing."""
    if ring_epoch > tracker.ring_epoch and acked_through > tracker.max_seen:
        tracker.max_seen = max(tracker.max_seen,
                               min(acked_through, seq - 1))
    tracker.ring_epoch = ring_epoch


def keyframe_wanted(*, needs_keyframe: bool, delivery_path: str,
                    has_base: bool, run_matches: bool,
                    since_keyframe: int, keyframe_every: int) -> bool:
    """Should the next v2 send ship FULL (keyframe) instead of delta?

    Yes when the server asked (409 needs-keyframe), when the window is
    a replay (a hand-off's new owner has no base state; the spool
    holds keyframes), when no acked base exists or it belongs to
    another run, or when the keyframe cadence is due. The checker pins
    the convergence property this predicate carries: after a 409 the
    next send is ALWAYS a keyframe, so a needs-keyframe loop cannot
    outlive one round-trip."""
    return (needs_keyframe or delivery_path != "fresh" or not has_base
            or not run_matches
            or since_keyframe + 1 >= keyframe_every)


def delta_base_matches(base_run: str, base_seq: int, run: str,
                       wanted_base_seq: int) -> bool:
    """Does a stored base row satisfy a delta frame's (run, base_seq)
    reference? A mismatch — hand-off, eviction, run change — is the
    structured 409 needs-keyframe answer, never a guess."""
    return base_run == run and base_seq == wanted_base_seq


def plan_ack_cursor(cursor: tuple[int, int], record: tuple[int, int],
                    record_end: int, cursor_segment_end: int,
                    next_segment: int | None) -> tuple[int, int] | None:
    """Validate one spool ack against the CURRENT cursor → the new
    ``(segment, offset)`` cursor, or None when the ack must be a no-op.

    ``record`` is the acked record's ``(segment, offset)`` position and
    ``record_end`` the offset just past its frame. An ack is honored
    when the record sits exactly at the cursor — or at the ONE hop
    batched acks legitimately produce: the cursor parked at a sealed
    segment's end (``cursor_segment_end``) while the record is the
    FIRST frame of the next segment (``next_segment``). Anything else
    means the cursor moved underneath the caller (cap eviction, a
    concurrent re-peek) and advancing would silently skip a record
    that was never sent."""
    if record == cursor:
        return record[0], record_end
    _seg, off = cursor
    if (off >= cursor_segment_end and next_segment is not None
            and record[0] == next_segment and record[1] == 0):
        return record[0], record_end
    return None


def plan_rewind_tail(starts: Sequence[int], cursor_offset: int,
                     max_records: int) -> tuple[int, ...]:
    """The already-acked record start offsets (current segment only)
    a rewind re-delivers: the last ``max_records`` frames strictly
    before the cursor. Bounded by segment retention — fully-acked
    sealed segments are deleted at ack time, so a rewind can never
    reach past the cursor segment's first frame, and never re-delivers
    a record the cursor has not concluded."""
    if max_records <= 0 or cursor_offset <= 0:
        return ()
    tail = [s for s in starts if s < cursor_offset]
    return tuple(tail[-max_records:])
