"""kepmc protocol models: the fleet's transition rules as explorable
state machines, built on the REAL pure code.

Fidelity is the whole point: every transition a model takes calls the
SAME function production runs — :func:`plan_succession` /
:func:`plan_membership_apply` / :class:`CoordinatorLease` for
membership, :class:`SeqTracker` + the watermark seeding rules for the
delivery plane, :func:`plan_ack_cursor` / :func:`plan_rewind_tail` for
the spool cursor, :func:`keyframe_wanted` / :func:`delta_base_matches`
for the wire-v2 keyframe/delta machine. The model layer contributes
only the EVENT VOCABULARY (deliver / duplicate / reorder /
drop-response / crash / restart / partition-probe / scale-op) and the
state packing; when an invariant fires, the counterexample is a real
schedule the shipped functions mishandle, not a modeling artifact.

Each model also carries its elastic-membership bug fixture as a ``variant``: with
``variant="shipped"`` (the registry default) the model drives the
fixed code; the named bug variants re-introduce one pre-fix behavior
so the test suite can prove the checker would have caught it
(``skip_demote_early_return`` — the broadcast-lands-before-demote
wedge; ``hardcoded_issuer`` — the holder-leave handoff break;
``skip_ownership_reseed`` — fabricated loss on ownership return).
Variants exist ONLY for fixtures: the lint registry never explores
them.

States are canonical hashable tuples; every model is deterministic
(no clocks, no randomness) so an exploration is reproducible
state-for-state. A state that already violates an invariant is
ABSORBING (no successors): exploration past a violation only buries
the minimal trace.
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping

from kepler_tpu_torch.fleet.delivery import (
    SeqTracker,
    delta_base_matches,
    keyframe_wanted,
    plan_ack_cursor,
    plan_rewind_tail,
    reseed_on_ownership_return,
    seed_fresh_tracker,
)
from kepler_tpu_torch.fleet.membership import (
    CoordinatorLease,
    MembershipError,
    elect_successor,
    plan_membership_apply,
    plan_succession,
)

__all__ = [
    "KeyframeDeltaModel",
    "LeaseSuccessionModel",
    "MODEL_BUILDERS",
    "SeqDeliveryModel",
    "SpoolCursorModel",
    "build_model",
]


# ---------------------------------------------------------------------------
# coordinator lease / succession (KTL130)
# ---------------------------------------------------------------------------

# replica: (alive, epoch, holder, peers, awaiting)
# state:   (replicas, messages) — messages: frozenset of
#          (epoch, peers, issuer) broadcasts, never consumed (so every
#          delivery can also happen as a duplicate)


class LeaseSuccessionModel:
    """Succession/lease safety over N replicas: crash, true-death
    notice, graceful leave, restart-join, broadcast delivery (with
    inherent duplication/reorder — messages persist), and optionally a
    partitioned prober that falsely suspects its holder.

    Every membership adoption runs the real
    :func:`plan_membership_apply` + :class:`CoordinatorLease.adopt`;
    every issuer election runs the real :func:`plan_succession`.
    """

    def __init__(self, replicas: int = 3, epoch_cap: int = 5,
                 msg_cap: int = 3, suspects: bool = False,
                 variant: str = "shipped") -> None:
        if not 2 <= replicas <= 3:
            raise ValueError("lease model scope is 2-3 replicas")
        self.names = tuple("abc"[:replicas])
        self.epoch_cap = epoch_cap
        # broadcasts persist forever (that is what makes every deliver
        # also a duplicate), so the DISTINCT-message count needs a cap
        # or the frozenset lattice explodes; issuance events gate on it
        self.msg_cap = msg_cap
        self.suspects = suspects
        self.variant = variant

    def initial(self) -> Any:
        holder = elect_successor(self.names)
        reps = tuple((True, 1, holder, self.names, False)
                     for _ in self.names)
        return reps, frozenset()

    # -- transition helpers (REAL code under the hood) ---------------------

    def _alive_names(self, reps: tuple[Any, ...]) -> tuple[str, ...]:
        return tuple(n for n, r in zip(self.names, reps) if r[0])

    def _deliver(self, name: str, rep: Any, msg: Any) -> Any:
        """One replica applies one broadcast — the production
        ``apply_membership`` decision, including replay-does-not-clear-
        awaiting and equal-epoch-conflict rejection."""
        alive, epoch, holder, peers, awaiting = rep
        m_epoch, m_peers, m_issuer = msg
        try:
            decision = plan_membership_apply(
                epoch, list(peers), "kepmc", m_epoch, list(m_peers),
                name, "peer")
        except MembershipError:
            return rep  # stale/conflict: rejected loudly, no change
        if decision.action == "replay":
            return rep  # production parity: awaiting is NOT cleared
        lease = CoordinatorLease(holder, epoch)
        lease.adopt(m_issuer, decision.epoch)
        return (alive, decision.epoch, lease.holder,
                tuple(sorted(decision.peers)), False)

    def _mint_ok(self, messages: frozenset[Any], epoch: int,
                 survivors: tuple[str, ...], issuer: str) -> bool:
        msg = (epoch, tuple(sorted(survivors)), issuer)
        return msg in messages or len(messages) < self.msg_cap

    def _issue(self, reps: tuple[Any, ...], messages: frozenset[Any],
               idx: int, survivors: tuple[str, ...],
               issuer: str) -> Any:
        """Replica ``idx`` issues a membership at its epoch+1 and
        applies it locally (the production issue path)."""
        name = self.names[idx]
        alive, epoch, holder, peers, awaiting = reps[idx]
        msg = (epoch + 1, tuple(sorted(survivors)), issuer)
        new_rep = self._deliver(name, reps[idx], msg)
        out = list(reps)
        out[idx] = new_rep
        return tuple(out), messages | {msg}

    # -- event enumeration --------------------------------------------------

    def successors(self, state: Any) -> Iterable[tuple[str, Any]]:
        reps, messages = state
        if any(True for _ in self.violations(state)):
            return  # absorbing: keep the minimal trace minimal
        alive = self._alive_names(reps)
        for i, name in enumerate(self.names):
            rep = reps[i]
            if rep[0]:
                if len(alive) > 1:
                    out = list(reps)
                    out[i] = (False,) + rep[1:]
                    yield f"crash({name})", (tuple(out), messages)
                yield from self._leave_events(reps, messages, i)
                yield from self._notice_events(reps, messages, i, alive)
                if self.suspects:
                    yield from self._suspect_events(reps, messages, i,
                                                    alive)
                for msg in sorted(messages):
                    new_rep = self._deliver(name, rep, msg)
                    if new_rep != rep:
                        out = list(reps)
                        out[i] = new_rep
                        yield (f"deliver(epoch={msg[0]},"
                               f"peers={{{','.join(msg[1])}}},"
                               f"issuer={msg[2]} -> {name})",
                               (tuple(out), messages))
            else:
                yield from self._restart_events(reps, messages, i)

    def _notice_events(self, reps: tuple[Any, ...],
                       messages: frozenset[Any], i: int,
                       alive: tuple[str, ...]
                       ) -> Iterable[tuple[str, Any]]:
        """Replica ``i`` notices the TRUE dead set and runs the demote
        decision (``_demote_mesh``'s shape)."""
        name = self.names[i]
        _alive, epoch, holder, peers, _awaiting = reps[i]
        if len(alive) == len(self.names):
            return  # nobody is dead; nothing to notice
        survivors = alive
        if set(survivors) == set(peers):
            if self.variant != "skip_demote_early_return":
                return  # FIXED: membership already reflects survivors
            # pre-fix wedge: fall through and await an apply that can
            # never come
        issuer = plan_succession(holder, survivors)
        if issuer == name:
            if (epoch + 1 <= self.epoch_cap
                    and self._mint_ok(messages, epoch + 1, survivors,
                                      issuer)):
                yield (f"notice({name}:issues)",
                       self._issue(reps, messages, i, survivors,
                                   issuer))
        else:
            out = list(reps)
            out[i] = reps[i][:4] + (True,)
            yield f"notice({name}:awaits {issuer})", (tuple(out),
                                                      messages)

    def _suspect_events(self, reps: tuple[Any, ...],
                        messages: frozenset[Any], i: int,
                        alive: tuple[str, ...]
                        ) -> Iterable[tuple[str, Any]]:
        """Partitioned prober: ``i`` falsely suspects its (live)
        holder dead and runs succession over the rest."""
        name = self.names[i]
        _alive, epoch, holder, peers, _awaiting = reps[i]
        if holder == name or holder not in alive:
            return  # self-suspicion is meaningless; true death is notice
        survivors = tuple(n for n in alive if n != holder)
        if not survivors or set(survivors) == set(peers):
            return
        issuer = plan_succession(holder, survivors)
        if issuer == name:
            if (epoch + 1 <= self.epoch_cap
                    and self._mint_ok(messages, epoch + 1, survivors,
                                      issuer)):
                yield (f"suspect({name}:issues over -{holder})",
                       self._issue(reps, messages, i, survivors,
                                   issuer))
        else:
            out = list(reps)
            out[i] = reps[i][:4] + (True,)
            yield (f"suspect({name}:awaits {issuer})",
                   (tuple(out), messages))

    def _leave_events(self, reps: tuple[Any, ...],
                      messages: frozenset[Any],
                      i: int) -> Iterable[tuple[str, Any]]:
        """Graceful leave: ``i`` broadcasts the membership without
        itself. FIXED code names the succession-planned holder as the
        lease issuer; the ``hardcoded_issuer`` variant re-introduces
        the pre-fix bug (issuer = the sender itself)."""
        name = self.names[i]
        _alive, epoch, holder, peers, _awaiting = reps[i]
        survivors = tuple(sorted(set(peers) - {name}))
        if not survivors or epoch + 1 >= self.epoch_cap + 1:
            return
        if self.variant == "hardcoded_issuer":
            issuer = name  # pre-fix: broke the holder-leave handoff
        else:
            issuer = plan_succession(holder, survivors)
        if not self._mint_ok(messages, epoch + 1, survivors, issuer):
            return
        msg = (epoch + 1, survivors, issuer)
        out = list(reps)
        out[i] = (False,) + reps[i][1:]
        yield f"leave({name})", (tuple(out), messages | {msg})

    def _restart_events(self, reps: tuple[Any, ...],
                        messages: frozenset[Any],
                        i: int) -> Iterable[tuple[str, Any]]:
        """Dead replica rejoins via the join handshake: the lease
        holder folds it in at epoch+1 and the joiner adopts the
        incumbent from the reply (it never self-elects)."""
        name = self.names[i]
        for j, hname in enumerate(self.names):
            h = reps[j]
            if not h[0] or h[2] != hname:
                continue  # only a replica believing itself holder folds
            _alive, h_epoch, _holder, h_peers, _awaiting = h
            if h_epoch + 1 > self.epoch_cap:
                continue
            new_peers = tuple(sorted(set(h_peers) | {name}))
            if not self._mint_ok(messages, h_epoch + 1, new_peers,
                                 hname):
                continue
            new_state, new_msgs = self._issue(
                reps, messages, j, new_peers, hname)
            out = list(new_state)
            folded = out[j]
            out[i] = (True, folded[1], folded[2], folded[3], False)
            yield (f"restart({name} joins via {hname})",
                   (tuple(out), new_msgs))

    # -- invariants ----------------------------------------------------------

    def violations(self, state: Any) -> Iterable[tuple[str, str]]:
        reps, messages = state
        alive = self._alive_names(reps)
        # no split-brain: two LIVE self-believing holders never share
        # an epoch. Only meaningful without partitioned probers — a
        # partition can mint transient dual holders by design; there
        # the protection is the conflict rejection below.
        if not self.suspects:
            holders = [(n, r[1]) for n, r in zip(self.names, reps)
                       if r[0] and r[2] == n]
            for a in range(len(holders)):
                for b in range(a + 1, len(holders)):
                    if holders[a][1] == holders[b][1]:
                        yield ("no-split-brain",
                               f"replicas {holders[a][0]!r} and "
                               f"{holders[b][0]!r} both hold the lease "
                               f"at epoch {holders[a][1]}")
        # the lease holder governs a membership it belongs to
        for n, r in zip(self.names, reps):
            if r[0] and r[2] not in r[3]:
                yield ("holder-in-peers",
                       f"replica {n!r} adopted lease holder {r[2]!r} "
                       f"outside its membership {list(r[3])!r}")
        # at most one epoch bump per succession: the epochs ever minted
        # form a contiguous range from the initial epoch
        epochs = {1} | {m[0] for m in messages} | {r[1] for r in reps}
        if sorted(epochs) != list(range(1, max(epochs) + 1)):
            yield ("contiguous-epochs",
                   f"epoch set {sorted(epochs)} has a gap: some "
                   f"succession bumped by more than one")
        # the membership wedge: a replica awaiting a membership that is
        # already fully reflected (its peers == the live set) with no
        # newer broadcast in flight will wait forever
        if not self.suspects:
            max_msg = max((m[0] for m in messages), default=0)
            for n, r in zip(self.names, reps):
                if (r[0] and r[4] and set(r[3]) == set(alive)
                        and max_msg <= r[1]):
                    yield ("no-await-wedge",
                           f"replica {n!r} awaits a membership apply "
                           f"at epoch {r[1]} but its peer set already "
                           f"matches the survivors and no newer "
                           f"broadcast exists — it waits forever")

    def describe_state(self, state: Any) -> str:
        reps, messages = state
        parts = []
        for n, (alive, epoch, holder, peers, awaiting) in zip(
                self.names, reps):
            parts.append(
                f"{n}[{'up' if alive else 'DOWN'} e{epoch} "
                f"holder={holder} peers={{{','.join(peers)}}}"
                f"{' AWAITING' if awaiting else ''}]")
        msgs = ", ".join(f"(e{e},{{{','.join(p)}}},{i})"
                         for e, p, i in sorted(messages)) or "none"
        return " ".join(parts) + f" inflight: {msgs}"


# ---------------------------------------------------------------------------
# seq dedup / watermark seeding (KTL131 + KTL132)
# ---------------------------------------------------------------------------

# tracker: None | (max_seen, order, epoch, lost)
# state: (owner, ring_epoch, emitted, acked, next_send, trackers,
#         replay_loss)

_SEQ_RUN = "kepmc-run"


class SeqDeliveryModel:
    """One agent's window stream against two aggregator replicas under
    elastic ownership: emit, deliver, drop-response (server ingested,
    2xx lost — the agent re-sends), spool-tail rewind (the send cursor
    steps BACK and the tail re-delivers in order: the wire is one FIFO
    drain loop, so replays never skip a seq), scale ops (ownership
    moves + ring-epoch bump), replica restarts (trackers are memory).
    Every observation runs the real :class:`SeqTracker` with the real
    watermark seeding rules."""

    def __init__(self, windows: int = 6, dedup_window: int = 2,
                 epoch_cap: int = 4, replicas: int = 2,
                 variant: str = "shipped") -> None:
        self.windows = windows
        self.dedup_window = dedup_window
        self.epoch_cap = epoch_cap
        self.replicas = replicas
        self.variant = variant

    def initial(self) -> Any:
        return 0, 1, 0, 0, 1, (None,) * self.replicas, False

    def _ingest(self, trackers: tuple[Any, ...], owner: int,
                ring_epoch: int, acked: int,
                seq: int) -> tuple[tuple[Any, ...], bool, int]:
        """The aggregator ``_ingest_payload`` seq accounting, driven
        through the real pure functions → (trackers', dup, lost)."""
        entry = trackers[owner]
        t = SeqTracker(_SEQ_RUN, self.dedup_window)
        prior_lost = 0
        if entry is None:
            seed_fresh_tracker(t, acked, seq)
        else:
            max_seen, order, tepoch, prior_lost = entry
            t.max_seen = max_seen
            for s in order:
                t.seen.add(s)
                t.order.append(s)
            t.ring_epoch = tepoch
        if self.variant != "skip_ownership_reseed":
            reseed_on_ownership_return(t, ring_epoch, acked, seq)
        dup, lost = t.observe(seq)
        out = list(trackers)
        out[owner] = (t.max_seen, tuple(t.order), t.ring_epoch,
                      prior_lost + lost)
        return tuple(out), dup, lost

    def successors(self, state: Any) -> Iterable[tuple[str, Any]]:
        (owner, epoch, emitted, acked, next_send, trackers,
         replay_loss) = state
        if any(True for _ in self.violations(state)):
            return  # absorbing
        if emitted < self.windows:
            yield "emit", (owner, epoch, emitted + 1, acked, next_send,
                           trackers, replay_loss)
        if next_send <= emitted:
            seq = next_send
            tr, _dup, lost = self._ingest(trackers, owner, epoch,
                                          acked, seq)
            # a re-sent concluded seq that still counts loss breaks
            # replay idempotence (it can never be a real gap: FIFO)
            bad_replay = replay_loss or (seq <= acked and lost > 0)
            kind = "replay" if seq <= acked else "deliver"
            yield (f"{kind}(seq={seq} -> r{owner})",
                   (owner, epoch, emitted, max(acked, seq), seq + 1,
                    tr, bad_replay))
            yield (f"drop_response(seq={seq} -> r{owner})",
                   (owner, epoch, emitted, acked, next_send, tr,
                    bad_replay))
        # spool rewind: the send cursor steps back over concluded
        # records (bounded tail); the drain loop then re-delivers them
        # IN ORDER before any fresh window
        for back in (1, 2):
            tgt = acked + 1 - back
            if 1 <= tgt < next_send:
                yield (f"rewind(to seq={tgt})",
                       (owner, epoch, emitted, acked, tgt, trackers,
                        replay_loss))
        if epoch < self.epoch_cap and self.replicas > 1:
            yield (f"scale(owner -> r{(owner + 1) % self.replicas})",
                   ((owner + 1) % self.replicas, epoch + 1, emitted,
                    acked, next_send, trackers, replay_loss))
        for r in range(self.replicas):
            if trackers[r] is not None:
                out = list(trackers)
                out[r] = None
                yield (f"restart(r{r})",
                       (owner, epoch, emitted, acked, next_send,
                        tuple(out), replay_loss))

    def violations(self, state: Any) -> Iterable[tuple[str, str]]:
        (_owner, _epoch, _emitted, _acked, _next_send, trackers,
         replay_loss) = state
        # every window reaches SOME owner in this model (the spool is
        # durable and sends are FIFO), so ANY counted loss is fabricated
        for r, entry in enumerate(trackers):
            if entry is not None and entry[3] > 0:
                yield ("no-fabricated-loss",
                       f"replica r{r} counted {entry[3]} lost "
                       f"window(s) although every window was delivered "
                       f"to its then-owner")
        if replay_loss:
            yield ("replay-idempotent",
                   "a spool-tail replay of an already-concluded seq "
                   "was counted as loss instead of being absorbed")

    def describe_state(self, state: Any) -> str:
        (owner, epoch, emitted, acked, next_send, trackers,
         replay_loss) = state
        ts = []
        for r, entry in enumerate(trackers):
            if entry is None:
                ts.append(f"r{r}[-]")
            else:
                ms, order, tepoch, lost = entry
                ts.append(f"r{r}[max={ms} seen={list(order)} "
                          f"e{tepoch} lost={lost}]")
        return (f"owner=r{owner} ring_epoch={epoch} emitted={emitted} "
                f"acked={acked} next_send={next_send} "
                + " ".join(ts)
                + (" REPLAY-LOSS" if replay_loss else ""))


# ---------------------------------------------------------------------------
# spool ack cursor / rewind (KTL131)
# ---------------------------------------------------------------------------

# record ledger status: "p" pending | "a" acked | "e" evicted
# state: (sealed, active, cursor, ledger, stale_flag, rewind_flag)
#   sealed: tuple[(idx, count), ...]   active: (idx, count)
#   ledger: tuple[(seg, off, status), ...] in append order


class SpoolCursorModel:
    """The spool's durability cursor under append/rotate, in-order and
    batched (segment-hop) acks, STALE acks racing cap eviction, peek
    hops, and bounded rewind — every cursor move computed by the real
    :func:`plan_ack_cursor` / :func:`plan_rewind_tail` (unit-sized
    records: offset == record ordinal, record_end == offset+1)."""

    def __init__(self, max_records: int = 5, segment_records: int = 2,
                 rewind_max: int = 2, variant: str = "shipped") -> None:
        self.max_records = max_records
        self.segment_records = segment_records
        self.rewind_max = rewind_max
        self.variant = variant

    def initial(self) -> Any:
        return (), (1, 0), (1, 0), (), False, False

    @staticmethod
    def _count(sealed: tuple[Any, ...], active: Any, seg: int) -> int:
        if seg == active[0]:
            return int(active[1])
        for idx, count in sealed:
            if idx == seg:
                return int(count)
        return 0

    def _next_seg(self, sealed: tuple[Any, ...], active: Any,
                  seg: int) -> int | None:
        later = [idx for idx, _ in sealed if idx > seg]
        if active[0] > seg:
            later.append(active[0])
        return min(later) if later else None

    def successors(self, state: Any) -> Iterable[tuple[str, Any]]:
        sealed, active, cursor, ledger, stale, rew = state
        if any(True for _ in self.violations(state)):
            return  # absorbing
        if len(ledger) < self.max_records:
            rec = (active[0], active[1], "p")
            new_active = (active[0], active[1] + 1)
            new_sealed = sealed
            if new_active[1] == self.segment_records:
                new_sealed = sealed + ((active[0],
                                        self.segment_records),)
                new_active = (active[0] + 1, 0)
            yield (f"append(seg={rec[0]},off={rec[1]})",
                   (new_sealed, new_active, cursor, ledger + (rec,),
                    stale, rew))
        yield from self._ack_events(state)
        # peek hop: the cursor parked at a sealed segment's end hops to
        # the next segment's first frame (spool.peek's shape)
        seg, off = cursor
        if (seg != active[0]
                and off >= self._count(sealed, active, seg)):
            nxt = self._next_seg(sealed, active, seg)
            if nxt is not None:
                yield (f"peek_hop(-> seg={nxt})",
                       (sealed, active, (nxt, 0), ledger, stale, rew))
        if sealed:
            yield from self._evict_event(state)
        yield from self._rewind_event(state)

    def _ack_events(self, state: Any) -> Iterable[tuple[str, Any]]:
        sealed, active, cursor, ledger, stale, rew = state
        seg, off = cursor
        end = self._count(sealed, active, seg)
        nxt = self._next_seg(sealed, active, seg)
        for rseg, roff, status in ledger:
            if status != "p":
                continue
            new_cursor = plan_ack_cursor(cursor, (rseg, roff),
                                         roff + 1, end, nxt)
            legit = (rseg, roff) == cursor or (
                off >= end and nxt is not None and rseg == nxt
                and roff == 0)
            if new_cursor is None:
                continue  # stale ack correctly refused: a no-op
            new_ledger = tuple(
                (s, o, "a" if (s, o) == (rseg, roff) else st)
                for s, o, st in ledger)
            yield (f"ack(seg={rseg},off={roff})",
                   (sealed, active, new_cursor, new_ledger,
                    stale or not legit, rew))

    def _evict_event(self, state: Any) -> Iterable[tuple[str, Any]]:
        sealed, active, cursor, ledger, stale, rew = state
        oldest = min(idx for idx, _ in sealed)
        new_sealed = tuple((i, c) for i, c in sealed if i != oldest)
        new_ledger = tuple(
            (s, o, "e" if s == oldest and st == "p" else st)
            for s, o, st in ledger)
        new_cursor = cursor
        if cursor[0] <= oldest:
            new_cursor = (oldest + 1, 0)  # spool._evict_for_locked
        yield (f"evict(seg={oldest})",
               (sealed and new_sealed or (), active, new_cursor,
                new_ledger, stale, rew))

    def _rewind_event(self, state: Any) -> Iterable[tuple[str, Any]]:
        sealed, active, cursor, ledger, stale, rew = state
        seg, off = cursor
        starts = tuple(range(self._count(sealed, active, seg)))
        tail = plan_rewind_tail(starts, off, self.rewind_max)
        if not tail:
            return
        bad = any(st != "a"
                  for s, o, st in ledger
                  if s == seg and o in tail)
        new_ledger = tuple(
            (s, o, "p" if s == seg and o in tail else st)
            for s, o, st in ledger)
        yield (f"rewind({len(tail)} record(s))",
               (sealed, active, (seg, tail[0]), new_ledger, stale,
                rew or bad))

    def violations(self, state: Any) -> Iterable[tuple[str, str]]:
        _sealed, _active, cursor, ledger, stale, rew = state
        for seg, off, status in ledger:
            before = (seg, off) < cursor
            if before and status == "p":
                yield ("cursor-no-skip",
                       f"cursor {cursor} passed record "
                       f"(seg={seg},off={off}) whose delivery never "
                       f"concluded — it is silently lost")
            if not before and status == "a":
                yield ("cursor-no-skip",
                       f"record (seg={seg},off={off}) is concluded but "
                       f"sits at/after cursor {cursor} — it would "
                       f"re-deliver as fresh")
        if stale:
            yield ("stale-ack-rejected",
                   "an ack for a record the cursor does not point at "
                   "(nor the one legitimate segment hop) was honored")
        if rew:
            yield ("rewind-bounded",
                   "a rewind re-opened a record that was never "
                   "concluded, or reached outside the cursor segment")

    def describe_state(self, state: Any) -> str:
        sealed, active, cursor, ledger, stale, rew = state
        recs = " ".join(f"{s}.{o}:{st}" for s, o, st in ledger) or "none"
        return (f"cursor={cursor} active=seg{active[0]}"
                f"({active[1]} rec) sealed={list(sealed)} "
                f"records: {recs}")


# ---------------------------------------------------------------------------
# wire-v2 keyframe / delta / 409 (KTL132)
# ---------------------------------------------------------------------------

# state: (seq, needs_kf, kf_base, since_kf, disrupted, owner, bases,
#         w409, dup_flag)

_KF_RUN = "kepmc-run"


class KeyframeDeltaModel:
    """The wire-v2 base-row machine: an agent streaming windows to two
    replicas through keyframe/delta selection (the real
    :func:`keyframe_wanted`), server-side base matching (the real
    :func:`delta_base_matches`), 409 needs-keyframe recovery, response
    loss, owner hand-off, base eviction, and duplicate keyframe
    replays. ``keyframe_every`` cadence and window count stay tiny —
    the machine has no long-range state."""

    def __init__(self, windows: int = 4, keyframe_every: int = 2,
                 replicas: int = 2, variant: str = "shipped") -> None:
        self.windows = windows
        self.keyframe_every = keyframe_every
        self.replicas = replicas
        self.variant = variant

    def initial(self) -> Any:
        return 1, False, None, 0, False, 0, (None,) * self.replicas, 0, False

    def _want_kf(self, needs: bool, disrupted: bool, kf_base: Any,
                 since: int) -> bool:
        needs_in = False if self.variant == "ignore_needs_flag" else needs
        return keyframe_wanted(
            needs_keyframe=needs_in,
            delivery_path="replay" if disrupted else "fresh",
            has_base=kf_base is not None, run_matches=True,
            since_keyframe=since, keyframe_every=self.keyframe_every)

    def _base_ok(self, bases: tuple[Any, ...], owner: int,
                 kf_base: Any) -> bool:
        if bases[owner] is None or kf_base is None:
            return False
        return delta_base_matches(_KF_RUN, int(bases[owner]), _KF_RUN,
                                  int(kf_base))

    def successors(self, state: Any) -> Iterable[tuple[str, Any]]:
        (seq, needs, kf_base, since, disrupted, owner, bases, w409,
         dup_flag) = state
        if any(True for _ in self.violations(state)):
            return  # absorbing
        if seq <= self.windows:
            wk = self._want_kf(needs, disrupted, kf_base, since)
            if wk:
                nb = list(bases)
                nb[owner] = seq  # keyframe plants the base (dup-safe)
                yield (f"send_kf_ok(seq={seq} -> r{owner})",
                       (seq + 1, False, seq, 0, False, owner,
                        tuple(nb), 0, dup_flag))
                yield (f"send_kf_lost(seq={seq} -> r{owner})",
                       (seq, needs, kf_base, since, True, owner,
                        tuple(nb), w409, dup_flag))
            elif self._base_ok(bases, owner, kf_base):
                yield (f"send_delta_ok(seq={seq} -> r{owner})",
                       (seq + 1, needs, kf_base, since + 1, False,
                        owner, bases, 0, dup_flag))
                yield (f"send_delta_lost(seq={seq} -> r{owner})",
                       (seq, needs, kf_base, since, True, owner,
                        bases, w409, dup_flag))
            else:
                # the structured 409: base missing/mismatched after a
                # hand-off, eviction or run change
                yield (f"recv_409(seq={seq} from r{owner})",
                       (seq, True, kf_base, since, disrupted, owner,
                        bases, min(w409 + 1, 3), dup_flag))
        if kf_base is not None:
            # spool-tail replay re-delivers the acked keyframe: the
            # duplicate MUST still plant the base (hand-off recovery)
            nb = list(bases)
            planted = kf_base
            if self.variant == "dup_kf_skips_base":
                planted = bases[owner]  # pre-hardening: dup judged, dropped
            nb[owner] = planted
            yield (f"dup_kf(seq={kf_base} -> r{owner})",
                   (seq, needs, kf_base, since, disrupted, owner,
                    tuple(nb), w409,
                    dup_flag or nb[owner] != kf_base))
        if self.replicas > 1:
            yield (f"handoff(-> r{(owner + 1) % self.replicas})",
                   (seq, needs, kf_base, since, True,
                    (owner + 1) % self.replicas, bases, w409,
                    dup_flag))
        if bases[owner] is not None:
            nb = list(bases)
            nb[owner] = None
            yield (f"evict_base(r{owner})",
                   (seq, needs, kf_base, since, disrupted, owner,
                    tuple(nb), w409, dup_flag))

    def violations(self, state: Any) -> Iterable[tuple[str, str]]:
        (_seq, _needs, _kf_base, _since, _disrupted, _owner, _bases,
         w409, dup_flag) = state
        # a 409 latches needs_keyframe, and keyframe_wanted() makes the
        # very next send a keyframe — which can never 409. So one
        # window sees at most ONE 409: the loop converges in a single
        # round-trip.
        if w409 > 1:
            yield ("409-converges",
                   f"the same window drew {w409} needs-keyframe "
                   f"answers: the 409 recovery loop is not converging")
        if dup_flag:
            yield ("dup-keyframe-plants-base",
                   "a duplicate keyframe was dedup-dropped WITHOUT "
                   "planting the delta base — the hand-off replay "
                   "cannot re-arm deltas")

    def describe_state(self, state: Any) -> str:
        (seq, needs, kf_base, since, disrupted, owner, bases, w409,
         dup_flag) = state
        bs = " ".join(f"r{r}[base={b}]" for r, b in enumerate(bases))
        return (f"window={seq} needs_kf={needs} agent_base={kf_base} "
                f"since_kf={since} path="
                f"{'replay' if disrupted else 'fresh'} owner=r{owner} "
                f"{bs} window_409s={w409}")


# ---------------------------------------------------------------------------
# factory
# ---------------------------------------------------------------------------

MODEL_BUILDERS: dict[str, type] = {
    "lease": LeaseSuccessionModel,
    "seq": SeqDeliveryModel,
    "spool": SpoolCursorModel,
    "keyframe": KeyframeDeltaModel,
}


def build_model(model: str, params: Mapping[str, Any] | None = None,
                variant: str = "shipped") -> Any:
    """Instantiate a registered model with a case's params/variant."""
    try:
        cls = MODEL_BUILDERS[model]
    except KeyError:
        raise ValueError(f"unknown protocol model {model!r}; "
                         f"registered: {sorted(MODEL_BUILDERS)}")
    return cls(**dict(params or {}), variant=variant)
