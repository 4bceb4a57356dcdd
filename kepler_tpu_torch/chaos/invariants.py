"""kepchaos global invariants, checked over a :class:`RunRecord`.

The record is a plain-data snapshot the conductor assembles from a run
(published windows, counter snapshots — including ones captured from
replicas at kill time — rung timelines, final membership/health views,
agent backlogs). Keeping it hand-buildable is the point: every checker
has a test that constructs a *violating* record by hand and asserts the
checker fires (a checker that cannot fail is worse than none).

The five invariants, matching docs/developer/resilience.md:

1. **Conservation** — per published row: ``energy ≈ power × dt``, the
   workload plane sums to the node envelope (ratio mode), and when the
   agents' emission ledger is available, published energy matches what
   was emitted (masked zones included).
2. **No fabricated loss** — ``windows_lost_total`` summed over every
   replica incarnation never exceeds the windows agents really
   abandoned (zero in the conductor harness: agents never drop
   pending windows).
3. **Idempotent merge** — a node appears in at most one replica's
   published window per window index, and workload ids never repeat
   within a row.
4. **Ladder monotonicity** — demotions move exactly one rung down with
   a known failure reason; repromotions move exactly one rung up and
   only after ``repromote_after`` clean windows.
5. **Convergence** — within the cooldown after the last scheduled
   fault: all member replicas agree on (epoch, peers, holder); the
   lease holder is a live member; health and window-health probes are
   green; every agent has drained its backlog.
6. **Journal completeness + causal order** — every conductor schedule
   op with a certain effect (a kill of a member, an accepted
   join/leave/restart, an enacted autoscale) leaves matching evidence
   in the merged black-box journal, each per-incarnation journal is
   strictly HLC-increasing, and no event's HLC physical component
   precedes the conductor's virtual-clock time of the op that caused
   it — the journal can NEVER tell a story the ground-truth schedule
   contradicts.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping, Sequence

# reasons _record_rung_transition_locked may carry for a one-rung demote
DEMOTION_REASONS: frozenset[str] = frozenset({
    "dispatch_error", "compile_error", "oom_on_grow", "stall",
    "runtime_error"})

RTOL = 1e-2       # f32 window planes, f16 workload plane
ATOL_UW = 1e3     # 1 mW absolute floor — masks pure float noise at 0


@dataclass(frozen=True)
class Violation:
    # conservation | loss | duplicates | ladder | convergence | journal
    invariant: str
    detail: str

    def __str__(self) -> str:
        return f"[{self.invariant}] {self.detail}"


@dataclass
class RowRecord:
    """One node's row in one published window (canonical zone order)."""

    node: str
    dt: float
    energy_uj: tuple[float, ...] = ()
    power_uw: tuple[float, ...] = ()
    wl_power_sum_uw: tuple[float, ...] = ()
    wl_ids: tuple[str, ...] = ()
    usage_ratio: float | None = None
    emitted_energy_uj: tuple[float, ...] | None = None


@dataclass
class WindowRecord:
    replica: str
    win: int
    rows: list[RowRecord] = field(default_factory=list)


@dataclass
class MembershipView:
    epoch: int
    peers: tuple[str, ...]
    holder: str


@dataclass
class RunRecord:
    windows: list[WindowRecord] = field(default_factory=list)
    # replica incarnation -> counter snapshot (live replicas at run end,
    # killed replicas at kill time — loss must be counted across both)
    stats: dict[str, Mapping[str, int]] = field(default_factory=dict)
    timelines: dict[str, Sequence[Mapping[str, object]]] = \
        field(default_factory=dict)
    repromote_after: int = 1
    abandoned_windows: int = 0
    membership: dict[str, MembershipView] = field(default_factory=dict)
    alive: frozenset[str] = frozenset()
    health_ok: dict[str, bool] = field(default_factory=dict)
    window_health_ok: dict[str, bool] = field(default_factory=dict)
    pending: dict[str, int] = field(default_factory=dict)
    # black box (invariant 6): replica incarnation -> journal snapshot
    # (live replicas at run end, killed incarnations at kill time) and
    # the conductor's ground-truth op log — only ops whose EFFECT was
    # certain (kill of a member, accepted join/leave/restart, enacted
    # autoscale), each with the virtual-clock time it happened at
    journals: dict[str, Sequence[Mapping[str, object]]] = \
        field(default_factory=dict)
    schedule_ops: list[Mapping[str, object]] = field(default_factory=list)


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= ATOL_UW + RTOL * max(abs(a), abs(b))


def check_conservation(rec: RunRecord) -> list[Violation]:
    out: list[Violation] = []
    for wr in rec.windows:
        for row in wr.rows:
            where = f"win={wr.win} replica={wr.replica} node={row.node}"
            if len(row.energy_uj) != len(row.power_uw):
                out.append(Violation(
                    "conservation", f"{where}: zone arity mismatch"))
                continue
            for z, (e, p) in enumerate(zip(row.energy_uj, row.power_uw)):
                if not _close(e, p * row.dt):
                    out.append(Violation(
                        "conservation",
                        f"{where} zone={z}: energy {e:.1f} uJ != power "
                        f"{p:.1f} uW x dt {row.dt:.3f} s"))
            if row.emitted_energy_uj is not None:
                for z, (e, g) in enumerate(
                        zip(row.energy_uj, row.emitted_energy_uj)):
                    if not _close(e, g):
                        out.append(Violation(
                            "conservation",
                            f"{where} zone={z}: published {e:.1f} uJ != "
                            f"emitted {g:.1f} uJ"))
            if row.usage_ratio is not None and row.wl_power_sum_uw:
                for z, (s, p) in enumerate(
                        zip(row.wl_power_sum_uw, row.power_uw)):
                    want = p * row.usage_ratio
                    if not _close(s, want):
                        out.append(Violation(
                            "conservation",
                            f"{where} zone={z}: workload plane sums to "
                            f"{s:.1f} uW, node envelope gives "
                            f"{want:.1f} uW"))
    return out


def check_no_fabricated_loss(rec: RunRecord) -> list[Violation]:
    total = sum(int(s.get("windows_lost_total", 0))
                for s in rec.stats.values())
    if total > rec.abandoned_windows:
        return [Violation(
            "loss",
            f"windows_lost_total={total} across all replica "
            f"incarnations, but agents only abandoned "
            f"{rec.abandoned_windows} windows")]
    return []


def check_no_duplicates(rec: RunRecord) -> list[Violation]:
    out: list[Violation] = []
    owners: dict[tuple[int, str], str] = {}
    for wr in rec.windows:
        for row in wr.rows:
            key = (wr.win, row.node)
            prev = owners.get(key)
            if prev is not None and prev != wr.replica:
                out.append(Violation(
                    "duplicates",
                    f"win={wr.win} node={row.node} published by both "
                    f"{prev} and {wr.replica}"))
            owners[key] = wr.replica
            if len(set(row.wl_ids)) != len(row.wl_ids):
                out.append(Violation(
                    "duplicates",
                    f"win={wr.win} replica={wr.replica} "
                    f"node={row.node}: repeated workload id"))
    return out


def check_ladder(rec: RunRecord) -> list[Violation]:
    out: list[Violation] = []
    for replica, timeline in rec.timelines.items():
        for entry in timeline:
            rung = int(entry.get("rung", -1))        # type: ignore[arg-type]
            from_rung = int(entry.get("from_rung", -1))  # type: ignore[arg-type]
            reason = str(entry.get("reason", ""))
            where = (f"{replica}: {entry.get('from_rung_name')} -> "
                     f"{entry.get('rung_name')} ({reason})")
            if reason == "repromoted":
                if rung != from_rung - 1:
                    out.append(Violation(
                        "ladder",
                        f"{where}: repromotion must climb exactly one "
                        f"rung"))
                clean = int(entry.get("windows_at_prev_rung", 0))  # type: ignore[arg-type]
                if clean < rec.repromote_after:
                    out.append(Violation(
                        "ladder",
                        f"{where}: repromoted after {clean} clean "
                        f"windows < repromote_after="
                        f"{rec.repromote_after}"))
            else:
                if reason not in DEMOTION_REASONS:
                    out.append(Violation(
                        "ladder", f"{where}: unknown transition reason"))
                if rung != from_rung + 1:
                    out.append(Violation(
                        "ladder",
                        f"{where}: demotion must drop exactly one rung"))
    return out


def check_convergence(rec: RunRecord) -> list[Violation]:
    out: list[Violation] = []
    # member replicas = live replicas that appear in their own ring
    members = {r: v for r, v in rec.membership.items()
               if r in rec.alive and r in v.peers}
    if not members:
        out.append(Violation("convergence", "no live member replicas"))
        return out
    views = {(v.epoch, tuple(sorted(v.peers)), v.holder)
             for v in members.values()}
    if len(views) > 1:
        out.append(Violation(
            "convergence",
            f"member views diverge: "
            f"{sorted(str(v) for v in views)}"))
    for replica, view in sorted(members.items()):
        if view.holder not in view.peers:
            out.append(Violation(
                "convergence",
                f"{replica}: lease holder {view.holder} is not a ring "
                f"member"))
        elif view.holder not in rec.alive:
            out.append(Violation(
                "convergence",
                f"{replica}: lease holder {view.holder} is dead"))
        if not rec.health_ok.get(replica, False):
            out.append(Violation(
                "convergence", f"{replica}: health probe still red "
                f"after cooldown"))
        if not rec.window_health_ok.get(replica, False):
            out.append(Violation(
                "convergence", f"{replica}: window health still red "
                f"after cooldown"))
    for agent, backlog in sorted(rec.pending.items()):
        if backlog:
            out.append(Violation(
                "convergence",
                f"agent {agent} still holds {backlog} undelivered "
                f"windows"))
    return out


def _hlc_of(entry: Mapping[str, object]) -> tuple[int, int, str]:
    h = entry.get("hlc")
    if not isinstance(h, Mapping):
        return (0, 0, "")
    return (int(h.get("phys_us", 0)),    # type: ignore[arg-type]
            int(h.get("logical", 0)),    # type: ignore[arg-type]
            str(h.get("node", "")))


def _op_evidence(op: Mapping[str, object],
                 entry: Mapping[str, object]) -> bool:
    """Does one journal event witness one schedule op?"""
    kind = str(entry.get("kind", ""))
    fields = entry.get("fields")
    fields = fields if isinstance(fields, Mapping) else {}
    peer = str(op.get("peer", ""))
    epoch_before = int(op.get("epoch_before", 0))  # type: ignore[arg-type]
    name = str(op.get("op", ""))
    if name == "autoscale":
        return (kind == "autoscale.enact"
                and int(fields.get("epoch", 0)) > epoch_before)  # type: ignore[arg-type]
    if kind != "membership.apply":
        return False
    peers = fields.get("peers")
    peers = list(peers) if isinstance(peers, (list, tuple)) else []
    epoch = int(fields.get("epoch", 0))  # type: ignore[arg-type]
    if name == "kill":
        # the survivors' succession apply: peer gone, epoch advanced
        return peer not in peers and epoch > epoch_before
    if name in ("restart", "join"):
        return peer in peers
    if name == "leave":
        return peer not in peers and epoch > epoch_before
    return False


def check_journal_vs_schedule(rec: RunRecord) -> list[Violation]:
    """Invariant 6: merged-journal completeness against the conductor's
    ground-truth op log, per-node HLC monotonicity, and no HLC stamp
    that predates the virtual-clock time of the op it witnesses."""
    out: list[Violation] = []
    merged: list[Mapping[str, object]] = []
    for inc in sorted(rec.journals):
        entries = list(rec.journals[inc])
        merged.extend(entries)
        # (a) strictly HLC-increasing within one incarnation's journal
        for prev, cur in zip(entries, entries[1:]):
            if _hlc_of(cur) <= _hlc_of(prev):
                out.append(Violation(
                    "journal",
                    f"{inc}: journal not strictly HLC-increasing at "
                    f"{_hlc_of(prev)} -> {_hlc_of(cur)}"))
    if not rec.schedule_ops:
        return out
    if not merged:
        out.append(Violation(
            "journal",
            f"{len(rec.schedule_ops)} schedule op(s) with certain "
            f"effects but the merged journal is empty"))
        return out
    for op in rec.schedule_ops:
        t_us = int(op.get("t_us", 0))  # type: ignore[arg-type]
        witnesses = [e for e in merged if _op_evidence(op, e)]
        label = (f"op={op.get('op')} peer={op.get('peer')} "
                 f"t_us={t_us} epoch_before={op.get('epoch_before')}")
        if not witnesses:
            out.append(Violation(
                "journal",
                f"schedule {label}: no witnessing event in the merged "
                f"journal"))
            continue
        # (b) causal order vs the conductor's virtual clock: at least
        # one witness must be stamped AT or AFTER the op happened — a
        # journal whose every witness precedes its cause is lying
        if all(_hlc_of(e)[0] < t_us for e in witnesses):
            stamps = sorted(_hlc_of(e)[0] for e in witnesses)
            out.append(Violation(
                "journal",
                f"schedule {label}: every witnessing event is stamped "
                f"before the op's virtual time ({stamps[-1]} < {t_us})"))
    return out


def check_all(rec: RunRecord) -> list[Violation]:
    return (check_conservation(rec)
            + check_no_fabricated_loss(rec)
            + check_no_duplicates(rec)
            + check_ladder(rec)
            + check_convergence(rec)
            + check_journal_vs_schedule(rec))
