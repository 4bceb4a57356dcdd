"""kepchaos conductor: drive a schedule against the fleet, judge it.

One :func:`run_schedule` call builds a fresh fleet + agents, arms the
schedule's fault events on a virtual-clock ``FaultPlan``, executes its
op events at their window indices, records every observable into a
:class:`Trace`, assembles the :class:`RunRecord`, and returns the
invariant verdicts. :func:`run_many` iterates schedule indices from one
seed; on the first red verdict it delta-debugs the schedule down to a
minimal failing subsequence (:func:`shrink`) and attaches copy-paste
repro commands for both the full and the shrunk key.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Sequence

from kepler_tpu_torch import fault
from kepler_tpu_torch.chaos.harness import ChaosAgent, ChaosConfig, ChaosFleet
from kepler_tpu_torch.chaos.invariants import MembershipView, RowRecord, \
    RunRecord, Violation, WindowRecord, check_all
from kepler_tpu_torch.chaos.schedule import Schedule, compile_fault_specs, \
    ddmin, generate
from kepler_tpu_torch.chaos.trace import Trace, digest_rows
from kepler_tpu_torch.fault import FaultPlan

# stats keys worth pinning in the trace (all integer counters)
_STAT_KEYS = ("reports_total", "rejected_total", "quarantined_total",
              "malformed_total", "clock_skew_total", "duplicates_total",
              "windows_lost_total")


@dataclass
class RunResult:
    schedule: Schedule
    violations: list[Violation]
    trace: Trace
    trace_hash: str
    record: RunRecord
    windows_published: int
    fault_fires: dict[str, int] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.violations


def _ops_by_window(schedule: Schedule) -> dict[int, list]:
    out: dict[int, list] = {}
    for ev in schedule.events:
        if ev.kind != "fault":
            out.setdefault(ev.at, []).append(ev)
    return out


def _execute_op(fleet: ChaosFleet, ev: Any, trace: Trace) -> None:
    if ev.kind == "kill":
        done = fleet.kill(ev.target)
    elif ev.kind == "restart":
        done = fleet.restart(ev.target)
    elif ev.kind == "join":
        done = fleet.join_op(ev.target)
    elif ev.kind == "leave":
        done = fleet.leave(ev.target)
    elif ev.kind == "autoscale_up":
        done = fleet.autoscale(up=True)
    else:   # autoscale_down
        done = fleet.autoscale(up=False)
    if not done:
        trace.emit("op_skipped", op=ev.kind, target=ev.target,
                   t=fleet.clock())


def _match_emitted(ledger_node: dict[int, dict[str, Any]],
                   energy: list[float]
                   ) -> tuple[list[float] | None, float | None]:
    """Find the emitted window whose masked zone energy best matches a
    published row; returns (emitted energy, its usage ratio). The
    conservation checker judges the match — a published row that
    matches nothing the agent ever emitted fails loudly."""
    best_key: tuple[float, int] | None = None
    best: tuple[list[float] | None, float | None] = (None, None)
    for win, entry in ledger_node.items():
        emitted = entry["energy"]
        err = sum((a - b) * (a - b) for a, b in zip(energy, emitted))
        key = (err, win)
        if best_key is None or key < best_key:
            best_key = key
            best = (list(emitted), float(entry["ratio"]))
    return best


def run_schedule(schedule: Schedule, cfg: ChaosConfig | None = None
                 ) -> RunResult:
    cfg = cfg or ChaosConfig()
    trace = Trace()
    trace.emit("schedule", seed=schedule.seed, index=schedule.index,
               events=[e.to_dict() for e in schedule.events],
               keep=list(schedule.keep))
    fleet = ChaosFleet(cfg, trace)
    agents = [ChaosAgent(f"cn{i:02d}", schedule.seed, fleet.endpoints,
                         cfg) for i in range(cfg.agents)]
    # agent name -> win -> {"energy": canonical masked uJ, "ratio": r}
    ledger: dict[str, dict[int, dict[str, Any]]] = {}
    plan = FaultPlan(compile_fault_specs(schedule.events, cfg.interval),
                     seed=schedule.seed * 1_000_003 + schedule.index,
                     clock=fleet.clock)
    ops = _ops_by_window(schedule)
    windows: list[WindowRecord] = []
    try:
        with fault.installed(plan):
            for win in range(1, cfg.total_windows + 1):
                fleet.ticks[0] += cfg.interval
                now = fleet.clock()
                for ev in ops.get(win - 1, ()):
                    _execute_op(fleet, ev, trace)
                fleet.succession_tick()
                for agent in agents:
                    agent.emit(win, ledger)
                for agent in agents:
                    agent.drain(fleet, now, trace)
                for peer in sorted(fleet.alive):
                    res = fleet.aggs[peer].aggregate_once()
                    if res is None or not res.names:
                        continue
                    wr = _window_record(peer, win, res, ledger)
                    windows.append(wr)
                    trace.emit(
                        "publish", replica=peer, win=win,
                        names=sorted(res.names),
                        digest=digest_rows([_row_dict(r)
                                            for r in wr.rows]))
        record = _assemble(fleet, agents, windows, cfg)
        record_final_trace(trace, fleet, record, plan)
        violations = check_all(record)
        trace.emit("verdict",
                   violations=[str(v) for v in violations])
        return RunResult(schedule=schedule, violations=violations,
                         trace=trace, trace_hash=trace.hash(),
                         record=record,
                         windows_published=len(windows),
                         fault_fires=dict(plan.fires))
    finally:
        fleet.shutdown()


def _row_dict(row: RowRecord) -> dict[str, Any]:
    return {"node": row.node, "dt": row.dt,
            "energy_uj": list(row.energy_uj),
            "power_uw": list(row.power_uw),
            "wl_sum_uw": list(row.wl_power_sum_uw),
            "wl_ids": list(row.wl_ids)}


def _window_record(peer: str, win: int, res: Any,
                   ledger: dict[str, dict[int, dict[str, Any]]]
                   ) -> WindowRecord:
    rows: list[RowRecord] = []
    for name in sorted(res.rows):
        i = res.rows[name]
        w = int(res.counts[i])
        energy = [float(x) for x in res.node_energy_uj[i]]
        power = [float(x) for x in res.node_power_uw[i]]
        wl_sum = [float(x)
                  for x in res.wl_power_uw[i, :w].sum(axis=0)]
        emitted, ratio = _match_emitted(ledger.get(name, {}), energy)
        rows.append(RowRecord(
            node=name, dt=float(res.dt[i]),
            energy_uj=tuple(energy), power_uw=tuple(power),
            wl_power_sum_uw=tuple(wl_sum),
            wl_ids=tuple(res.workload_ids[i]),
            usage_ratio=ratio,
            emitted_energy_uj=(None if emitted is None
                               else tuple(emitted))))
    return WindowRecord(replica=peer, win=win, rows=rows)


def _assemble(fleet: ChaosFleet, agents: list[ChaosAgent],
              windows: list[WindowRecord], cfg: ChaosConfig
              ) -> RunRecord:
    stats: dict[str, dict[str, int]] = dict(fleet.retired_stats)
    timelines: dict[str, list[dict[str, Any]]] = {
        k: list(v) for k, v in fleet.retired_timelines.items()}
    journals: dict[str, list[dict[str, Any]]] = {
        k: list(v) for k, v in fleet.retired_journals.items()}
    membership: dict[str, MembershipView] = {}
    health_ok: dict[str, bool] = {}
    window_health_ok: dict[str, bool] = {}
    for peer in sorted(fleet.alive):
        agg = fleet.aggs[peer]
        stats[fleet.incarnation(peer)] = dict(agg._stats)
        timelines[fleet.incarnation(peer)] = [
            dict(e) for e in agg._rung_timeline]
        journals[fleet.incarnation(peer)] = agg._journal.snapshot()
        ring = agg._ring
        lease = agg._lease
        if ring is not None:
            membership[peer] = MembershipView(
                epoch=int(ring.epoch), peers=tuple(ring.peers),
                holder=str(lease.holder) if lease is not None else "")
        health_ok[peer] = bool(agg.health().get("ok"))
        window_health_ok[peer] = bool(agg.window_health().get("ok"))
    return RunRecord(
        windows=windows, stats=stats,
        timelines={k: _clean_timeline(v) for k, v in timelines.items()},
        repromote_after=cfg.repromote_after,
        abandoned_windows=0,
        membership=membership, alive=frozenset(fleet.alive),
        health_ok=health_ok, window_health_ok=window_health_ok,
        pending={a.name: len(a.pending) for a in agents},
        journals=journals, schedule_ops=list(fleet.op_log))


def _clean_timeline(timeline: list[dict[str, Any]]
                    ) -> list[dict[str, Any]]:
    """Strip wall-clock fields so records (and the trace) stay replay-
    stable; the ladder checker only needs the transition shape."""
    keep = ("rung", "rung_name", "from_rung", "from_rung_name",
            "reason", "windows_at_prev_rung")
    return [{k: e[k] for k in keep if k in e} for e in timeline]


def record_final_trace(trace: Trace, fleet: ChaosFleet,
                       record: RunRecord, plan: FaultPlan) -> None:
    trace.emit(
        "final",
        t=fleet.clock(),
        alive=sorted(record.alive),
        membership={p: {"epoch": v.epoch, "peers": list(v.peers),
                        "holder": v.holder}
                    for p, v in sorted(record.membership.items())},
        stats={inc: {k: int(s.get(k, 0)) for k in _STAT_KEYS}
               for inc, s in sorted(record.stats.items())},
        timelines={inc: list(tl)
                   for inc, tl in sorted(record.timelines.items())},
        pending=dict(sorted(record.pending.items())),
        fault_fires=dict(sorted(plan.fires.items())))


def _sum_fires(results: Sequence[RunResult]) -> dict[str, int]:
    total: dict[str, int] = {}
    for r in results:
        for site, n in r.fault_fires.items():
            total[site] = total.get(site, 0) + int(n)
    return dict(sorted(total.items()))


def repro_command(schedule: Schedule, device: str = "cuda",
                  shards: int = 8) -> str:
    cmd = (f"python -m kepler_tpu_torch.chaos --seed {schedule.seed} "
           f"--schedule {schedule.index}")
    if schedule.keep:
        cmd += " --keep " + ",".join(str(k) for k in schedule.keep)
    if device != "cuda":
        cmd += f" --device {device}"
    if shards != 8:
        cmd += f" --shards {shards}"
    return cmd


def shrink(schedule: Schedule, cfg: ChaosConfig | None = None
           ) -> tuple[Schedule, int]:
    """Delta-debug a failing schedule to a 1-minimal failing event
    subsequence. Returns (shrunk schedule, number of replay runs)."""
    cfg = cfg or ChaosConfig()
    runs = 0

    def fails(keep: Sequence[int]) -> bool:
        nonlocal runs
        runs += 1
        return not run_schedule(schedule.subset(keep), cfg).ok

    minimal = ddmin(range(len(schedule.events)), fails)
    return schedule.subset(minimal), runs


@dataclass
class ChaosReport:
    """Aggregate verdict for a ``run_many`` sweep (the CHAOS_*.json
    artifact shape)."""

    seed: int
    requested: int
    device: str = "cuda"       # where the sweep ran (for the repro)
    results: list[RunResult] = field(default_factory=list)
    failure: RunResult | None = None
    shrunk: Schedule | None = None
    shrink_runs: int = 0

    @property
    def ok(self) -> bool:
        return self.failure is None

    def to_artifact(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "seed": self.seed,
            "schedules_requested": self.requested,
            "schedules_run": len(self.results),
            "events_total": sum(len(r.schedule.events)
                                for r in self.results),
            "windows_published": sum(r.windows_published
                                     for r in self.results),
            "fault_fires": _sum_fires(self.results),
            "verdicts": {
                "green": sum(1 for r in self.results if r.ok),
                "red": sum(1 for r in self.results if not r.ok)},
            "trace_hashes": {str(r.schedule.index): r.trace_hash
                             for r in self.results},
        }
        if self.failure is not None:
            fail: dict[str, Any] = {
                "index": self.failure.schedule.index,
                "violations": [str(v) for v in self.failure.violations],
                "repro": repro_command(self.failure.schedule,
                                       self.device)}
            if self.shrunk is not None:
                fail["shrunk_events"] = len(self.shrunk.events)
                fail["shrink_runs"] = self.shrink_runs
                fail["repro_shrunk"] = repro_command(self.shrunk,
                                                     self.device)
            out["failure"] = fail
        return out


def run_many(seed: int, count: int, cfg: ChaosConfig | None = None,
             *, do_shrink: bool = True, start: int = 0) -> ChaosReport:
    cfg = cfg or ChaosConfig()
    members = [f"10.99.0.{i + 1}:28283" for i in range(cfg.replicas)]
    standbys = [f"10.99.0.{i + 1}:28283"
                for i in range(cfg.replicas,
                               cfg.replicas + cfg.standbys)]
    report = ChaosReport(seed=seed, requested=count, device=cfg.device)
    for index in range(start, start + count):
        schedule = generate(seed, index, horizon=cfg.horizon,
                            members=members, standbys=standbys)
        result = run_schedule(schedule, cfg)
        report.results.append(result)
        if not result.ok:
            report.failure = result
            if do_shrink:
                report.shrunk, report.shrink_runs = shrink(schedule, cfg)
            break
    return report
