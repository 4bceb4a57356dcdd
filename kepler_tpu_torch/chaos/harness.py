"""kepchaos harness: a real in-process fleet under conductor control.

No protocol logic is mocked. The fleet is real ``Aggregator`` replicas
(window engines included, ``model_mode=None`` so no trained model is
needed) wired through the same injected seams production uses: the
``membership_topology`` seam for peer probes and membership delivery,
the ``clock`` seam for all time. Agents speak the real v2 wire format
through ``Aggregator._handle_report`` — the same entry the HTTP server
calls — and consult the real ``fault.fire`` sites on their send path,
mirroring ``kepler_tpu_torch.fleet.agent`` behavior (failover rotation,
421-redirect following, 429 throttle obedience, ``acked_through``
stamping) in a deterministically schedulable form.

Determinism rules (the trace-hash pin depends on them):

- all time is the fleet's virtual clock; nothing reads the wall clock;
- all report content derives from ``crc32(f"{seed}:{name}:{win}")`` —
  never builtin ``hash``, which CPython salts per process;
- every iteration over replicas/agents is in sorted order.
"""

from __future__ import annotations

import json
import zlib
from collections import deque
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from kepler_tpu_torch import fault
from kepler_tpu_torch.chaos.trace import Trace
from kepler_tpu_torch.fleet import wire
from kepler_tpu_torch.fleet.aggregator import Aggregator
from kepler_tpu_torch.fleet.journal import EventJournal
from kepler_tpu_torch.parallel.fleet import MODE_RATIO, NodeReport
from kepler_tpu_torch.parallel.mesh import make_mesh
from kepler_tpu_torch.server.http import APIServer

ZONES: tuple[str, ...] = ("package", "dram")
# published windows carry zones in sorted order — precompute the
# permutation so the emission ledger matches row-for-row
_CANON = tuple(int(i) for i in np.argsort(np.array(ZONES)))


class _Req:
    """Stand-in for the HTTP handler's request object (same shape the
    membership/report tests use)."""

    command = "POST"

    def __init__(self, body: bytes) -> None:
        self.body = body


def content_rng(seed: int, name: str, win: int) -> np.random.Generator:
    """Per-(agent, window) content stream, stable across processes."""
    key = zlib.crc32(f"{seed}:{name}:{win}".encode())
    return np.random.default_rng(key)


@dataclass
class ChaosConfig:
    """Harness shape knobs. Defaults are sized so one schedule (horizon
    + cooldown windows) runs in well under a second of wall time after
    the per-replica warm-up compiles."""

    replicas: int = 3
    standbys: int = 1
    agents: int = 4
    workloads: int = 3
    interval: float = 5.0          # virtual seconds per window
    horizon: int = 12              # windows with faults/ops scheduled
    cooldown: int = 12             # clean windows before convergence
    repromote_after: int = 1
    attempts_per_tick: int = 8     # agent send attempts per window
    # the port's rule for entry points: the card unless the caller asks
    # for the CPU; the Aggregator raises when CUDA is absent
    device: str = "cuda"
    # the Aggregator's window backend: "einsum" is the reference's
    # harness default, "pallas" launches the hand-written kernels
    backend: str = "einsum"
    # virtual shards of `device` each replica's mesh holds: the
    # reference's sweep runs on 8 forced host devices, so rung 0 is the
    # sharded engine there and here alike (the trace hashes pin it)
    shards: int = 8

    @property
    def degraded_ttl(self) -> float:
        # quarantine flags must decay within the cooldown
        return self.interval * max(2, self.cooldown // 3)

    @property
    def total_windows(self) -> int:
        return self.horizon + self.cooldown


class ChaosAgent:
    """A deterministic stand-in for ``fleet.agent``: emits one report
    per window into an ordered pending queue and drains it against the
    fleet, consulting the real fault sites the production agent does.
    Pending windows are never abandoned, so any ``windows_lost_total``
    the servers count is fabricated by definition."""

    def __init__(self, name: str, seed: int, endpoints: list[str],
                 cfg: ChaosConfig) -> None:
        self.name = name
        self.seed = seed
        self.cfg = cfg
        self.run = f"chaos-{seed}"
        self.endpoints = list(endpoints)
        self._cursor = zlib.crc32(name.encode()) % len(endpoints)
        self.target = endpoints[self._cursor]
        self.pending: deque[tuple[int, NodeReport]] = deque()
        self.acked_through = 0

    def _rotate(self) -> None:
        self._cursor = (self._cursor + 1) % len(self.endpoints)
        self.target = self.endpoints[self._cursor]

    def emit(self, win: int,
             ledger: dict[str, dict[int, dict[str, Any]]]) -> None:
        rng = content_rng(self.seed, self.name, win)
        w = self.cfg.workloads
        cpu = rng.uniform(0.1, 5.0, w).astype(np.float32)
        deltas = rng.uniform(1e7, 5e8, len(ZONES)).astype(np.float32)
        ratio = float(rng.uniform(0.2, 0.9))
        valid = np.ones(len(ZONES), bool)
        spec = fault.fire("device.read_error")
        if spec is not None:
            valid[int(spec.arg or 0) % len(ZONES)] = False
        report = NodeReport(
            node_name=self.name,
            zone_deltas_uj=deltas,
            zone_valid=valid,
            usage_ratio=ratio,
            cpu_deltas=cpu,
            workload_ids=[f"{self.name}-w{k}" for k in range(w)],
            node_cpu_delta=float(cpu.sum()),
            dt_s=self.cfg.interval,
            mode=MODE_RATIO,
            workload_kinds=np.ones(w, np.int8))
        masked = np.where(valid, deltas, 0.0)
        ledger.setdefault(self.name, {})[win] = {
            "energy": [float(masked[i]) for i in _CANON],
            "ratio": ratio}
        self.pending.append((win, report))

    def drain(self, fleet: "ChaosFleet", now: float, trace: Trace
              ) -> None:
        budget = self.cfg.attempts_per_tick
        while self.pending and budget > 0:
            budget -= 1
            seq, report = self.pending[0]
            outcome = self._attempt(fleet, now, seq, report, trace)
            if outcome == "acked":
                self.pending.popleft()
                self.acked_through = seq
            elif outcome == "stop":
                break
            # "retry": loop again against the (possibly rotated) target

    def _attempt(self, fleet: "ChaosFleet", now: float, seq: int,
                 report: NodeReport, trace: Trace) -> str:
        if fault.fire("net.refuse") is not None:
            trace.emit("send", agent=self.name, seq=seq, out="refused")
            self._rotate()
            return "stop"
        spec = fault.fire("net.throttle")
        if spec is not None:
            # the production agent honors Retry-After: no failover, no
            # breaker — just back off until the next window
            trace.emit("send", agent=self.name, seq=seq, out="throttled")
            return "stop"
        sent_at = now
        spec = fault.fire("report.clock_skew")
        if spec is not None:
            sent_at += spec.arg if spec.arg is not None else 300.0
        data = wire.encode_report_v2(
            report, list(ZONES), seq=seq, run=self.run, sent_at=sent_at)
        data = wire.restamp_transmit(
            data, sent_at=sent_at, acked_through=self.acked_through)
        if fault.fire("net.corrupt_body") is not None:
            data = data[:max(8, len(data) // 2)]
        target = self.target
        result = fleet.post_report(target, data)
        if result is None:   # connection refused: peer is down
            trace.emit("send", agent=self.name, seq=seq, out="down",
                       target=target)
            self._rotate()
            return "retry"
        status, _, body = result
        if fault.fire("net.partition") is not None:
            # delivered, but the response is lost: the agent keeps the
            # window pending and re-sends — dedup must absorb it
            trace.emit("send", agent=self.name, seq=seq,
                       out="partitioned", status=status, target=target)
            return "retry"
        trace.emit("send", agent=self.name, seq=seq, out=status,
                   target=target)
        if status == 204:
            return "acked"
        if status == 421:
            try:
                owner = json.loads(body).get("owner", "")
            except Exception:
                owner = ""
            if owner and owner in self.endpoints:
                self.target = owner
                self._cursor = self.endpoints.index(owner)
            else:
                self._rotate()
            return "retry"
        if status == 503:
            self._rotate()
            return "stop"
        if status == 429:
            return "stop"
        # 400/422/409: this attempt is burned (quarantine counted
        # server-side); the window stays pending for the next tick
        return "stop"


class _StubAdmission:
    """Feeds ``_autoscale_tick`` a fixed load signal (same shape as the
    membership tests' stub) so autoscale ops are deterministic."""

    def __init__(self, load: float) -> None:
        self._load = load

    def load(self) -> float:
        return self._load

    def shed_by_reason(self) -> dict[str, int]:
        return {}

    def latency_ewma(self) -> float:
        return 0.0


class ChaosFleet:
    """Replicated aggregators + membership seams + conductor ops."""

    def __init__(self, cfg: ChaosConfig, trace: Trace) -> None:
        self.cfg = cfg
        self.trace = trace
        self.ticks = [1e9]
        base = [f"10.99.0.{i + 1}:28283"
                for i in range(cfg.replicas + cfg.standbys)]
        self.members0 = base[:cfg.replicas]
        self.standby_peers = base[cfg.replicas:]
        self.endpoints = list(base)
        self.alive: set[str] = set()
        self.aggs: dict[str, Aggregator] = {}
        # counter/timeline snapshots from replicas at kill time, keyed
        # by incarnation ("peer#generation")
        self.retired_stats: dict[str, dict[str, int]] = {}
        self.retired_timelines: dict[str, list[dict[str, Any]]] = {}
        self.retired_journals: dict[str, list[dict[str, Any]]] = {}
        # ground truth for invariant 6: schedule ops whose fleet effect
        # is CERTAIN (a kill is only certain once a succession tick saw
        # the peer still dead; a restart/join only when it actually
        # re-registers an absent peer; autoscale only on an epoch bump)
        self.op_log: list[dict[str, Any]] = []
        self._pending_kills: list[dict[str, Any]] = []
        self._generation: dict[str, int] = {}
        for peer in self.members0:
            self._spawn(peer, self.members0)

    # -- seams ------------------------------------------------------------

    def clock(self) -> float:
        return self.ticks[0]

    def _peer_alive(self, peer: str) -> bool:
        return peer in self.alive

    def _deliver(self, target: str, payload: dict) -> dict:
        if target not in self.alive:
            raise OSError(f"connection refused: {target}")
        status, _, body = self.aggs[target]._handle_membership(
            _Req(json.dumps(payload).encode()))
        del status
        return json.loads(body)

    def post_report(self, target: str, data: bytes
                    ) -> tuple[int, dict, bytes] | None:
        if target not in self.alive:
            return None
        return self.aggs[target]._handle_report(_Req(data))

    # -- lifecycle --------------------------------------------------------

    def _spawn(self, peer: str, ring_hint: list[str]) -> Aggregator:
        agg = Aggregator(
            APIServer(),
            peers=sorted(set(ring_hint) | {peer}),
            self_peer=peer,
            model_mode=None,
            backend=self.cfg.backend,
            device=self.cfg.device,
            mesh=make_mesh([self.cfg.shards],
                           devices=[self.cfg.device] * self.cfg.shards),
            node_bucket=8,
            workload_bucket=8,
            stale_after=1e9,
            pipeline_depth=1,
            repromote_after=self.cfg.repromote_after,
            degraded_ttl=self.cfg.degraded_ttl,
            dispatch_timeout=120.0,
            clock=self.clock,
            membership_topology={"peer_alive": self._peer_alive,
                                 "deliver": self._deliver},
            # autoscale stays DISARMED between ops: the per-window tick
            # with no admission controller reads load 0.0, which with
            # autoApply would scale the fleet down on its own — the
            # conductor installs a policy only for commanded ticks
            membership_autoscale=False,
            membership_auto_apply=True,
            membership_standby_peers=list(self.standby_peers),
            # black-box journal on the fleet's virtual clock: HLC stamps
            # derive from self.clock, so the merged timeline is as
            # replay-stable as the trace
            journal=EventJournal(enabled=True, node=peer,
                                 clock=self.clock))
        agg.init()
        self.aggs[peer] = agg
        self.alive.add(peer)
        self.trace.emit("spawn", peer=peer, t=self.clock())
        return agg

    def incarnation(self, peer: str) -> str:
        return f"{peer}#{self._generation.get(peer, 0)}"

    def _now_us(self) -> int:
        return int(self.clock() * 1e6)

    def _member_epoch(self) -> int:
        """Ring epoch in the stable member view (0 when none)."""
        for peer in sorted(self.alive):
            ring = self.aggs[peer]._ring
            if ring is not None and peer in ring.peers:
                return int(ring.epoch)
        return 0

    def kill(self, peer: str) -> bool:
        if peer not in self.alive:
            return False
        members = self.member_peers()
        if peer in members and not [
                m for m in members if m != peer and m in self.alive]:
            return False   # never kill the last live member
        if peer in members:
            # not yet CERTAIN: a restart in this same window would
            # revive the peer before any succession demotes it — the
            # op is sealed into op_log by the next succession tick
            self._pending_kills.append({
                "op": "kill", "peer": peer, "t_us": self._now_us(),
                "epoch_before": self._member_epoch()})
        agg = self.aggs[peer]
        self.retired_stats[self.incarnation(peer)] = dict(agg._stats)
        self.retired_timelines[self.incarnation(peer)] = [
            dict(e) for e in agg._rung_timeline]
        self.retired_journals[self.incarnation(peer)] = \
            agg._journal.snapshot()
        self.alive.discard(peer)
        agg.shutdown()
        del self.aggs[peer]
        self._generation[peer] = self._generation.get(peer, 0) + 1
        self.trace.emit("kill", peer=peer, t=self.clock())
        return True

    def restart(self, peer: str) -> bool:
        if peer in self.alive:
            return False
        hint = self.member_peers() or list(self.members0)
        # a revive before the succession tick voids any pending kill:
        # the excluding succession apply it would witness never happens
        self._pending_kills = [
            op for op in self._pending_kills if op["peer"] != peer]
        was_member = peer in self.member_peers()
        epoch_before = self._member_epoch()
        agg = self._spawn(peer, hint)
        try:
            agg.request_join()
            self.trace.emit("join", peer=peer, t=self.clock(), ok=True)
            if not was_member:
                # certain: registering an absent peer forces a
                # membership apply that names it
                self.op_log.append({
                    "op": "restart", "peer": peer,
                    "t_us": self._now_us(),
                    "epoch_before": epoch_before})
            return True
        except Exception as err:
            self.trace.emit("join", peer=peer, t=self.clock(), ok=False,
                            reason=type(err).__name__)
            return False

    def join_op(self, peer: str) -> bool:
        """Join semantics for every starting state: dead peer -> spawn
        and register; live retired peer (left earlier) -> re-register;
        live member -> no-op."""
        if peer not in self.alive:
            return self.restart(peer)
        agg = self.aggs[peer]
        ring = agg._ring
        if ring is not None and peer in ring.peers:
            return False
        was_member = peer in self.member_peers()
        epoch_before = self._member_epoch()
        try:
            agg.request_join()
            self.trace.emit("join", peer=peer, t=self.clock(), ok=True)
            if not was_member:
                self.op_log.append({
                    "op": "join", "peer": peer, "t_us": self._now_us(),
                    "epoch_before": epoch_before})
            return True
        except Exception as err:
            self.trace.emit("join", peer=peer, t=self.clock(), ok=False,
                            reason=type(err).__name__)
            return False

    def leave(self, peer: str) -> bool:
        members = self.member_peers()
        if peer not in members or len(members) <= 1:
            return False
        start = sorted(m for m in members if m in self.alive)
        if not start:
            return False
        epoch_before = self._member_epoch()
        target = start[0]
        for _ in range(len(members) + 2):
            try:
                reply = self._deliver(target,
                                      {"op": "leave", "peer": peer})
            except OSError:
                break
            if reply.get("reason") == "not_leader":
                nxt = reply.get("holder", "")
                if not nxt or nxt == target or nxt not in self.alive:
                    break
                target = nxt
                continue
            self.trace.emit("leave", peer=peer, via=target,
                            ok=bool(reply.get("ok")), t=self.clock())
            if reply.get("ok"):
                # certain: an ok reply means the leader applied the
                # excluding membership with an epoch bump
                self.op_log.append({
                    "op": "leave", "peer": peer, "t_us": self._now_us(),
                    "epoch_before": epoch_before})
                # a dead member leaving is the same excluding apply a
                # pending kill of THAT peer is waiting on: certain now
                self.op_log.extend(op for op in self._pending_kills
                                   if op["peer"] == peer)
                self._pending_kills = [op for op in self._pending_kills
                                       if op["peer"] != peer]
            return bool(reply.get("ok"))
        self.trace.emit("leave", peer=peer, ok=False, t=self.clock())
        return False

    def autoscale(self, up: bool) -> bool:
        from kepler_tpu_torch.fleet.membership import AutoscalePolicy

        holder = self.current_holder()
        if not holder or holder not in self.alive:
            return False
        agg = self.aggs[holder]
        epoch_before = int(agg._ring.epoch)
        agg._admission = _StubAdmission(2.0 if up else 0.0)
        agg._autoscale = AutoscalePolicy(up_windows=1, down_windows=1)
        try:
            agg._autoscale_tick()
        finally:
            agg._admission = None
            agg._autoscale = None
        self.trace.emit("autoscale", direction="up" if up else "down",
                        holder=holder, t=self.clock(),
                        epoch=agg._ring.epoch)
        if int(agg._ring.epoch) > epoch_before:
            # certain only when the tick actually enacted a scale (at
            # the replica floor/ceiling nothing changes)
            self.op_log.append({
                "op": "autoscale", "peer": "", "t_us": self._now_us(),
                "epoch_before": epoch_before})
        if up:
            # the autoscaler "provisioned" the promoted standby: give
            # any member peer without a live process one, and have it
            # register to adopt the incumbent lease
            for peer in sorted(agg._ring.peers):
                if peer not in self.alive:
                    self.restart(peer)
        return True

    # -- views ------------------------------------------------------------

    def member_peers(self) -> list[str]:
        """Membership as seen by live replicas that are members of
        their own ring (the stable view once converged)."""
        for peer in sorted(self.alive):
            ring = self.aggs[peer]._ring
            if ring is not None and peer in ring.peers:
                return list(ring.peers)
        return []

    def current_holder(self) -> str:
        for peer in sorted(self.alive):
            agg = self.aggs[peer]
            ring = agg._ring
            if ring is None or peer not in ring.peers:
                continue
            lease = agg._lease
            if lease is not None and lease.holder:
                return str(lease.holder)
        return ""

    def succession_tick(self) -> None:
        """What the health-probe loop does in production: every live
        member that sees a dead ring peer runs mesh demotion, which
        probes survivors and lets exactly one issuer drive the epoch
        bump + broadcast."""
        if self._pending_kills:
            # a peer still dead at succession time WILL be demoted by
            # this tick (the membership seams are deterministic): the
            # pending kill's fleet effect is certain now
            self.op_log.extend(op for op in self._pending_kills
                               if op["peer"] not in self.alive)
            self._pending_kills.clear()
        for peer in sorted(self.alive):
            agg = self.aggs[peer]
            ring = agg._ring
            if ring is None or peer not in ring.peers:
                continue
            if any(p not in self.alive for p in ring.peers):
                agg._demote_mesh("host_dead")

    def shutdown(self) -> None:
        for peer in sorted(self.aggs):
            self.aggs[peer].shutdown()
        self.aggs.clear()
        self.alive.clear()
