"""Per-node fleet scoreboard: one glanceable health row per node.

Before this module, answering "which of my 1024 agents is unhealthy?"
meant grepping four counters across families (quarantine, seq gaps,
duplicates, staleness) and eyeballing the power gauges for outliers.
The scoreboard synthesizes them into one bounded table the aggregator
updates at ingest time and serves three ways:

- ``GET /debug/fleet`` — the full table as JSON (operator drill-down);
- ``kepler_fleet_node_state{node_name}`` — per-node enum gauge (the
  state code below), cardinality bounded by the LRU cap;
- ``kepler_fleet_scoreboard_nodes{state}`` — the rollup (how many nodes
  in each state), cardinality fixed at ``len(STATE_NAMES)``.

State machine (priority order — a node is its WORST current state):

``quarantined`` (a report was quarantined within ``flag_ttl``) >
``stale`` (no accepted report within ``stale_after``) >
``anomalous`` (reported node power z-scored past ``anomaly_z`` within
``flag_ttl``) > ``lossy`` (a seq gap charged lost windows within
``flag_ttl``) > ``healthy``.

The anomaly flag is a ROLLING z-score over an EWMA mean/variance of the
node's reported power (sum of valid zone deltas / dt): cheap (O(1) per
report, no history buffer) and self-tuning per node, but it flags
CHANGES, not absolutes — a node that boots hot and stays hot reads
healthy, and the first ``min_samples`` reports never flag while the
baseline forms (docs/developer/observability.md "Fleet scoreboard").

This is the read side ROADMAP items 3 (online calibration: which nodes'
ratio labels to trust) and 4 (power-aware actuation: which node to act
on) consume.

Concurrency: NOT internally locked. The owning :class:`Aggregator`
mutates and snapshots the table under its report-store lock, one call
per ingest — the same discipline as its other per-node tables.
"""

from __future__ import annotations

import math

__all__ = ["FleetScoreboard", "STATE_NAMES", "STATE_HEALTHY",
           "STATE_STALE", "STATE_LOSSY", "STATE_ANOMALOUS",
           "STATE_QUARANTINED"]

# enum-gauge codes: 0 is healthy so dashboards can alert on `> 0`, and
# the ordering matches escalation severity
STATE_HEALTHY = 0
STATE_STALE = 1
STATE_LOSSY = 2
STATE_ANOMALOUS = 3
STATE_QUARANTINED = 4
STATE_NAMES = ("healthy", "stale", "lossy", "anomalous", "quarantined")


class _NodeEntry:
    __slots__ = ("last_seen", "reports", "duplicates", "windows_lost",
                 "last_lost_at", "quarantined", "last_quarantine_at",
                 "last_quarantine_reason", "delivery_ewma_s",
                 "delivery_n", "power_w", "power_mean_w", "power_var",
                 "power_n", "last_z", "last_anomaly_at")

    def __init__(self) -> None:
        self.last_seen = 0.0
        self.reports = 0
        self.duplicates = 0
        self.windows_lost = 0
        self.last_lost_at = 0.0
        self.quarantined = 0
        self.last_quarantine_at = 0.0
        self.last_quarantine_reason = ""
        self.delivery_ewma_s = 0.0
        self.delivery_n = 0
        self.power_w = 0.0
        self.power_mean_w = 0.0
        self.power_var = 0.0
        self.power_n = 0
        self.last_z = 0.0
        self.last_anomaly_at = 0.0


class FleetScoreboard:
    """Count-capped LRU table of per-node health state.

    ``cap`` bounds BOTH memory and metric cardinality: the
    least-recently-updated node is evicted beyond it (an evicted node
    that reports again simply restarts its baselines), junk rows that
    never had an accepted report first. Node names come off the wire,
    so they are length-capped too."""

    def __init__(self, cap: int = 1024, anomaly_z: float = 4.0,
                 flag_ttl: float = 60.0, ewma_alpha: float = 0.2,
                 min_samples: int = 8, name_cap: int = 128,
                 junk_cap: int = 64) -> None:
        self._cap = max(1, int(cap))
        self._anomaly_z = max(0.0, float(anomaly_z))
        self._flag_ttl = max(0.0, float(flag_ttl))
        self._alpha = min(1.0, max(1e-3, float(ewma_alpha)))
        self._min_samples = max(2, int(min_samples))
        self._name_cap = max(1, int(name_cap))
        # rows that never had an accepted report are second-class: their
        # count is sub-capped (the same 64 discipline as the
        # aggregator's degraded table) and they expire once their
        # quarantine flag decays — spoofed names from malformed reports
        # must neither evict real rows nor linger as permanent series
        self._junk_cap = max(1, int(junk_cap))
        self._junk = 0  # rows with reports == 0 (kept exact so the
        # eviction scan is skipped entirely in the common no-junk case)
        self._nodes: dict[str, _NodeEntry] = {}

    def __len__(self) -> int:
        return len(self._nodes)

    # -- update side (caller holds the aggregator's store lock) ------------

    def _touch(self, node: str, weak: bool = False) -> _NodeEntry | None:
        """LRU access: pop-and-reinsert keeps dict order = update
        recency, so cap eviction drops the longest-silent node.

        Node names on the quarantine/duplicate paths come off the wire
        UNVALIDATED (``peek_node_name`` of a report that failed
        decoding), so a malformed-report burst can mint unbounded
        distinct junk names. Eviction therefore prefers rows that never
        had an accepted report (junk churns junk), and a ``weak`` insert
        — used by those paths — is DROPPED rather than evict a real
        node's row when the table is full of accepted reporters."""
        node = node[:self._name_cap]
        entry = self._nodes.pop(node, None)
        if entry is None:
            if weak and self._junk >= self._junk_cap:
                # a flood inside the decay window churns the junk
                # sub-table, never growing it past its cap
                self._evict_junk()
            while len(self._nodes) >= self._cap:
                if self._junk and self._evict_junk():
                    continue
                if weak:
                    return None
                del self._nodes[next(iter(self._nodes))]
            entry = _NodeEntry()
            self._junk += 1  # no accepted report yet
        self._nodes[node] = entry
        return entry

    def _evict_junk(self) -> bool:
        """Evict the oldest never-accepted row. O(position of the first
        junk row); callers skip the scan via ``_junk`` when none exist."""
        victim = next((k for k, v in self._nodes.items()
                       if v.reports == 0), None)
        if victim is None:  # counter drift safety net
            self._junk = 0
            return False
        del self._nodes[victim]
        self._junk -= 1
        return True

    def observe_report(self, node: str, now: float, power_w: float,
                       lost: int = 0) -> None:
        """One ACCEPTED report: liveness, loss accounting, and the
        rolling power z-score."""
        e = self._touch(node)
        if e.reports == 0:
            self._junk -= 1  # first accepted report promotes the row
        e.last_seen = now
        e.reports += 1
        if lost:
            e.windows_lost += int(lost)
            e.last_lost_at = now
        if not math.isfinite(power_w) or power_w < 0.0:
            return  # a hostile/garbage magnitude never poisons the stats
        e.power_w = power_w
        if e.power_n == 0:
            # seed the baseline from the first sample: an EWMA walking
            # up from zero would inject a large cold-start variance
            # transient that takes tens of windows to decay
            e.power_mean_w = power_w
            e.power_n = 1
            return
        if e.power_n >= self._min_samples and self._anomaly_z > 0.0:
            spread = math.sqrt(e.power_var) if e.power_var > 0.0 else 0.0
            # variance floor: a perfectly flat baseline (fake meters,
            # quantized readings) must not turn a 1e-6 W wiggle into an
            # "anomaly" — require real relative + absolute movement
            floor = max(0.05 * max(e.power_mean_w, 0.0), 0.5)
            z = (power_w - e.power_mean_w) / max(spread, floor)
            e.last_z = z
            if abs(z) > self._anomaly_z:
                e.last_anomaly_at = now
        delta = power_w - e.power_mean_w
        e.power_mean_w += self._alpha * delta
        e.power_var = ((1.0 - self._alpha)
                       * (e.power_var + self._alpha * delta * delta))
        e.power_n += 1

    def drop(self, node: str) -> bool:
        """Remove a node's row outright (ingest hand-off: the node now
        belongs to another replica — keeping the row here would decay
        into a permanent false 'stale' signal on the OLD owner)."""
        entry = self._nodes.pop(node[:self._name_cap], None)
        if entry is None:
            return False
        if entry.reports == 0:
            self._junk -= 1
        return True

    def observe_duplicate(self, node: str, now: float) -> None:
        e = self._touch(node, weak=True)
        if e is None:
            return
        e.duplicates += 1
        e.last_seen = now  # a duplicate still proves the sender is alive

    # keplint: taint-sink=bounded-store-key — the name becomes an LRU key
    # and a metric label; callers sanitize wire-peeked names first
    def observe_quarantine(self, node: str, now: float,
                           reason: str) -> None:
        """Weak insert: the name may be hostile garbage (it is peeked
        from a report that FAILED validation) — it never evicts a real
        node's row (the aggregator's separate 64-capped ``_degraded``
        table still records it)."""
        e = self._touch(node, weak=True)
        if e is None:
            return
        e.quarantined += 1
        e.last_quarantine_at = now
        e.last_quarantine_reason = reason

    def observe_delivery(self, node: str, latency_s: float) -> None:
        """EWMA of the end-to-end delivery latency the trace closure
        measured (fresh path only is fed by the aggregator — replay
        latency is outage age, not network health)."""
        e = self._touch(node)
        if e.delivery_n == 0:
            e.delivery_ewma_s = latency_s
        else:
            e.delivery_ewma_s += self._alpha * (latency_s
                                                - e.delivery_ewma_s)
        e.delivery_n += 1

    # -- read side ---------------------------------------------------------
    # (still under the aggregator's store lock — the read paths prune
    # expired junk rows, so they mutate too)

    def _expire_junk(self, now: float) -> None:
        """Drop never-accepted rows whose quarantine flag has decayed:
        a spoofed name must not linger as a permanent 'stale' series
        once its evidence expires (rows with accepted reports live for
        the LRU lifetime — silence about a REAL node is signal)."""
        if not self._junk:
            return
        dead = [k for k, e in self._nodes.items()
                if e.reports == 0
                and not (self._flag_ttl and e.quarantined
                         and now - e.last_quarantine_at <= self._flag_ttl)]
        for k in dead:
            del self._nodes[k]
            self._junk -= 1

    def _state_of(self, e: _NodeEntry, now: float,
                  stale_after: float) -> int:
        if self._flag_ttl and now - e.last_quarantine_at <= self._flag_ttl \
                and e.quarantined:
            return STATE_QUARANTINED
        if stale_after > 0 and now - e.last_seen > stale_after:
            return STATE_STALE
        if self._flag_ttl and e.last_anomaly_at \
                and now - e.last_anomaly_at <= self._flag_ttl:
            return STATE_ANOMALOUS
        if self._flag_ttl and e.last_lost_at \
                and now - e.last_lost_at <= self._flag_ttl:
            return STATE_LOSSY
        return STATE_HEALTHY

    def flagged(self, node: str, now: float) -> bool:
        """Cheap read (caller holds the aggregator's store lock): does
        the node currently carry a live quarantine/anomaly/loss flag?
        The admission controller's priority input — flagged reporters'
        fresh windows queue behind clean ground truth under overload.
        Staleness is deliberately NOT a flag here: "hasn't reported
        lately" describes every node at the front of a recovery burst,
        not a quality problem. Unknown nodes are unflagged."""
        e = self._nodes.get(node[:self._name_cap])
        if e is None:
            return False
        return self._state_of(e, now, float("inf")) != STATE_HEALTHY

    def states(self, now: float, stale_after: float) -> dict[str, int]:
        """node → state code (the enum gauge's samples)."""
        self._expire_junk(now)
        return {node: self._state_of(e, now, stale_after)
                for node, e in self._nodes.items()}

    def snapshot(self, now: float, stale_after: float) -> dict:
        """The ``/debug/fleet`` payload: per-node rows + state rollup."""
        self._expire_junk(now)
        nodes: dict[str, dict] = {}
        rollup = {name: 0 for name in STATE_NAMES}
        for node, e in self._nodes.items():
            state = self._state_of(e, now, stale_after)
            rollup[STATE_NAMES[state]] += 1
            nodes[node] = {
                "state": STATE_NAMES[state],
                "state_code": state,
                "last_seen_age_s": round(max(0.0, now - e.last_seen), 3),
                "reports": e.reports,
                "duplicates": e.duplicates,
                "windows_lost": e.windows_lost,
                "quarantined": e.quarantined,
                "last_quarantine_reason": e.last_quarantine_reason,
                "delivery_ewma_s": round(e.delivery_ewma_s, 6),
                "power_w": round(e.power_w, 3),
                "power_mean_w": round(e.power_mean_w, 3),
                "power_z": round(e.last_z, 3),
                "anomalous": bool(
                    self._flag_ttl and e.last_anomaly_at
                    and now - e.last_anomaly_at <= self._flag_ttl),
            }
        return {"cap": self._cap, "anomaly_z": self._anomaly_z,
                "flag_ttl_s": self._flag_ttl,
                "stale_after_s": stale_after,
                "states": rollup, "nodes": nodes}
