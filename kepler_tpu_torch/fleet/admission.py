"""Ingest admission control: shed load BEFORE it becomes decode work.

The ring made the ingest tier survive a replica crash; this module makes the
*survivors* survive the crash's aftermath. When 1 of N replicas dies,
every displaced agent fails over to a survivor simultaneously and replays
its spool backlog — a thundering herd the un-protected ingest path would
absorb at full decode cost until latency (and the fleet window behind it)
collapsed. The spool + idempotent ``(run, seq)`` dedup make shedding
SAFE: a throttled record stays durable on the agent's disk and replays
later, so answering ``429 + Retry-After`` costs a little latency and
never a window. Graceful degradation is pure upside — this controller is
the valve.

Two load signals, one ladder:

- **Inflight budget.** Admitted ingest requests currently being decoded/
  merged, against ``max_inflight``. The cheap, instantaneous signal.
- **Latency budget.** An EWMA of per-record ingest service time against
  ``latency_budget``. The smoothed, "the tier is sinking" signal. The
  EWMA also decays with a fixed half-life while nothing is being
  admitted/observed, so a burst that was fully shed cannot pin the
  controller in a shed state forever.

``load`` is the max of the two ratios. Shedding is PRIORITY-AWARE so the
fleet's live attribution accuracy degrades LAST:

==========  =======================================  ==============
 priority    class                                    shed at load
==========  =======================================  ==============
 0           fresh window, RAPL ground truth,         ≥ 2.0
             healthy scoreboard node
 1           fresh window, model-estimated node       ≥ 1.5
             (or a scoreboard-flagged reporter)
 2           replay backlog, ground-truth node        ≥ 1.25
 3           replay backlog, model-estimated node     ≥ 1.0
==========  =======================================  ==============

A deep replay backlog is the first thing to wait (it is, by
construction, already safe on disk) and live measured watts are the last
— so a herd event costs backlog drain time, not attribution accuracy.

``Retry-After`` is load-derived (base × load), clamped to
``[retry_after, retry_after_max]``, and jittered ±50% from a seeded RNG
so a thousand throttled agents do not re-arrive in phase.
"""

from __future__ import annotations

# keplint: monotonic-only — budget/EWMA/decay math must survive NTP steps.

import math
import random
import threading
import time as _time
from typing import Callable

# priority classes (see the table above)
PRIORITY_FRESH_GROUND = 0
PRIORITY_FRESH_MODEL = 1
PRIORITY_REPLAY_GROUND = 2
PRIORITY_REPLAY_MODEL = 3
N_PRIORITIES = 4

# load at which each priority class starts shedding (index = priority)
SHED_THRESHOLDS = (2.0, 1.5, 1.25, 1.0)

# shed-reason label values (bounded set — these become metric labels)
REASON_INFLIGHT = "inflight"
REASON_LATENCY = "latency"

# idle half-life of the latency EWMA: with nothing admitted (total shed),
# the remembered latency halves this often, guaranteeing recovery probes
_EWMA_HALFLIFE_S = 5.0


def clamp_priority(priority: int) -> int:
    """Coerce an externally derived priority into the ladder's range."""
    if not isinstance(priority, int) or isinstance(priority, bool):
        return PRIORITY_FRESH_GROUND
    return min(max(priority, PRIORITY_FRESH_GROUND), N_PRIORITIES - 1)


class AdmissionController:
    """Inflight + latency budgets in front of the ingest path.

    Thread-safe: ``admit``/``done`` run on every ingest handler thread;
    all state lives behind one lock (a handful of float ops per call —
    three orders of magnitude below the decode work being protected).
    """

    def __init__(
        self,
        max_inflight: int = 64,
        latency_budget: float = 0.25,
        retry_after: float = 1.0,
        retry_after_max: float = 30.0,
        ewma_alpha: float = 0.2,
        degraded_ttl: float = 60.0,
        jitter_seed: int | None = None,
        monotonic: Callable[[], float] | None = None,
    ) -> None:
        self._max_inflight = max(1, int(max_inflight))
        self._latency_budget = max(0.0, float(latency_budget))
        self._retry_after = max(1e-3, float(retry_after))
        self._retry_after_max = max(self._retry_after,
                                    float(retry_after_max))
        self._alpha = min(1.0, max(1e-3, float(ewma_alpha)))
        self._degraded_ttl = max(0.0, float(degraded_ttl))
        self._rng = random.Random(jitter_seed)
        self._monotonic = monotonic or _time.monotonic
        self._lock = threading.Lock()
        self._inflight = 0  # keplint: guarded-by=_lock
        self._ewma = 0.0  # keplint: guarded-by=_lock
        self._ewma_at: float | None = None  # keplint: guarded-by=_lock
        self._last_shed_at: float | None = None  # keplint: guarded-by=_lock
        self._shed_by_reason: dict[str, int] = {  # keplint: guarded-by=_lock
            REASON_INFLIGHT: 0, REASON_LATENCY: 0}

    # -- admission ---------------------------------------------------------

    def admit(self, priority: int) -> float | None:
        """One pre-decode admission check. Returns ``None`` when the
        request is admitted (the caller MUST pair it with :meth:`done`)
        or the Retry-After seconds to answer the 429 with.

        The check and the inflight increment are atomic, so a admitted
        request can never race past the cap."""
        priority = clamp_priority(priority)
        with self._lock:
            now = self._monotonic()
            inflight_load, latency_load = self._loads_locked(now)
            load = max(inflight_load, latency_load)
            if load < SHED_THRESHOLDS[priority]:
                self._inflight += 1
                return None
            reason = (REASON_INFLIGHT if inflight_load >= latency_load
                      else REASON_LATENCY)
            self._shed_by_reason[reason] += 1
            self._last_shed_at = now
            return self._retry_after_locked(load)

    def done(self, latency_s: float) -> None:
        """An admitted request finished after ``latency_s`` of service
        time: release its inflight slot and fold the observation into
        the latency EWMA."""
        with self._lock:
            self._inflight = max(0, self._inflight - 1)
            if latency_s >= 0.0 and math.isfinite(latency_s):
                now = self._monotonic()
                decayed = self._decayed_ewma_locked(now)
                self._ewma = (decayed
                              + self._alpha * (latency_s - decayed))
                self._ewma_at = now

    # -- internals ---------------------------------------------------------

    # keplint: requires-lock=_lock
    def _decayed_ewma_locked(self, now: float) -> float:
        """The EWMA with idle decay applied: while nothing is being
        observed (e.g. everything is shed before decode), the remembered
        latency halves every ``_EWMA_HALFLIFE_S`` — a fully-shed burst
        must not pin the controller in a shed state forever."""
        if self._ewma_at is None or self._ewma <= 0.0:
            return self._ewma
        idle = max(0.0, now - self._ewma_at)
        if idle <= 0.0:
            return self._ewma
        return self._ewma * (0.5 ** (idle / _EWMA_HALFLIFE_S))

    # keplint: requires-lock=_lock
    def _loads_locked(self, now: float) -> tuple[float, float]:
        inflight_load = self._inflight / self._max_inflight
        latency_load = 0.0
        if self._latency_budget > 0.0:
            latency_load = (self._decayed_ewma_locked(now)
                            / self._latency_budget)
        return inflight_load, latency_load

    # keplint: requires-lock=_lock
    def _retry_after_locked(self, load: float) -> float:
        """Load-derived, clamped, jittered backoff hint: heavier
        overload asks agents to stay away longer; the ±50% jitter keeps
        a shed herd from re-arriving in phase."""
        base = min(self._retry_after * max(1.0, load),
                   self._retry_after_max)
        jittered = base * self._rng.uniform(0.5, 1.5)
        return round(min(max(jittered, 0.05), self._retry_after_max), 3)

    # -- introspection -----------------------------------------------------

    def load(self) -> float:
        with self._lock:
            return max(*self._loads_locked(self._monotonic()))

    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def latency_ewma(self) -> float:
        with self._lock:
            return self._decayed_ewma_locked(self._monotonic())

    def shed_by_reason(self) -> dict[str, int]:
        with self._lock:
            return dict(self._shed_by_reason)

    def health(self) -> dict:
        """``fleet-ingest`` probe for /healthz: degraded while shedding
        (a shed within ``degraded_ttl``) — the operator's "the ingest
        tier is actively re-pacing its agents" signal. It recovers on
        its own once load falls back under budget and throttled agents
        stop being turned away."""
        with self._lock:
            now = self._monotonic()
            inflight_load, latency_load = self._loads_locked(now)
            load = max(inflight_load, latency_load)
            shed_total = sum(self._shed_by_reason.values())
            last_shed = self._last_shed_at
            shedding = (last_shed is not None
                        and now - last_shed <= self._degraded_ttl)
            out = {
                "ok": not shedding,
                "shedding": shedding,
                "inflight": self._inflight,
                "max_inflight": self._max_inflight,
                "latency_ewma_s": round(
                    self._decayed_ewma_locked(now), 6),
                "latency_budget_s": self._latency_budget,
                "load": round(load, 4),
                "shed_total": shed_total,
                "shed_by_reason": dict(self._shed_by_reason),
            }
            if last_shed is not None:
                out["last_shed_age_s"] = round(now - last_shed, 3)
            return out
