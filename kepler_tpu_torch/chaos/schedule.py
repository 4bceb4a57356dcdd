"""kepchaos schedule grammar: randomized, time-phased fault schedules.

A :class:`Schedule` is a flat, ordered list of :class:`ChaosEvent`
entries, each pinned to a *window index* on the conductor's virtual
clock. Two event families share the grammar:

- **fault** events compile onto the existing :class:`FaultSpec`
  machinery (``kepler_tpu_torch.fault``) with ``start``/``duration`` expressed
  in virtual seconds, so the same injection points the hand-written
  chaos tests use are exercised — nothing is mocked around them;
- **op** events (``kill``/``restart``/``join``/``leave``/
  ``autoscale_up``/``autoscale_down``) are executed by the conductor
  against the in-process fleet (replica teardown, ``POST
  /v1/membership`` traffic, autoscale enactment).

Everything is derived from ``(seed, index)`` through one
``random.Random`` — no wall clock, no process entropy — so
``generate(seed, index)`` is a pure function and a failing schedule is
a two-integer repro key. Shrinking (:func:`ddmin`) minimizes a failing
schedule to a subsequence of its events by classic delta-debugging.

Only *deterministic-under-virtual-time* fault sites enter the generator
pool; sites whose observable effect couples to the wall clock (real
``time.sleep``, watchdog races) or that sit off the composed fleet
surface (node-local spool/telemetry paths) are listed in
``EXCLUDED_SITES`` with the reason, and a fence test asserts the pool
and the exclusions exactly partition ``KNOWN_SITES``.
"""

from __future__ import annotations

import json
import random
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Mapping, Sequence

from kepler_tpu_torch.fault import KNOWN_SITES, FaultSpec

# Sites the generator draws from: deterministic effect under the
# conductor's virtual clock, consulted on the composed fleet surface.
FAULT_POOL: tuple[str, ...] = (
    "device.read_error",
    "net.refuse",
    "net.corrupt_body",
    "report.clock_skew",
    "device.dispatch_error",
    "device.compile_error",
    "device.oom_on_grow",
    "net.partition",
    "replica.down",
    "net.throttle",
)

# Excluded from randomized schedules — site -> reason. Kept exhaustive
# against KNOWN_SITES by tests/test_torch_chaos.py so a new site must be
# either scheduled or explicitly excluded here.
EXCLUDED_SITES: dict[str, str] = {
    "net.slow": "real agent-side sleep; delivery latency couples to the "
                "wall clock, breaking bit-identical replay",
    "aggregator.ingest_slow": "real time.sleep in ingest; the admission "
                              "latency EWMA it drives is wall-clock fed",
    "device.stall": "demotion depends on the real dispatch-watchdog "
                    "race, not the virtual clock",
    "device.counter_wrap": "consulted in the node monitor's sysfs read "
                           "path, below the wire surface this harness "
                           "drives",
    "disk.write_error": "spool runs on the node agent's disk path, not "
                        "in the in-process fleet",
    "disk.fsync_error": "spool runs on the node agent's disk path, not "
                        "in the in-process fleet",
    "disk.torn_tail": "spool runs on the node agent's disk path, not "
                      "in the in-process fleet",
    "telemetry.drop": "telemetry span ring lives in the node process, "
                      "off the fleet surface",
}

OP_KINDS: tuple[str, ...] = (
    "kill", "restart", "join", "leave", "autoscale_up", "autoscale_down")


@dataclass(frozen=True)
class ChaosEvent:
    """One schedule entry. ``at`` is a 0-based window index; fault
    events stay armed for ``windows`` windows, op events execute once
    at the top of window ``at``."""

    at: int
    kind: str               # "fault" or one of OP_KINDS
    site: str = ""          # fault events only
    target: str = ""        # op events: the peer acted on
    windows: int = 1        # fault events: armed duration in windows
    count: int | None = None
    probability: float = 1.0
    arg: float | None = None

    def __post_init__(self) -> None:
        if self.kind == "fault":
            if self.site not in KNOWN_SITES:
                raise ValueError(f"unknown fault site {self.site!r}")
        elif self.kind not in OP_KINDS:
            raise ValueError(f"unknown event kind {self.kind!r}")
        if self.at < 0:
            raise ValueError("event window index must be >= 0")
        if self.windows < 1:
            raise ValueError("fault duration must be >= 1 window")

    def to_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {"at": self.at, "kind": self.kind}
        if self.site:
            out["site"] = self.site
        if self.target:
            out["target"] = self.target
        if self.windows != 1:
            out["windows"] = self.windows
        if self.count is not None:
            out["count"] = self.count
        if self.probability != 1.0:
            out["probability"] = self.probability
        if self.arg is not None:
            out["arg"] = self.arg
        return out

    @classmethod
    def from_dict(cls, raw: Mapping[str, Any]) -> "ChaosEvent":
        allowed = {"at", "kind", "site", "target", "windows", "count",
                   "probability", "arg"}
        unknown = set(raw) - allowed
        if unknown:
            raise ValueError(f"chaos event has unknown keys "
                             f"{sorted(unknown)}")
        return cls(
            at=int(raw["at"]), kind=str(raw["kind"]),
            site=str(raw.get("site", "")),
            target=str(raw.get("target", "")),
            windows=int(raw.get("windows", 1)),
            count=(None if raw.get("count") is None
                   else int(raw["count"])),
            probability=float(raw.get("probability", 1.0)),
            arg=(None if raw.get("arg") is None else float(raw["arg"])))


@dataclass(frozen=True)
class Schedule:
    """A generated (or replayed) fault schedule, keyed by
    ``(seed, index)``. ``keep`` records which original event indices
    survived shrinking — empty means the full schedule."""

    seed: int
    index: int
    events: tuple[ChaosEvent, ...]
    keep: tuple[int, ...] = field(default=())

    def subset(self, keep: Sequence[int]) -> "Schedule":
        keep_t = tuple(sorted(set(int(k) for k in keep)))
        if any(k < 0 or k >= len(self.events) for k in keep_t):
            raise ValueError("keep index out of range")
        return Schedule(seed=self.seed, index=self.index,
                        events=tuple(self.events[k] for k in keep_t),
                        keep=keep_t)

    def to_json(self) -> str:
        out: dict[str, Any] = {
            "seed": self.seed, "index": self.index,
            "events": [e.to_dict() for e in self.events]}
        if self.keep:
            out["keep"] = list(self.keep)
        return json.dumps(out, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "Schedule":
        raw = json.loads(text)
        sched = cls(seed=int(raw["seed"]), index=int(raw["index"]),
                    events=tuple(ChaosEvent.from_dict(e)
                                 for e in raw.get("events", [])),
                    keep=tuple(int(k) for k in raw.get("keep", [])))
        return sched


# sites that demote the device-window ladder: capped per schedule so a
# fixed cooldown always re-promotes to the top rung before convergence
# is judged (probe back-off doubles on failed retries, so unbounded
# stacks could out-run any constant K)
LADDER_SITES: frozenset[str] = frozenset({
    "device.dispatch_error", "device.compile_error",
    "device.oom_on_grow"})
MAX_LADDER_EVENTS = 2


def _fault_event(rng: random.Random, horizon: int,
                 ladder_left: int) -> ChaosEvent:
    site = rng.choice(FAULT_POOL)
    if site in LADDER_SITES and ladder_left <= 0:
        site = rng.choice(tuple(s for s in FAULT_POOL
                                if s not in LADDER_SITES))
    at = rng.randrange(max(1, horizon))
    windows = rng.randint(1, 3)
    probability = rng.choice((1.0, 1.0, 1.0, 0.5))
    arg: float | None = None
    count: int | None
    if site in LADDER_SITES:
        count = 1           # one demotion per event, shallow walks
        probability = 1.0
    elif site == "device.read_error":
        count = rng.randint(1, 2)
        arg = float(rng.randrange(4))       # which zone to mask
    else:
        count = rng.randint(1, 3)
        if site == "report.clock_skew":
            # well past the 120 s tolerance, both directions
            arg = rng.choice((300.0, -300.0))
        elif site == "net.throttle":
            arg = 1.0                       # Retry-After seconds
    return ChaosEvent(at=at, kind="fault", site=site, windows=windows,
                      count=count, probability=probability, arg=arg)


def _op_event(rng: random.Random, horizon: int, members: Sequence[str],
              standbys: Sequence[str]) -> list[ChaosEvent]:
    kind = rng.choice(OP_KINDS)
    everyone = list(members) + list(standbys)
    out: list[ChaosEvent] = []
    if kind in ("autoscale_up", "autoscale_down"):
        out.append(ChaosEvent(at=rng.randrange(max(1, horizon)),
                              kind=kind))
    elif kind in ("kill", "leave"):
        at = rng.randrange(max(1, horizon))
        target = rng.choice(list(members))
        out.append(ChaosEvent(at=at, kind=kind, target=target))
        # usually bring the peer back so schedules stay productive —
        # the executor no-ops a restart/join of a live member
        if rng.random() < 0.75:
            back = "restart" if kind == "kill" else "join"
            out.append(ChaosEvent(at=at + rng.randint(2, 4), kind=back,
                                  target=target))
    else:  # restart / join of anyone (live ones no-op at runtime)
        out.append(ChaosEvent(at=rng.randrange(max(1, horizon)),
                              kind=kind, target=rng.choice(everyone)))
    return out


def generate(seed: int, index: int, *, horizon: int,
             members: Sequence[str], standbys: Sequence[str],
             min_events: int = 3, max_events: int = 8) -> Schedule:
    """Pure function ``(seed, index) -> Schedule``: every draw comes
    from one ``random.Random(seed * 1_000_003 + index)``, so the key
    alone replays the schedule on any host (no string hashing — CPython
    salts ``hash(str)`` per process)."""
    rng = random.Random(seed * 1_000_003 + index)
    n = rng.randint(min_events, max_events)
    events: list[ChaosEvent] = []
    while len(events) < n:
        if rng.random() < 0.7:
            ladder_used = sum(1 for e in events if e.site in LADDER_SITES)
            events.append(_fault_event(
                rng, horizon, MAX_LADDER_EVENTS - ladder_used))
        else:
            events.extend(_op_event(rng, horizon, members, standbys))
    events.sort(key=lambda e: (e.at, e.kind, e.site, e.target))
    return Schedule(seed=seed, index=index, events=tuple(events))


def compile_fault_specs(events: Iterable[ChaosEvent],
                        interval: float) -> list[FaultSpec]:
    """Lower fault events onto ``FaultSpec`` windows in virtual seconds.

    The conductor arms the plan at virtual t0 and advances the clock by
    ``interval`` before processing window ``w`` (1-based), so elapsed
    time at window ``w`` is ``w * interval``; an event at 0-based index
    ``a`` targeting windows ``a+1 .. a+windows`` therefore opens at
    ``(a + 0.5) * interval``."""
    specs: list[FaultSpec] = []
    for ev in events:
        if ev.kind != "fault":
            continue
        specs.append(FaultSpec(
            site=ev.site, probability=ev.probability, count=ev.count,
            start=(ev.at + 0.5) * interval,
            duration=ev.windows * interval, arg=ev.arg))
    return specs


def ddmin(indices: Sequence[int],
          fails: Callable[[Sequence[int]], bool]) -> tuple[int, ...]:
    """Classic delta debugging over event indices: returns a minimal
    (1-minimal) subsequence for which ``fails`` still holds. ``fails``
    must hold for the full ``indices``."""
    work = list(indices)
    if not fails(work):
        raise ValueError("ddmin precondition: full set must fail")
    granularity = 2
    while len(work) >= 2:
        size = len(work) // granularity
        chunks = [work[i:i + size]
                  for i in range(0, len(work), size)] if size else [work]
        reduced = False
        for i, chunk in enumerate(chunks):
            if fails(chunk):                    # subset reproduces
                work = list(chunk)
                granularity = 2
                reduced = True
                break
            complement = [x for j, c in enumerate(chunks) if j != i
                          for x in c]
            if complement and fails(complement):  # complement reproduces
                work = complement
                granularity = max(granularity - 1, 2)
                reduced = True
                break
        if not reduced:
            if granularity >= len(work):
                break
            granularity = min(len(work), granularity * 2)
    return tuple(work)
