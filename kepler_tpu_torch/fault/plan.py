"""Seedable fault-injection registry (chaos harness).

The reference hardens every layer against partial failure (skip-on-error
zone reads, rollback-on-init-failure, degrade-gracefully exporters) but
offers no way to *exercise* those paths deterministically. This module is
that way: a ``FaultPlan`` holds a set of ``FaultSpec`` entries — each
scoped by probability, fire count, and a time window — and layers consult
it through cheap injection points (``fault.fire("net.refuse")``).

Design constraints:

- **Zero cost when disarmed.** ``fire()`` with no installed plan is one
  module-global read and a ``None`` check — safe to leave in hot paths
  (the monitor's refresh loop, the agent's send path).
- **Deterministic.** All randomness comes from one seeded ``Random``;
  the same plan replays the same fault sequence, so resilience tests
  never flake.
- **Inspectable.** Per-site check/fire counters let tests assert not just
  the outcome but that the fault actually happened (and stopped).

Sites are free-form strings but the canonical set is ``KNOWN_SITES``;
``FaultPlan.from_config`` rejects unknown sites so a typo'd YAML plan
fails at startup instead of silently injecting nothing.
"""

from __future__ import annotations

# keplint: monotonic-only — fault windows (start/duration) use elapsed time

import contextlib
import logging
import random
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Iterator, Mapping

log = logging.getLogger("kepler.fault")

# Canonical injection sites: ``(site, consulting layer, effect)``. The
# catalog is the single source of truth — ``KNOWN_SITES`` (the
# validation set), the resilience.md fault-site table
# (``hack/gen_fault_docs.py``), the dead-site fence test, and the
# kepchaos schedule generator are all derived from it, so a site cannot
# be added without its documentation (or documented without a consumer).
SITE_CATALOG: tuple[tuple[str, str, str], ...] = (
    ("device.read_error", "monitor",
     "zone read fails → zone masked this window"),
    ("device.counter_wrap", "monitor",
     "counter forced to `arg` → wraparound-delta path"),
    ("net.refuse", "agent",
     "connect/send raises `ConnectionRefusedError`"),
    ("net.slow", "agent",
     "send stalls `arg` seconds (≤ timeout)"),
    ("net.corrupt_body", "agent",
     "report body truncated → server-side `WireError`"),
    ("report.clock_skew", "agent",
     "`sent_at` stamped `arg` seconds off"),
    ("disk.write_error", "spool",
     "append fails cleanly (no bytes land) → in-memory fallback"),
    ("disk.fsync_error", "spool",
     "fsync fails; record stays in page cache, counted"),
    ("disk.torn_tail", "spool",
     "partial frame written, append raises — kill -9 mid-write stand-in"),
    ("telemetry.drop", "telemetry",
     "a completed cycle trace is dropped before the ring buffer"),
    # device-plane window leg (aggregator degradation ladder,
    # docs/developer/resilience.md "Device-plane faults")
    ("device.dispatch_error", "window",
     "the XLA dispatch raises → ladder demotion"),
    ("device.compile_error", "window",
     "a cold program/update compile fails (fires before the cache entry "
     "lands)"),
    ("device.oom_on_grow", "window",
     "a bucket-growth recompile OOMs"),
    ("device.stall", "window",
     "the fetch hangs `arg` seconds → dispatch-timeout demotion"),
    # HA ingest tier (consistent-hash replicated aggregators,
    # docs/developer/resilience.md "Ingest hand-off")
    ("net.partition", "agent",
     "one-way partition: report delivered, response dropped → "
     "re-delivery, dedup absorbs"),
    ("replica.down", "aggregator",
     "ingest answers 503 (dying replica) → agent failover + spool"),
    # overload control (admission + shedding,
    # docs/developer/resilience.md "Overload and backpressure")
    ("net.throttle", "agent",
     "send answered 429 with `arg` as Retry-After → throttle path (no "
     "breaker/failover)"),
    ("aggregator.ingest_slow", "aggregator",
     "ingest stalls `arg` seconds → latency EWMA climbs, admission "
     "sheds"),
)

KNOWN_SITES: tuple[str, ...] = tuple(s for s, _, _ in SITE_CATALOG)


@dataclass(frozen=True)
class FaultSpec:
    """One scoped fault.

    ``probability`` gates each eligible check; ``skip`` lets the first N
    eligible checks pass untouched (e.g. "refuse the 3rd connect");
    ``count`` caps total fires (None = unlimited); ``start``/``duration``
    bound the window in seconds since the plan was armed; ``arg`` is a
    site-specific magnitude (seconds of delay for ``net.slow``, seconds
    of skew for ``report.clock_skew``, forced counter value for
    ``device.counter_wrap``).
    """

    site: str
    probability: float = 1.0
    count: int | None = None
    skip: int = 0
    start: float = 0.0
    duration: float | None = None
    arg: float | None = None

    def __post_init__(self) -> None:
        if not self.site or not isinstance(self.site, str):
            raise ValueError("fault spec needs a site")
        # type-check before range-check: a YAML typo like `arg: fast` must
        # be a startup ValueError, never a TypeError escaping validation or
        # a crash inside an injection point at fire time
        def _num(name: str, value: Any, allow_none: bool = False) -> None:
            if value is None and allow_none:
                return
            if isinstance(value, bool) or not isinstance(
                    value, (int, float)):
                raise ValueError(
                    f"{self.site}: {name} must be a number, "
                    f"got {value!r}")

        _num("probability", self.probability)
        _num("count", self.count, allow_none=True)
        _num("skip", self.skip)
        _num("start", self.start)
        _num("duration", self.duration, allow_none=True)
        _num("arg", self.arg, allow_none=True)
        if not 0.0 <= self.probability <= 1.0:
            raise ValueError(
                f"{self.site}: probability must be in [0, 1], "
                f"got {self.probability}")
        if self.count is not None and self.count < 0:
            raise ValueError(f"{self.site}: count must be >= 0")
        if self.skip < 0:
            raise ValueError(f"{self.site}: skip must be >= 0")
        if self.duration is not None and self.duration < 0:
            raise ValueError(f"{self.site}: duration must be >= 0")


class _SpecState:
    __slots__ = ("spec", "seen", "fired")

    def __init__(self, spec: FaultSpec) -> None:
        self.spec = spec
        self.seen = 0   # eligible checks observed (drives `skip`)
        self.fired = 0  # faults actually injected (drives `count`)


class FaultPlan:
    """A seeded registry of scoped faults, consulted via :meth:`fire`.

    Thread-safe: injection points run on monitor/agent/server threads
    concurrently; all spec state and the RNG live behind one lock (the
    disarmed fast path never takes it — see module-level :func:`fire`).
    """

    def __init__(self, specs: Iterable[FaultSpec] = (), seed: int = 0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self._lock = threading.Lock()
        self._rng = random.Random(seed)
        self._clock = clock
        self._armed_at = clock()
        self._specs: dict[str, list[_SpecState]] = {}
        self.checks: dict[str, int] = {}
        self.fires: dict[str, int] = {}
        for spec in specs:
            self.add(spec)

    def add(self, spec: FaultSpec) -> "FaultPlan":
        with self._lock:
            self._specs.setdefault(spec.site, []).append(_SpecState(spec))
        return self

    def sites(self) -> tuple[str, ...]:
        with self._lock:
            return tuple(self._specs)

    def fire(self, site: str) -> FaultSpec | None:
        """One injection-point check: returns the spec that fires (first
        match in registration order) or None. Never raises."""
        with self._lock:
            self.checks[site] = self.checks.get(site, 0) + 1
            states = self._specs.get(site)
            if not states:
                return None
            elapsed = self._clock() - self._armed_at
            for st in states:
                spec = st.spec
                if elapsed < spec.start:
                    continue
                if (spec.duration is not None
                        and elapsed > spec.start + spec.duration):
                    continue
                if spec.count is not None and st.fired >= spec.count:
                    continue
                st.seen += 1
                if st.seen <= spec.skip:
                    continue
                if spec.probability < 1.0 \
                        and self._rng.random() >= spec.probability:
                    continue
                st.fired += 1
                self.fires[site] = self.fires.get(site, 0) + 1
                return spec
        return None

    def fired(self, site: str) -> int:
        with self._lock:
            return self.fires.get(site, 0)

    def checked(self, site: str) -> int:
        with self._lock:
            return self.checks.get(site, 0)

    def stats(self) -> dict[str, dict[str, int]]:
        """{site: {checks, fires}} — for /healthz details and test asserts."""
        with self._lock:
            sites = set(self.checks) | set(self.fires) | set(self._specs)
            return {s: {"checks": self.checks.get(s, 0),
                        "fires": self.fires.get(s, 0)} for s in sites}

    @classmethod
    def from_config(cls, cfg: Any) -> "FaultPlan":
        """Build from a ``FaultConfig`` (config.py): ``specs`` is a list of
        mappings with a required ``site`` key plus any FaultSpec field.
        Unknown sites/keys fail loudly — a typo'd chaos plan must not
        silently inject nothing."""
        specs: list[FaultSpec] = []
        for i, raw in enumerate(cfg.specs):
            if not isinstance(raw, Mapping):
                raise ValueError(f"fault.specs[{i}] must be a mapping")
            allowed = {"site", "probability", "count", "skip", "start",
                       "duration", "arg"}
            unknown = set(raw) - allowed
            if unknown:
                raise ValueError(
                    f"fault.specs[{i}] has unknown keys {sorted(unknown)}")
            site = raw.get("site", "")
            if site not in KNOWN_SITES:
                raise ValueError(
                    f"fault.specs[{i}]: unknown site {site!r}; known: "
                    f"{', '.join(KNOWN_SITES)}")
            try:
                specs.append(FaultSpec(**raw))
            except TypeError as err:  # e.g. count given as a list
                raise ValueError(f"fault.specs[{i}]: {err}") from err
        return cls(specs, seed=cfg.seed)


# -- module-level active plan (the cheap injection-point surface) -----------

_active: FaultPlan | None = None


def install(plan: FaultPlan) -> FaultPlan:
    """Arm a plan process-wide. Layers' injection points start consulting
    it immediately."""
    global _active
    _active = plan
    return plan


def uninstall() -> None:
    global _active
    _active = None


def active() -> FaultPlan | None:
    return _active


def fire(site: str) -> FaultSpec | None:
    """The injection point. Disarmed cost: one global read + None check."""
    plan = _active
    if plan is None:
        return None
    return plan.fire(site)


def install_from_config(cfg: Any) -> FaultPlan | None:
    """Arm the config's chaos plan (``FaultConfig``) at startup; no-op
    when disabled. Shared by both binaries (cmd/main, cmd/aggregator)."""
    if not cfg.enabled:
        return None
    plan = install(FaultPlan.from_config(cfg))
    log.warning("FAULT INJECTION ARMED (seed=%d): %s — exported data is "
                "not trustworthy while a chaos plan is active",
                cfg.seed, ", ".join(plan.sites()))
    return plan


@contextlib.contextmanager
def installed(plan: FaultPlan) -> Iterator[FaultPlan]:
    """Test helper: arm ``plan`` for the duration of a with-block, always
    disarming on exit (a failed assert must not leak faults into the next
    test)."""
    prev = _active
    install(plan)
    try:
        yield plan
    finally:
        if prev is None:
            uninstall()
        else:
            install(prev)
