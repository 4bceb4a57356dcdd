"""Self-telemetry plane: cycle span tracing and self-metrics.

Kepler's whole value is attribution of invisible costs, yet until this
module the reproduction could not attribute its own: the monitor's
refresh duration lived in one debug log line, fleet delivery latency was
unobservable end-to-end, and the watchdog could say *that* a refresh
stalled but not *where*. This module is the missing instrument: a
low-overhead, monotonic-clock span recorder wired through every hot path
(monitor refresh stages, exporter scrape, agent emit→spool→drain→send,
aggregator ingest→decode→merge).

Model:

- ``span(name)`` is a context manager timing one stage on the calling
  thread. Spans nest; the **outermost** span on a thread is a *cycle*.
  While a cycle is open, its spans accumulate in a per-thread buffer
  with no locking at all; when the outermost span closes, the whole
  trace is flushed to the sinks under ONE lock acquisition per cycle.
- Sink 1 — **self-metrics**: per-stage duration histograms
  (``kepler_self_stage_duration_seconds{stage=…}``) plus
  ``kepler_self_cycle_overrun_total{cycle=…}`` when a cycle exceeds its
  budget (the monitor passes ``monitor.interval``), exposed through the
  standard custom-collector hook (:func:`collector`).
- Sink 2 — **traces**: a bounded ring of the last N complete cycle
  traces, served by ``/debug/traces`` (:func:`make_traces_handler`) as
  plain JSON or Chrome trace-event format loadable in Perfetto /
  ``chrome://tracing``. The watchdog snapshots :func:`inflight` on a
  stall so the stale-snapshot report can name the stuck stage.

Cost contract:

- **Disabled (the default until configured): ~O(100ns) per span.** The
  module-level :func:`span` is one global read, one attribute check, and
  a shared no-op context manager — safe to leave inline in the monitor's
  refresh loop (tests pin < 1µs per call).
- **Enabled: no locks on the span path.** Timing uses
  ``time.monotonic`` only (NTP steps must never produce negative stage
  durations); wall time enters a trace once per cycle, through the
  injected clock seam, purely as the Chrome-trace anchor.
- **Telemetry must never break the host component.** Trace flushing
  consults the ``telemetry.drop`` fault site so chaos tests can prove
  the pipeline survives its own observability being dropped; dropped
  traces are counted (``kepler_self_traces_dropped_total``), never
  raised.

Profiler mirror: while a ``torch.profiler`` records, every span also
opens a ``torch.profiler.record_function`` range of its (trace) name, so
the spans sit on the profiler's clock, nest with PyTorch's operators in
its Chrome trace, and select the device work each stage launched. The
gate is a flag read (``torch.autograd.profiler._is_profiler_enabled``,
looked up in ``sys.modules``: without torch loaded no profiler can
record, so this module imports no torch). With no profiler recording a
span opens no range, enabled recorder or not; with the recorder disabled
and a profiler recording, ``span()`` returns a range-only context.
"""

from __future__ import annotations

# keplint: monotonic-only — span durations must survive NTP clock steps;
# wall time only via the injected clock seam (chrome-trace anchors).

import bisect
import collections
import contextlib
import logging
import sys
import threading
import time as _time
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Sequence

from kepler_tpu_torch import fault

log = logging.getLogger("kepler.telemetry")

DEFAULT_RING_SIZE = 32

# stage histograms: monitor stages are sub-millisecond to tens of ms on
# CPU; a slow scrape or a compile-bearing refresh lands in the seconds
DEFAULT_STAGE_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 10.0,
)

# end-to-end fleet delivery: fresh sends are milliseconds; spool replays
# carry outage durations, so the tail reaches hours
DEFAULT_DELIVERY_BUCKETS = (
    0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0, 60.0,
    300.0, 1800.0, 3600.0, 21600.0,
)


class Histogram:
    """Fixed-bucket histogram accumulator.

    The shared shape for both telemetry sinks: per-stage durations here,
    the aggregator's delivery-latency families on its side. NOT
    internally locked — owners observe/snapshot under their own lock
    (one acquisition per cycle / per ingest, never per bucket)."""

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: Sequence[float]) -> None:
        self.bounds: tuple[float, ...] = tuple(float(b) for b in bounds)
        self.counts = [0] * len(self.bounds)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self.bounds, value)
        if i < len(self.counts):
            self.counts[i] += 1
        self.sum += value
        self.count += 1

    def cumulative(self) -> list[tuple[str, int]]:
        """prometheus exposition shape: [(le, cumulative_count), …,
        ("+Inf", total)]."""
        out: list[tuple[str, int]] = []
        running = 0
        for bound, n in zip(self.bounds, self.counts):
            running += n
            out.append((repr(bound), running))
        out.append(("+Inf", self.count))
        return out


@dataclass(frozen=True)
class SpanEvent:
    """One completed span inside a cycle trace."""

    name: str
    depth: int  # 0 = the cycle itself
    rel_start_s: float  # seconds after cycle start (monotonic)
    duration_s: float
    # histogram stage key: None = use `name`; "" = trace-only (the span
    # shows in /debug/traces but observes no stage histogram). Keeps
    # per-instance span names (window.h2d_delta.s<k>) from minting one
    # kepler_self_stage_duration_seconds series per shard/index.
    stage: str | None = None


@dataclass(frozen=True)
class CycleTrace:
    """One complete cycle: the outermost span plus everything it nested."""

    name: str
    thread: str
    thread_id: int
    start_wall: float  # wall-clock anchor (clock seam) at cycle start
    duration_s: float
    overrun: bool
    events: tuple[SpanEvent, ...]

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "thread": self.thread,
            "start": self.start_wall,
            "duration_s": self.duration_s,
            "overrun": self.overrun,
            "spans": [
                {"name": e.name, "depth": e.depth,
                 "rel_start_s": e.rel_start_s,
                 "duration_s": e.duration_s,
                 **({"stage": e.stage} if e.stage is not None else {})}
                for e in self.events
            ],
        }


class _ThreadState:
    """Per-thread span buffer. Touched ONLY by its owner thread on the
    span path; :meth:`SpanRecorder.inflight` reads a snapshot of
    ``stack`` cross-thread (a copy of a list of tuples — safe under the
    GIL, and worst case one entry stale)."""

    __slots__ = ("stack", "events", "wall_anchor", "mono_anchor",
                 "thread_name", "thread_id")

    def __init__(self) -> None:
        t = threading.current_thread()
        self.stack: list[tuple[str, float, float | None]] = []
        self.events: list[SpanEvent] = []
        self.wall_anchor = 0.0
        self.mono_anchor = 0.0
        self.thread_name = t.name
        self.thread_id = t.ident or 0


class _Span:
    """Live span handle (enabled path). Re-entrant use of one handle is
    not supported — ``span()`` returns a fresh handle per with-block."""

    __slots__ = ("_rec", "_st", "_name", "_budget", "_t0", "_depth",
                 "_stage", "_range")

    def __init__(self, rec: "SpanRecorder", st: _ThreadState, name: str,
                 budget_s: float | None,
                 stage: str | None = None) -> None:
        self._rec = rec
        self._st = st
        self._name = name
        self._budget = budget_s
        self._stage = stage

    def __enter__(self) -> "_Span":
        self._range = _mirror(self._name)
        self._range.__enter__()
        st = self._st
        if not st.stack:
            st.events = []
            st.wall_anchor = self._rec._clock()
            st.mono_anchor = self._rec._monotonic()
        self._depth = len(st.stack)
        self._t0 = self._rec._monotonic()
        st.stack.append((self._name, self._t0, self._budget))
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> None:
        t1 = self._rec._monotonic()
        self._range.__exit__(exc_type, exc, tb)
        st = self._st
        if st.stack:
            st.stack.pop()
        st.events.append(SpanEvent(
            name=self._name, depth=self._depth,
            rel_start_s=self._t0 - st.mono_anchor,
            duration_s=max(0.0, t1 - self._t0),
            stage=self._stage))
        if not st.stack:
            self._rec._complete_cycle(st, self._budget)


def _mirror(name: str) -> Any:
    """The profiler range ``name`` while a torch profiler records, else
    the shared no-op. The gate is a flag read, no C call."""
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is not None and prof._is_profiler_enabled:
        return _range(name)
    return _NOOP


def _range(name: str) -> Any:
    """A profiler range named ``name`` (a context manager)."""
    from torch.profiler import record_function

    return record_function(name)


class _NoopSpan:
    """Shared disabled-path context manager: zero state, zero work."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> None:
        return None


_NOOP = _NoopSpan()


class SpanRecorder:
    """Span sink: stage histograms, overrun counters, trace ring.

    One instance is installed process-wide (see the module-level
    :func:`span` / :func:`install`); tests build private instances."""

    def __init__(
        self,
        enabled: bool = True,
        ring_size: int = DEFAULT_RING_SIZE,
        stage_buckets: Sequence[float] = DEFAULT_STAGE_BUCKETS,
        clock: Callable[[], float] | None = None,
        monotonic: Callable[[], float] | None = None,
    ) -> None:
        self._enabled = bool(enabled)
        self._clock = clock or _time.time  # wall: chrome-trace anchors only
        self._monotonic = monotonic or _time.monotonic
        self._stage_buckets = tuple(float(b) for b in stage_buckets)
        self._tls = threading.local()
        self._lock = threading.Lock()
        # everything below is guarded by _lock and touched once per
        # COMPLETED cycle, never per span. The trace ring is partitioned
        # PER CYCLE NAME (each a deque of the last ring_size cycles): on
        # an aggregator, ingest POSTs complete hundreds of cycles per
        # second while a fleet window completes once per interval — one
        # shared ring would evict every window trace within milliseconds
        # of a scrape, turning /debug/traces into 32 identical ingest
        # cycles. Cycle-name cardinality is code-bounded (the stage
        # catalog in docs/developer/observability.md), so memory stays
        # O(cycle kinds × ring_size).
        self._ring_size = max(1, int(ring_size))
        self._rings: dict[str, collections.deque[CycleTrace]] = {}
        self._hist: dict[str, Histogram] = {}
        self._overruns: dict[str, int] = {}
        self._dropped = 0
        self._cycles = 0
        # thread-id → _ThreadState, for the cross-thread inflight view
        self._threads: dict[int, tuple[threading.Thread, _ThreadState]] = {}

    @property
    def enabled(self) -> bool:
        return self._enabled

    # -- span API ------------------------------------------------------------

    def span(self, name: str, budget_s: float | None = None,
             stage: str | None = None):
        """Context manager timing one stage. ``budget_s`` is meaningful
        on the OUTERMOST span of a cycle: exceeding it counts one
        ``kepler_self_cycle_overrun_total{cycle=name}``. ``stage``
        overrides the histogram key (``""`` = trace-only) — see
        :class:`SpanEvent`."""
        if not self._enabled:
            return _mirror(name)
        return _Span(self, self._state(), name, budget_s, stage)

    def _state(self) -> _ThreadState:
        st = getattr(self._tls, "state", None)
        if st is None:
            st = _ThreadState()
            self._tls.state = st
            with self._lock:
                # prune dead threads so a churny thread pool can't grow
                # the registry without bound
                for tid in [t for t, (th, _s) in self._threads.items()
                            if not th.is_alive()]:
                    del self._threads[tid]
                self._threads[st.thread_id] = (
                    threading.current_thread(), st)
        return st

    def _complete_cycle(self, st: _ThreadState,
                        budget_s: float | None) -> None:
        events = tuple(st.events)
        st.events = []
        outer = events[-1]  # outermost span exits last
        overrun = budget_s is not None and outer.duration_s > budget_s
        if fault.fire("telemetry.drop") is not None:
            with self._lock:
                self._dropped += 1
            return
        trace = CycleTrace(
            name=outer.name, thread=st.thread_name,
            thread_id=st.thread_id, start_wall=st.wall_anchor,
            duration_s=outer.duration_s, overrun=overrun, events=events)
        with self._lock:
            self._cycles += 1
            for ev in events:
                key = ev.name if ev.stage is None else ev.stage
                if not key:
                    continue  # trace-only span (stage="")
                hist = self._hist.get(key)
                if hist is None:
                    hist = self._hist[key] = Histogram(
                        self._stage_buckets)
                hist.observe(ev.duration_s)
            if overrun:
                self._overruns[outer.name] = \
                    self._overruns.get(outer.name, 0) + 1
                log.warning("cycle %s overran its budget: %.2f ms > "
                            "%.2f ms", outer.name,
                            outer.duration_s * 1e3, budget_s * 1e3)
            ring = self._rings.get(outer.name)
            if ring is None:
                ring = self._rings[outer.name] = collections.deque(
                    maxlen=self._ring_size)
            ring.append(trace)
        # the ONE timing debug log (replaces the monitor's ad-hoc
        # "refresh done in" line — one source of truth for cycle timing)
        log.debug("%s done in %.2f ms (%d spans)", outer.name,
                  outer.duration_s * 1e3, len(events))

    # -- read API ------------------------------------------------------------

    def recent_traces(self) -> list[CycleTrace]:
        """Complete cycle traces across every per-cycle ring, ordered by
        wall-clock start (newest last)."""
        with self._lock:
            traces = [t for ring in self._rings.values() for t in ring]
        traces.sort(key=lambda t: t.start_wall)
        return traces

    def inflight(self) -> list[dict]:
        """Open spans per thread, outermost first — the watchdog's
        where-is-it-stuck snapshot. Reads other threads' stacks without
        their cooperation: safe (list-of-tuples snapshot under the GIL),
        and at worst one span stale."""
        now = self._monotonic()
        with self._lock:
            states = [st for _th, st in self._threads.values()]
        out = []
        for st in states:
            stack = list(st.stack)
            if not stack:
                continue
            out.append({
                "thread": st.thread_name,
                "spans": [{"name": name,
                           "elapsed_s": max(0.0, now - t0)}
                          for name, t0, _budget in stack],
            })
        return out

    def stats(self) -> dict:
        with self._lock:
            return {"enabled": self._enabled, "cycles": self._cycles,
                    "dropped": self._dropped,
                    "overruns": dict(self._overruns),
                    "stages": sorted(self._hist)}

    # -- sink 1: prometheus self-metrics --------------------------------------

    def collect(self):
        """prometheus_client custom-collector hook (kepler_self_*)."""
        from prometheus_client.core import (
            CounterMetricFamily,
            HistogramMetricFamily,
        )
        with self._lock:
            hist_snap = [(stage, list(h.counts), h.sum, h.count)
                         for stage, h in sorted(self._hist.items())]
            overruns = dict(self._overruns)
            dropped = self._dropped
        stage_family = HistogramMetricFamily(
            "kepler_self_stage_duration_seconds",
            "Duration of one instrumented pipeline stage (span)",
            labels=["stage"])
        for stage, counts, total_sum, count in hist_snap:
            h = Histogram(self._stage_buckets)
            h.counts, h.sum, h.count = counts, total_sum, count
            stage_family.add_metric([stage], buckets=h.cumulative(),
                                    sum_value=total_sum)
        yield stage_family
        over = CounterMetricFamily(
            "kepler_self_cycle_overrun_total",
            "Cycles that exceeded their duration budget "
            "(monitor refreshes longer than monitor.interval)",
            labels=["cycle"])
        for cycle, n in sorted(overruns.items()):
            over.add_metric([cycle], n)
        yield over
        drop = CounterMetricFamily(
            "kepler_self_traces_dropped_total",
            "Completed cycle traces dropped before reaching the sinks "
            "(telemetry.drop fault site)")
        drop.add_metric([], dropped)
        yield drop

    # -- sink 2: trace export --------------------------------------------------

    def chrome_trace(self) -> dict:
        """Ring contents in Chrome trace-event format (Perfetto /
        chrome://tracing: complete "X" events on a wall-clock µs axis,
        plus thread-name metadata)."""
        events: list[dict] = []
        named: set[int] = set()
        for tr in self.recent_traces():
            base_us = tr.start_wall * 1e6
            if tr.thread_id not in named:
                named.add(tr.thread_id)
                events.append({"name": "thread_name", "ph": "M", "pid": 0,
                               "tid": tr.thread_id,
                               "args": {"name": tr.thread}})
            for ev in tr.events:
                events.append({
                    "name": ev.name, "ph": "X", "cat": "kepler",
                    "ts": base_us + ev.rel_start_s * 1e6,
                    "dur": ev.duration_s * 1e6,
                    "pid": 0, "tid": tr.thread_id,
                    "args": {"depth": ev.depth},
                })
        return {"traceEvents": events, "displayTimeUnit": "ms"}


# ---------------------------------------------------------------------------
# module-level installed recorder (the cheap instrumentation surface)
# ---------------------------------------------------------------------------

# starts DISABLED: an unconfigured import (library use, unit tests) pays
# only the no-op fast path until a binary calls install_from_config
_active = SpanRecorder(enabled=False)


def recorder() -> SpanRecorder:
    return _active


def install(rec: SpanRecorder) -> SpanRecorder:
    """Install a recorder process-wide; instrumented layers pick it up on
    their next span."""
    global _active
    _active = rec
    return rec


def span(name: str, budget_s: float | None = None,
         stage: str | None = None):
    """The instrumentation point. Disabled cost: one global read, one
    attribute check, the profiler gate (a dict lookup and a flag read)
    and a shared no-op context manager. ``stage`` re-keys the stage
    histogram (``""`` = trace-only), so per-instance span names never
    mint per-instance metric series; the profiler range takes ``name``."""
    rec = _active
    if not rec._enabled:
        # _mirror() inlined: this is the hot path
        prof = sys.modules.get("torch.autograd.profiler")
        if prof is not None and prof._is_profiler_enabled:
            return _range(name)
        return _NOOP
    return rec.span(name, budget_s, stage)


def inflight() -> list[dict]:
    return _active.inflight()


def recent_traces() -> list[CycleTrace]:
    return _active.recent_traces()


def install_from_config(cfg: Any) -> SpanRecorder:
    """Build + install a recorder from a ``TelemetryConfig`` (config.py).
    Shared by both binaries (cmd/main, cmd/aggregator)."""
    rec = SpanRecorder(
        enabled=cfg.enabled,
        ring_size=cfg.ring_size,
        stage_buckets=cfg.stage_buckets or DEFAULT_STAGE_BUCKETS,
    )
    return install(rec)


@contextlib.contextmanager
def installed(rec: SpanRecorder) -> Iterator[SpanRecorder]:
    """Test helper: install ``rec`` for a with-block, always restoring
    the previous recorder on exit."""
    prev = _active
    install(rec)
    try:
        yield rec
    finally:
        install(prev)


class SelfMetricsCollector:
    """Registry adapter yielding the INSTALLED recorder's families at
    scrape time (not the recorder captured at wiring time), so a late
    install_from_config or a test's :func:`installed` swap is always the
    one scraped."""

    def collect(self):
        yield from _active.collect()


def collector() -> SelfMetricsCollector:
    return SelfMetricsCollector()


# ---------------------------------------------------------------------------
# /debug/traces endpoint
# ---------------------------------------------------------------------------


def make_traces_handler(rec: SpanRecorder | None = None):
    """APIServer handler serving recent cycle traces.

    ``GET /debug/traces`` → ``{"enabled", "traces", "inflight"}`` JSON;
    ``GET /debug/traces?format=chrome`` → Chrome trace-event JSON
    (load in Perfetto / chrome://tracing). ``rec=None`` follows the
    installed recorder."""
    import json
    from urllib.parse import parse_qs, urlparse

    # keplint: thread-role=http-handler
    def handler(request) -> tuple[int, dict[str, str], bytes]:
        active = rec if rec is not None else _active
        qs = parse_qs(urlparse(request.path).query)
        fmt = qs.get("format", ["json"])[0]
        if fmt == "chrome":
            payload = active.chrome_trace()
        elif fmt == "json":
            payload = {
                "enabled": active.enabled,
                "traces": [t.to_dict() for t in active.recent_traces()],
                "inflight": active.inflight(),
            }
        else:
            return (400, {"Content-Type": "text/plain"},
                    f"unknown format {fmt!r}; use json or chrome\n".encode())
        return (200, {"Content-Type": "application/json"},
                json.dumps(payload).encode())

    return handler
