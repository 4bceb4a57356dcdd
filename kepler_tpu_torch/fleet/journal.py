"""Fleet black box: the HLC-stamped causal event journal.

Every fleet state transition — rung ladder moves, lease adoptions,
membership applies, autoscale enactments, quarantine/shed onset, agent
breaker flips, spool rewinds, watchdog stalls — is emitted through ONE
chokepoint (:meth:`EventJournal.emit` / module :func:`emit`) with a
``kind`` drawn from the closed :data:`KIND_CATALOG` registry. The fence
test (tests/test_journal_fence.py) pins catalog ↔ emit-site agreement in
both directions and ``hack/gen_journal_docs.py`` renders the catalog
into docs/developer/observability.md, so an event kind cannot exist
without documentation or documentation without an emitter — the same
teeth ``fault.SITE_CATALOG`` has.

Storage is a bounded in-memory ring (``telemetry.journal.ringSize``)
plus an optional spool-framed durable file (``telemetry.journal.dir``,
length-prefixed CRC32 frames like fleet/spool.py, capped at
``telemetry.journal.maxBytes`` with one rotation) so a crashed replica's
last events survive for the incident bundle.

Cost contract (same as ``telemetry.spans``): module-level :func:`emit`
against the default disabled journal is one global read and one
attribute check — pinned < 1 µs/event by tests — so emission points are
safe in ingest and send paths.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import struct
import threading
import time
import zlib
from collections import deque
from typing import Any, Callable, Iterator

from kepler_tpu_torch.telemetry.hlc import (
    DEFAULT_MAX_DRIFT_S,
    HLC,
    HlcClock,
    parse_hlc,
)

log = logging.getLogger("kepler.journal")

__all__ = [
    "DEFAULT_RING_SIZE",
    "EventJournal",
    "KIND_CATALOG",
    "KNOWN_KINDS",
    "active",
    "canonical_json",
    "collector",
    "emit",
    "install",
    "install_from_config",
    "installed",
    "make_journal_handler",
    "read_frames",
]

# Canonical event kinds: ``(kind, emitting layer, meaning)``. The single
# source of truth — the fence test, the generated observability.md
# catalog table, and the blackbox CLI's rendering all derive from it.
KIND_CATALOG: tuple[tuple[str, str, str], ...] = (
    ("admission.shed", "aggregator",
     "admission control began shedding (accepting → shedding edge); "
     "per-request 429s are counters, the onset is the incident marker"),
    ("autoscale.enact", "aggregator",
     "the lease holder enacted a scale decision (standby promote / "
     "member retire) — fields name direction, peer, and new epoch"),
    ("breaker.close", "agent",
     "the agent's send circuit breaker closed (probe or send "
     "succeeded; deliveries resume)"),
    ("breaker.open", "agent",
     "the agent's send circuit breaker opened after consecutive "
     "failures (sends stop; spool keeps accumulating)"),
    ("lease.adopt", "aggregator",
     "this replica adopted a coordinator lease (holder, epoch) — "
     "succession and join grants land here"),
    ("membership.apply", "aggregator",
     "an ingest-ring membership change was applied (epoch, peers, "
     "source, dropped/retired shards)"),
    ("quarantine.onset", "aggregator",
     "a node entered the degraded set (first strike of this spell: "
     "malformed / clock-skew / flapping quarantine)"),
    ("rung.transition", "aggregator",
     "the degradation ladder moved (demotion or repromotion) — the "
     "journal twin of the /debug/window rung timeline entry"),
    ("spool.rewind", "agent",
     "the agent rewound its durable spool cursor for hand-off replay "
     "(unacked frames will be redelivered to the new owner)"),
    ("watchdog.stall", "monitor",
     "the monitor watchdog detected a stalled refresh loop (first "
     "detection of this stall, not the per-check repeat)"),
)

KNOWN_KINDS: tuple[str, ...] = tuple(k for k, _, _ in KIND_CATALOG)
_KNOWN_SET = frozenset(KNOWN_KINDS)

DEFAULT_RING_SIZE = 512
DEFAULT_MAX_BYTES = 4_000_000

# durable frame: little-endian (payload length, crc32) then the JSON
# payload — fleet/spool.py's framing, so a torn tail is detected, not
# parsed
_FRAME = struct.Struct("<II")


def canonical_json(obj: Any) -> bytes:
    """Canonical (sorted-key, no-whitespace) JSON bytes: the bundle /
    merged-timeline determinism contract — same content, same SHA-256."""
    return json.dumps(obj, sort_keys=True,
                      separators=(",", ":")).encode()


class EventJournal:
    """Bounded-ring (+ optional durable) journal with an embedded
    :class:`HlcClock`. One per process in production; one per replica in
    the chaos harness (each on the conductor's virtual clock)."""

    def __init__(self, *, enabled: bool = False, node: str = "",
                 ring_size: int = DEFAULT_RING_SIZE,
                 dir: str = "", max_bytes: int = DEFAULT_MAX_BYTES,
                 clock: Callable[[], float] = time.time,
                 max_drift_s: float = DEFAULT_MAX_DRIFT_S) -> None:
        self._enabled = bool(enabled)
        self.hlc = HlcClock(node, clock=clock, max_drift_s=max_drift_s)
        self._lock = threading.Lock()
        self._ring: deque[dict[str, Any]] = deque(
            maxlen=max(1, int(ring_size)))
        self._counts: dict[str, int] = {k: 0 for k in KNOWN_KINDS}
        self._dir = dir
        self._max_bytes = max(4096, int(max_bytes))
        self._path = ""
        self._file: Any = None
        self._write_errors = 0
        if enabled and dir:
            self._open_spool()

    # -- emission chokepoint ----------------------------------------------

    @property
    def enabled(self) -> bool:
        return self._enabled

    @property
    def node(self) -> str:
        return self.hlc.node

    def emit(self, kind: str, **fields: Any) -> HLC | None:
        """THE chokepoint. ``kind`` must be cataloged — an unknown kind
        raises so a typo'd emitter fails its first test, exactly like
        ``FaultPlan.from_config`` rejecting unknown sites."""
        if not self._enabled:
            return None
        if kind not in _KNOWN_SET:
            raise ValueError(
                f"journal kind {kind!r} is not in KIND_CATALOG — add it "
                "to kepler_tpu_torch/fleet/journal.py (and run "
                "python hack/gen_journal_docs.py)")
        stamp = self.hlc.now()
        entry: dict[str, Any] = {"hlc": stamp.to_dict(), "kind": kind,
                                 "fields": fields}
        with self._lock:
            self._ring.append(entry)
            self._counts[kind] += 1
            if self._file is not None:
                self._append_frame(entry)
        return stamp

    # -- HLC piggyback surface --------------------------------------------

    def header(self) -> str | None:
        """Outbound ``X-Kepler-HLC`` value (advances the clock), or
        ``None`` when the journal is disabled (no header emitted)."""
        if not self._enabled:
            return None
        return self.hlc.now().encode()

    def observe(self, remote: HLC) -> HLC | None:
        """Merge an inbound (already laundered) stamp."""
        if not self._enabled:
            return None
        return self.hlc.observe(remote)

    def observe_text(self, text: object) -> bool:
        """Launder + merge a wire-borne stamp. Returns False when the
        value is present but hostile (caller decides 400 vs ignore);
        True for absent/valid."""
        if text is None or not self._enabled:
            return True
        remote = parse_hlc(text)
        if remote is None:
            return False
        self.hlc.observe(remote)
        return True

    # -- views ------------------------------------------------------------

    def snapshot(self, since: HLC | None = None,
                 limit: int | None = None) -> list[dict[str, Any]]:
        """Ring contents in HLC order, strictly after ``since``."""
        with self._lock:
            entries = list(self._ring)
        if since is not None:
            key = (since.phys_us, since.logical, since.node)
            entries = [e for e in entries
                       if (e["hlc"]["phys_us"], e["hlc"]["logical"],
                           e["hlc"]["node"]) > key]
        if limit is not None and limit >= 0:
            entries = entries[:limit]
        return entries

    def counts(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def stats(self) -> dict[str, Any]:
        with self._lock:
            events = sum(self._counts.values())
            ring_len = len(self._ring)
        return {"enabled": self._enabled, "node": self.node,
                "events_total": events, "ring": ring_len,
                "spool": self._path, "write_errors": self._write_errors,
                "hlc_clamped_total": self.hlc.clamped_total(),
                "hlc_drift_seconds": self.hlc.drift_seconds()}

    # -- prometheus -------------------------------------------------------

    def collect(self) -> Iterator[Any]:
        """prometheus_client custom-collector hook (kepler_fleet_*)."""
        from prometheus_client.core import (
            CounterMetricFamily,
            GaugeMetricFamily,
        )
        counts = self.counts()
        events = CounterMetricFamily(
            "kepler_fleet_journal_events_total",
            "Fleet black-box journal events emitted, by event kind "
            "(closed registry: journal.KIND_CATALOG)",
            labels=["kind"])
        for kind in KNOWN_KINDS:
            events.add_metric([kind], counts.get(kind, 0))
        yield events
        drift = GaugeMetricFamily(
            "kepler_fleet_hlc_drift_seconds",
            "Signed physical-clock offset (remote minus local wall) of "
            "the last HLC stamp observed from a peer")
        drift.add_metric([], self.hlc.drift_seconds())
        yield drift
        clamped = CounterMetricFamily(
            "kepler_fleet_hlc_clamped_total",
            "Inbound HLC stamps whose physical component exceeded the "
            "aggregator.hlcMaxDrift bound and was clamped (hostile or "
            "badly skewed peer clock)")
        clamped.add_metric([], self.hlc.clamped_total())
        yield clamped

    # -- durable spool ----------------------------------------------------

    def _open_spool(self) -> None:
        try:
            os.makedirs(self._dir, exist_ok=True)
            safe = "".join(ch if (ch.isalnum() or ch in "._-") else "_"
                           for ch in (self.node or "journal"))
            self._path = os.path.join(self._dir, f"{safe}.kepj")
            self._file = open(self._path, "ab")
        except OSError as err:
            self._write_errors += 1
            self._file = None
            log.warning("journal spool unavailable (%s); ring only", err)

    def _append_frame(self, entry: dict[str, Any]) -> None:
        payload = canonical_json(entry)
        frame = _FRAME.pack(len(payload),
                            zlib.crc32(payload)) + payload
        try:
            if self._file.tell() + len(frame) > self._max_bytes:
                self._rotate()
            if self._file is not None:
                self._file.write(frame)
                self._file.flush()
        except (OSError, ValueError):
            self._write_errors += 1
            self._file = None

    def _rotate(self) -> None:
        self._file.close()
        os.replace(self._path, self._path + ".1")
        self._file = open(self._path, "ab")

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                with contextlib.suppress(OSError, ValueError):
                    self._file.close()
                self._file = None


def read_frames(path: str) -> list[dict[str, Any]]:
    """Read a durable journal file; a torn tail or a CRC mismatch ends
    the scan cleanly (kill -9 mid-append is the expected case)."""
    entries: list[dict[str, Any]] = []
    try:
        data = open(path, "rb").read()
    except OSError:
        return entries
    off = 0
    while off + _FRAME.size <= len(data):
        length, crc = _FRAME.unpack_from(data, off)
        off += _FRAME.size
        payload = data[off:off + length]
        if len(payload) != length or zlib.crc32(payload) != crc:
            break
        off += length
        try:
            entries.append(json.loads(payload))
        except ValueError:
            break
    return entries


# ---------------------------------------------------------------------------
# module-level installed journal (agent/monitor processes; the
# aggregator holds a per-instance journal so chaos replicas stay apart)
# ---------------------------------------------------------------------------

# starts DISABLED: library imports and unit tests pay only the fast path
_active = EventJournal(enabled=False)


def active() -> EventJournal:
    return _active


def install(jnl: EventJournal) -> EventJournal:
    global _active
    _active = jnl
    return jnl


def emit(kind: str, **fields: Any) -> HLC | None:
    """The process-global emission point. Disabled cost: one global
    read, one attribute check, return — pinned < 1 µs by tests."""
    jnl = _active
    if not jnl._enabled:
        return None
    return jnl.emit(kind, **fields)


def install_from_config(cfg: Any, *, node: str = "",
                        max_drift_s: float = DEFAULT_MAX_DRIFT_S
                        ) -> EventJournal:
    """Build + install from a ``TelemetryConfig`` (cfg.journal holds the
    leaves). Shared by both binaries."""
    j = cfg.journal
    jnl = EventJournal(enabled=j.enabled, node=node,
                       ring_size=j.ring_size, dir=j.dir,
                       max_bytes=j.max_bytes, max_drift_s=max_drift_s)
    return install(jnl)


@contextlib.contextmanager
def installed(jnl: EventJournal) -> Iterator[EventJournal]:
    """Test helper: install for a with-block, always restoring."""
    prev = _active
    install(jnl)
    try:
        yield jnl
    finally:
        install(prev)


class JournalCollector:
    """Registry adapter following the INSTALLED journal at scrape time
    (same contract as telemetry.SelfMetricsCollector)."""

    def __init__(self, jnl: EventJournal | None = None) -> None:
        self._jnl = jnl

    def collect(self) -> Iterator[Any]:
        yield from (self._jnl or _active).collect()


def collector(jnl: EventJournal | None = None) -> JournalCollector:
    return JournalCollector(jnl)


# ---------------------------------------------------------------------------
# /debug/journal endpoint
# ---------------------------------------------------------------------------


def make_journal_handler(jnl: EventJournal | None = None
                         ) -> Callable[[Any],
                                       tuple[int, dict[str, str], bytes]]:
    """APIServer handler: ``GET /debug/journal`` → ``{"node", "enabled",
    "hlc", "events", "cursor"}``. ``?since=<phys:logical:node>`` resumes
    strictly after that stamp (cursor pagination — pass the previous
    response's ``cursor``); ``?limit=N`` bounds the page."""
    from urllib.parse import parse_qs, urlparse

    # keplint: thread-role=http-handler
    def handler(request: Any) -> tuple[int, dict[str, str], bytes]:
        journal = jnl if jnl is not None else _active
        qs = parse_qs(urlparse(request.path).query)
        since: HLC | None = None
        raw_since = qs.get("since", [None])[0]
        if raw_since is not None:
            since = parse_hlc(raw_since)
            if since is None:
                return (400, {"Content-Type": "application/json"},
                        b'{"error": "bad since cursor"}')
        limit: int | None = None
        raw_limit = qs.get("limit", [None])[0]
        if raw_limit is not None:
            try:
                limit = max(0, int(raw_limit))
            except ValueError:
                return (400, {"Content-Type": "application/json"},
                        b'{"error": "bad limit"}')
        events = journal.snapshot(since=since, limit=limit)
        cursor = ""
        if events:
            last = events[-1]["hlc"]
            cursor = HLC(last["phys_us"], last["logical"],
                         last["node"]).encode()
        payload = {"node": journal.node, "enabled": journal.enabled,
                   "stats": journal.stats(), "events": events,
                   "cursor": cursor}
        return (200, {"Content-Type": "application/json"},
                json.dumps(payload).encode())

    return handler
