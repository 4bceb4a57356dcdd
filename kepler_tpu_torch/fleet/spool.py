"""Crash-safe on-disk report spool: the durable leg of the delivery plane.

The agent→aggregator path is *retry*-safe (backoff, breaker); this
module makes it *crash*-safe. Every window report is appended to an
append-only, segment-rotated spool before any send attempt, and the ack
cursor only advances on a 2xx — so an agent crash, a node reboot, or an
aggregator outage longer than the in-memory ring replays the backlog
instead of silently losing it (at-least-once delivery; the aggregator's
``(run, seq)`` dedup window makes replays idempotent).

Layout (one directory per agent):

- ``spool-<n>.seg`` — segments of length-prefixed CRC32-framed records::

      frame = <u32 payload_len> <u32 crc32(payload)> <f64 appended_at> payload

  The payload is the existing ``wire.encode_report`` bytes — no wire
  format fork. ``appended_at`` (agent wall clock, via the injected seam)
  exists only for the health probe's oldest-record age.
- ``cursor.json`` — the persisted ack cursor ``{segment, offset}``,
  written via atomic rename. Records before it were 2xx-acknowledged.

Durability contract:

- **Torn tails recover.** A ``kill -9`` mid-append leaves a partial or
  CRC-broken final frame; :meth:`Spool.open` scans the last segment and
  truncates at the first bad frame, so the spool reopens clean and loses
  at most the one record that was being written.
- **fsync policy is configurable.** ``"none"`` (page cache only),
  ``"batch"`` (default: at most one fsync per ``fsync_interval``, issued
  from the agent's DRAIN thread via :meth:`Spool.sync` — the append path,
  which runs inside the monitor's refresh lock, never fsyncs), or
  ``"always"`` (every append pays its fsync inline; the subprocess crash
  tests use this).
- **Bounded.** ``max_bytes``/``max_records`` caps evict the *oldest*
  segment wholesale; every unacked record so evicted is counted
  (``evicted_total`` → ``kepler_fleet_spool_evicted_total``) — overflow
  is loss, and loss must be visible, never silent.

Fault injection sites (``kepler_tpu_torch.fault``): ``disk.write_error``
(append fails cleanly), ``disk.fsync_error`` (fsync fails; the record
stays appended), ``disk.torn_tail`` (a partial frame is written and the
append raises — the deterministic stand-in for kill -9 mid-write).
"""

from __future__ import annotations

# keplint: monotonic-only — cursor/oldest-age math must survive NTP steps;
# wall time only via the injected clock seam (record appended_at stamps).

import json
import logging
import os
import struct
import threading
import time as _time
import zlib
from dataclasses import dataclass
from typing import BinaryIO, Callable

from kepler_tpu_torch import fault
from kepler_tpu_torch.fleet.delivery import plan_ack_cursor, plan_rewind_tail
from kepler_tpu_torch.utils.atomicio import atomic_write_json

log = logging.getLogger("kepler.fleet.spool")

_FRAME = struct.Struct("<IId")  # payload_len, crc32, appended_at
_SEG_PREFIX = "spool-"
_SEG_SUFFIX = ".seg"
_CURSOR_FILE = "cursor.json"
# a single report is a few KiB; anything near the segment cap is corrupt
MAX_RECORD_BYTES = 16 << 20

FSYNC_POLICIES = ("none", "batch", "always")


class SpoolError(OSError):
    """Spool I/O failed; the caller degrades to in-memory-only delivery."""


@dataclass(frozen=True)
class SpoolRecord:
    """One unacked record, as handed to the drain loop."""

    payload: bytes
    appended_at: float  # agent wall clock at append (clock seam)
    segment: int
    offset: int  # frame start within the segment
    # appended by a PREVIOUS process (crash backlog found at open): the
    # structural "this send is a replay" signal for the delivery-latency
    # path label — wall-clock comparisons can't distinguish a crash
    # backlog from a fresh window under a frozen test clock
    recovered: bool = False


def _seg_name(index: int) -> str:
    return f"{_SEG_PREFIX}{index:010d}{_SEG_SUFFIX}"


def _seg_index(name: str) -> int | None:
    if not (name.startswith(_SEG_PREFIX) and name.endswith(_SEG_SUFFIX)):
        return None
    try:
        return int(name[len(_SEG_PREFIX):-len(_SEG_SUFFIX)])
    except ValueError:
        return None


class Spool:
    """Append-only segmented spool with a persisted ack cursor.

    Thread-safe: appends arrive on the monitor's refresh thread (the
    agent's window listener), peek/ack on the agent's drain thread; all
    state lives behind one lock. Disk work per append is one buffered
    write (+ a batched fsync at most once per ``fsync_interval``).
    """

    # keplint: protocol-transition — cursor birth state
    def __init__(
        self,
        directory: str,
        max_bytes: int = 64 << 20,
        max_records: int = 4096,
        segment_bytes: int = 1 << 20,
        fsync: str = "batch",
        fsync_interval: float = 1.0,
        clock: Callable[[], float] | None = None,
        monotonic: Callable[[], float] | None = None,
    ) -> None:
        if fsync not in FSYNC_POLICIES:
            raise ValueError(
                f"unknown fsync policy {fsync!r}; valid: "
                f"{', '.join(FSYNC_POLICIES)}")
        self._dir = directory
        self._max_bytes = max(segment_bytes, max_bytes)
        self._max_records = max(1, max_records)
        self._segment_bytes = max(4096, segment_bytes)
        # rotate every quarter of the record cap too, so the record-cap
        # eviction (whole oldest segments) has useful granularity
        self._segment_records = max(1, self._max_records // 4)
        self._fsync = fsync
        self._fsync_interval = max(0.0, fsync_interval)
        self._clock = clock or _time.time
        self._monotonic = monotonic or _time.monotonic
        self._lock = threading.Lock()
        # segment index → (record_count, byte_size) for sealed segments;
        # the active (highest-index) segment is tracked live
        self._segments: dict[int, tuple[int, int]] = {}  # keplint: guarded-by=_lock
        self._active: int = 0
        self._active_bytes = 0
        self._active_records = 0
        self._write_fh: BinaryIO | None = None
        self._read_fh: BinaryIO | None = None
        self._read_seg = 0
        self._cursor_seg = 0  # keplint: guarded-by=_lock
        self._cursor_off = 0  # keplint: guarded-by=_lock
        self._last_fsync = float("-inf")  # monotonic
        self._dirty = False  # keplint: guarded-by=_lock
        self._peeked: SpoolRecord | None = None  # keplint: guarded-by=_lock
        self._pending_records = 0  # keplint: guarded-by=_lock
        self._stats = {"appended_total": 0, "acked_total": 0,
                       "evicted_total": 0, "truncated_tail_records": 0,
                       "rewound_total": 0,
                       "write_errors_total": 0, "fsync_errors_total": 0}
        self._open()

    # -- open / recovery ---------------------------------------------------

    # keplint: requires-lock=_lock
    # keplint: protocol-transition — recovery clamps the persisted cursor
    def _open(self) -> None:
        os.makedirs(self._dir, exist_ok=True)
        cursor = self._load_cursor()
        indices = sorted(
            i for i in (_seg_index(n) for n in os.listdir(self._dir))
            if i is not None)
        if not indices:
            indices = [1]
            with open(self._seg_path(1), "ab"):
                pass
        # torn-tail recovery on the LAST segment only: earlier segments
        # were sealed by rotation, so a partial frame can only be at the
        # end of the newest one (a kill -9 mid-append)
        for idx in indices[:-1]:
            count, size = self._scan_segment(idx, truncate=False)
            self._segments[idx] = (count, size)
        last = indices[-1]
        count, size = self._scan_segment(last, truncate=True)
        self._active = last
        self._active_records = count
        self._active_bytes = size
        # records below this (segment, offset) watermark were appended by
        # a previous process → their delivery is a replay by construction
        self._open_tail = (last, size)
        self._write_fh = open(self._seg_path(last), "ab")
        # clamp a cursor pointing at an evicted/older segment or past a
        # truncated tail back onto real data
        self._cursor_seg, self._cursor_off = cursor
        if self._cursor_seg not in self._segments \
                and self._cursor_seg != self._active:
            later = [i for i in indices if i >= self._cursor_seg]
            self._cursor_seg = later[0] if later else self._active
            self._cursor_off = 0
        if self._cursor_seg == self._active:
            self._cursor_off = min(self._cursor_off, self._active_bytes)
        # pending backlog from the counts the scan above already produced;
        # only a mid-segment cursor needs one partial re-read
        counts = {**{i: c for i, (c, _s) in self._segments.items()},
                  self._active: self._active_records}
        pending = sum(c for i, c in counts.items() if i > self._cursor_seg)
        if self._cursor_off == 0:
            pending += counts.get(self._cursor_seg, 0)
        else:
            pending += self._records_from(self._cursor_seg,
                                          self._cursor_off)
        self._pending_records = pending
        if self._pending_records:
            log.info("spool %s: replaying %d unacked record(s) from a "
                     "previous run", self._dir, self._pending_records)

    def _scan_segment(self, index: int, truncate: bool) -> tuple[int, int]:
        """→ (records, valid_bytes); optionally truncate a torn tail."""
        path = self._seg_path(index)
        records = 0
        good = 0
        try:
            size = os.path.getsize(path)
            with open(path, "rb") as fh:
                while True:
                    header = fh.read(_FRAME.size)
                    if len(header) < _FRAME.size:
                        break
                    length, crc, _ts = _FRAME.unpack(header)
                    if length > MAX_RECORD_BYTES or \
                            good + _FRAME.size + length > size:
                        break
                    payload = fh.read(length)
                    if len(payload) < length or \
                            zlib.crc32(payload) != crc:
                        break
                    good += _FRAME.size + length
                    records += 1
        except OSError as err:
            raise SpoolError(f"cannot scan spool segment {path}: {err}") \
                from err
        if truncate and good < size:
            self._stats["truncated_tail_records"] += 1
            log.warning("spool %s: truncating torn tail (%d bytes) — "
                        "recovered from an interrupted append", path,
                        size - good)
            with open(path, "ab") as fh:
                fh.truncate(good)
        return records, good

    # keplint: requires-lock=_lock
    def _count_pending(self) -> int:
        """Records at/after the cursor (startup only; kept incrementally
        afterwards)."""
        pending = 0
        for idx in sorted([*self._segments, self._active]):
            if idx < self._cursor_seg:
                continue
            start = self._cursor_off if idx == self._cursor_seg else 0
            pending += self._records_from(idx, start)
        return pending

    def _records_from(self, index: int, offset: int) -> int:
        count = 0
        try:
            fh = open(self._seg_path(index), "rb")
        except OSError:
            return 0  # unreadable segment: counted as loss by the caller
        with fh:
            fh.seek(offset)
            while True:
                header = fh.read(_FRAME.size)
                if len(header) < _FRAME.size:
                    return count
                length, _crc, _ts = _FRAME.unpack(header)
                payload = fh.read(length)
                if len(payload) < length:
                    return count
                count += 1

    # -- append ------------------------------------------------------------

    def append(self, payload: bytes) -> bool:
        """Durably append one encoded report. Returns False (and counts a
        write error) when the disk rejects it — the caller's in-memory
        path still runs, so a sick disk degrades to PR-1 semantics
        instead of blocking the monitor."""
        frame = _FRAME.pack(len(payload), zlib.crc32(payload),
                            self._clock())
        with self._lock:
            fh = None
            try:
                if (self._active_bytes >= self._segment_bytes
                        or self._active_records >= self._segment_records):
                    self._rotate_locked()
                self._evict_for_locked(len(frame) + len(payload))
                fh = self._write_fh
                assert fh is not None  # opened in _open()
                spec = fault.fire("disk.torn_tail")
                if spec is not None:
                    # the deterministic kill -9 stand-in: part of the
                    # frame lands on disk, then the "process dies"
                    torn = (frame + payload)[:max(1, int(spec.arg or
                                                         _FRAME.size + 3))]
                    fh.write(torn)
                    fh.flush()
                    raise SpoolError("fault-injected torn write")
                if fault.fire("disk.write_error") is not None:
                    raise SpoolError("fault-injected write error")
                fh.write(frame)
                fh.write(payload)
                fh.flush()
            except (OSError, ValueError) as err:
                # ValueError covers writes on a handle something closed
                # underneath us — any of these must degrade, never raise
                # into the monitor's refresh thread
                self._stats["write_errors_total"] += 1
                log.warning("spool append failed: %s", err)
                # a SURVIVED write error must leave the stream framed: any
                # partial bytes are cut back to the last good frame (a real
                # kill -9 never gets here — open() truncates its torn tail)
                if fh is not None:
                    try:
                        fh.truncate(self._active_bytes)
                        fh.seek(self._active_bytes)
                    except (OSError, ValueError):
                        pass
                return False
            self._active_bytes += len(frame) + len(payload)
            self._active_records += 1
            self._pending_records += 1
            self._stats["appended_total"] += 1
            self._dirty = True
            if self._fsync == "always":
                # the caller opted into paying the fsync per append
                self._fsync_locked()
        return True

    def sync(self) -> None:
        """Batched-durability tick — called from the agent's DRAIN
        thread (every wake cycle) and on close, never from the append
        path: ``append()`` runs inside the monitor's refresh lock, where
        a slow disk's fsync would stall attribution and every concurrent
        scrape. Worst case the batch policy leaves ``fsync_interval`` +
        one wake period of appends in the page cache — that is the
        documented trade against a zero-cost hot path."""
        if self._fsync != "batch":
            return
        with self._lock:
            now = self._monotonic()
            if (not self._dirty
                    or now - self._last_fsync < self._fsync_interval):
                return
            self._last_fsync = now
            self._fsync_locked()

    # keplint: requires-lock=_lock
    def _fsync_locked(self) -> None:
        try:
            if fault.fire("disk.fsync_error") is not None:
                raise SpoolError("fault-injected fsync error")
            assert self._write_fh is not None
            os.fsync(self._write_fh.fileno())
            self._dirty = False
        except OSError as err:
            # the record is written (page cache); only the durability
            # guarantee weakened — count it, keep serving
            self._stats["fsync_errors_total"] += 1
            log.warning("spool fsync failed: %s", err)

    # keplint: requires-lock=_lock
    def _rotate_locked(self) -> None:
        # open the NEW segment first: if the disk refuses (full, r/o),
        # the raise leaves every field untouched and the old handle open,
        # so the spool keeps limping on the current segment instead of
        # wedging on a closed file
        new_fh = open(self._seg_path(self._active + 1), "ab")
        old_fh = self._write_fh
        self._segments[self._active] = (self._active_records,
                                        self._active_bytes)
        self._active += 1
        self._active_records = 0
        self._active_bytes = 0
        self._write_fh = new_fh
        if old_fh is not None:
            try:
                if self._fsync != "none":
                    # seal durably: sync() only ever reaches the ACTIVE
                    # fd, so an unsynced tail closed here would sit in
                    # page cache until kernel writeback — outliving the
                    # documented batch-durability window. Rotation is
                    # rare (once per segment), so the cost stays off the
                    # per-window path.
                    os.fsync(old_fh.fileno())
                old_fh.close()
            except OSError as err:
                self._stats["fsync_errors_total"] += 1
                log.warning("spool segment seal fsync failed: %s", err)
                try:
                    old_fh.close()
                except OSError:
                    pass

    # -- eviction (byte/record caps) ----------------------------------------

    # keplint: requires-lock=_lock
    # keplint: protocol-transition — eviction hops the cursor off dead segments
    def _evict_for_locked(self, incoming: int) -> None:
        """Evict oldest sealed segments until the incoming frame fits the
        caps. Unacked records in an evicted segment are LOST — counted in
        ``evicted_total`` so prolonged overflow is alertable."""
        while self._segments and (
                self._total_bytes_locked() + incoming > self._max_bytes
                or self._total_records_locked() + 1 > self._max_records):
            oldest = min(self._segments)
            count, _size = self._segments.pop(oldest)
            lost = count
            if oldest < self._cursor_seg:
                lost = 0  # fully acked segment: nothing unacked lost
            elif oldest == self._cursor_seg:
                lost = self._records_from(oldest, self._cursor_off)
            if lost:
                self._stats["evicted_total"] += lost
                self._pending_records -= lost
                log.warning("spool cap reached: evicted segment %d with "
                            "%d unacked record(s)", oldest, lost)
            try:
                os.unlink(self._seg_path(oldest))
            except OSError:
                pass
            if self._cursor_seg <= oldest:
                self._cursor_seg = oldest + 1
                self._cursor_off = 0
                self._persist_cursor_locked()
            if self._read_seg <= oldest:
                self._close_read_locked()
            self._peeked = None

    def _total_bytes_locked(self) -> int:
        return sum(s for _, s in self._segments.values()) \
            + self._active_bytes

    def _total_records_locked(self) -> int:
        return sum(c for c, _ in self._segments.values()) \
            + self._active_records

    # -- drain (peek / ack) --------------------------------------------------

    # keplint: protocol-transition — the exhausted-segment cursor hop
    def peek(self) -> SpoolRecord | None:
        """Next unacked record, or None when fully drained. Repeated
        peeks without an ack return the same record."""
        with self._lock:
            if self._peeked is not None:
                return self._peeked
            while True:
                rec = self._read_at_locked(self._cursor_seg,
                                           self._cursor_off)
                if rec is not None:
                    self._peeked = rec
                    return rec
                # cursor segment exhausted: hop to the next segment, or
                # report drained when already on the active one
                if self._cursor_seg >= self._active:
                    return None
                nxt = [i for i in [*self._segments, self._active]
                       if i > self._cursor_seg]
                self._cursor_seg = min(nxt)
                self._cursor_off = 0
                self._close_read_locked()

    def peek_batch(self, max_records: int) -> "list[SpoolRecord]":
        """Up to ``max_records`` consecutive unacked records starting at
        the cursor, WITHOUT advancing it — the batched-drain read
        (``/v1/reports``): recovery replay ships K records per request
        instead of one. The first element always equals :meth:`peek`'s
        record, and acking the returned records in order walks the
        cursor past exactly this batch.

        Deliberately side-effect-free (unlike :meth:`peek`, it never
        hops the cursor or recounts the backlog): the scan simply STOPS
        at the first unreadable/corrupt point and the single-record
        path deals with it when the cursor arrives there — a read-ahead
        must never mutate durability state."""
        if max_records <= 0:
            return []
        with self._lock:
            return self._scan_ahead_locked(self._cursor_seg,
                                           self._cursor_off, max_records)

    # keplint: requires-lock=_lock
    def _scan_ahead_locked(self, seg: int, offset: int,
                           max_records: int) -> "list[SpoolRecord]":
        out: list[SpoolRecord] = []
        while len(out) < max_records:
            end = (self._active_bytes if seg == self._active
                   else self._segments.get(seg, (0, 0))[1])
            try:
                with open(self._seg_path(seg), "rb") as fh:
                    while len(out) < max_records \
                            and offset + _FRAME.size <= end:
                        fh.seek(offset)
                        header = fh.read(_FRAME.size)
                        if len(header) < _FRAME.size:
                            return out
                        length, crc, ts = _FRAME.unpack(header)
                        if offset + _FRAME.size + length > end:
                            return out
                        payload = fh.read(length)
                        if len(payload) < length \
                                or zlib.crc32(payload) != crc:
                            return out  # corrupt: stop the read-ahead
                        out.append(SpoolRecord(
                            payload=payload, appended_at=ts,
                            segment=seg, offset=offset,
                            recovered=(seg, offset) < self._open_tail))
                        offset += _FRAME.size + length
            except OSError:
                return out  # unreadable: the drain head will report it
            if len(out) >= max_records or seg >= self._active:
                return out
            nxt = [i for i in [*self._segments, self._active] if i > seg]
            if not nxt:
                return out
            seg, offset = min(nxt), 0
        return out

    # keplint: requires-lock=_lock
    # keplint: protocol-transition — corrupt-region skip moves the cursor
    def _read_at_locked(self, seg: int, offset: int) -> SpoolRecord | None:
        if self._read_fh is None or self._read_seg != seg:
            self._close_read_locked()
            try:
                self._read_fh = open(self._seg_path(seg), "rb")
            except OSError as err:
                if seg == self._active:
                    # transient (fd exhaustion?): do NOT hop the cursor —
                    # the drain stalls and retries on the next wake
                    log.warning("spool: cannot open active segment %d "
                                "(%s); will retry", seg, err)
                    return None
                # a SEALED segment we cannot read is unrecoverable loss:
                # make it visible (the contract: loss is never silent),
                # drop it from the plan, and recount the backlog gauge
                count, _size = self._segments.pop(seg, (0, 0))
                lost = count if offset == 0 else 0  # acked part unknowable
                self._stats["evicted_total"] += lost
                log.warning("spool: sealed segment %d unreadable (%s); "
                            "skipping it — %s unacked record(s) lost",
                            seg, err, lost if offset == 0 else "an unknown "
                            "number of")
                self._pending_records = self._count_pending()
                return None
            self._read_seg = seg
        fh = self._read_fh
        assert fh is not None
        end = (self._active_bytes if seg == self._active
               else self._segments.get(seg, (0, 0))[1])
        if offset + _FRAME.size > end:
            return None
        fh.seek(offset)
        header = fh.read(_FRAME.size)
        if len(header) < _FRAME.size:
            return None
        length, crc, ts = _FRAME.unpack(header)
        if offset + _FRAME.size + length > end:
            return None
        payload = fh.read(length)
        if len(payload) < length or zlib.crc32(payload) != crc:
            # CRC break mid-segment (disk corruption): skip the rest of
            # this segment rather than replaying garbage forever, and
            # recount the pending backlog — the skipped region's record
            # count is unknowable, so the gauge must not drift
            log.warning("spool %s: corrupt record at segment %d offset "
                        "%d; skipping rest of segment",
                        self._dir, seg, offset)
            self._cursor_off = end
            self._pending_records = self._count_pending()
            return None
        return SpoolRecord(payload=payload, appended_at=ts,
                           segment=seg, offset=offset,
                           recovered=(seg, offset) < self._open_tail)

    # keplint: protocol-transition
    def ack(self, rec: SpoolRecord | None = None) -> None:
        """Advance the cursor past ``rec`` (the record whose delivery
        concluded — 2xx or permanent 4xx) and persist it.

        The ack is validated against the CURRENT cursor: if eviction (or
        anything else) moved the cursor since the record was peeked, the
        ack is a no-op — advancing past a record that was never sent
        would silently drop it. ``rec=None`` acks the currently peeked
        record (single-threaded callers/tests)."""
        with self._lock:
            if rec is None:
                rec = self._peeked
            if rec is None:
                return
            # validation against the CURRENT cursor — including the ONE
            # segment hop batched acks (peek_batch) legitimately cross —
            # is the PURE cursor rule (fleet/delivery.py, model-checked
            # by kepmc); anything it rejects means the cursor moved
            # underneath us (cap eviction, a concurrent re-peek) and
            # acking would skip a record that was never sent
            end = (self._active_bytes
                   if self._cursor_seg == self._active
                   else self._segments.get(self._cursor_seg,
                                           (0, 0))[1])
            nxt = [i for i in [*self._segments, self._active]
                   if i > self._cursor_seg]
            new_cursor = plan_ack_cursor(
                (self._cursor_seg, self._cursor_off),
                (rec.segment, rec.offset),
                rec.offset + _FRAME.size + len(rec.payload),
                end, min(nxt) if nxt else None)
            if new_cursor is None:
                return
            self._peeked = None
            self._cursor_seg, self._cursor_off = new_cursor
            self._pending_records = max(0, self._pending_records - 1)
            self._stats["acked_total"] += 1
            self._persist_cursor_locked()
            # fully-acked sealed segments are dead weight: drop them
            for idx in [i for i in self._segments
                        if i < self._cursor_seg]:
                del self._segments[idx]
                try:
                    os.unlink(self._seg_path(idx))
                except OSError:
                    pass

    # keplint: protocol-transition
    def rewind(self, max_records: int) -> int:
        """Move the ack cursor BACK over up to ``max_records`` already-
        acknowledged records so they re-deliver.

        The ingest hand-off's spool-tail replay: when an agent's owner
        moves (membership change, replica loss), the NEW owner has
        never seen the node — re-sending the recent tail rebuilds its
        scoreboard/seq state from real records, and any replica that
        already ingested them absorbs the overlap through the
        ``(run, seq)`` dedup window. Bounded by segment retention:
        fully-acked sealed segments are deleted at ack time, so the
        rewind reaches at most the start of the cursor's current
        segment. Returns how many records the cursor moved back over.
        """
        if max_records <= 0:
            return 0
        with self._lock:
            if self._cursor_off == 0:
                return 0
            end = (self._active_bytes
                   if self._cursor_seg == self._active
                   else self._segments.get(self._cursor_seg, (0, 0))[1])
            end = min(end, self._cursor_off)
            starts: list[int] = []
            try:
                with open(self._seg_path(self._cursor_seg), "rb") as fh:
                    off = 0
                    while off + _FRAME.size <= end:
                        fh.seek(off)
                        header = fh.read(_FRAME.size)
                        if len(header) < _FRAME.size:
                            break
                        length, _crc, _ts = _FRAME.unpack(header)
                        if length > MAX_RECORD_BYTES \
                                or off + _FRAME.size + length > end:
                            break
                        starts.append(off)
                        off += _FRAME.size + length
            except OSError as err:
                log.warning("spool rewind failed (%s); tail not "
                            "re-delivered", err)
                return 0
            # which acked frames re-deliver is the PURE rewind rule
            # (fleet/delivery.py, model-checked by kepmc)
            tail = plan_rewind_tail(starts, self._cursor_off,
                                    max_records)
            if not tail:
                return 0
            self._cursor_off = tail[0]
            self._peeked = None
            self._pending_records += len(tail)
            self._stats["rewound_total"] = (
                self._stats.get("rewound_total", 0) + len(tail))
            self._persist_cursor_locked()
            return len(tail)

    # -- cursor persistence --------------------------------------------------

    def _cursor_path(self) -> str:
        return os.path.join(self._dir, _CURSOR_FILE)

    def _persist_cursor_locked(self) -> None:
        try:
            atomic_write_json(self._cursor_path(),
                              {"v": 1, "segment": self._cursor_seg,
                               "offset": self._cursor_off})
        except OSError as err:
            # a stale cursor only means re-delivery (at-least-once); the
            # aggregator's dedup window absorbs it
            log.warning("spool cursor persist failed: %s", err)

    def _load_cursor(self) -> tuple[int, int]:
        try:
            with open(self._cursor_path(), encoding="utf-8") as fh:
                data = json.load(fh)
            seg, off = int(data["segment"]), int(data["offset"])
            if seg < 1 or off < 0:
                raise ValueError("negative cursor")
            return seg, off
        except FileNotFoundError:
            return 1, 0
        except (OSError, ValueError, TypeError, KeyError) as err:
            # a corrupt cursor re-delivers from the oldest record —
            # at-least-once holds, dedup absorbs it; never crash startup
            log.warning("spool cursor unreadable (%s); replaying from "
                        "oldest record", err)
            return 1, 0

    # -- introspection -------------------------------------------------------

    def pending_records(self) -> int:
        with self._lock:
            return self._pending_records

    def utilization(self) -> float:
        """Fraction of the binding cap in use (0..1): the MAX of byte and
        record utilization — a record-cap-bound spool (small maxRecords,
        roomy maxBytes) must still trip the health probe's early warning
        before eviction starts discarding windows."""
        with self._lock:
            by_bytes = self._total_bytes_locked() / max(1, self._max_bytes)
            by_records = (self._total_records_locked()
                          / max(1, self._max_records))
            return min(1.0, max(by_bytes, by_records))

    def oldest_age(self) -> float | None:
        """Agent-clock seconds since the oldest UNACKED record was
        appended (None when drained) — the backlog-depth probe signal."""
        rec = self.peek()
        if rec is None:
            return None
        return max(0.0, self._clock() - rec.appended_at)

    def stats(self) -> dict:
        with self._lock:
            return dict(self._stats)

    def health(self) -> dict:
        """Probe for the HealthRegistry: degraded when the spool is close
        to evicting (utilization ≥ 0.9) — the operator's early warning
        before overflow starts discarding windows."""
        util = self.utilization()
        age = self.oldest_age()
        out = {
            "ok": util < 0.9,
            "utilization": round(util, 4),
            "pending_records": self.pending_records(),
            **self.stats(),
        }
        if age is not None:
            out["oldest_record_age_s"] = round(age, 3)
        return out

    def close(self) -> None:
        with self._lock:
            if (self._fsync == "batch" and self._dirty
                    and self._write_fh is not None):
                self._fsync_locked()  # final durability flush
            if self._write_fh is not None:
                try:
                    self._write_fh.close()
                except OSError:
                    pass
                self._write_fh = None
            self._close_read_locked()

    def _close_read_locked(self) -> None:
        if self._read_fh is not None:
            try:
                self._read_fh.close()
            except OSError:
                pass
            self._read_fh = None
            self._read_seg = 0

    def _seg_path(self, index: int) -> str:
        return os.path.join(self._dir, _seg_name(index))
