"""Fleet wire format: NodeReport ⇄ bytes.

The reference has no inter-node plane (SURVEY §2 checklist — Prometheus
scrape is its only aggregation path); this framework adds a DCN leg: node
agents stream per-window feature rows to the cluster aggregator, which
batches them into the `[nodes × pods × features]` tensor (BASELINE.json
north star).

Two versions coexist on the wire, dispatched by magic:

* **Version 1** — a fixed magic, a length-prefixed JSON header (names,
  scalars, array manifest), then the raw little-endian array bytes in
  manifest order. Retained byte-for-byte for old agents.
* **Version 2** (the ingest fast path) — a fixed-layout struct-packed
  binary header (:class:`WireLayoutV2`): every routing/identity field the
  admitted path touches (seq/run/epoch/owner/acked_through, mode, node
  name, transmit stamps) sits at a struct offset, so
  ``peek_routing``/``peek_identity``/``peek_node_name`` are O(1) reads
  off ONE :func:`parse_header` pass — no JSON anywhere on the admitted
  path. Two frame kinds:

  - **keyframe**: the full report; workload arrays decode as
    ``np.frombuffer`` VIEWS over the request body (bounds-checked, zero
    copy) shaped to land straight in ``pack_reports_into`` staging rows;
  - **delta**: only the workload rows that changed against the last
    acked keyframe (changed-index vector + packed f32 values) plus the
    per-window zone/scalar block — or, when nothing changed at all,
    ``FLAG_SAME`` and an empty payload, so an unchanged node costs one
    header parse and nothing else (the wire-side mirror of the device
    plane's delta-H2D). A delta whose base the aggregator doesn't hold
    is answered with a structured 409 needs-keyframe — resend full,
    never a failure.

No pickle anywhere — payloads arrive over the network and are treated as
untrusted: dtypes come from a whitelist, every length is bounds-checked
before allocation, and a malformed frame is a :class:`WireError`, never
a crash or an out-of-bounds write.
"""

from __future__ import annotations

import json
import math
import struct
from typing import Any

import numpy as np

from kepler_tpu_torch.parallel.fleet import NodeReport

MAGIC = b"KTPUFL1\n"
_HEADER_LEN = struct.Struct("<I")
MAX_HEADER_BYTES = 16 << 20
MAX_ARRAY_BYTES = 256 << 20
# batch envelope (batched spool drain): a length-prefixed
# multi-report request so recovery replay ships K spooled records per
# POST instead of one. Each inner record is a full encode_report payload
# — no per-record format fork, and the aggregator runs each through the
# SAME single-report ingest (per-record dedup, quarantine, admission).
BATCH_MAGIC = b"KTPUFB1\n"
_BATCH_COUNT = struct.Struct("<I")
_RECORD_LEN = struct.Struct("<I")
MAX_BATCH_RECORDS = 1024
# node names become Prometheus label values, scoreboard/tracker keys, and
# log fields; the cap matches the scoreboard's name_cap so one contract
# bounds every store keyed on the name
MAX_NODE_NAME = 128

# v2 frame-kind flags (WireLayoutV2 fixed header, `flags` field)
FLAG_DELTA = 1  # delta frame (vs keyframe)
FLAG_KINDS = 2  # keyframe carries a workload_kinds plane
FLAG_REPLAY = 4  # delivery_path == "replay" (transmit-time restamp)
FLAG_SAME = 8  # delta with NOTHING changed: empty payload, base reused


# keplint: sanitizes — the chokepoint that launders a wire-derived node
# name: printable ASCII only (newlines would forge log lines; control
# bytes corrupt label values), length-capped so hostile names can't mint
# unbounded store keys / metric series
def sanitize_node_name(name: str) -> str:
    cleaned = "".join(c for c in name[:MAX_NODE_NAME]
                      if " " <= c <= "\x7e")
    return cleaned.strip()

_DTYPES = {"float32": np.float32, "float64": np.float64,
           "int8": np.int8, "int32": np.int32, "bool": np.bool_}


class WireError(ValueError):
    pass


# keplint: layout-definition — THE v2 frame layout, the single source of
# truth for every struct offset: encoder, decoder, restamp, and the peek
# accessors all derive from this class, so a hand-typed offset can never
# silently diverge (KTL114 forbids raw layout arithmetic outside it).
class WireLayoutV2:
    """Fixed-layout v2 frame.

    ``magic(8) | FIXED | name | run | trace | owner | pad→8`` is the
    header region (``header_len`` bytes, 8-aligned so every f32/f64
    payload offset stays aligned for zero-copy views); the payload
    region follows:

    * keyframe: ``COUNTS_KF (n_zones, n_workloads, zn_len, ids_len,
      meta_len) | zone_deltas f32[Z] | cpu_deltas f32[W] | zone_valid
      u8[Z] | kinds i8[W]? | zone_names blob | ids blob | meta blob``
    * delta: ``COUNTS_DELTA (n_zones, n_changed) | zone_deltas f32[Z] |
      zone_valid u8[Z] | pad→4 | idx i32[n] | val f32[n]`` (all absent
      under ``FLAG_SAME``)

    String blobs are sequences of u16-length-prefixed UTF-8 strings —
    still no JSON anywhere on the frame.
    """

    MAGIC = b"KTPUFL2\n"
    VERSION = 2
    # version u16, flags u16, header_len u32, seq u64, epoch u64,
    # acked_through u64, base_seq u64, mode i32, then six f64s
    # (sent_at, emitted_at, appended_at — NaN = absent — usage_ratio,
    # node_cpu_delta, dt_s), then four u16 string lengths
    # (name, run, trace, owner)
    FIXED = struct.Struct("<HHIQQQQi6d4H")
    COUNTS_KF = struct.Struct("<5I")
    COUNTS_DELTA = struct.Struct("<2I")
    STR_LEN = struct.Struct("<H")
    HDR_ALIGN = 8
    F32 = np.dtype(np.float32).itemsize
    I32 = np.dtype(np.int32).itemsize
    # field caps — every length is validated against these BEFORE any
    # slice or allocation, so hostile frames can't balloon memory
    MAX_NAME = MAX_NODE_NAME
    MAX_RUN = 128
    MAX_TRACE = 128
    MAX_OWNER = 256  # == ring.MAX_PEER_NAME
    MAX_ZONES = 4096
    MAX_WORKLOADS = 1 << 22
    MAX_BLOB = 16 << 20
    MAX_HEADER = 4096

    @classmethod
    def fixed_end(cls) -> int:
        """Offset where the var-length string block starts."""
        return len(cls.MAGIC) + cls.FIXED.size

    @classmethod
    def header_len(cls, name_b: bytes, run_b: bytes, trace_b: bytes,
                   owner_b: bytes) -> int:
        """Total 8-aligned header-region length for these strings."""
        raw = (cls.fixed_end() + len(name_b) + len(run_b) + len(trace_b)
               + len(owner_b))
        pad = (-raw) % cls.HDR_ALIGN
        return raw + pad

    @classmethod
    def pack_header(cls, *, flags: int, seq: int, epoch: int,
                    acked_through: int, base_seq: int, mode: int,
                    sent_at: float, emitted_at: float, appended_at: float,
                    usage_ratio: float, node_cpu_delta: float,
                    dt_s: float, name: str, run: str, trace: str,
                    owner: str) -> bytes:
        """Assemble the full header region (magic through pad)."""
        name_b = name.encode()
        run_b = run.encode()
        trace_b = trace.encode()
        owner_b = owner.encode()
        if len(name_b) > cls.MAX_NAME:
            raise WireError("node_name too long for v2 header")
        if len(run_b) > cls.MAX_RUN or len(trace_b) > cls.MAX_TRACE \
                or len(owner_b) > cls.MAX_OWNER:
            raise WireError("run/trace/owner too long for v2 header")
        hlen = cls.header_len(name_b, run_b, trace_b, owner_b)
        fixed = cls.FIXED.pack(
            cls.VERSION, flags, hlen, seq, epoch, acked_through,
            base_seq, mode, sent_at, emitted_at, appended_at,
            usage_ratio, node_cpu_delta, dt_s,
            len(name_b), len(run_b), len(trace_b), len(owner_b))
        blob = cls.MAGIC + fixed + name_b + run_b + trace_b + owner_b
        return blob + b"\x00" * (hlen - len(blob))


_L2 = WireLayoutV2


def encode_report(report: NodeReport, zone_names: list[str],
                  seq: int = 0, run: str = "",
                  sent_at: float | None = None,
                  trace_id: str = "",
                  emitted_at: float | None = None) -> bytes:
    """Serialize one node's window for the POST /v1/report body.

    ``sent_at`` (agent wall clock, seconds) lets the aggregator detect
    clock-skewed senders; omitted for pre-skew-check agents.
    ``trace_id``/``emitted_at`` open the per-window delivery trace: the
    agent stamps both at WINDOW time (emit), the aggregator closes the
    trace at merge and observes ``received - emitted_at`` into
    ``kepler_fleet_delivery_latency_seconds``. Omitted by pre-telemetry
    agents — the aggregator then simply records no observation."""
    arrays: list[tuple[str, np.ndarray]] = [
        ("zone_deltas_uj", np.ascontiguousarray(
            report.zone_deltas_uj, np.float32)),
        ("zone_valid", np.ascontiguousarray(report.zone_valid, np.bool_)),
        ("cpu_deltas", np.ascontiguousarray(report.cpu_deltas, np.float32)),
    ]
    if report.workload_kinds is not None:
        arrays.append(("workload_kinds", np.ascontiguousarray(
            report.workload_kinds, np.int8)))
    header: dict[str, Any] = {
        "v": 1,
        "seq": seq,
        # per-agent-run nonce: lets the aggregator tell a restarted agent
        # re-sending the same seq value apart from a retransmission
        "run": run,
        "node_name": report.node_name,
        "zone_names": list(zone_names),
        "usage_ratio": float(report.usage_ratio),
        "node_cpu_delta": float(report.node_cpu_delta),
        "dt_s": float(report.dt_s),
        "mode": int(report.mode),
        "workload_ids": list(report.workload_ids),
        "meta": dict(report.meta),
        "arrays": [
            {"name": n, "dtype": str(a.dtype), "shape": list(a.shape)}
            for n, a in arrays
        ],
    }
    if sent_at is not None:
        header["sent_at"] = float(sent_at)
    if trace_id:
        header["trace"] = str(trace_id)
    if emitted_at is not None:
        header["emitted_at"] = float(emitted_at)
    header_bytes = json.dumps(header, separators=(",", ":")).encode()
    parts = [MAGIC, _HEADER_LEN.pack(len(header_bytes)), header_bytes]
    parts += [a.tobytes() for _, a in arrays]
    return b"".join(parts)


def _pack_strs(items: "list[str]") -> bytes:
    parts: list[bytes] = []
    for s in items:
        b = str(s).encode()
        if len(b) > 0xFFFF:
            raise WireError("string too long for v2 blob")
        parts.append(_L2.STR_LEN.pack(len(b)))
        parts.append(b)
    return b"".join(parts)


def _unpack_strs(data: bytes, off: int, end: int,
                 count: "int | None") -> "list[str]":
    """Bounds-checked u16-length-prefixed string blob → list[str]. The
    blob must fill [off, end) exactly; ``count=None`` walks to the end
    instead of expecting a known string count (the meta blob)."""
    out: list[str] = []
    while (off < end) if count is None else (len(out) < count):
        if off + _L2.STR_LEN.size > end:
            raise WireError("truncated v2 string blob")
        (n,) = _L2.STR_LEN.unpack_from(data, off)
        off += _L2.STR_LEN.size
        if off + n > end:
            raise WireError("v2 string overruns its blob")
        out.append(data[off: off + n].decode("utf-8", "replace"))
        off += n
    if off != end:
        raise WireError("trailing bytes in v2 string blob")
    return out


def encode_report_v2(report: NodeReport, zone_names: list[str],
                     seq: int = 0, run: str = "",
                     sent_at: float | None = None,
                     trace_id: str = "",
                     emitted_at: float | None = None) -> bytes:
    """Serialize one node's window as a v2 KEYFRAME (binary header +
    raw little-endian arrays + length-prefixed string blobs). Field
    semantics match :func:`encode_report`; transmit-time fields (owner/
    epoch/acked_through/delivery_path/appended_at) are stamped later by
    :func:`restamp_transmit`."""
    zd = np.ascontiguousarray(report.zone_deltas_uj, np.float32)
    zv = np.ascontiguousarray(report.zone_valid, np.uint8)
    cpu = np.ascontiguousarray(report.cpu_deltas, np.float32)
    kinds = report.workload_kinds
    flags = 0
    kinds_b = b""
    if kinds is not None:
        flags |= FLAG_KINDS
        kinds_b = np.ascontiguousarray(kinds, np.int8).tobytes()
    z, w = int(zd.shape[0]), int(cpu.shape[0])
    if len(zone_names) != z:
        raise WireError("zone_names/zone_deltas length mismatch")
    zn_b = _pack_strs(list(zone_names))
    ids_b = _pack_strs(list(report.workload_ids))
    meta_items: list[str] = []
    for k, v in dict(report.meta).items():
        meta_items.append(str(k))
        meta_items.append(str(v))
    meta_b = _pack_strs(meta_items)
    header = _L2.pack_header(
        flags=flags, seq=int(seq), epoch=0, acked_through=0, base_seq=0,
        mode=int(report.mode),
        sent_at=float(sent_at) if sent_at is not None else math.nan,
        emitted_at=(float(emitted_at) if emitted_at is not None
                    else math.nan),
        appended_at=math.nan,
        usage_ratio=float(report.usage_ratio),
        node_cpu_delta=float(report.node_cpu_delta),
        dt_s=float(report.dt_s),
        name=report.node_name, run=str(run), trace=str(trace_id),
        owner="")
    counts = _L2.COUNTS_KF.pack(z, w, len(zn_b), len(ids_b), len(meta_b))
    return b"".join([header, counts, zd.tobytes(), cpu.tobytes(),
                     zv.tobytes(), kinds_b, zn_b, ids_b, meta_b])


class ParsedHeader:
    """ONE cached header parse, carried from the admission peek through
    ingest: v1 = the JSON header dict (parsed once — ``decode_report``
    reuses it); v2 = the struct fields lifted into the same dict shape,
    so every downstream consumer (skew check, identity coercion, ring
    headers, delivery-trace close) is version-blind."""

    __slots__ = ("version", "header", "flags", "base_seq", "body_off")

    def __init__(self, version: int, header: dict, flags: int,
                 base_seq: int, body_off: int) -> None:
        self.version = version
        self.header = header
        self.flags = flags
        self.base_seq = base_seq
        self.body_off = body_off

    @property
    def is_delta(self) -> bool:
        return bool(self.flags & FLAG_DELTA)

    @property
    def same(self) -> bool:
        return bool(self.flags & FLAG_SAME)

    def routing(self) -> tuple[str, str, int]:
        """Sanitized ``(node_name, delivery_path, mode)`` — the
        admission controller's priority inputs (peek_routing
        semantics)."""
        name = self.header.get("node_name")
        name = sanitize_node_name(name) if isinstance(name, str) else ""
        path = ("replay" if self.header.get("delivery_path") == "replay"
                else "fresh")
        mode = self.header.get("mode")
        if isinstance(mode, bool) or not isinstance(mode, int):
            mode = 0
        return name, path, mode

    def identity(self) -> tuple[str, int]:
        """Coerced ``(run, seq)`` (peek_identity semantics)."""
        seq = self.header.get("seq")
        run = self.header.get("run")
        if isinstance(seq, bool) or not isinstance(seq, int) or seq < 0:
            seq = 0
        if not isinstance(run, str):
            run = ""
        return run, seq


def parse_header(data: bytes) -> ParsedHeader:
    """Version-dispatched single header parse. Raises
    :class:`WireError` on anything that is not a well-formed v1 or v2
    header region (payload regions are validated by the decoders)."""
    if len(data) >= len(_L2.MAGIC) \
            and data[: len(_L2.MAGIC)] == _L2.MAGIC:
        return _parse_header_v2(data)
    if len(data) < len(MAGIC) + _HEADER_LEN.size:
        raise WireError("short payload")
    if data[: len(MAGIC)] != MAGIC:
        raise WireError("bad magic")
    off = len(MAGIC)
    (hlen,) = _HEADER_LEN.unpack_from(data, off)
    off += _HEADER_LEN.size
    if hlen > MAX_HEADER_BYTES or off + hlen > len(data):
        raise WireError("bad header length")
    try:
        header = json.loads(data[off: off + hlen])
    except (json.JSONDecodeError, UnicodeDecodeError) as err:
        raise WireError(f"bad header json: {err}") from err
    if not isinstance(header, dict):
        raise WireError("header is not a mapping")
    return ParsedHeader(1, header, 0, 0, off + hlen)


def _parse_header_v2(data: bytes) -> ParsedHeader:
    fixed_end = _L2.fixed_end()
    if len(data) < fixed_end:
        raise WireError("short v2 payload")
    (version, flags, hlen, seq, epoch, acked, base_seq, mode,
     sent_at, emitted_at, appended_at, ratio, denom, dt,
     name_len, run_len, trace_len, owner_len) = _L2.FIXED.unpack_from(
        data, len(_L2.MAGIC))
    if version != _L2.VERSION:
        raise WireError(f"unsupported wire version {version}")
    if name_len > _L2.MAX_NAME or run_len > _L2.MAX_RUN \
            or trace_len > _L2.MAX_TRACE or owner_len > _L2.MAX_OWNER:
        raise WireError("v2 header string over its cap")
    str_end = fixed_end + name_len + run_len + trace_len + owner_len
    if hlen > _L2.MAX_HEADER or hlen % _L2.HDR_ALIGN \
            or hlen < str_end or hlen > len(data):
        raise WireError("bad v2 header length")
    off = fixed_end
    name = data[off: off + name_len].decode("utf-8", "replace")
    off += name_len
    run = data[off: off + run_len].decode("utf-8", "replace")
    off += run_len
    header: dict[str, Any] = {
        "v": 2,
        "seq": seq,
        "run": run,
        "node_name": name,
        "mode": mode,
        "usage_ratio": ratio,
        "node_cpu_delta": denom,
        "dt_s": dt,
        "epoch": epoch,
        "acked_through": acked,
    }
    if trace_len:
        header["trace"] = data[off: off + trace_len].decode(
            "utf-8", "replace")
    off += trace_len
    if owner_len:
        header["owner"] = data[off: off + owner_len].decode(
            "utf-8", "replace")
    # NaN (x != x) marks an absent stamp — cheaper than math.isnan on
    # the per-record hot path
    if sent_at == sent_at:
        header["sent_at"] = sent_at
    if emitted_at == emitted_at:
        header["emitted_at"] = emitted_at
    if appended_at == appended_at:
        header["appended_at"] = appended_at
    if flags & FLAG_REPLAY:
        header["delivery_path"] = "replay"
    return ParsedHeader(2, header, flags, base_seq, hlen)


def try_parse_header(data: bytes) -> "ParsedHeader | None":
    """Best-effort :func:`parse_header` — None instead of raising (the
    peeks' never-raise contract)."""
    try:
        return parse_header(data)
    except Exception:
        return None


def encode_report_batch(payloads: "list[bytes]") -> bytes:
    """Wrap encoded report payloads in the batch envelope for
    ``POST /v1/reports`` (batched spool drain). Bounded: callers must
    keep batches within :data:`MAX_BATCH_RECORDS`."""
    if not payloads:
        raise WireError("empty report batch")
    if len(payloads) > MAX_BATCH_RECORDS:
        raise WireError(
            f"batch of {len(payloads)} exceeds {MAX_BATCH_RECORDS}")
    parts = [BATCH_MAGIC, _BATCH_COUNT.pack(len(payloads))]
    for p in payloads:
        parts.append(_RECORD_LEN.pack(len(p)))
        parts.append(p)
    return b"".join(parts)


def decode_report_batch(data: bytes) -> "list[bytes]":
    """Split a batch envelope into its per-record payloads (each still
    an opaque ``encode_report`` blob the caller decodes individually).
    The payload arrives over the network: every length is bounds-checked
    before a slice, the record count is capped, and trailing garbage is
    rejected — a malformed envelope is a :class:`WireError`, never an
    allocation or an index error."""
    if len(data) < len(BATCH_MAGIC) + _BATCH_COUNT.size:
        raise WireError("short batch payload")
    if data[: len(BATCH_MAGIC)] != BATCH_MAGIC:
        raise WireError("bad batch magic")
    off = len(BATCH_MAGIC)
    (count,) = _BATCH_COUNT.unpack_from(data, off)
    off += _BATCH_COUNT.size
    if count < 1 or count > MAX_BATCH_RECORDS:
        raise WireError(f"batch count {count} out of range "
                        f"[1, {MAX_BATCH_RECORDS}]")
    out: list[bytes] = []
    for i in range(count):
        if off + _RECORD_LEN.size > len(data):
            raise WireError(f"batch record {i} truncated")
        (rlen,) = _RECORD_LEN.unpack_from(data, off)
        off += _RECORD_LEN.size
        if rlen > MAX_HEADER_BYTES + MAX_ARRAY_BYTES \
                or off + rlen > len(data):
            raise WireError(f"batch record {i} overruns payload")
        out.append(data[off: off + rlen])
        off += rlen
    if off != len(data):
        raise WireError("trailing bytes after batch records")
    return out


# keplint: sanitizes — the node name is laundered through
# sanitize_node_name before it leaves; path/mode collapse to a bounded
# enum, so nothing here can mint hostile store keys or labels
def peek_routing(data: bytes) -> tuple[str, str, int]:
    """Best-effort ``(node_name, delivery_path, mode)`` from a payload —
    the admission controller's pre-decode priority inputs. The name is
    sanitized, the path clamped to ``fresh``/``replay``, the mode to a
    plain int. Never raises; garbage reads as the HIGHEST priority
    class (``("", "fresh", 0)``) so a mangled header is judged by the
    real decode, not shed on a guess."""
    parsed = try_parse_header(data)
    if parsed is None:
        return "", "fresh", 0
    try:
        return parsed.routing()
    except Exception:
        return "", "fresh", 0


def restamp_transmit(data: bytes, sent_at: float,
                     delivery_path: str | None = None,
                     appended_at: float | None = None,
                     owner: str | None = None,
                     epoch: int | None = None,
                     acked_through: int | None = None) -> bytes:
    """Rewrite a report payload's transmit-time header fields in place.

    Spooled records (``fleet.spool``) keep their original ``run``/``seq``
    identity but must carry a TRANSMIT-time ``sent_at``: the aggregator's
    clock-skew quarantine compares ``sent_at`` against its receive time,
    so a backlog replayed hours after the window was measured would look
    like a skewed sender if the append-time stamp rode along.

    ``delivery_path`` ("fresh"/"replay") and ``appended_at`` (the spool's
    original append stamp) are transmit-time properties too — the agent
    only knows at send time whether a window waited out an outage, and
    the aggregator's delivery-latency histogram measures replays from the
    ORIGINAL append time under the ``path="replay"`` label.

    The HA-ingest ring fields are transmit-time as well: ``owner`` (the
    replica the agent believes owns it), ``epoch`` (the agent's known
    ring epoch), and ``acked_through`` (the highest seq the agent has a
    2xx for — any replica's). A spooled record replayed to a NEW owner
    after a hand-off must carry the agent's CURRENT view, not the one
    baked in at append time: ``acked_through`` is how a fresh owner's
    seq tracker seeds without fabricating a leading-gap loss spike for
    windows that were delivered to the previous owner.

    Only the header region is re-serialized — array/payload bytes pass
    through untouched on BOTH versions. Raises :class:`WireError` on a
    payload it cannot parse."""
    if len(data) >= len(_L2.MAGIC) \
            and data[: len(_L2.MAGIC)] == _L2.MAGIC:
        return _restamp_v2(data, sent_at, delivery_path, appended_at,
                           owner, epoch, acked_through)
    if len(data) < len(MAGIC) + _HEADER_LEN.size or \
            data[: len(MAGIC)] != MAGIC:
        raise WireError("bad magic")
    off = len(MAGIC)
    (hlen,) = _HEADER_LEN.unpack_from(data, off)
    off += _HEADER_LEN.size
    if hlen > MAX_HEADER_BYTES or off + hlen > len(data):
        raise WireError("bad header length")
    try:
        header = json.loads(data[off: off + hlen])
    except (json.JSONDecodeError, UnicodeDecodeError) as err:
        raise WireError(f"bad header json: {err}") from err
    if not isinstance(header, dict):
        raise WireError("header is not a mapping")
    header["sent_at"] = float(sent_at)
    if delivery_path is not None:
        header["delivery_path"] = str(delivery_path)
    if appended_at is not None:
        header["appended_at"] = float(appended_at)
    if owner is not None:
        header["owner"] = str(owner)
    if epoch is not None:
        header["epoch"] = int(epoch)
    if acked_through is not None:
        header["acked_through"] = int(acked_through)
    header_bytes = json.dumps(header, separators=(",", ":")).encode()
    return b"".join([MAGIC, _HEADER_LEN.pack(len(header_bytes)),
                     header_bytes, data[off + hlen:]])


def _restamp_v2(data: bytes, sent_at: float,
                delivery_path: str | None, appended_at: float | None,
                owner: str | None, epoch: int | None,
                acked_through: int | None) -> bytes:
    parsed = _parse_header_v2(data)
    hdr = parsed.header
    flags = parsed.flags
    if delivery_path is not None:
        if delivery_path == "replay":
            flags |= FLAG_REPLAY
        else:
            flags &= ~FLAG_REPLAY
    prev_appended = hdr.get("appended_at")
    prev_emitted = hdr.get("emitted_at")
    header = _L2.pack_header(
        flags=flags, seq=hdr["seq"],
        epoch=int(epoch) if epoch is not None else hdr["epoch"],
        acked_through=(int(acked_through) if acked_through is not None
                       else hdr["acked_through"]),
        base_seq=parsed.base_seq, mode=hdr["mode"],
        sent_at=float(sent_at),
        emitted_at=(prev_emitted if isinstance(prev_emitted, float)
                    else math.nan),
        appended_at=(float(appended_at) if appended_at is not None else
                     (prev_appended if isinstance(prev_appended, float)
                      else math.nan)),
        usage_ratio=hdr["usage_ratio"],
        node_cpu_delta=hdr["node_cpu_delta"], dt_s=hdr["dt_s"],
        name=hdr["node_name"], run=hdr["run"],
        trace=hdr.get("trace", ""),
        owner=str(owner) if owner is not None else hdr.get("owner", ""))
    return header + data[parsed.body_off:]


def restamp_sent_at(data: bytes, sent_at: float) -> bytes:
    """Back-compat alias: rewrite only ``sent_at`` (see
    :func:`restamp_transmit`)."""
    return restamp_transmit(data, sent_at)


# keplint: taint-source — the ONLY wire accessor that skips validation
# (the body already failed decoding); callers must sanitize_node_name()
# before the peeked name touches a label, store key, or log line
def peek_node_name(data: bytes) -> str | None:
    """Best-effort node name from a (possibly malformed) payload.

    Used by the aggregator's per-node degradation accounting: when
    ``decode_report`` rejects a body, a salvageable header still tells us
    WHICH node is sending garbage. Never raises; returns None when even
    the header is unreadable."""
    parsed = try_parse_header(data)
    if parsed is None:
        return None
    name = parsed.header.get("node_name")
    return name if isinstance(name, str) and name else None


def peek_identity(data: bytes) -> tuple[str, int]:
    """Best-effort ``(run, seq)`` from a payload (``("", 0)`` when
    unreadable or absent).

    Used by the agent's delivered-watermark accounting: a spooled
    record's identity lives only in its wire header, and the agent
    needs it at ACK time to advance ``acked_through`` — scoped to the
    run, because an old run's replayed seqs say nothing about the
    current run's stream. Never raises."""
    parsed = try_parse_header(data)
    if parsed is None:
        return "", 0
    try:
        return parsed.identity()
    except Exception:
        return "", 0


def _validated_node_name(header: dict) -> str:
    raw = header.get("node_name")
    if not isinstance(raw, str):
        raise WireError("node_name must be a string")
    node_name = sanitize_node_name(raw)
    if not node_name or node_name != raw:
        # reject rather than silently rewrite: an agent sending control
        # bytes or a >128-char name is misconfigured or hostile, and a
        # rewritten identity would split its series mid-stream
        raise WireError("node_name must be 1-128 printable ASCII chars")
    return node_name


# keplint: sanitizes — every field is validated (dtype whitelist, bounds
# checks, node-name charset/length) or the whole report is rejected, so
# decoded output is trusted downstream
def decode_report(data: bytes,
                  parsed: "ParsedHeader | None" = None
                  ) -> tuple[NodeReport, dict[str, Any]]:
    """Parse a report payload → (NodeReport, header). Raises WireError on
    any malformed/oversized input. ``parsed`` (a :func:`parse_header`
    memo) skips the header re-parse — the admitted ingest path parses
    each record's header exactly once.

    v2 KEYFRAMES decode zero-copy: the returned workload arrays are
    read-only ``np.frombuffer`` views over ``data``. v2 DELTA frames
    need base state — use :func:`decode_delta`."""
    if parsed is None:
        parsed = parse_header(data)
    if parsed.version == 2:
        if parsed.is_delta:
            raise WireError("v2 delta frame needs a base keyframe "
                            "(decode_delta)")
        return _decode_keyframe_v2(data, parsed)
    header = parsed.header
    off = parsed.body_off
    if header.get("v") != 1:
        raise WireError(f"unsupported version {header.get('v')!r}")

    arrays: dict[str, np.ndarray] = {}
    for spec in header.get("arrays", []):
        name, dtype_s = spec.get("name"), spec.get("dtype")
        shape = spec.get("shape")
        if dtype_s not in _DTYPES:
            raise WireError(f"dtype {dtype_s!r} not allowed")
        if (not isinstance(shape, list) or len(shape) != 1
                or not isinstance(shape[0], int) or shape[0] < 0):
            raise WireError(f"bad shape {shape!r} for {name!r}")
        dtype = np.dtype(_DTYPES[dtype_s])
        nbytes = shape[0] * dtype.itemsize
        if nbytes > MAX_ARRAY_BYTES or off + nbytes > len(data):
            raise WireError(f"array {name!r} overruns payload")
        arrays[name] = np.frombuffer(
            data, dtype=dtype, count=shape[0], offset=off).copy()
        off += nbytes

    zone_names = header.get("zone_names")
    if (not isinstance(zone_names, list)
            or not all(isinstance(z, str) for z in zone_names)):
        raise WireError("zone_names must be a list of strings")
    node_name = _validated_node_name(header)
    try:
        n_zones = len(zone_names)
        report = NodeReport(
            node_name=node_name,
            zone_deltas_uj=arrays["zone_deltas_uj"],
            zone_valid=arrays["zone_valid"],
            usage_ratio=float(header["usage_ratio"]),
            cpu_deltas=arrays["cpu_deltas"],
            workload_ids=[str(w) for w in header["workload_ids"]],
            node_cpu_delta=float(header["node_cpu_delta"]),
            dt_s=float(header["dt_s"]),
            mode=int(header["mode"]),
            workload_kinds=arrays.get("workload_kinds"),
            meta={str(k): str(v)
                  for k, v in dict(header.get("meta", {})).items()},
        )
    except (KeyError, TypeError) as err:
        raise WireError(f"missing field: {err}") from err
    if report.zone_deltas_uj.shape != (n_zones,):
        raise WireError("zone_deltas/zone_names length mismatch")
    if report.zone_valid.shape != (n_zones,):
        raise WireError("zone_valid/zone_names length mismatch")
    if len(report.workload_ids) != len(report.cpu_deltas):
        raise WireError("workload_ids/cpu_deltas length mismatch")
    if (report.workload_kinds is not None
            and len(report.workload_kinds) != len(report.cpu_deltas)):
        raise WireError("workload_kinds/cpu_deltas length mismatch")
    return report, header


def _kf_section_offsets(data: bytes, parsed: ParsedHeader) -> dict:
    """Validated section offsets of a v2 keyframe payload region —
    every bound checked against ``len(data)`` before any slice, and the
    payload must fill the body exactly (no trailing garbage)."""
    off = parsed.body_off
    if off + _L2.COUNTS_KF.size > len(data):
        raise WireError("truncated v2 keyframe counts")
    z, w, zn_len, ids_len, meta_len = _L2.COUNTS_KF.unpack_from(data, off)
    if z > _L2.MAX_ZONES or w > _L2.MAX_WORKLOADS:
        raise WireError("v2 keyframe zone/workload count over cap")
    if max(zn_len, ids_len, meta_len) > _L2.MAX_BLOB:
        raise WireError("v2 keyframe blob over cap")
    o = off + _L2.COUNTS_KF.size
    sec = {"z": z, "w": w}
    sec["zd"] = o
    o += z * _L2.F32
    sec["cpu"] = o
    o += w * _L2.F32
    sec["zv"] = o
    o += z
    if parsed.flags & FLAG_KINDS:
        sec["kinds"] = o
        o += w
    sec["zn"] = (o, o + zn_len)
    o += zn_len
    sec["ids"] = (o, o + ids_len)
    o += ids_len
    sec["meta"] = (o, o + meta_len)
    o += meta_len
    if o != len(data):
        raise WireError("v2 keyframe payload length mismatch")
    return sec


def _decode_keyframe_v2(data: bytes,
                        parsed: ParsedHeader
                        ) -> tuple[NodeReport, dict[str, Any]]:
    header = parsed.header
    node_name = _validated_node_name(header)
    sec = _kf_section_offsets(data, parsed)
    z, w = sec["z"], sec["w"]
    # zero-copy: read-only views over the request body (the f32 offsets
    # are 4-aligned by the 8-aligned header-region contract), shaped to
    # land straight in pack_reports_into staging rows
    zone_deltas = np.frombuffer(data, np.float32, count=z,
                                offset=sec["zd"])
    cpu_deltas = np.frombuffer(data, np.float32, count=w,
                               offset=sec["cpu"])
    zone_valid = np.frombuffer(data, np.bool_, count=z, offset=sec["zv"])
    kinds = None
    if "kinds" in sec:
        kinds = np.frombuffer(data, np.int8, count=w,
                              offset=sec["kinds"])
    zone_names = _unpack_strs(data, sec["zn"][0], sec["zn"][1], z)
    workload_ids = _unpack_strs(data, sec["ids"][0], sec["ids"][1], w)
    meta_start, meta_end = sec["meta"]
    meta: dict[str, str] = {}
    if meta_end > meta_start:
        flat = _unpack_strs(data, meta_start, meta_end, None)
        if len(flat) % 2:
            raise WireError("v2 meta blob has an odd string count")
        meta = dict(zip(flat[0::2], flat[1::2]))
    # the header dict is this parse's own (one per record): no copy
    header["zone_names"] = zone_names
    header["workload_ids"] = workload_ids
    header["meta"] = meta
    report = NodeReport(
        node_name=node_name,
        zone_deltas_uj=zone_deltas,
        zone_valid=zone_valid,
        usage_ratio=float(header["usage_ratio"]),
        cpu_deltas=cpu_deltas,
        workload_ids=workload_ids,
        node_cpu_delta=float(header["node_cpu_delta"]),
        dt_s=float(header["dt_s"]),
        mode=int(header["mode"]),
        workload_kinds=kinds,
        meta=meta,
    )
    return report, header



# keplint: sanitizes — delta fields are bounds-checked against the base
# (strictly increasing in-range indices, zone count pinned) or the whole
# frame is rejected; merged output reuses already-validated base state
def decode_delta(data: bytes, parsed: ParsedHeader,
                 base_report: NodeReport,
                 base_zone_names: "tuple[str, ...]"
                 ) -> tuple[NodeReport, dict[str, Any], bool]:
    """Merge a v2 DELTA frame against its base keyframe → ``(report,
    header, content_changed)``.

    The caller resolved the base by (node, run, base_seq); this
    function only validates the frame against its shape. A ``FLAG_SAME``
    frame reuses the base arrays outright — the aggregator then keeps
    the node's content identity, and the window engine's delta-H2D
    short-circuits to zero staged rows. Hostile frames (truncated,
    overlong counts, negative/overlapping indices) raise
    :class:`WireError`; nothing is ever written outside the merged
    report."""
    if parsed.version != 2 or not parsed.is_delta:
        raise WireError("not a v2 delta frame")
    header = parsed.header
    # fast path: the base was resolved BY this frame's name, and the
    # base's own name passed keyframe validation — a bytewise match
    # needs no re-sanitization (hot path: every delta, every window)
    raw_name = header.get("node_name")
    if raw_name == base_report.node_name:
        node_name = base_report.node_name
    else:
        node_name = _validated_node_name(header)
        if node_name != base_report.node_name:
            raise WireError("delta node_name does not match its base")
    base_cpu = np.asarray(base_report.cpu_deltas)
    w = int(base_cpu.shape[0])
    off = parsed.body_off
    scalars_same = (
        header["usage_ratio"] == float(base_report.usage_ratio)
        and header["node_cpu_delta"] == float(base_report.node_cpu_delta)
        and header["dt_s"] == float(base_report.dt_s)
        and header["mode"] == int(base_report.mode))
    # the header dict is this parse's own (one per record) — extend in
    # place, sharing the base's already-validated identity planes
    header["zone_names"] = base_zone_names
    header["workload_ids"] = base_report.workload_ids
    header["meta"] = base_report.meta
    if parsed.same:
        if off != len(data):
            raise WireError("FLAG_SAME delta carries payload bytes")
        report = NodeReport(
            node_name=node_name,
            zone_deltas_uj=base_report.zone_deltas_uj,
            zone_valid=base_report.zone_valid,
            usage_ratio=float(header["usage_ratio"]),
            cpu_deltas=base_report.cpu_deltas,
            workload_ids=base_report.workload_ids,
            node_cpu_delta=float(header["node_cpu_delta"]),
            dt_s=float(header["dt_s"]),
            mode=int(header["mode"]),
            workload_kinds=base_report.workload_kinds,
            meta=header["meta"],
        )
        return report, header, not scalars_same
    if off + _L2.COUNTS_DELTA.size > len(data):
        raise WireError("truncated v2 delta counts")
    z, n_changed = _L2.COUNTS_DELTA.unpack_from(data, off)
    if z != len(base_zone_names):
        raise WireError("delta zone count does not match its base")
    if n_changed > w:
        raise WireError("delta changes more rows than the base holds")
    o = off + _L2.COUNTS_DELTA.size
    zd_off = o
    o += z * _L2.F32
    zv_off = o
    o += z
    o += (-o) % _L2.I32  # pad so the index vector stays 4-aligned
    idx_off = o
    o += n_changed * _L2.I32
    val_off = o
    o += n_changed * _L2.F32
    if o != len(data):
        raise WireError("v2 delta payload length mismatch")
    zone_deltas = np.frombuffer(data, np.float32, count=z, offset=zd_off)
    zone_valid = np.frombuffer(data, np.bool_, count=z, offset=zv_off)
    cpu = base_cpu
    if n_changed:
        idx = np.frombuffer(data, np.int32, count=n_changed,
                            offset=idx_off)
        # strictly-increasing in-range check: a Python walk beats numpy
        # at typical delta sizes (a handful of active rows), and numpy
        # takes over past the crossover
        if n_changed <= 64:
            ints = idx.tolist()
            ok = 0 <= ints[0] and ints[-1] < w and all(
                a < b for a, b in zip(ints, ints[1:]))
        else:
            ok = bool(idx[0] >= 0 and idx[-1] < w
                      and (idx[1:] > idx[:-1]).all())
        if not ok:
            raise WireError("delta indices must be strictly increasing "
                            "and inside the base workload range")
        vals = np.frombuffer(data, np.float32, count=n_changed,
                             offset=val_off)
        cpu = base_cpu.copy()
        cpu[idx] = vals
    report = NodeReport(
        node_name=node_name,
        zone_deltas_uj=zone_deltas,
        zone_valid=zone_valid,
        usage_ratio=float(header["usage_ratio"]),
        cpu_deltas=cpu,
        workload_ids=base_report.workload_ids,
        node_cpu_delta=float(header["node_cpu_delta"]),
        dt_s=float(header["dt_s"]),
        mode=int(header["mode"]),
        workload_kinds=base_report.workload_kinds,
        meta=header["meta"],
    )
    return report, header, True


def encode_delta_v2(full: bytes, base: bytes) -> "bytes | None":
    """Derive a v2 DELTA frame: ``full`` (this window's keyframe bytes)
    expressed against ``base`` (the last ACKED keyframe's bytes). Both
    are the agent's OWN payloads, but are still validated structurally.

    Returns None when a delta cannot represent the change — different
    run/name/mode, a changed workload set (ids/kinds), or a changed zone
    axis — in which case the caller ships the keyframe. Bitwise
    comparison throughout, so NaN-carrying rows conservatively count as
    changed instead of flapping."""
    try:
        fp = parse_header(full)
        bp = parse_header(base)
        if fp.version != 2 or bp.version != 2 or fp.is_delta \
                or bp.is_delta:
            return None
        fh, bh = fp.header, bp.header
        if fh["run"] != bh["run"] or not fh["run"] \
                or fh["node_name"] != bh["node_name"] \
                or fh["mode"] != bh["mode"]:
            return None
        fs = _kf_section_offsets(full, fp)
        bs = _kf_section_offsets(base, bp)
        z, w = fs["z"], fs["w"]
        if (z, w) != (bs["z"], bs["w"]):
            return None
        # identity planes must match bytewise: ids, kinds, zone names
        if full[fs["ids"][0]: fs["ids"][1]] \
                != base[bs["ids"][0]: bs["ids"][1]]:
            return None
        if full[fs["zn"][0]: fs["zn"][1]] \
                != base[bs["zn"][0]: bs["zn"][1]]:
            return None
        if ("kinds" in fs) != ("kinds" in bs):
            return None
        if "kinds" in fs and full[fs["kinds"]: fs["kinds"] + w] \
                != base[bs["kinds"]: bs["kinds"] + w]:
            return None
        if full[fs["meta"][0]: fs["meta"][1]] \
                != base[bs["meta"][0]: bs["meta"][1]]:
            return None
        # bitwise row diff (u32 views — NaN-exact)
        cur = np.frombuffer(full, np.uint32, count=w, offset=fs["cpu"])
        prev = np.frombuffer(base, np.uint32, count=w, offset=bs["cpu"])
        changed = np.flatnonzero(cur != prev).astype(np.int32)
        zones_same = (
            full[fs["zd"]: fs["zd"] + z * _L2.F32]
            == base[bs["zd"]: bs["zd"] + z * _L2.F32]
            and full[fs["zv"]: fs["zv"] + z]
            == base[bs["zv"]: bs["zv"] + z])
        scalars_same = (
            fh["usage_ratio"] == bh["usage_ratio"]
            and fh["node_cpu_delta"] == bh["node_cpu_delta"]
            and fh["dt_s"] == bh["dt_s"])
        flags = (fp.flags & FLAG_REPLAY) | FLAG_DELTA
        if changed.size == 0 and zones_same and scalars_same:
            flags |= FLAG_SAME
            payload = b""
        else:
            vals = np.frombuffer(full, np.float32, count=w,
                                 offset=fs["cpu"])[changed]
            zd = full[fs["zd"]: fs["zd"] + z * _L2.F32]
            zv = full[fs["zv"]: fs["zv"] + z]
            head_len = _L2.COUNTS_DELTA.size + len(zd) + len(zv)
            pad = b"\x00" * ((-head_len) % _L2.I32)
            payload = b"".join([
                _L2.COUNTS_DELTA.pack(z, int(changed.size)), zd, zv,
                pad, changed.tobytes(), vals.tobytes()])
        sent = fh.get("sent_at")
        emitted = fh.get("emitted_at")
        appended = fh.get("appended_at")
        header = _L2.pack_header(
            flags=flags, seq=fh["seq"], epoch=fh["epoch"],
            acked_through=fh["acked_through"], base_seq=bh["seq"],
            mode=fh["mode"],
            sent_at=sent if isinstance(sent, float) else math.nan,
            emitted_at=(emitted if isinstance(emitted, float)
                        else math.nan),
            appended_at=(appended if isinstance(appended, float)
                         else math.nan),
            usage_ratio=fh["usage_ratio"],
            node_cpu_delta=fh["node_cpu_delta"], dt_s=fh["dt_s"],
            name=fh["node_name"], run=fh["run"],
            trace=fh.get("trace", ""), owner=fh.get("owner", ""))
        return header + payload
    except WireError:
        return None


def transcode_to_v1(data: bytes) -> bytes:
    """A v2 KEYFRAME re-encoded as a v1 frame (the agent's downgrade
    path against an old replica that answers 415/400 to v2). v1 frames
    pass through untouched; a v2 DELTA cannot be transcoded without its
    base and raises :class:`WireError` — the agent keyframes instead."""
    if data[: len(MAGIC)] == MAGIC:
        return data
    parsed = parse_header(data)
    if parsed.is_delta:
        raise WireError("cannot transcode a v2 delta without its base")
    report, header = _decode_keyframe_v2(data, parsed)
    sent = header.get("sent_at")
    emitted = header.get("emitted_at")
    return encode_report(
        report, list(header["zone_names"]), seq=header["seq"],
        run=header["run"],
        sent_at=sent if isinstance(sent, float) else None,
        trace_id=header.get("trace", ""),
        emitted_at=emitted if isinstance(emitted, float) else None)
