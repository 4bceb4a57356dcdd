"""Fleet agent: streams per-window feature rows to the cluster aggregator.

The node-side half of the fleet plane: subscribes to the monitor's raw window samples, serializes them
(``fleet.wire``), and POSTs to the aggregator's ``/v1/report``. The node's
own Prometheus exporter is untouched — the aggregator is an *additional*
consumer, exactly as Prometheus scrape is in the reference.

Failure model (reference degrade-gracefully stance, hardened): an
unreachable aggregator never blocks or kills the node monitor. Samples
queue in a small ring (newest wins); the send path reuses one persistent
connection, retries with exponential backoff + jitter, and a circuit
breaker sheds sends entirely while open so a dead aggregator costs the
node one failed probe per cooldown instead of a connect timeout per
window. Breaker state is surfaced through :meth:`health` for the API
server's ``/healthz``. Fault-injection points (``kepler_tpu_torch.fault``) cover
the whole path: connect refusal, slow sends, body corruption, clock skew.

Durability: with a ``fleet.spool.Spool`` attached, every window
is appended to the crash-safe on-disk spool before any send attempt and
acknowledged only on a 2xx (or permanent 4xx), so agent crashes and
outages longer than the ring replay the backlog instead of losing it —
replayed records keep their original ``run``+``seq`` identity; only the
transmit-time header fields (``sent_at``, the delivery-latency
``delivery_path``/``appended_at``) are restamped at send. The
breaker/backoff machinery stays the sole send gate in both modes.

Self-telemetry: the emit→spool-append→drain→send legs carry
``telemetry.span`` instrumentation, and every window opens a delivery
trace (``trace`` id + ``emitted_at`` in the wire header) that the
aggregator closes at merge into
``kepler_fleet_delivery_latency_seconds{path="fresh"|"replay"}``.

HA ingest tier: with ``peers`` set (the replicas'
``aggregator.peers`` list), the agent learns the consistent-hash ring
LAZILY — it dials any peer, follows the structured ``421 + owner +
epoch`` redirect to the replica that owns its ``node_name``, and
re-resolves when a response advertises a higher membership epoch. A
replica outage falls back to the machinery above unchanged (backoff,
breaker, spool), with one addition: each consecutive failure rotates to
the next peer, so the first live replica answers with ownership truth
(a 2xx or a redirect). On an owner CHANGE the hand-off is hot: the
agent rewinds its spool tail (``handoff_replay`` records) so the new
owner rebuilds the node's recent state from real records — replicas
that already ingested them absorb the overlap through the ``(run,
seq)`` dedup window, and the ``acked_through`` watermark stamped at
transmit keeps the new owner's gap detection from fabricating loss for
windows the OLD owner acknowledged.
"""

from __future__ import annotations

# keplint: monotonic-only — backoff/breaker/rate-limit math must survive
# NTP steps; wall time only via the injected clock seam (sent_at).

import base64
import collections
import http.client
import json
import logging
import math
import random
import socket
import ssl
import threading
import time as _time
import urllib.parse
import uuid
from typing import Any, Callable, Sequence

from kepler_tpu_torch import fault, telemetry
from kepler_tpu_torch.fleet import journal
from kepler_tpu_torch.fleet.delivery import keyframe_wanted
from kepler_tpu_torch.fleet.ring import coerce_epoch, sanitize_peer
from kepler_tpu_torch.fleet.spool import Spool, SpoolRecord
from kepler_tpu_torch.fleet.wire import (WireError, WireLayoutV2,
                                   encode_delta_v2, encode_report,
                                   encode_report_batch,
                                   encode_report_v2, peek_identity,
                                   restamp_transmit, transcode_to_v1)
from kepler_tpu_torch.monitor.monitor import PowerMonitor, WindowSample
from kepler_tpu_torch.parallel.fleet import MODE_RATIO, NodeReport
from kepler_tpu_torch.service.lifecycle import CancelContext, backoff_with_jitter

log = logging.getLogger("kepler.fleet.agent")

# circuit-breaker states (health()["breaker"])
BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half-open"


class AggregatorRejectedError(http.client.HTTPException):
    """4xx from the aggregator: the delivery path is HEALTHY, this payload
    is permanently rejected (skew, auth, size, malformed). Retrying would
    fail forever and tripping the breaker would shed GOOD reports from an
    aggregator that is demonstrably up — so the drain loop drops the
    sample instead."""

    def __init__(self, status: int) -> None:
        super().__init__(f"aggregator rejected report: {status}")
        self.status = status


class UnsendableRecordError(Exception):
    """A (spooled) record that cannot even be serialized for transmit
    (restamp failed: format drift across an upgrade, CRC-missed
    corruption). Dropped WITHOUT touching the circuit breaker — no
    network contact happened, so it is evidence of nothing."""


class OwnerRedirectError(Exception):
    """421 from a replica that does not own this node: a structured
    redirect naming the owning peer + the ring membership epoch. NOT a
    rejection (the payload is fine) and NOT an outage (the tier
    answered) — the drain loop follows it to the owner and retries the
    SAME window there."""

    def __init__(self, owner: str | None, epoch: int | None) -> None:
        super().__init__(
            f"report redirected to owner {owner!r} (epoch {epoch})")
        self.owner = owner
        self.epoch = epoch


class ThrottledError(Exception):
    """429 from the aggregator: a THROTTLE, not a failure. The tier is
    alive and over its admission budget; the record is safe (spooled or
    still in hand) and will be accepted later — so a 429 must never
    feed the circuit breaker, trip peer rotation, count as a send
    failure, or move the ``_disrupted_at`` replay watermark. The drain
    loop just waits out the (coerced, jittered) Retry-After."""

    def __init__(self, retry_after: float) -> None:
        super().__init__(f"aggregator shedding load "
                         f"(retry after {retry_after:g}s)")
        self.retry_after = retry_after


class _BatchUnsupportedError(Exception):
    """The batch endpoint is not usable against this target (an older
    replica's 404/405, or a 400 for an envelope it cannot parse):
    remember that and fall back to single-record sends — never an
    outage signal, never a reason to drop records."""


class NeedsKeyframeError(Exception):
    """Structured 409 from the aggregator to a wire-v2 DELTA frame: it
    holds no matching base for this node (fresh owner after a hand-off,
    evicted base row, run change). Treated like a 421 — the tier is
    alive and the payload is fine, so the drain loop resends the SAME
    window as a full keyframe: never a failure, never breaker food."""


class _WireDowngradeError(Exception):
    """A 415/400 answered to a v2-encoded frame: an old replica that
    cannot speak wire v2. The target is remembered as v1-only for
    ``wire_degraded_ttl`` (the batch 404/405 downgrade, wire-
    shaped) and the SAME record retries as v1 — nothing dropped,
    nothing counted as an outage."""


# backoff used when a 429 carries no usable Retry-After (absent,
# non-numeric, negative, bool) — an adversarial owner must not be able
# to park an agent, so hostile values coerce HERE, not at honor time
DEFAULT_RETRY_AFTER = 1.0

# byte budget for one batched-drain request: well under the server's
# 64 MiB report-body cap, with headroom for the restamp's header growth
# and the envelope framing. Without this bound a backlog of large
# reports could build a body the server 413s FOREVER — the same batch
# re-peeked every round, the drain wedged.
MAX_BATCH_BYTES = 32 << 20


def coerce_retry_after(raw: object, default: float = DEFAULT_RETRY_AFTER,
                       cap: float = 300.0) -> float:
    """Harden a wire Retry-After (header string or batch-response JSON
    number): non-numeric/negative/bool/non-finite values fall back to
    ``default``; everything is clamped to ``cap`` so a hostile replica
    cannot park an agent forever. Mirrors the run/seq and ring-header
    coercion discipline."""
    cap = max(0.0, cap)
    if isinstance(raw, bool):
        return min(default, cap)
    if isinstance(raw, (int, float)):
        val = float(raw)
    elif isinstance(raw, str):
        try:
            val = float(raw.strip())
        except ValueError:
            return min(default, cap)
    else:
        return min(default, cap)
    if not math.isfinite(val) or val < 0.0:
        return min(default, cap)
    return min(val, cap)


class _TokenBucket:
    """Replay pacer: at most ``rate`` records/s with a burst of
    ``burst`` — a rejoining agent slews its spool backlog in instead of
    dumping it on a replica that just absorbed a herd. Monotonic-clock
    only (injected seam); single-threaded (the drain loop owns it)."""

    __slots__ = ("_rate", "_burst", "_tokens", "_last", "_monotonic")

    def __init__(self, rate: float, burst: int,
                 monotonic: Callable[[], float]) -> None:
        self._rate = max(1e-6, float(rate))
        self._burst = max(1, int(burst))
        self._tokens = float(self._burst)
        self._monotonic = monotonic
        self._last = monotonic()

    def take(self, want: int) -> tuple[int, float]:
        """→ ``(granted, wait_s)``: up to ``want`` tokens now, or
        ``(0, seconds until one accrues)``."""
        now = self._monotonic()
        self._tokens = min(float(self._burst),
                           self._tokens + (now - self._last) * self._rate)
        self._last = now
        if self._tokens < 1.0:
            return 0, (1.0 - self._tokens) / self._rate
        granted = min(max(1, want), int(self._tokens))
        self._tokens -= granted
        return granted, 0.0


def _parse_redirect(data: bytes, headers) -> tuple[str | None, int | None]:
    """(owner, epoch) from a 421 response — body JSON first, the
    ``X-Kepler-Owner``/``X-Kepler-Epoch`` headers as fallback. Both
    values arrive from the network and are laundered through the ring's
    sanitizers; an unusable redirect returns ``(None, None)`` and is
    handled as a failed send, never followed blindly."""
    owner: object = None
    epoch: object = None
    try:
        payload = json.loads(data)
        if isinstance(payload, dict):
            owner = payload.get("owner")
            epoch = payload.get("epoch")
    except (ValueError, UnicodeDecodeError):
        pass
    if owner is None:
        owner = headers.get("X-Kepler-Owner")
    if epoch is None:
        epoch = _epoch_from_header(headers.get("X-Kepler-Epoch"))
    return sanitize_peer(owner), coerce_epoch(epoch)


def _epoch_from_header(raw: str | None) -> int | None:
    if raw is None:
        return None
    try:
        return int(raw)
    except ValueError:
        return None


class _PeerTarget:
    """One dialable ingest replica (parsed once, switched cheaply).

    ``display`` is the credential-stripped identity (no URL userinfo):
    it is what leaves the process — health payloads, log lines, and the
    ``owner`` wire header — so an endpoint of the documented
    ``https://user:pw@agg:28283`` form never leaks its password."""

    __slots__ = ("url", "display", "host", "port", "path", "batch_path",
                 "tls", "auth_header", "tls_ctx")

    def __init__(self, url: str, display: str, host: str, port: int,
                 path: str, tls: bool, auth_header: str, tls_ctx) -> None:
        self.url = url
        self.display = display
        self.host = host
        self.port = port
        self.path = path
        self.batch_path = path + "s"  # /v1/report → /v1/reports
        self.tls = tls
        self.auth_header = auth_header
        self.tls_ctx = tls_ctx


def _parse_target(endpoint: str, tls_skip_verify: bool) -> _PeerTarget:
    u = urllib.parse.urlsplit(endpoint if "//" in endpoint
                              else f"http://{endpoint}")
    if not u.hostname or not u.port:
        raise ValueError(
            f"aggregator endpoint needs host:port, got {endpoint!r}")
    tls = u.scheme == "https"
    auth_header = ""
    if u.username is not None:
        creds = f"{urllib.parse.unquote(u.username)}:" \
                f"{urllib.parse.unquote(u.password or '')}"
        auth_header = "Basic " + base64.b64encode(creds.encode()).decode()
        if not tls:
            log.warning(
                "aggregator endpoint has basic-auth credentials but no "
                "https:// scheme — the Authorization header will go over "
                "the wire in cleartext")
    tls_ctx = None
    if tls:
        tls_ctx = ssl.create_default_context()
        if tls_skip_verify:
            tls_ctx.check_hostname = False
            tls_ctx.verify_mode = ssl.CERT_NONE
    display = (f"{u.scheme}://{u.hostname}:{u.port}" if "//" in endpoint
               else f"{u.hostname}:{u.port}")
    return _PeerTarget(endpoint, display, u.hostname, u.port,
                       (u.path.rstrip("/") or "") + "/v1/report",
                       tls, auth_header, tls_ctx)


class FleetAgent:
    # keplint: protocol-transition — delivery-state birth
    def __init__(
        self,
        monitor: PowerMonitor,
        endpoint: str,
        node_name: str = "",
        mode: int = MODE_RATIO,
        timeout_s: float = 2.0,
        queue_max: int = 8,
        tls_skip_verify: bool = False,
        backoff_initial: float = 0.1,
        backoff_max: float = 5.0,
        breaker_threshold: int = 5,
        breaker_cooldown: float = 10.0,
        flush_timeout_s: float = 2.0,
        clock: Callable[[], float] | None = None,
        monotonic: Callable[[], float] | None = None,
        jitter_seed: int | None = None,
        spool: Spool | None = None,
        peers: Sequence[str] | None = None,
        handoff_replay: int = 8,
        drain_batch_max: int = 1,
        drain_replay_rps: float = 0.0,
        drain_retry_after_max: float = 300.0,
        wire_version: int = 2,
        keyframe_every: int = 16,
        wire_degraded_ttl: float = 60.0,
    ) -> None:
        self._monitor = monitor
        self._endpoint = endpoint
        self._node_name = node_name or socket.gethostname()
        self._mode = mode
        self._timeout = timeout_s
        # in-memory ring of (seq, sample, emitted_at, trace_id): the
        # delivery queue without a spool, the degraded fallback with one
        # (disk write failures). emitted_at/trace ride along because mem
        # items serialize lazily at SEND time, but the delivery trace
        # opens at WINDOW time.
        self._queue: collections.deque[
            tuple[int, WindowSample, float, str]] = \
            collections.deque(maxlen=queue_max)
        # durable delivery: when set, every window is appended to the
        # crash-safe spool before any send attempt and only acked on 2xx
        self._spool = spool
        self._wake = threading.Event()
        # seq is assigned at WINDOW time (enqueue), not send time, so a
        # dropped/evicted window leaves a visible seq gap the aggregator
        # counts as kepler_fleet_windows_lost_total — loss accounting
        # depends on dropped windows consuming sequence numbers
        self._seq = 0
        self._run_nonce = uuid.uuid4().hex[:16]  # identifies this agent run
        self._clock = clock or _time.time
        self._monotonic = monotonic or _time.monotonic
        self._drop_logged: float | None = None  # monotonic of last warning
        # wall clock of the last observed delivery disruption (failed
        # send, or shedding while the breaker is open): a window that was
        # emitted at or before it waited out an outage, so its eventual
        # delivery is labeled path="replay" in the aggregator's
        # delivery-latency histogram. None = never disrupted.
        self._disrupted_at: float | None = None
        # retry/backoff + circuit breaker (jitter is seeded so resilience
        # tests replay the exact same schedule)
        self._backoff_initial = max(backoff_initial, 1e-3)
        self._backoff_max = max(backoff_max, self._backoff_initial)
        self._breaker_threshold = max(1, breaker_threshold)
        self._breaker_cooldown = max(breaker_cooldown, 1e-3)
        self._flush_timeout = max(0.0, flush_timeout_s)
        self._rng = random.Random(jitter_seed)
        self._breaker_state = BREAKER_CLOSED
        self._breaker_open_until = 0.0
        self._breaker_backoff = self._breaker_cooldown  # escalates per reopen
        self._consecutive_failures = 0
        # ("spool", SpoolRecord) | ("mem", seq, sample) | None
        self._inflight: tuple | None = None
        self._conn: http.client.HTTPConnection | None = None
        self._stats = {"sent_total": 0, "send_failures": 0,
                       "dropped_total": 0, "server_rejections": 0,
                       "connects_total": 0,
                       "breaker_opens": 0, "flushed_on_shutdown": 0,
                       "redirects_followed": 0, "failovers": 0,
                       "handoffs": 0, "throttled_total": 0,
                       "drain_batches": 0, "drain_batch_records": 0,
                       "keyframes_sent": 0, "deltas_sent": 0,
                       "keyframe_resends": 0, "wire_downgrades": 0}
        # wire v2 fast path: windows encode as binary v2
        # KEYFRAMES (what the spool stores — replay/hand-off needs no
        # base state); at TRANSMIT time a fresh window whose identity
        # planes match the last ACKED keyframe ships as a delta frame
        # instead (changed rows only; FLAG_SAME when nothing moved).
        # Every `keyframe_every`-th window resends full, a structured
        # 409 needs-keyframe forces the next send full, and a replica
        # answering 415/400 to v2 bytes is remembered as v1-only for
        # `wire_degraded_ttl` then re-probed.
        self._wire_version = 2 if int(wire_version) >= 2 else 1
        self._keyframe_every = max(1, int(keyframe_every))
        self._wire_degraded_ttl = max(1e-3, float(wire_degraded_ttl))
        self._kf_base: "tuple[int, bytes] | None" = None  # (seq, bytes)
        self._since_keyframe = 0
        self._needs_keyframe = False
        self._v1_until: dict[str, float] = {}  # target url → monotonic
        # overload control: batched spool drain + throttle
        # handling. drain_batch_max > 1 ships K spooled records per
        # /v1/reports request during recovery replay; drain_replay_rps
        # token-bucket-paces that replay (0 = unpaced) so a rejoining
        # agent slews its backlog in rather than dumping it; 429
        # Retry-After values are coerced + clamped (a hostile owner
        # must not park the agent) and honored with decorrelated jitter.
        self._drain_batch_max = max(1, int(drain_batch_max))
        # floored: a zero clamp would turn every 429 into an immediate
        # resend — a tight hammer loop that defeats admission control
        self._retry_after_max = max(1e-3, float(drain_retry_after_max))
        self._pacer: _TokenBucket | None = None
        if drain_replay_rps > 0.0:
            self._pacer = _TokenBucket(drain_replay_rps,
                                       self._drain_batch_max,
                                       self._monotonic)
        # decorrelated-jitter state for consecutive throttles (reset on
        # any successful send)
        self._throttle_prev: float | None = None
        self._throttle_logged: float | None = None  # monotonic
        # targets whose batch endpoint answered 404/405/400 (an older
        # replica): fall back to single-record sends there
        self._no_batch_targets: set[str] = set()
        # HA ingest tier: the replica set. With one endpoint this is a
        # 1-peer tier and every ring mechanism below is inert; with
        # ``peers`` (the replicas' aggregator.peers list, basic-auth/TLS
        # carried per URL exactly like the single endpoint) the agent
        # follows 421 owner redirects and fails over between replicas.
        # TLS contexts are built once per peer, not per send.
        self._tls_skip_verify = tls_skip_verify
        urls = [u for u in (list(peers) if peers else []) if u]
        if endpoint and endpoint not in urls:
            urls.insert(0, endpoint)
        if not urls:
            raise ValueError("fleet agent needs an aggregator endpoint "
                             "or a non-empty peers list")
        self._peers = [_parse_target(u, tls_skip_verify) for u in urls]
        # loop/growth bounds FROZEN at the configured membership: a
        # replica naming ever-fresh owners must neither grow the peer
        # list without bound nor raise its own redirect-hop budget
        self._configured_peers = len(self._peers)
        self._max_learned_peers = self._configured_peers + 8
        # ring state, learned lazily off responses: the current owner
        # target, the highest membership epoch seen, redirect-loop
        # accounting, and the delivered watermark (highest seq with a
        # 2xx from ANY replica) stamped into every transmit header
        self._handoff_replay = max(0, int(handoff_replay))
        self._ring_epoch = 0
        self._redirect_hops = 0
        self._acked_through = 0
        # the replica that took the last 2xx: a success landing on a
        # DIFFERENT one means this node's owner moved (whether we got
        # there via a 421 redirect or by failover luck) — that is the
        # hand-off moment, and the spool tail re-delivers
        self._last_ok_target: _PeerTarget | None = None
        self._set_target(self._peers[0])

    def name(self) -> str:
        return "fleet-agent"

    def init(self) -> None:
        self._monitor.add_window_listener(self._on_window)
        if self._spool is not None and self._spool.pending_records():
            self._wake.set()  # replay the crash backlog without waiting
        log.info("fleet agent: node=%s → %s://%s:%d%s%s%s",
                 self._node_name, "https" if self._tls else "http",
                 self._host, self._port, self._path,
                 " (basic auth)" if self._auth_header else "",
                 " (durable spool)" if self._spool is not None else "")

    def _on_window(self, sample: WindowSample) -> None:
        # runs inside the monitor's refresh lock: must stay cheap. The
        # window takes its seq HERE so a window lost anywhere downstream
        # (ring overflow, spool eviction, disk failure) leaves a seq gap
        # the aggregator counts as loss. It also opens its delivery
        # trace here: a trace id + emit wall time ride the wire header
        # so the aggregator can close the trace at merge into a true
        # end-to-end latency. With a spool, the window is made durable
        # before any send attempt (one buffered write; fsync is batched,
        # never per-window by default); a disk failure degrades to the
        # in-memory ring instead of blocking the monitor.
        with telemetry.span("agent.emit"):
            self._seq += 1
            seq = self._seq
            emitted_at = self._clock()
            trace_id = uuid.uuid4().hex[:16]
            if self._spool is not None:
                try:
                    body = self._encode(sample, seq, trace_id=trace_id,
                                        emitted_at=emitted_at)
                    with telemetry.span("agent.spool_append"):
                        appended = self._spool.append(body)
                    if appended:
                        self._wake.set()
                        return
                except Exception:
                    log.exception("spool append failed; falling back to "
                                  "the in-memory ring for this window")
            if len(self._queue) == self._queue.maxlen:
                self._stats["dropped_total"] += 1
            self._queue.append((seq, sample, emitted_at, trace_id))
            self._wake.set()

    # keplint: thread-role=agent
    def run(self, ctx: CancelContext) -> None:
        while not ctx.cancelled():
            self._wake.wait(timeout=0.5)
            self._wake.clear()
            self._drain(ctx)
            if self._spool is not None:
                # batched-durability tick on THIS thread — kept off the
                # append path (monitor refresh lock) and independent of
                # breaker state, so an outage backlog still hits disk
                self._spool.sync()
            if ctx.wait(0.0):
                return

    # keplint: thread-role=shutdown
    def shutdown(self) -> None:
        self._wake.set()
        # best-effort final flush: a clean node drain delivers its queued
        # window(s) instead of abandoning them. Bounded by flush_timeout_s
        # and skipped while the breaker is open (aggregator presumed down).
        # With a spool, anything not flushed stays durable and replays on
        # the next run — the flush is a latency nicety, not the safety net.
        if self._breaker_state != BREAKER_OPEN:
            deadline = self._monotonic() + self._flush_timeout
            while self._monotonic() < deadline:
                item = self._inflight or self._next_item()
                if item is None:
                    break
                self._inflight = item
                try:
                    self._send_item(item)
                except UnsendableRecordError as err:
                    self._finish_item(item)
                    if item[0] != "batch":
                        self._stats["dropped_total"] += 1
                    log.info("shutdown flush: unsendable record (%s)", err)
                    continue
                except ThrottledError as err:
                    # the flush is a latency nicety; a shedding tier has
                    # asked us to go away — the spool keeps everything
                    if item[0] == "batch":
                        self._inflight = None
                    log.info("shutdown flush stopped (throttled): %s", err)
                    break
                except NeedsKeyframeError:
                    self._on_needs_keyframe()
                    continue
                except _WireDowngradeError:
                    self._v1_until[self._target.url] = \
                        self._monotonic() + self._wire_degraded_ttl
                    self._stats["wire_downgrades"] += 1
                    continue
                except _BatchUnsupportedError:
                    self._no_batch_targets.add(self._target.url)
                    self._inflight = None
                    continue
                except OwnerRedirectError as err:
                    if item[0] == "batch":
                        self._inflight = None  # re-peek past acked prefix
                    if self._follow_redirect(err):
                        continue  # retry against the named owner
                    log.info("shutdown flush stopped (unusable "
                             "redirect): %s", err)
                    break
                except AggregatorRejectedError as err:
                    # this one sample is unacceptable; the rest may flush
                    self._finish_item(item)
                    self._stats["dropped_total"] += 1
                    self._stats["server_rejections"] += 1
                    log.info("shutdown flush: report rejected (%s)", err)
                    continue
                except (OSError, http.client.HTTPException) as err:
                    log.info("shutdown flush stopped (%d left): %s",
                             self.backlog(), err)
                    break
                self._finish_item(item)
                self._stats["sent_total"] += 1
                self._stats["flushed_on_shutdown"] += 1
        self._close_conn()
        if self._spool is not None:
            self._spool.close()

    def health(self) -> dict:
        """Probe for the API server's /healthz (server.health registry)."""
        out = {
            "ok": self._breaker_state != BREAKER_OPEN,
            "breaker": self._breaker_state,
            "consecutive_failures": self._consecutive_failures,
            "queued": self.backlog(),
            "target": self._target.display,
            "ring_epoch": self._ring_epoch,
            "acked_through": self._acked_through,
            "wire_version": (1 if self._wire_version < 2
                             or self._target_downgraded()
                             else 2),
            **self._stats,
        }
        if self._spool is not None:
            out["spool_pending"] = self._spool.pending_records()
        return out

    def spool_health(self) -> dict:
        """Spool probe for the HealthRegistry (utilization, oldest-record
        age, eviction counters). Reports ok with no spool configured."""
        if self._spool is None:
            return {"ok": True, "enabled": False}
        return {"enabled": True, **self._spool.health()}

    def backlog(self) -> int:
        """Windows awaiting delivery (spool backlog + in-memory ring).
        An in-flight SPOOL record is still unacked and therefore already
        inside pending_records() — only a mem item (popped off the ring)
        needs counting separately."""
        inflight = self._inflight
        pending = len(self._queue) + (
            1 if inflight is not None and inflight[0] == "mem" else 0)
        if self._spool is not None:
            pending += self._spool.pending_records()
        return pending

    def collect(self):
        """prometheus_client custom-collector hook: the breaker-state
        gauge (always) plus spool durability metrics (only when a spool
        is configured)."""
        from prometheus_client.core import (
            CounterMetricFamily,
            GaugeMetricFamily,
        )
        breaker = GaugeMetricFamily(
            "kepler_fleet_agent_breaker_state",
            "Send circuit-breaker state as an enum gauge: exactly one "
            "of the three state labels is 1 at any scrape (alert on "
            'kepler_fleet_agent_breaker_state{state="open"} == 1)',
            labels=["state"])
        for state in (BREAKER_CLOSED, BREAKER_HALF_OPEN, BREAKER_OPEN):
            breaker.add_metric([state],
                               1.0 if self._breaker_state == state
                               else 0.0)
        yield breaker
        if self._spool is None:
            return
        stats = self._spool.stats()
        evicted = CounterMetricFamily(
            "kepler_fleet_spool_evicted_total",
            "Unacked windows discarded by spool cap eviction")
        evicted.add_metric([], stats["evicted_total"])
        yield evicted
        pending = GaugeMetricFamily(
            "kepler_fleet_spool_pending_records",
            "Windows appended to the spool and not yet acknowledged")
        pending.add_metric([], self._spool.pending_records())
        yield pending
        util = GaugeMetricFamily(
            "kepler_fleet_spool_utilization_ratio",
            "Spool bytes in use as a fraction of the configured cap")
        util.add_metric([], self._spool.utilization())
        yield util
        age = GaugeMetricFamily(
            "kepler_fleet_spool_oldest_record_age_seconds",
            "Age of the oldest unacknowledged spooled window")
        age.add_metric([], self._spool.oldest_age() or 0.0)
        yield age
        errors = CounterMetricFamily(
            "kepler_fleet_spool_write_errors_total",
            "Spool appends that failed at the disk layer")
        errors.add_metric([], stats["write_errors_total"])
        yield errors

    # -- internals ---------------------------------------------------------

    def _drain(self, ctx: CancelContext | None) -> None:
        """Send queued samples, honoring breaker state and backoff.

        Closed: send with exponential-backoff retries; `breaker_threshold`
        consecutive failures open the breaker. Open: shed (no connection
        attempts) until the cooldown elapses, then half-open. Half-open:
        one probe send — success closes the breaker, failure re-opens it
        with a doubled (capped) cooldown.
        """
        if (self._inflight is None and not self._queue
                and (self._spool is None
                     or self._spool.pending_records() == 0)):
            return  # idle wake: no work, no telemetry cycle recorded
        with telemetry.span("agent.drain"):
            self._drain_pending(ctx)

    def _drain_pending(self, ctx: CancelContext | None) -> None:
        while not (ctx is not None and ctx.cancelled()):
            now = self._monotonic()
            if (self._breaker_state == BREAKER_OPEN
                    and now < self._breaker_open_until):
                # shedding: backlog stays in the spool/ring. The outage
                # is still ongoing — keep the disruption watermark
                # current so windows emitted DURING the open window are
                # labeled replays when they finally deliver.
                self._disrupted_at = self._clock()
                return
            item = self._inflight
            if item is None:
                # an elapsed-cooldown breaker stays OPEN until a sample
                # exists to probe with: health must not report recovery
                # that nothing demonstrated
                item = self._next_item()
                if item is None:
                    return
                self._inflight = item
            if item[0] == "batch" and self._pacer is not None:
                # replay pacing: the token bucket caps how fast the
                # backlog slews in — a depleted bucket waits for a
                # token instead of dumping the spool on the aggregator
                granted, wait = self._pacer.take(len(item[1]))
                if granted == 0:
                    self._inflight = None
                    if ctx is None or ctx.wait(wait):
                        return
                    continue
                if granted < len(item[1]):
                    item = ("batch", item[1][:granted])
                    self._inflight = item
            if self._breaker_state == BREAKER_OPEN:
                self._breaker_state = BREAKER_HALF_OPEN
                log.info("circuit breaker half-open: probing aggregator")
            try:
                sent_seq = self._send_item(item)
            except ThrottledError as err:
                # a 429 is a throttle, not a failure: no breaker/
                # failover/disruption bookkeeping — wait out the
                # (coerced) Retry-After with decorrelated jitter and
                # retry. Spooled records stay durable meanwhile.
                self._stats["throttled_total"] += 1
                if item[0] == "batch":
                    # the concluded prefix was acked inside the send;
                    # re-peek the rest from the cursor next round
                    self._inflight = None
                self._log_throttle(err)
                delay = self._throttle_delay(err.retry_after)
                if ctx is None or ctx.wait(delay):
                    return
                continue
            except NeedsKeyframeError:
                # the SAME window retries as a full keyframe: the tier
                # answered (breaker-closing evidence), nothing dropped,
                # nothing counted as a failure — a 421 in wire clothing
                self._on_needs_keyframe()
                self._note_send_success()
                continue
            except _WireDowngradeError:
                # old replica: remember it as v1-only for the TTL and
                # retry the SAME record transcoded down
                self._v1_until[self._target.url] = \
                    self._monotonic() + self._wire_degraded_ttl
                self._stats["wire_downgrades"] += 1
                self._note_send_success()
                log.info("target %s cannot parse wire v2; downgrading "
                         "to v1 for %.0fs", self._target.display,
                         self._wire_degraded_ttl)
                continue
            except _BatchUnsupportedError:
                # older replica without /v1/reports: remember and fall
                # back to single-record sends against this target
                self._no_batch_targets.add(self._target.url)
                self._inflight = None
                continue
            except UnsendableRecordError as err:
                # poisoned record: ack + drop so the backlog moves on,
                # but leave the breaker exactly as it was — this proves
                # nothing about the aggregator (a half-open probe simply
                # passes to the next record). Batch items already acked
                # and counted their poisoned records internally.
                self._finish_item(item)
                if item[0] != "batch":
                    self._stats["dropped_total"] += 1
                    log.warning("dropping unsendable spooled record: %s",
                                err)
                continue
            except OwnerRedirectError as err:
                # this replica answered "not mine": follow the redirect
                # and retry the SAME window against the named owner. An
                # unusable redirect (loop, hostile owner) degrades to
                # the ordinary failure path — backoff + failover decide
                # the next attempt, the spool keeps the record safe.
                if item[0] == "batch":
                    # any concluded prefix was acked in the send;
                    # re-peek the remainder against the new owner
                    self._inflight = None
                if self._follow_redirect(err):
                    continue
                self._on_send_failure(err)
                self._rotate_target()
                if self._breaker_state == BREAKER_OPEN:
                    return
                delay = self._backoff_delay()
                if ctx is None or ctx.wait(delay):
                    return
                continue
            except AggregatorRejectedError as err:
                # the aggregator ANSWERED: delivery is healthy, this
                # payload will never be accepted — drop it and count the
                # response as breaker-closing evidence (retrying a 4xx
                # forever would shed good reports from a live aggregator).
                # A spooled record is acked too: replaying a permanent
                # reject forever would wedge the whole backlog behind it.
                self._finish_item(item)
                self._stats["dropped_total"] += 1
                self._stats["server_rejections"] += 1
                self._log_drop(err)
                self._note_send_success()
                continue
            except (OSError, http.client.HTTPException) as err:
                if item[0] == "batch":
                    # records are durable in the spool; re-peek from
                    # the cursor after backoff (dedup absorbs any
                    # record the replica processed before dying)
                    self._inflight = None
                self._on_send_failure(err)
                # probe a different replica next: during a replica
                # outage successive attempts cycle the peer list, and
                # the first live one answers with ownership truth
                self._rotate_target()
                if self._breaker_state == BREAKER_OPEN:
                    return
                # closed, below threshold: retry after backoff with jitter
                delay = self._backoff_delay()
                if ctx is None or ctx.wait(delay):
                    return
                continue
            self._finish_item(item)
            if sent_seq:
                # delivered watermark (any replica's 2xx): stamped into
                # every transmit header so a NEW owner's gap detection
                # never counts windows a previous owner acknowledged
                self._advance_acked(sent_seq)
            if self._target is not self._last_ok_target:
                if self._last_ok_target is not None:
                    self._handoff_rewind()
                self._last_ok_target = self._target
            self._redirect_hops = 0
            self._stats["sent_total"] += 1
            self._note_send_success()

    def _next_item(self) -> tuple | None:
        """Next undelivered window: the durable spool backlog first (it
        holds the OLDEST windows, including a previous run's replay),
        then the in-memory ring. A backlog deeper than one record
        drains BATCHED (``("batch", [records])``) when batching is
        enabled and the current target supports it — recovery replay
        then ships K records per request instead of one."""
        if self._spool is not None:
            if (self._drain_batch_max > 1
                    and self._target.url not in self._no_batch_targets
                    and self._spool.pending_records() > 1):
                recs = self._spool.peek_batch(self._drain_batch_max)
                # byte-bound the request body: truncate (never drop) at
                # the budget — an over-budget HEAD record falls through
                # to the single path, which always handled big reports
                total = 0
                for k, rec in enumerate(recs):
                    total += len(rec.payload) + 256
                    if total > MAX_BATCH_BYTES and k > 0:
                        recs = recs[:k]
                        break
                if len(recs) > 1:
                    return ("batch", recs)
            rec = self._spool.peek()
            if rec is not None:
                return ("spool", rec)
        if self._queue:
            seq, sample, emitted_at, trace_id = self._queue.popleft()
            return ("mem", seq, sample, emitted_at, trace_id)
        return None

    def _finish_item(self, item: tuple) -> None:
        """The item's delivery concluded (2xx or permanent 4xx): advance
        the spool ack cursor so it is never re-sent. Batch items acked
        per record inside the send — only the in-flight slot clears."""
        self._inflight = None
        if item[0] == "spool":
            assert self._spool is not None
            self._spool.ack(item[1])  # validated: never acks a record
            # other than the one whose delivery just concluded

    def _note_send_success(self) -> None:
        """The aggregator responded — close the breaker, reset schedules."""
        if self._breaker_state != BREAKER_CLOSED:
            log.info("circuit breaker closed: aggregator recovered")
            journal.emit("breaker.close", target=self._target.display,
                         failures=self._consecutive_failures)
        self._breaker_state = BREAKER_CLOSED
        self._consecutive_failures = 0
        self._breaker_backoff = self._breaker_cooldown
        self._throttle_prev = None  # throttle jitter restarts fresh

    def _throttle_delay(self, retry_after: float) -> float:
        """Decorrelated jitter over the server's Retry-After hint:
        consecutive throttles spread a herd of waiting agents apart
        (``sleep = uniform(hint, prev * 3)``, clamped) instead of
        re-synchronizing them on the hint's exact value."""
        base = max(1e-3, retry_after)
        prev = self._throttle_prev if self._throttle_prev else base
        delay = min(max(self._retry_after_max, base),
                    self._rng.uniform(base, max(base, prev * 3.0)))
        self._throttle_prev = delay
        return delay

    def _log_throttle(self, err: ThrottledError) -> None:
        # same monotonic rate-limit SHAPE as send failures, but its OWN
        # timestamp and INFO level — sustained throttling must not
        # suppress the data-loss WARNING (_log_drop), which is the
        # operator's only loss signal exactly during overload
        now = self._monotonic()
        if self._throttle_logged is None \
                or now - self._throttle_logged >= 30.0:
            self._throttle_logged = now
            log.info("aggregator throttled this agent (429): %s", err)

    def _on_send_failure(self, err: Exception) -> None:
        self._stats["send_failures"] += 1
        self._consecutive_failures += 1
        # windows emitted at or before this instant waited through a
        # delivery disruption — their eventual sends are replays
        self._disrupted_at = self._clock()
        self._log_drop(err)
        half_open = self._breaker_state == BREAKER_HALF_OPEN
        if (half_open
                or self._consecutive_failures >= self._breaker_threshold):
            if half_open:
                # failed probe: double the cooldown, capped — but never
                # below the operator-configured base cooldown
                self._breaker_backoff = min(
                    self._breaker_backoff * 2,
                    max(60.0, self._breaker_cooldown))
            self._breaker_state = BREAKER_OPEN
            self._breaker_open_until = (self._monotonic()
                                        + self._breaker_backoff)
            self._stats["breaker_opens"] += 1
            journal.emit("breaker.open", target=self._target.display,
                         failures=self._consecutive_failures,
                         cooldown_s=round(self._breaker_backoff, 3),
                         probe_failed=half_open)
            # shed the in-flight IN-MEMORY sample — by reopen time it is
            # stale. A spooled record is NOT shed: it stays durably
            # unacked and replays after the cooldown (losing it would
            # defeat the spool's whole reason to exist).
            if self._inflight is not None:
                if self._inflight[0] == "mem":
                    self._stats["dropped_total"] += 1
                self._inflight = None
            log.warning("circuit breaker open for %.1fs after %d "
                        "consecutive send failures: %s",
                        self._breaker_backoff,
                        self._consecutive_failures, err)

    def _backoff_delay(self) -> float:
        return backoff_with_jitter(self._backoff_initial, self._backoff_max,
                                   self._consecutive_failures, self._rng)

    def _set_target(self, target: _PeerTarget) -> None:
        self._target = target
        self._host, self._port = target.host, target.port
        self._path, self._tls = target.path, target.tls
        self._auth_header = target.auth_header
        self._tls_ctx = target.tls_ctx

    def _resolve_peer(self, owner: str) -> "_PeerTarget | None":
        """The dialable target for a redirect's (sanitized) owner id: an
        exact URL, display, or host:port match in the known peer list,
        else — lazy ring learning for agents with a stale peers config —
        the owner parsed as a fresh endpoint and remembered. Learning is
        BOUNDED: past the cap an unknown owner is an unusable redirect
        (failure path), never unbounded peer-list growth."""
        for t in self._peers:
            if owner in (t.url, t.display, f"{t.host}:{t.port}"):
                return t
        if len(self._peers) >= self._max_learned_peers:
            return None
        try:
            target = _parse_target(owner, self._tls_skip_verify)
        except ValueError:
            return None
        self._peers.append(target)
        return target

    def _follow_redirect(self, err: OwnerRedirectError) -> bool:
        """Adopt a 421's owner + epoch. Returns False (caller treats it
        as a failed send) when the redirect is unusable: hostile/empty
        owner, a target we are already on, or an owner-disagreement
        loop — the hop budget is frozen at the CONFIGURED peer count
        (not the learned list, which a hostile replica could grow) and
        resets only on a successful send."""
        self._adopt_epoch(err.epoch)
        if err.owner is None:
            return False
        self._redirect_hops += 1
        if self._redirect_hops > self._configured_peers + 2:
            return False
        target = self._resolve_peer(err.owner)
        if target is None or target is self._target:
            return False
        self._close_conn()
        self._set_target(target)
        self._stats["redirects_followed"] += 1
        # the redirect IS an aggregator answer — the ingest tier is
        # alive, so it closes the breaker like any other response
        self._note_send_success()
        log.info("ingest owner moved: following redirect to %s "
                 "(ring epoch %d)", target.display, self._ring_epoch)
        return True

    def _handoff_rewind(self) -> None:
        """Hot hand-off: the last 2xx came from a DIFFERENT replica
        than the one before — this node's owner moved. Re-deliver the
        spool tail so the new owner rebuilds the node's recent state
        from real records; any replica that already ingested them
        absorbs the overlap through the (run, seq) dedup window."""
        if self._spool is None or not self._handoff_replay:
            return
        rewound = self._spool.rewind(self._handoff_replay)
        if rewound:
            self._stats["handoffs"] += 1
            journal.emit("spool.rewind", records=rewound,
                         target=self._target.display)
            # an in-flight peek predates the rewound cursor (its ack
            # would no-op anyway) — drop it so the drain restarts from
            # the rewound tail in order
            self._inflight = None
            log.info("hand-off: re-delivering %d spooled record(s) to "
                     "the new owner %s", rewound, self._target.display)

    def _rotate_target(self) -> None:
        """Outage failover: point the next attempt at the next
        configured peer — the first live replica answers with ownership
        truth (a 2xx if it owns this node, a 421 redirect if not)."""
        if len(self._peers) <= 1:
            return
        i = self._peers.index(self._target)
        self._close_conn()
        self._set_target(self._peers[(i + 1) % len(self._peers)])
        self._stats["failovers"] += 1

    def _connection(self) -> http.client.HTTPConnection:
        if self._conn is not None:
            return self._conn
        if self._tls:
            conn: http.client.HTTPConnection = http.client.HTTPSConnection(
                self._host, self._port, timeout=self._timeout,
                context=self._tls_ctx)
        else:
            conn = http.client.HTTPConnection(self._host, self._port,
                                              timeout=self._timeout)
        self._conn = conn
        self._stats["connects_total"] += 1
        return conn

    def _close_conn(self) -> None:
        conn, self._conn = self._conn, None
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass

    def _encode(self, sample: WindowSample, seq: int,
                trace_id: str = "", emitted_at: float | None = None
                ) -> bytes:
        """Wire bytes for one window — WITHOUT ``sent_at``, which is a
        transmit-time property stamped by :meth:`_post` (a spooled record
        may be sent long after it was encoded). ``trace_id``/
        ``emitted_at`` are WINDOW-time properties: the delivery trace
        opens when the window is emitted, not when it is serialized."""
        batch = sample.batch
        report = NodeReport(
            node_name=self._node_name,
            zone_deltas_uj=sample.zone_deltas_uj,
            zone_valid=sample.zone_valid,
            usage_ratio=sample.usage_ratio,
            cpu_deltas=batch.cpu_deltas,
            workload_ids=list(batch.ids),
            node_cpu_delta=batch.node_cpu_delta,
            dt_s=sample.dt_s,
            mode=self._mode,
            workload_kinds=batch.kinds,
        )
        if self._wire_version >= 2:
            # binary v2 keyframe — the durable form (spooled records
            # are ALWAYS keyframes; the delta rewrite happens at
            # transmit against the last acked keyframe)
            return encode_report_v2(report, list(sample.zone_names),
                                    seq=seq, run=self._run_nonce,
                                    trace_id=trace_id,
                                    emitted_at=emitted_at)
        return encode_report(report, list(sample.zone_names), seq=seq,
                             run=self._run_nonce, trace_id=trace_id,
                             emitted_at=emitted_at)

    def _target_downgraded(self) -> bool:
        """True while the current target is remembered as v1-only; an
        elapsed ``wire_degraded_ttl`` clears the mark so the next send
        re-probes v2."""
        until = self._v1_until.get(self._target.url)
        if until is None:
            return False
        if self._monotonic() >= until:
            del self._v1_until[self._target.url]
            return False
        return True

    def _prepare_wire(self, body: bytes,
                      path: str) -> "tuple[bytes, tuple | None]":
        """Pick this send's wire form → ``(frame, info)``.

        v1 bodies pass through. A v2 keyframe against a v1-downgraded
        target transcodes down (raising WireError → the caller's
        unsendable path). Otherwise a FRESH window with a usable acked
        base ships as a delta (``info = ("delta",)``); everything else
        stays a keyframe (``info = ("kf", seq, body)`` when it can
        become the next base). Replays always ship full — a hand-off's
        new owner has no base state, and the spool holds keyframes."""
        if body[: len(WireLayoutV2.MAGIC)] != WireLayoutV2.MAGIC:
            return body, None
        if self._wire_version < 2 or self._target_downgraded():
            return transcode_to_v1(body), None
        run, seq = peek_identity(body)
        # the keyframe/delta choice is the PURE predicate
        # (fleet/delivery.py, model-checked by kepmc) — the 409
        # convergence property lives there
        want_kf = keyframe_wanted(
            needs_keyframe=self._needs_keyframe, delivery_path=path,
            has_base=self._kf_base is not None,
            run_matches=(run == self._run_nonce),
            since_keyframe=self._since_keyframe,
            keyframe_every=self._keyframe_every)
        if not want_kf and self._kf_base is not None:
            delta = encode_delta_v2(body, self._kf_base[1])
            if delta is not None:
                return delta, ("delta",)
        if run == self._run_nonce and seq > 0:
            return body, ("kf", seq, body)
        return body, None

    # keplint: protocol-transition — adopt an ACCEPTED keyframe as the
    # delta base (runs for spooled keyframes the owner concluded too)
    def _adopt_kf_base(self, seq: int, body: bytes) -> None:
        self._kf_base = (seq, body)
        self._since_keyframe = 0
        self._needs_keyframe = False

    # keplint: protocol-transition — a 409 latches the forced keyframe:
    # the NEXT send of this window always ships full (convergence)
    def _on_needs_keyframe(self) -> None:
        self._needs_keyframe = True
        self._stats["keyframe_resends"] += 1

    # keplint: protocol-transition — delivered watermark: a seq SOME
    # replica 2xx'd; monotonic, stamped into every transmit header
    def _advance_acked(self, seq: int) -> None:
        self._acked_through = max(self._acked_through, seq)

    # keplint: protocol-transition — the ring epoch only ratchets
    # forward (stale redirects/accepts can never regress it)
    def _adopt_epoch(self, epoch: int | None) -> None:
        if epoch is not None and epoch > self._ring_epoch:
            self._ring_epoch = epoch

    # keplint: protocol-transition — delta-cadence tick
    def _after_wire_success(self, info: "tuple | None") -> None:
        """A 2xx landed: adopt the keyframe as the delta base, or tick
        the delta cadence toward the next scheduled keyframe."""
        if info is None:
            return
        if info[0] == "kf":
            self._adopt_kf_base(info[1], info[2])
            self._stats["keyframes_sent"] += 1
        else:
            self._since_keyframe += 1
            self._stats["deltas_sent"] += 1

    def _delivery_path(self, origin_wall: float, recovered: bool) -> str:
        """Label for the delivery-latency histogram: a crash-backlog
        record (``recovered``) or a window that waited through a send
        disruption is a replay; everything else is a fresh send."""
        if recovered:
            return "replay"
        if self._disrupted_at is not None \
                and origin_wall <= self._disrupted_at:
            return "replay"
        return "fresh"

    def _send_item(self, item: tuple) -> int:
        """Send one queued window; returns its seq (0 when the payload
        carries none, or belongs to a PREVIOUS run — an old run's
        replayed seqs must not inflate this run's delivered watermark,
        or they could mask the new run's own leading-window loss) so
        the caller can advance ``acked_through`` after the ack."""
        if item[0] == "batch":
            return self._send_batch(item[1])
        if item[0] == "spool":
            rec = item[1]
            path = self._delivery_path(rec.appended_at, rec.recovered)
            run, seq = peek_identity(rec.payload)
            with telemetry.span("agent.send"):
                self._post(rec.payload, path=path,
                           appended_at=rec.appended_at)
            return seq if run == self._run_nonce else 0
        _tag, seq, sample, emitted_at, trace_id = item
        path = self._delivery_path(emitted_at, False)
        with telemetry.span("agent.send"):
            self._post(self._encode(sample, seq, trace_id=trace_id,
                                    emitted_at=emitted_at),
                       path=path)
        return seq

    def _send(self, sample: WindowSample, seq: int | None = None) -> None:
        """Encode + POST one sample (direct-send path used by tests and
        the pre-spool call sites). ``seq=None`` takes the next number."""
        if seq is None:
            self._seq += 1
            seq = self._seq
        self._post(self._encode(sample, seq,
                                trace_id=uuid.uuid4().hex[:16],
                                emitted_at=self._clock()))

    def _fire_presend_faults(self) -> None:
        """Connection-level fault sites, consulted once per send attempt
        BEFORE any payload work — exactly where a real refused connect,
        slow network, or shedding replica would interpose."""
        spec = fault.fire("net.refuse")
        if spec is not None:
            self._close_conn()
            raise ConnectionRefusedError("fault-injected connect refusal")
        spec = fault.fire("net.slow")
        if spec is not None:
            _time.sleep(min(spec.arg or 0.05, self._timeout))
        spec = fault.fire("net.throttle")
        if spec is not None:
            # chaos stand-in for an admission-shedding replica: the send
            # is answered 429 before any bytes move (arg = Retry-After)
            raise ThrottledError(coerce_retry_after(
                spec.arg if spec.arg is not None else DEFAULT_RETRY_AFTER,
                cap=self._retry_after_max))

    def _transport_post(self, url_path: str,
                        body: bytes) -> tuple[Any, bytes]:
        """One POST over the persistent connection (fault sites fired
        by the caller via :meth:`_fire_presend_faults`; the one-way
        ``net.partition`` fires after the response). → (response,
        body bytes)."""
        headers = {"Content-Type": "application/octet-stream"}
        if self._auth_header:
            headers["Authorization"] = self._auth_header
        conn = self._connection()
        try:
            conn.request("POST", url_path, body=body, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
        except Exception:
            # a dead persistent connection is not reusable — reconnect on
            # the next attempt
            self._close_conn()
            raise
        jnl = journal.active()
        if jnl.enabled:
            # merge the replica's HLC piggyback (EVERY response carries
            # it when its journal is on — accepts, 421 redirects, 409
            # needs-keyframe, 429 sheds) so this agent's breaker/spool
            # events order causally after the replica's state changes.
            # A hostile stamp is laundered away; a vaulted one is
            # clamped (observe_text → parse_hlc + drift clamp).
            jnl.observe_text(resp.headers.get("X-Kepler-HLC"))
        if fault.fire("net.partition") is not None:
            # one-way partition: the replica processed the report but
            # its response never made it back — the agent must treat
            # the send as failed and re-deliver later (the dedup window
            # absorbs the duplicate)
            self._close_conn()
            raise OSError("fault-injected one-way partition "
                          "(response lost)")
        if resp.status >= 300 or resp.will_close:
            self._close_conn()
        return resp, data

    def _learn_epoch(self, headers: Any) -> None:
        """Lazy epoch learning: accepts advertise the ring epoch too,
        so a settled agent still notices a membership bump."""
        self._adopt_epoch(coerce_epoch(
            _epoch_from_header(headers.get("X-Kepler-Epoch"))))

    def _post(self, body: bytes, path: str = "fresh",
              appended_at: float | None = None) -> None:
        self._fire_presend_faults()
        sent_at = self._clock()
        spec = fault.fire("report.clock_skew")
        if spec is not None:
            sent_at += spec.arg if spec.arg is not None else 300.0
        try:
            frame, wire_info = self._prepare_wire(body, path)
            frame = restamp_transmit(frame, sent_at, delivery_path=path,
                                     appended_at=appended_at,
                                     owner=self._target.display,
                                     epoch=self._ring_epoch,
                                     acked_through=self._acked_through)
        except WireError as err:
            # a spooled record that no longer parses (disk corruption the
            # CRC missed, or a format change across restart) can never be
            # sent — drop it so the backlog doesn't wedge behind it, but
            # through a path that does NOT masquerade as an aggregator
            # response (no network contact happened)
            raise UnsendableRecordError(str(err)) from err
        sent_v2 = frame[: len(WireLayoutV2.MAGIC)] == WireLayoutV2.MAGIC
        sent_delta = wire_info is not None and wire_info[0] == "delta"
        spec = fault.fire("net.corrupt_body")
        if spec is not None:
            # drop the tail: header (and node name) stay parseable, the
            # array manifest overruns → deterministic WireError server-side
            frame = frame[:-4]
        resp, data = self._transport_post(self._path, frame)
        if resp.status == 421:
            owner, epoch = _parse_redirect(data, resp.headers)
            raise OwnerRedirectError(owner, epoch)
        if resp.status == 409 and sent_delta \
                and resp.headers.get("X-Kepler-Needs-Keyframe"):
            # only a DELTA can legitimately need a keyframe; the marker
            # on anything else is a hostile/buggy server and falls
            # through to the permanent-reject path (no resend loop)
            raise NeedsKeyframeError()
        if sent_v2 and (resp.status == 415 or (
                resp.status == 400
                and (b"bad magic" in data or b"unsupported" in data))):
            # an old replica that can't parse v2 bytes at all (its v1
            # decoder answers "bad magic"/"unsupported version"):
            # downgrade this target and retry the SAME record as v1. A
            # 400 naming any OTHER defect is a real quarantine of a
            # corrupt record and keeps its permanent-reject semantics.
            raise _WireDowngradeError()
        if resp.status == 429:
            # a throttle, never a failure: the Retry-After is hostile
            # wire input until coerced (clamped so an adversarial owner
            # can't park this agent forever)
            raise ThrottledError(coerce_retry_after(
                resp.headers.get("Retry-After"),
                cap=self._retry_after_max))
        if 400 <= resp.status < 500:
            raise AggregatorRejectedError(resp.status)
        if resp.status >= 300:
            raise http.client.HTTPException(
                f"aggregator returned {resp.status}")
        self._learn_epoch(resp.headers)
        self._after_wire_success(wire_info)

    def _send_batch(self, recs: "list[SpoolRecord]") -> int:
        """Ship consecutive spooled records as ONE ``/v1/reports``
        request (batched recovery drain) and conclude each according to
        its per-record status. Records are acked IN ORDER as their
        statuses conclude; the first throttle/redirect stops the walk —
        the concluded prefix stays acked, the rest re-peeks from the
        cursor. Returns the highest acked seq of the CURRENT run (the
        ``acked_through`` watermark input). Every per-record status is
        hostile wire input: malformed rows conclude nothing."""
        assert self._spool is not None
        self._fire_presend_faults()
        sent_at = self._clock()
        spec = fault.fire("report.clock_skew")
        if spec is not None:
            sent_at += spec.arg if spec.arg is not None else 300.0
        bodies: list[bytes] = []
        batch: list[SpoolRecord] = []
        downgraded = self._wire_version < 2 or self._target_downgraded()
        for rec in recs:
            path = self._delivery_path(rec.appended_at, rec.recovered)
            try:
                payload = rec.payload
                if downgraded:
                    # v1-only target: spooled v2 keyframes transcode
                    # down per record (v1 payloads pass through)
                    payload = transcode_to_v1(payload)
                bodies.append(restamp_transmit(
                    payload, sent_at, delivery_path=path,
                    appended_at=rec.appended_at,
                    owner=self._target.display,
                    epoch=self._ring_epoch,
                    acked_through=self._acked_through))
            except WireError as err:
                if bodies:
                    # truncate: the poisoned record surfaces as the
                    # batch head next round and is dropped there
                    break
                # poisoned head: ack + drop exactly like the single
                # path (no network contact — evidence of nothing)
                self._spool.ack(rec)
                self._stats["dropped_total"] += 1
                log.warning("dropping unsendable spooled record: %s", err)
                continue
            batch.append(rec)
        if not bodies:
            raise UnsendableRecordError(
                "entire batch head was unsendable (already dropped)")
        with telemetry.span("agent.send"):
            resp, data = self._transport_post(
                self._target.batch_path, encode_report_batch(bodies))
        status = resp.status
        if status in (400, 404, 405, 413):
            # an older replica without /v1/reports, one that cannot
            # parse the envelope, or a smaller body cap than ours
            # (413): fall back to single-record sends against this
            # target — nothing concluded, nothing dropped
            raise _BatchUnsupportedError(
                f"batch endpoint answered {status}")
        if status == 421:
            owner, epoch = _parse_redirect(data, resp.headers)
            raise OwnerRedirectError(owner, epoch)
        if status == 429:
            raise ThrottledError(coerce_retry_after(
                resp.headers.get("Retry-After"),
                cap=self._retry_after_max))
        if status != 200:
            raise http.client.HTTPException(
                f"aggregator returned {status}")
        self._learn_epoch(resp.headers)
        try:
            payload = json.loads(data)
        except (ValueError, UnicodeDecodeError):
            payload = None
        results = (payload.get("results")
                   if isinstance(payload, dict) else None)
        if not isinstance(results, list):
            # hostile/garbled response: nothing provably concluded —
            # the records stay spooled and the failure path sets pace
            raise http.client.HTTPException(
                "unparseable batch response body")
        self._stats["drain_batches"] += 1
        top_seq = 0
        concluded = 0
        throttle: float | None = None
        redirect: "tuple | None" = None
        kf_base: "tuple[int, bytes] | None" = None
        wire_downgrade = False
        for rec, row in zip(batch, results):
            st = row.get("status") if isinstance(row, dict) else None
            if isinstance(st, bool) or not isinstance(st, int):
                break  # hostile row: stop concluding records here
            if (st in (400, 415) and not downgraded
                    and rec.payload[: len(WireLayoutV2.MAGIC)]
                    == WireLayoutV2.MAGIC):
                err_txt = row.get("error")
                if isinstance(err_txt, str) and (
                        "bad magic" in err_txt
                        or "unsupported" in err_txt):
                    # a pre-v2 replica whose batch endpoint exists but
                    # whose v1 decoder rejects every v2 record: this is
                    # the wire-downgrade signature, NOT a permanent
                    # reject — stop concluding WITHOUT acking so the
                    # durable backlog retries transcoded to v1
                    wire_downgrade = True
                    break
            if 200 <= st < 300:
                self._spool.ack(rec)
                concluded += 1
                run, seq = peek_identity(rec.payload)
                if run == self._run_nonce:
                    top_seq = max(top_seq, seq)
                    if (seq > 0 and not downgraded
                            and rec.payload[: len(WireLayoutV2.MAGIC)]
                            == WireLayoutV2.MAGIC):
                        # a spooled keyframe the owner just accepted is
                        # a fresh delta base — after a herd replay the
                        # agent resumes deltas immediately
                        kf_base = (seq, rec.payload)
                continue
            if st == 409 and isinstance(row.get("needs_keyframe"),
                                        bool) and row["needs_keyframe"]:
                # spooled records are already keyframes, so this can
                # only be a hostile/buggy server: stop concluding
                # WITHOUT acking (never drop a durable record on it)
                break
            if st == 429:
                throttle = coerce_retry_after(
                    row.get("retry_after"), cap=self._retry_after_max)
                break
            if st == 421:
                redirect = (sanitize_peer(row.get("owner")),
                            coerce_epoch(row.get("epoch")))
                break
            if 400 <= st < 500:
                # per-record permanent reject: ack + drop so the rest
                # of the backlog never wedges behind it (single-path
                # semantics, record by record)
                self._spool.ack(rec)
                concluded += 1
                self._stats["dropped_total"] += 1
                self._stats["server_rejections"] += 1
                continue
            break  # per-record 5xx: not concluded; retries later
        self._stats["drain_batch_records"] += concluded
        if top_seq:
            self._advance_acked(top_seq)
        if kf_base is not None:
            self._adopt_kf_base(kf_base[0], kf_base[1])
        if wire_downgrade and concluded == 0:
            # nothing concluded: surface the downgrade so the drain
            # marks the target v1-only and retries the SAME batch
            # transcoded — never the failure path (the replica is up)
            raise _WireDowngradeError()
        if wire_downgrade:
            # a prefix concluded before the v2 wall: mark the target
            # here so the next peek already transcodes
            self._v1_until[self._target.url] = \
                self._monotonic() + self._wire_degraded_ttl
            self._stats["wire_downgrades"] += 1
        if throttle is not None:
            raise ThrottledError(throttle)
        if redirect is not None:
            raise OwnerRedirectError(*redirect)
        if concluded == 0:
            # a 200 that concluded NOTHING (hostile rows, short/empty
            # results, per-record 5xx) must not read as success — the
            # drain would re-peek the identical batch and spin. The
            # failure path's backoff sets the retry pace instead.
            raise http.client.HTTPException(
                "batch response concluded no records")
        return top_seq

    def _log_drop(self, err: Exception) -> None:
        # rate-limit to one warning per 30 s of MONOTONIC time (not sample
        # time: a stalled or skewed monitor clock must not suppress the
        # operator's only signal that reports are failing)
        now = self._monotonic()
        if self._drop_logged is None or now - self._drop_logged >= 30.0:
            self._drop_logged = now
            log.warning("fleet report send failed (aggregator unreachable "
                        "or rejecting): %s", err)
