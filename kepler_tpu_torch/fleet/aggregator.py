"""Cluster aggregator: ingest node reports, attribute the whole fleet on
CUDA devices.

The counterpart of ``kepler_tpu.fleet.aggregator``. Node
agents POST per-window feature rows; every ``interval`` the aggregator
runs one fleet window over the latest report from each node and
publishes:

- ``GET /v1/results[?node=…]`` — attributed watts scattered back per node
  (JSON), the pull leg for non-RAPL nodes that want their estimates;
- ``GET /metrics`` — cluster-level Prometheus families
  (``kepler_fleet_…``), the same scrape plane the reference leans on.

The default window path is DEVICE-RESIDENT and PIPELINED
(``kepler_tpu_torch.fleet.window``): the padded packed batch lives on the
card, each window scatter-updates only the rows whose report changed
(delta H2D, in place), and with ``pipeline_depth`` ≥ 2 the fetch/scatter
of window N overlaps window N+1's host assembly and dispatch, at the cost
of results being at most ``pipeline_depth − 1`` intervals stale. With
``fused_window_k`` K > 1 rung 0 is the fused tier instead: host-only
staging per interval, one launch and one fetch per K windows (with
``backend="pallas"`` and no model, one launch of kernel B2). Shutdown
(and an emptied fleet) deterministically drains in-flight windows.

Every dispatched window queues its result plane for an asynchronous D2H
copy into pinned host memory, with a ``torch.cuda.Event`` recorded on the
dispatching stream right behind it (``fleet.window.copy_to_host_async``;
over shards or node blocks one pinned buffer, an event per device,
``copy_blocks_to_host_async``). The fetch, which runs on the
fetch-worker thread, waits on that event
before it reads the buffer: PyTorch's current stream is per thread, so
nothing relies on the worker's own stream to order after the launches.

The serial path — full assemble + one dispatch + one fetch per window —
is retained for ``accuracy_mode`` (the configuration the 0.5% budget is
validated under), temporal mode (whose feature-history tensor has no
packed layout), and training-dump capture (which needs the assembled
host batch). Its programs are the port's ``make_fleet_program`` and
``make_temporal_fleet_program``.

The device mesh (``parallel.mesh``; ``mesh_shape`` ``[]`` = every
visible device, 1-D over ``node``): on a node mesh of two or more shards
rung 0 is the ``ShardedWindowEngine`` (per-shard rings, sticky node→shard
assignment, one launch per shard) and the packed-serial rung a
single-device engine on the first shard's device. Everything else spans
the mesh as the reference's node sharding does, one NODE BLOCK per node
row on the row's first shard's device (``aggregator_core.node_blocks``):
the fused tier's resident block and flush (B2 once per block with
``backend="pallas"``), the unsharded engine on a 2-D ``node × model``
mesh, and the einsum-serial and temporal programs (the batch cut by
block, one H2D each, the results joined in block order at fetch).
Shards may be virtual (several on one card). With ``multihost_enabled``
and a mesh spanning several processes, rung 0 is the
``MultiHostWindowEngine`` (only this process's shards, bucket needs
agreed across processes), ingest ownership derives from the mesh shard
map, and a cross-host failure demotes to "mesh minus one host" and runs
membership succession.

Device errors. The ladder (fused/pipelined → packed-serial → einsum-serial
→ NumPy host) demotes one rung per device failure. A
``torch.cuda.OutOfMemoryError`` while the buckets grow is recoverable and
counts as ``oom_on_grow``, like the injected ``device.oom_on_grow``. A
real CUDA fault such as an illegal address poisons the CUDA context:
every device rung on that context then fails, and the ladder walks down
to the NumPy rung, which calls no ``torch.cuda`` API and keeps
publishing (ratio attribution exact) for the life of the process.

Late/missing nodes: a node whose latest report is older than
``stale_after`` falls out of the batch (its row just isn't assembled) —
the batched analog of the reference's per-zone skip-on-error.
"""

from __future__ import annotations

import collections
import hashlib
import json
import logging
import queue
import threading
import time as _time
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Mapping, Sequence

import numpy as np
import torch

from kepler_tpu_torch import fault, telemetry
from kepler_tpu_torch.device import resolve_device
from kepler_tpu_torch.fleet.admission import (
    PRIORITY_FRESH_GROUND,
    PRIORITY_FRESH_MODEL,
    PRIORITY_REPLAY_GROUND,
    AdmissionController,
)
from kepler_tpu_torch.fleet.delivery import (
    SeqTracker,
    delta_base_matches,
    reseed_on_ownership_return,
    seed_fresh_tracker,
)
from kepler_tpu_torch.fleet.journal import (
    EventJournal,
    canonical_json,
    make_journal_handler,
)
from kepler_tpu_torch.fleet.membership import (
    AutoscaleDecision,
    AutoscalePolicy,
    AutoscaleSignals,
    CoordinatorLease,
    MembershipError,
    elect_successor,
    plan_membership_apply,
    plan_succession,
    validate_membership_payload,
)
from kepler_tpu_torch.fleet.ring import (HashRing, RingError, coerce_epoch,
                                         ring_from_mesh, sanitize_peer)
from kepler_tpu_torch.fleet.wire import (
    ParsedHeader,
    WireError,
    decode_delta,
    decode_report,
    decode_report_batch,
    peek_node_name,
    peek_routing,
    sanitize_node_name,
    try_parse_header,
)
from kepler_tpu_torch.fleet.scoreboard import STATE_NAMES, FleetScoreboard
from kepler_tpu_torch.fleet.window import (DeviceWindowError, FusedFlush,
                                           FusedWindowEngine, HostCopy,
                                           MultiHostWindowEngine,
                                           PackedWindowEngine, RowInput,
                                           ShardedWindowEngine, WindowMeta,
                                           align_zone_matrices,
                                           copy_blocks_to_host_async,
                                           copy_plane_to_host_async)
from kepler_tpu_torch.monitor.history import HistoryBuffer
from kepler_tpu_torch.telemetry import DEFAULT_DELIVERY_BUCKETS, Histogram
from kepler_tpu_torch.parallel.aggregator_core import (
    make_fleet_program,
    make_temporal_fleet_program,
    run_fleet_attribution,
)
from kepler_tpu_torch.parallel.fleet import (MODE_MODEL, NodeReport,
                                             assemble_fleet_batch)
from kepler_tpu_torch.parallel.mesh import (NODE_AXIS, Mesh, Shard,
                                            make_mesh, multihost_status,
                                            process_index,
                                            submesh_for_processes)
from kepler_tpu_torch.server.http import APIServer
from kepler_tpu_torch.service.lifecycle import CancelContext
from kepler_tpu_torch.utils.rowstore import RowStore

log = logging.getLogger("kepler.fleet.aggregator")

# upper bound for one report POST (64 MiB ≫ any real fleet window: 10k
# workloads ≈ 50 KiB of arrays + ids) — enforced by the server before the
# body is buffered
MAX_REPORT_BYTES = 64 << 20

# TEST-ONLY chaos regression seed: when flipped (monkeypatched by the
# kepchaos shrinking-proof test, never set in production code), the
# membership fan-out stamps this replica as the issuer instead of the
# current lease holder — the historical holder-self-leave bug, where
# receivers adopt the DEPARTED peer as lease holder. kepchaos must
# catch this from a randomized schedule and shrink it to the minimal
# repro; see tests/test_torch_chaos.py.
_BUG_BROADCAST_SELF_ISSUER = False

# degradation-ladder rungs for the window's device leg
# (docs/developer/resilience.md "Device-plane faults"): every device
# failure demotes ONE rung; `repromote_after` consecutive clean windows
# at a lower rung retry the rung above (hysteresis, like the breaker's
# half-open probe and the bucket ladder's shrink window). The bottom
# rung calls no torch.cuda API at all, so the aggregator keeps
# publishing with the device plane completely dead.
RUNG_PIPELINED = 0  # packed resident batch, pipelineDepth in flight
RUNG_PACKED_SERIAL = 1  # packed resident batch, depth 1
RUNG_EINSUM = 2  # serial program (full assemble + dense dispatch)
RUNG_NUMPY = 3  # pure-NumPy host fallback (no device)
RUNG_NAMES = ("packed-pipelined", "packed-serial", "einsum-serial",
              "numpy-host")
# rung 0's name when the window is sharded over a node mesh of two or
# more shards (ShardedWindowEngine): a single shard's device failure
# demotes to the single-device rungs above, so only rung 0 has a
# sharded form
RUNG_NAME_SHARDED = "packed-sharded-pipelined"
# rung 0's names on a multi-host mesh (MultiHostWindowEngine): healthy,
# and after the "mesh minus one host" demotion (the surviving process's
# own single-host sharded engine — sticky for the process lifetime)
RUNG_NAME_MULTIHOST = "packed-multihost-pipelined"
RUNG_NAME_MESH_DEGRADED = "packed-sharded-mesh-minus-host"
# rung 0's name when the fused device-resident window loop is active
# (FusedWindowEngine, aggregator.fusedWindowK > 1): one launch + one
# fetch per K windows. A device failure at this tier demotes WITHIN
# rung 0 to the packed-pipelined engine (the fused flag flips) before
# the ordinary ladder applies.
RUNG_NAME_FUSED = "packed-fused-scan"

# per-mode checkpoint layout: required keys, and which key's last axis is
# the zone count Z. Temporal params serve through the dedicated history
# program (make_temporal_fleet_program), not the single-tick predictor
# registry — the aggregator accretes each workload's window itself.
_REQUIRED_PARAM_KEYS = {
    "mlp": ("w0", "b0", "w1", "b1", "w2", "b2", "w_skip"),
    "linear": ("weight", "bias"),
    "moe": ("gate_w", "w0", "b0", "w1", "b1", "w_skip"),
    "deep": ("in_proj", "in_bias", "blocks", "w_head", "b_head", "w_skip"),
    "temporal": ("in_proj", "pos_emb", "wq", "wk", "wv", "wo",
                 "w_mlp0", "w_mlp1", "w_head", "b_head", "w_skip"),
}
_OUTPUT_BIAS_KEY = {"mlp": "b2", "linear": "bias", "moe": "b1",
                    "deep": "b_head", "temporal": "b_head"}


@dataclass
class _Stored:
    report: NodeReport
    zone_names: tuple[str, ...]
    received: float
    seq: int
    run: str = ""  # agent-run nonce (empty for pre-nonce agents)
    # seq at which the report CONTENT last changed (wire v2 FLAG_SAME
    # deltas bump seq but keep this, so the window engine's per-row
    # identity short-circuits to zero staged bytes for unchanged nodes);
    # 0 = unknown → fall back to seq (v1 agents restage every window)
    content_seq: int = 0
    wire_version: int = 1


@dataclass
class _BaseRow:
    """One node's resident delta base: the last v2 keyframe accepted
    from it (count-capped LRU beside the seq trackers). Immutable once
    stored — replaced wholesale by the next keyframe, so delta merges
    read it without the store lock."""

    run: str
    seq: int
    report: NodeReport
    zone_names: tuple[str, ...]


def _primary_introspect(snap: Mapping[str, dict]) -> dict | None:
    """The engine snapshot the shard/staleness/skew metrics should read:
    the one actively holding resident rows. After a demotion both
    engines were reset and the DEMOTED rung's engine re-packs — the
    rung-0 engine reads empty until re-promotion, so preferring it
    unconditionally would blank the flight recorder exactly while the
    plane is degraded."""
    fused = snap.get("fused")
    pipelined = snap.get("pipelined")
    serial = snap.get("serial")
    if fused and fused["resident"]["rows"]:
        return fused
    if pipelined and pipelined["resident"]["rows"]:
        return pipelined
    if serial and serial["resident"]["rows"]:
        return serial
    return fused or pipelined or serial


def _failure_reason(err: BaseException) -> str:
    """The ladder's demotion reason for a device-leg failure. A real
    CUDA out-of-memory (a bucket growth that does not fit) counts as
    ``oom_on_grow``, like the injected ``device.oom_on_grow``."""
    if isinstance(err, DeviceWindowError):
        return err.reason
    if isinstance(err, torch.cuda.OutOfMemoryError):
        return "oom_on_grow"
    return "runtime_error"


def _report_power_w(report: NodeReport) -> float:
    """The node's self-reported power this window (valid zone energy
    over the window interval), the scoreboard's anomaly signal. Returns
    NaN when the report carries no usable window (the scoreboard skips
    non-finite magnitudes)."""
    dt = float(report.dt_s)
    if dt <= 0.0:
        return float("nan")
    valid = np.asarray(report.zone_valid, bool)
    deltas = np.asarray(report.zone_deltas_uj, np.float64)
    if valid.shape != deltas.shape or not valid.any():
        return float("nan")
    return float(deltas[valid].sum()) / dt / 1e6


@dataclass
class _Pending:
    """One dispatched, not-yet-published window in the pipeline.

    Everything here was SNAPSHOTTED at dispatch: fetching and publishing
    window N after window N+1 changed the fleet must never mix rows —
    the metadata (and, on the packed path, the resident batch version the
    program read) is this window's own.
    """

    kind: str  # "packed" | "legacy" | "fused" | "numpy"
    # packed/legacy: the HostCopy of the result tensor(s) queued at
    # dispatch (per shard or node block, joined); fused/numpy: the window's
    # plane, already on the host
    out: object
    meta: WindowMeta | None  # packed path row layout
    now: float  # publication timestamp (dispatch-time clock)
    assembly_ms: float
    dispatch_ms: float
    h2d_rows: int
    compiled: bool
    # packed path: per-shard H2D breakdown + shard count ((h2d,), 1 when
    # the dispatching engine was unsharded; legacy/numpy paths leave
    # (), 1)
    h2d_shards: tuple = ()
    shards: int = 1
    # fused path (kind "fused"): `out` is already a HOST slice of the
    # batch fetch. The whole batch's device cost is carried by its LAST
    # window (`dispatch_ms`; earlier windows publish with 0 — the K−1
    # free rides are the amortization), and sync_per_window_ms is the
    # honest averaged figure (−1 on non-fused windows).
    sync_per_window_ms: float = -1.0
    fused_fetch_ms: float = 0.0
    # legacy path extras (training dump + dense scatter)
    batch: object = None
    aligned: list | None = None
    zone_names: list | None = None
    feat_hist: object = None
    t_valid: object = None


#: how long ``shutdown()`` waits for an idle fetch worker to end
_WORKER_JOIN_S = 5.0


class _FetchWorker:
    """One persistent daemon thread running window fetches, so the
    dispatch-timeout watchdog can bound them without spawning a thread
    per window (the healthy hot path publishes every interval forever).
    A fetch that exceeds its timeout abandons the WORKER — it stays
    parked in native code on the hung handle, which the ladder's ring
    re-seed guarantees nothing else reads — and the aggregator lazily
    replaces it on the next fetch."""

    __slots__ = ("_requests", "_thread")

    def __init__(self) -> None:
        self._requests: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="kepler-window-fetch")
        self._thread.start()

    # keplint: thread-role=fetch-worker
    def _loop(self) -> None:
        while True:
            fn, out = self._requests.get()
            if fn is None:
                return
            try:
                out.put(("value", fn()))
            except BaseException as err:  # relayed to the caller thread
                out.put(("error", err))

    def alive(self) -> bool:
        return self._thread.is_alive()

    def stop(self) -> None:
        self._requests.put((None, None))

    def join(self, timeout: float) -> None:
        self._thread.join(timeout)

    def run(self, fn: "Callable[[], object]",
            timeout: float) -> "tuple[str, object] | None":
        """→ ("value", result) | ("error", exc) | None on timeout (the
        worker is then permanently occupied — abandon it)."""
        out: queue.Queue = queue.Queue(maxsize=1)
        self._requests.put((fn, out))
        try:
            return out.get(timeout=timeout)
        except queue.Empty:
            return None


# the dedup/gap tracker moved to the PURE decision layer
# (fleet/delivery.py) so the kepmc protocol checker drives the exact
# observe/seed transitions this ingest path runs; the old private name
# stays as the module-local spelling
_SeqTracker = SeqTracker


class FleetResults:
    """One published fleet window, column-oriented.

    Publication is a handful of array references — no per-workload (or
    even per-node) Python happens per window; JSON materializes lazily
    per ``/v1/results`` request via :meth:`render_node`.

    Arrays are indexed by ROW via ``rows[name]`` — on the packed
    resident path nodes sit at stable row indices with holes, so
    ``names`` is the key list, never an implicit index order.

    On the packed path the per-workload matrices arrive as ONE f16
    watts array; the µW/µJ f32 materialization (two [N, W, Z] passes)
    is deferred to first access (``wl_power_uw``/``wl_energy_uj``
    properties) so the window hot loop never pays it — renders slice
    per row straight from the f16 plane."""

    __slots__ = ("timestamp", "zones", "names", "rows", "mode",
                 "node_power_uw", "node_energy_uj", "node_joules_total",
                 "workload_ids", "workload_kinds", "counts", "dt",
                 "_wl_watts_f16", "_wl_power_uw", "_wl_energy_uj")

    def __init__(self, timestamp: float, zones: list[str],
                 names: list[str], rows: dict[str, int], mode: np.ndarray,
                 node_power_uw: np.ndarray, node_energy_uj: np.ndarray,
                 node_joules_total: np.ndarray, workload_ids: list,
                 workload_kinds: list, counts: list,
                 wl_power_uw: np.ndarray | None = None,
                 wl_energy_uj: np.ndarray | None = None,
                 wl_watts_f16: np.ndarray | None = None,
                 dt: np.ndarray | None = None) -> None:
        self.timestamp = timestamp
        self.zones = zones
        self.names = names
        self.rows = rows
        self.mode = mode
        self.node_power_uw = node_power_uw
        self.node_energy_uj = node_energy_uj
        self.node_joules_total = node_joules_total
        self.workload_ids = workload_ids
        self.workload_kinds = workload_kinds
        self.counts = counts
        self.dt = dt
        self._wl_watts_f16 = wl_watts_f16
        self._wl_power_uw = wl_power_uw
        self._wl_energy_uj = wl_energy_uj

    def __contains__(self, name: str) -> bool:
        return name in self.rows

    @property
    def wl_power_uw(self) -> np.ndarray:
        if self._wl_power_uw is None:
            self._wl_power_uw = np.multiply(
                self._wl_watts_f16, 1e6, dtype=np.float32)
        return self._wl_power_uw

    @property
    def wl_energy_uj(self) -> np.ndarray:
        if self._wl_energy_uj is None:
            self._wl_energy_uj = self.wl_power_uw * self.dt[:, None, None]
        return self._wl_energy_uj

    def _row_wl(self, i: int, w: int) -> tuple[np.ndarray, np.ndarray]:
        """(power_uw [w, Z], energy_uj [w, Z]) for one row — slices the
        f16 plane directly when the full f32 planes were never forced."""
        if self._wl_power_uw is not None:
            return self._wl_power_uw[i, :w], self.wl_energy_uj[i, :w]
        power = np.multiply(self._wl_watts_f16[i, :w], 1e6,
                            dtype=np.float32)
        return power, power * float(self.dt[i])

    def render_node(self, name: str) -> dict:
        """The node's JSON payload (wire schema unchanged from the
        per-window-dict era)."""
        i = self.rows[name]
        w = self.counts[i]
        kinds = self.workload_kinds[i]
        power, energy = self._row_wl(i, w)
        return {
            "timestamp": self.timestamp,
            "zones": list(self.zones),
            "mode": int(self.mode[i]),
            "node_power_uw": self.node_power_uw[i].tolist(),
            "node_energy_uj": self.node_energy_uj[i].tolist(),
            "node_joules_total": self.node_joules_total[i].tolist(),
            "workloads": [
                {
                    "id": wid,
                    "kind": int(kinds[k]) if kinds is not None else -1,
                    "power_uw": p,
                    "energy_uj": e,
                }
                for k, (wid, p, e) in enumerate(zip(
                    self.workload_ids[i],
                    power.tolist(),
                    energy.tolist()))
            ],
        }


class Aggregator:
    """Service: report store + periodic fleet attribution over a device
    mesh.

    ``device`` (default ``"cuda"``) is the type of device the mesh is
    built from; it raises without CUDA unless the caller passes
    ``"cpu"`` (the tests). ``mesh`` (a ``parallel.mesh.Mesh``, built by
    ``init()`` from ``mesh_shape``/``mesh_axes`` when absent) may name
    virtual shards; the single-device rungs run on its first shard's
    device."""

    # keplint: protocol-transition — ingest-state birth
    def __init__(
        self,
        server: APIServer,
        interval: float = 5.0,
        stale_after: float = 15.0,
        model_mode: str | None = "mlp",
        model_params: Mapping[str, np.ndarray] | None = None,
        node_bucket: int = 8,
        workload_bucket: int = 256,
        backend: str = "einsum",
        accuracy_mode: bool = False,
        history_window: int = 16,
        training_dump_dir: str = "",
        training_dump_max_files: int = 1000,
        skew_tolerance: float = 120.0,
        degraded_ttl: float = 60.0,
        dedup_window: int = 1024,
        delivery_buckets: Sequence[float] | None = None,
        pipeline_depth: int = 1,
        fused_window_k: int = 1,
        bucket_shrink_after: int = 16,
        fallback_enabled: bool = True,
        repromote_after: int = 8,
        dispatch_timeout: float = 30.0,
        mesh_shape: Sequence[int] | None = None,
        mesh_axes: Sequence[str] | None = None,
        multihost_enabled: bool = False,
        multihost_takeover: bool = True,
        multihost_topology: Mapping[str, Any] | None = None,
        membership_auto_apply: bool = False,
        membership_autoscale: bool = False,
        membership_scale_up_load: float = 1.0,
        membership_scale_down_load: float = 0.25,
        membership_up_windows: int = 3,
        membership_down_windows: int = 12,
        membership_min_replicas: int = 1,
        membership_max_replicas: int = 0,
        membership_standby_peers: Sequence[str] | None = None,
        membership_probe_timeout: float = 2.0,
        membership_topology: Mapping[str, Any] | None = None,
        scoreboard_cap: int = 1024,
        anomaly_z: float = 4.0,
        peers: Sequence[str] | None = None,
        self_peer: str = "",
        ring_epoch: int = 1,
        ring_vnodes: int = 64,
        admission_enabled: bool = False,
        admission_max_inflight: int = 64,
        admission_latency_budget: float = 0.25,
        admission_retry_after: float = 1.0,
        admission_retry_after_max: float = 30.0,
        admission_jitter_seed: int | None = None,
        base_row_cache: int = 1024,
        clock: Callable[[], float] | None = None,
        mesh: Mesh | None = None,
        journal: EventJournal | None = None,
        hlc_max_drift: float = 60.0,
        device: str | torch.device = "cuda",
    ) -> None:
        self._device = resolve_device(device)
        self._server = server
        self._interval = interval
        self._stale_after = stale_after
        self._model_mode = model_mode
        self._params = model_params
        self._node_bucket = node_bucket
        self._workload_bucket = workload_bucket
        self._backend = backend
        # serve estimators at f32/highest precision (the configuration the
        # 0.5% accuracy budget is validated under); bf16 = throughput mode
        self._accuracy_mode = accuracy_mode
        self._clock = clock or _time.time
        # fleet black box: every state transition below goes through the
        # journal chokepoint; the default is a disabled per-instance
        # journal (one attribute check per emission) on this replica's
        # clock seam, so library/test construction costs nothing and
        # chaos replicas never share clocks
        self._journal = journal if journal is not None else EventJournal(
            enabled=False, node=str(self_peer or ""), clock=self._clock,
            max_drift_s=hlc_max_drift)
        # admission-shed ONSET edge (False→True) is a journal event; the
        # return to admitting resets the edge detector — steady-state
        # shedding emits nothing (the journal records transitions, rates
        # live in the admission controller's own counters)
        self._shedding = False  # keplint: guarded-by=_lock
        # /debug/bundle stamps a config fingerprint so two bundles from
        # "the same fleet" are checkably from the same rollout
        self._config_fingerprint = hashlib.sha256(canonical_json({
            "self_peer": str(self_peer or ""),
            "interval": float(interval),
            "stale_after": float(stale_after),
            "model_mode": str(model_mode or ""),
            "multihost": bool(multihost_enabled),
            "hlc_max_drift": float(hlc_max_drift),
        })).hexdigest()[:16]
        self._mesh = mesh
        # aggregator.meshShape/meshAxes: the device mesh the packed
        # window path actually runs on ([] = all devices, 1-D node axis
        # — the sharded production shape)
        self._mesh_shape = list(mesh_shape or [])
        self._mesh_axes = list(mesh_axes or [])
        # -- multi-host tier: with multihost enabled and a mesh spanning
        # > 1 process, rung 0 runs the MultiHostWindowEngine (this
        # process's shards only, bucket needs agreed across processes)
        # and ingest ownership derives from the mesh shard map
        # (ring_from_mesh). A cross-host failure demotes STICKY to the
        # surviving single-host engine ("mesh minus one host"), bumping
        # the ring epoch so displaced agents follow 421s to the new
        # owner. multihost_topology injects a virtual topology:
        # process_index, device_process (shard index → process) and a
        # HostLocalFabric.
        self._multihost_enabled = bool(multihost_enabled)
        # aggregator.multihost.takeover: whether a survivor of a host
        # death may issue the survivor membership (_demote_mesh)
        self._multihost_takeover = bool(multihost_takeover)
        topo = dict(multihost_topology or {})
        self._mh_process_index: int | None = topo.get("process_index")
        self._mh_device_process = topo.get("device_process")
        self._mh_fabric = topo.get("fabric")
        self._mesh_degraded = False  # keplint: guarded-by=_results_lock
        self._engine_mesh: Mesh | None = None  # mesh the packed engines run on
        # temporal mode: per-node feature-history ring buffers, fed on
        # report receipt so the window advances at each node's own cadence.
        # Each node's buffer carries its OWN lock: ingest for node A never
        # stalls on the [N, W, T, F] assembly reading node B, and the
        # assembly never holds the report-store lock at all (history
        # assembly must never stall a /v1/report POST).
        self._history_window = history_window
        self._history: dict[str, tuple[threading.Lock, "HistoryBuffer"]] = {}
        # training-data capture: RAPL nodes' windows + their ratio watts
        # become (features, labels) files for cmd/train (the
        # kepler-model-server train→serve loop)
        self._dump_dir = training_dump_dir
        self._dump_max_files = max(1, training_dump_max_files)
        self._dump_seq = 0
        self._dump_files: list[str] | None = None  # seeded on first dump

        # report quarantine: a malformed or clock-skewed report is rejected
        # BEFORE it can poison the batch, and the offense is charged to the
        # sending node so operators see WHICH node degrades (the reference
        # only ages bad nodes out silently). Entries decay after
        # ``degraded_ttl`` of good behavior.
        self._skew_tolerance = skew_tolerance
        self._degraded_ttl = degraded_ttl
        self._degraded: dict[str, dict] = {}
        # names come from (possibly hostile) malformed payloads: bound the
        # table (oldest offender evicted) and the per-name length so a
        # garbage flood can't grow memory or log volume without limit
        self._degraded_cap = 64
        self._degraded_name_cap = 128

        self._lock = threading.Lock()
        self._reports: dict[str, _Stored] = {}  # keplint: guarded-by=_lock
        # per-node run nonces superseded by restarts: a network-delayed
        # straggler from ANY previous agent run must not be re-classified
        # as yet another restart (that would overwrite the fresher run's
        # report, push a spurious temporal history window, and mark the
        # LIVE run as superseded — going dark until the next restart).
        # A bounded per-node list (oldest dropped) keeps memory O(nodes).
        self._superseded_runs: dict[str, list[str]] = {}
        self._superseded_cap = 16
        # idempotent ingest + loss accounting: per-node seq trackers for
        # the CURRENT run (spool replays dedupe; seq jumps become
        # kepler_fleet_windows_lost_total). Trackers deliberately OUTLIVE
        # batch staleness: a partition longer than stale_after followed
        # by a spool replay must resume from max_seen, not fabricate a
        # loss spike and re-ingest delivered windows. Bounded by count
        # instead (least-recently-observed evicted at the cap), like the
        # cumulative loss table.
        self._dedup_window = max(1, dedup_window)
        # end-to-end delivery latency: the agent stamps a trace id +
        # emitted_at at window emit; the accepted (non-duplicate) ingest
        # closes the trace here. Replays measure from the spool's
        # original appended_at under their own label so outage backlogs
        # never pollute the fresh-delivery signal.
        self._delivery_hist: dict[str, Histogram] = {  # keplint: guarded-by=_lock
            path: Histogram(delivery_buckets or DEFAULT_DELIVERY_BUCKETS)
            for path in ("fresh", "replay")}
        self._seq_trackers: dict[str, _SeqTracker] = {}  # keplint: guarded-by=_lock
        self._tracker_cap = 512
        # wire v2 delta bases: per-node last accepted keyframe, the
        # state a delta frame merges against. Count-capped LRU (dict
        # order = recency; oldest evicted) beside the seq trackers — a
        # delta whose base was evicted is answered with a structured
        # 409 needs-keyframe and the agent resends full, so eviction is
        # a round-trip, never corruption or loss.
        self._base_rows: dict[str, _BaseRow] = {}  # keplint: guarded-by=_lock
        self._base_row_cache = max(1, int(base_row_cache))
        self._lost_by_node: dict[str, int] = {}  # keplint: guarded-by=_lock
        self._lost_node_cap = 256
        # fleet scoreboard: one synthesized health row per node (state
        # machine + rolling power z-score), LRU-capped, updated at ingest
        # and served via /debug/fleet + kepler_fleet_node_state
        self._scoreboard = FleetScoreboard(  # keplint: guarded-by=_lock
            cap=scoreboard_cap, anomaly_z=anomaly_z,
            flag_ttl=degraded_ttl)
        # HA ingest ring: with peers configured, this replica
        # accepts only the nodes the consistent-hash ring assigns it and
        # answers everyone else with a structured 421 owner redirect.
        # The ring object is IMMUTABLE — a membership change swaps in a
        # new one wholesale (apply_membership), so the ingest hot path
        # reads it without the store lock.
        self._ring: HashRing | None = None
        self._self_peer = str(self_peer or "")
        self._ring_vnodes = max(1, int(ring_vnodes))
        # config-ORDER peer list (HashRing sorts; the mesh ring needs
        # process-index order: peers[p] = process p's endpoint)
        self._config_peers = list(peers or [])
        self._ring_epoch_cfg = max(1, int(ring_epoch))
        if peers:
            if not self._self_peer:
                raise ValueError(
                    "aggregator.selfPeer must name this replica when "
                    "aggregator.peers is set")
            self._ring = HashRing(peers, epoch=max(1, int(ring_epoch)),
                                  vnodes=self._ring_vnodes)
            if self._self_peer not in self._ring:
                raise ValueError(
                    f"aggregator.selfPeer {self_peer!r} is not in "
                    f"aggregator.peers {list(self._ring.peers)!r}")
        self._last_redirect_at: float | None = None  # keplint: guarded-by=_lock
        self._last_membership_at: float | None = None  # keplint: guarded-by=_lock
        # -- elastic membership: coordinator lease +
        # deterministic succession + runtime join/leave + autoscale.
        # The lease is DERIVED state, advanced in lock-step with the
        # ring epoch by apply_membership; its initial holder is the
        # lowest configured peer, so every replica starts agreeing.
        # Succession (plan_succession): on a host death exactly one
        # survivor — the incumbent holder while it lives, else the
        # lowest surviving peer — issues the survivor membership.
        self._lease: CoordinatorLease | None = None
        if self._ring is not None:
            self._lease = CoordinatorLease(
                elect_successor(self._config_peers),
                epoch=self._ring.epoch)
        mtopo = dict(membership_topology or {})
        # test seams for the liveness probe and the membership POST
        # (defaults: HTTP /healthz GET and /v1/membership POST)
        self._peer_alive_fn = mtopo.get("peer_alive")
        self._deliver_fn = mtopo.get("deliver")
        self._membership_probe_timeout = max(
            0.1, float(membership_probe_timeout))
        self._membership_auto_apply = bool(membership_auto_apply)
        self._standby_peers = list(membership_standby_peers or [])
        # "degraded, awaiting membership": a survivor that is NOT the
        # succession issuer (or has succession disabled) holds position
        # until the issuer's membership broadcast arrives — surfaced by
        # the fleet-ring probe, /debug/ring and the awaiting gauge
        self._awaiting_membership = False  # keplint: guarded-by=_results_lock
        # armed fabric incarnation for the next mesh-path membership (a
        # rejoin's fresh HostLocalFabric; production analog: restart the
        # multi-process job before re-applying the full set)
        self._mesh_arm: Any = None
        self._mesh_elastic: Mesh | None = None  # live (possibly sub-) mesh
        self._membership_rejected: dict[str, int] = {}  # keplint: guarded-by=_lock
        self._membership_applied: dict[str, int] = {}  # keplint: guarded-by=_lock
        self._autoscale: AutoscalePolicy | None = None
        if membership_autoscale:
            self._autoscale = AutoscalePolicy(
                scale_up_load=membership_scale_up_load,
                scale_down_load=membership_scale_down_load,
                up_windows=membership_up_windows,
                down_windows=membership_down_windows,
                min_replicas=membership_min_replicas,
                max_replicas=membership_max_replicas)
        self._autoscale_last: AutoscaleDecision | None = None  # keplint: guarded-by=_results_lock
        self._autoscale_decisions: dict[str, int] = {}  # keplint: guarded-by=_results_lock
        self._autoscale_shed_seen = 0
        # overload control: an AdmissionController in front of
        # the ingest path sheds with 429 + Retry-After BEFORE decode work
        # when the inflight or latency budget is blown — priority-aware,
        # so replay backlogs wait first and live RAPL ground truth sheds
        # last. Disabled (None) keeps the pre-admission ingest path
        # byte-for-byte: shedding off ≡ old behavior.
        self._admission: AdmissionController | None = None
        if admission_enabled:
            self._admission = AdmissionController(
                max_inflight=admission_max_inflight,
                latency_budget=admission_latency_budget,
                retry_after=admission_retry_after,
                retry_after_max=admission_retry_after_max,
                degraded_ttl=degraded_ttl,
                jitter_seed=admission_jitter_seed)
        self._results_lock = threading.Lock()
        self._results: FleetResults | None = None  # keplint: guarded-by=_results_lock
        self._last_window_at: float | None = None
        self._stats = {"reports_total": 0, "rejected_total": 0,
                       "quarantined_total": 0, "malformed_total": 0,
                       "clock_skew_total": 0,
                       "reports_redirected_total": 0,
                       # wire v2: deltas answered 409 needs-keyframe
                       # (missing/mismatched base — agent resends full)
                       "keyframe_requests_total": 0,
                       "duplicates_total": 0, "windows_lost_total": 0,
                       "attributions_total": 0, "last_batch_nodes": 0,
                       "last_batch_workloads": 0,
                       # whole-window cost (sum of the legs below — in
                       # pipelined mode wall time spans two calls, so the
                       # sum is the honest per-window figure)
                       "last_attribution_ms": 0.0,
                       # its legs, so a regression is attributable
                       "last_assembly_ms": 0.0,
                       "last_device_ms": 0.0,
                       "last_scatter_ms": 0.0,
                       # pipelined-window legs + delta-H2D accounting
                       "last_dispatch_ms": 0.0,
                       "last_wait_ms": 0.0,
                       # publish-fetch leg alone (per-shard addressable
                       # D2H materialization inside the pipeline wait)
                       "last_fetch_ms": 0.0,
                       # fused tier: device sync cost averaged over the
                       # windows of the last flushed batch (0 until the
                       # fused tier publishes)
                       "last_sync_per_window_ms": 0.0,
                       "last_h2d_rows": 0,
                       # sharded window: device shards the last window ran
                       # over (1 = unsharded engine or demoted rung) and
                       # the per-shard H2D breakdown
                       "window_shards": 0,
                       "last_h2d_shards": [],
                       # sticky-map load skew: max/mean per-shard row
                       # occupancy (1.0 = balanced, 0 = no rows yet)
                       "shard_skew": 0.0,
                       "window_compiles_total": 0,
                       # degradation ladder (0 = healthy full path)
                       "window_rung": 0,
                       "window_demotions_total": 0,
                       "window_repromotions_total": 0}
        # ingest payload bytes by wire version (the v1↔v2 byte-savings
        # evidence: kepler_fleet_ingest_bytes_total{version})
        self._ingest_bytes: dict[int, int] = {1: 0, 2: 0}  # keplint: guarded-by=_lock
        # cumulative per-node energy for _total counters: a shared dense
        # RowStore (the same machinery as the monitor's per-workload
        # accumulators) whose columns follow the canonical zone axis and
        # remap BY NAME when it changes. Survives a node briefly falling
        # out of the batch, pruned after _cum_retention of total silence.
        self._cum = RowStore(0, initial_rows=0)
        self._cum_zones: list[str] = []
        self._cum_last_seen: dict[str, float] = {}
        self._cum_retention = max(stale_after * 20.0, 600.0)
        self._program = None  # the serial rung's program, built once
        # untrained fallbacks per zone count — never clobber trained params
        self._fallback_params: dict[int, object] = {}
        # -- window pipeline (fleet.window) --------------------------------
        # depth 1 = serial (dispatch then fetch in the same call, the
        # library-call contract every aggregate_once() test relies on);
        # depth D ≥ 2 keeps D−1 windows in flight: the fetch/scatter of
        # window N overlaps window N+1's assembly+dispatch, and published
        # results are at most D−1 intervals stale. The deque normally
        # belongs to the aggregation loop alone, but shutdown() may drain
        # it from the lifecycle thread when the runner overruns its join
        # timeout — _pipeline_lock serializes those drains (uncontended
        # in steady state; never held during dispatch).
        self._pipeline_depth = max(1, int(pipeline_depth))
        self._bucket_shrink_after = max(1, int(bucket_shrink_after))
        self._pipeline_lock = threading.Lock()
        self._inflight: collections.deque[_Pending] = collections.deque()  # keplint: guarded-by=_pipeline_lock
        # rung-0 engine: ShardedWindowEngine on a 1-D node mesh of two or
        # more shards (per-shard rings, sticky assignment),
        # PackedWindowEngine otherwise; _engine_serial is the
        # single-device demotion engine the ladder's packed-serial rung
        # uses when rung 0 is sharded
        self._engine: PackedWindowEngine | None = None
        self._engine_serial: PackedWindowEngine | None = None
        self._shard_count = 1  # set in init() from the mesh shape
        # -- fused device-resident window loop (aggregator.fusedWindowK):
        # K > 1 replaces the rung-0 tier with the FusedWindowEngine —
        # host-only staging per interval, ONE launch + one batched
        # fetch per K windows. Published windows stay within the
        # ladder's ≤ depth−1 staleness contract with K as the depth.
        # Single-host only: the multi-host tier has its own ring story.
        self._fused_window_k = max(1, int(fused_window_k))
        self._engine_fused: FusedWindowEngine | None = None
        # a device failure at the fused tier flips this (rung 0 stays,
        # its engine drops to packed-pipelined — the mesh demotion's
        # shape); repromote_after clean windows at rung 0 clear it
        self._fused_degraded = False  # keplint: guarded-by=_results_lock
        # per-un-flushed-window aggregation snapshots, oldest first,
        # parallel to the fused engine's pending ring: (stored_sorted,
        # zone_names, now, t_win). Popped as the flush publishes; after
        # a failure resets the engine these are ORPHANED and
        # _replay_fused_pending republishes them at the demoted tier —
        # the zero-gaps invariant. Aggregation-loop-only state.
        self._fused_pending: list[tuple] = []
        # -- device-plane degradation ladder (fleet.window faults) ---------
        # state is written only by the aggregation loop; reads from the
        # probe/metrics threads snapshot under _results_lock
        self._fallback_enabled = bool(fallback_enabled)
        self._repromote_after = max(1, int(repromote_after))
        self._dispatch_timeout = max(0.0, float(dispatch_timeout))
        self._rung = RUNG_PIPELINED  # keplint: guarded-by=_results_lock
        self._clean_windows = 0  # consecutive clean at the current rung
        self._windows_since_failure = 0
        # rung timeline: a bounded ring of ladder transitions (rung,
        # reason, monotonic + wall time, windows spent at the previous
        # rung) behind the ladder — the flight recorder's "when did we
        # degrade, why, and for how long" answer, served by the probe
        # and /debug/window. Published windows tick _windows_at_rung.
        self._rung_timeline: collections.deque[dict] = collections.deque(  # keplint: guarded-by=_results_lock
            maxlen=64)
        self._windows_at_rung = 0
        # per-window engine introspection snapshot (computed by the
        # publish path, read by /debug/window + collect off-thread)
        self._introspect_cache: dict = {}  # keplint: guarded-by=_results_lock
        # failed-probe backoff (the breaker's doubling cooldown, ladder-
        # shaped): a demotion that lands before a just-promoted rung
        # proves itself doubles the clean-window threshold for the next
        # probe (capped), so probing a permanently wedged device — each
        # stall probe abandons one fetch worker — has a DECAYING cadence,
        # not a constant leak rate. Reset on reaching full health.
        self._probe_penalty = 1
        self._probe_penalty_cap = 64
        self._just_promoted = False
        self._last_window_failure = ""
        self._demotions_by_reason: dict[str, int] = {}  # keplint: guarded-by=_results_lock
        # lazy, replaced after a stall abandons it; used only by the
        # publish path (serialized by _pipeline_lock)
        self._fetch_worker: _FetchWorker | None = None

    def name(self) -> str:
        return "fleet-aggregator"

    # -- lifecycle ---------------------------------------------------------

    def init(self) -> None:
        if self._mesh is None:
            self._mesh = make_mesh(self._mesh_shape,
                                   self._mesh_axes or (NODE_AXIS,),
                                   device=self._device)
        if self._mh_device_process is not None:
            # the virtual topology labels each shard (by index) with its
            # process; every later query reads the shard's own label
            self._mesh = self._mesh.with_processes(self._mh_device_process)
        # the packed-serial rung runs on the mesh's first shard's device;
        # the other rungs span the mesh's node blocks
        self._device = self._mesh.devices[0]
        n_dev = self._mesh.size
        # the node axis shards over the mesh: round the bucket up so padded
        # batches always divide evenly across shards
        if self._node_bucket % n_dev:
            self._node_bucket = ((self._node_bucket // n_dev) + 1) * n_dev
        self._shard_count = self._mesh_shard_count()
        if self._ring is not None and self._multihost_active():
            # co-locate ingest with compute: ownership derives from the
            # mesh shard map — each replica ingests exactly the agents
            # whose packed rows live on its own shards.
            # aggregator.peers is ordered by process index here.
            shard_procs = list(self._mesh.processes)
            n_hosts = len(set(shard_procs))
            if len(self._config_peers) != n_hosts:
                raise ValueError(
                    f"aggregator.peers has {len(self._config_peers)} "
                    f"entries but the multi-host mesh spans {n_hosts} "
                    "processes — one peer endpoint per process, in "
                    "process-index order")
            me = self._self_process()
            if (0 <= me < len(self._config_peers)
                    and self._config_peers[me] != self._self_peer):
                # a misordered list would silently INVERT ownership:
                # every replica ingesting exactly the OTHER host's
                # agents — fail loudly instead
                raise ValueError(
                    f"aggregator.peers[{me}] is "
                    f"{self._config_peers[me]!r} but this replica "
                    f"(process {me}) is aggregator.selfPeer "
                    f"{self._self_peer!r} — the list must be ordered "
                    "by process index")
            self._ring = ring_from_mesh(self._config_peers, shard_procs,
                                        epoch=self._ring_epoch_cfg)
            log.info("ingest ring derived from the mesh shard map: "
                     "%d shards over %d hosts, epoch %d, self owns "
                     "%.3f of the shard space", self._ring.n_shards,
                     n_hosts, self._ring.epoch,
                     self._ring.ownership_ratio(self._self_peer))
        if self._backend == "pallas" and self._device.type == "cuda":
            # build every hand kernel now: a failed nvcc fails init().
            # Left to the first window, the ladder would take the build
            # error for a device failure and demote past every kernel.
            from kepler_tpu_torch.ops import build

            build.build_all()
        if self._model_mode:
            if self._model_mode != "temporal":
                from kepler_tpu_torch.models.estimator import predictor

                # fail at startup on unservable mode; temporal serves via
                # its dedicated history program instead of the registry
                predictor(self._model_mode)
            self._check_params_shape()
            if self._params is None:
                log.warning("no trained %s params given; estimates will use "
                            "untrained initialization", self._model_mode)
        self._server.register("/v1/report", "Fleet ingest",
                              "POST node window reports", self._handle_report,
                              max_body=MAX_REPORT_BYTES)
        self._server.register("/v1/reports", "Fleet batch ingest",
                              "POST a batch of node window reports "
                              "(length-prefixed envelope; per-record "
                              "status in the JSON response) — the "
                              "spool-drain replay path",
                              self._handle_report_batch,
                              max_body=MAX_REPORT_BYTES)
        self._server.register("/v1/results", "Fleet results",
                              "attributed watts per node", self._handle_results)
        self._server.register("/debug/window", "Window introspection",
                              "device-plane engine state: rung + "
                              "timeline, shards, bucket ladders, "
                              "compile-cache cost stats",
                              self._handle_window_debug)
        self._server.register("/debug/fleet", "Fleet scoreboard",
                              "per-node health state table",
                              self._handle_fleet_debug)
        self._server.register("/debug/ring", "Ingest ring",
                              "consistent-hash ingest ring: membership "
                              "epoch, peers, ownership share, redirect "
                              "counters", self._handle_ring_debug)
        self._server.register("/debug/journal", "Fleet black box",
                              "HLC-stamped causal event journal "
                              "(?since=<hlc cursor>&limit=N paginates)",
                              make_journal_handler(self._journal))
        self._server.register("/debug/bundle", "Incident bundle",
                              "one-shot incident snapshot: journal + "
                              "rung timeline + scoreboard + ring + "
                              "config fingerprint (canonical JSON — "
                              "feed to python -m kepler_tpu_torch.blackbox)",
                              self._handle_bundle_debug)
        if self._ring is not None:
            self._server.register("/v1/membership", "Elastic membership",
                                  "POST apply/join/leave membership "
                                  "operations (coordinator-lease gated)",
                                  self._handle_membership)
        health = getattr(self._server, "health", None)
        if health is not None:
            health.register_probe("fleet-aggregator", self.health)
            health.register_probe("fleet-window", self.window_health)
            if self._ring is not None:
                health.register_probe("fleet-ring", self.ring_health)
            if self._admission is not None:
                # degraded while shedding — the "ingest tier is actively
                # re-pacing its agents" signal; recovers on its own
                health.register_probe("fleet-ingest",
                                      self._admission.health)
            # ready once init completed: endpoints registered, mesh
            # built, kernels built, params validated — an empty fleet is
            # still a ready aggregator
            health.register_readiness("fleet-aggregator",
                                      lambda: {"ok": True})
        log.info("aggregator: mesh=%s devices=%d (%s) backend=%s model=%s "
                 "interval=%.1fs", self._mesh.describe(), n_dev,
                 self._device, self._backend, self._model_mode,
                 self._interval)

    def _window_mesh(self) -> Mesh:
        """The mesh the window engines run on: init()'s, or — for an
        Aggregator driven without init() — one shard on ``device``."""
        if self._mesh is not None:
            return self._mesh
        return Mesh((Shard(self._device),), (1,), (NODE_AXIS,))

    def _serial_mesh(self) -> Mesh:
        """The mesh the einsum-serial and temporal programs run over: the
        window mesh, or — when it spans processes — this process's own
        shards (its batch holds only the nodes it ingested, and a
        process launches on its own devices only)."""
        mesh = self._window_mesh()
        if len(set(mesh.processes)) > 1:
            return self._local_mesh()
        return mesh

    def _mesh_shard_count(self, mesh: Mesh | None = None) -> int:
        """Shards the packed window runs over: the node-axis size when
        the mesh is 1-D over ``node`` (every shard independent, with its
        own resident ring). Single-shard and 2-D (node × model) meshes
        run the unsharded engine — on a 2-D mesh its batch is still cut
        into node blocks, but its H2D stays whole-batch."""
        mesh = mesh if mesh is not None else self._mesh
        if mesh is None:
            return 1
        n_dev = mesh.size
        if n_dev > 1 and mesh.axis_size(NODE_AXIS) == n_dev:
            return n_dev
        return 1

    # -- multi-host topology -----------------------------------------------
    # every shard carries its process index (init() applied an injected
    # virtual topology's labels), so the helpers read the mesh itself

    def _self_process(self) -> int:
        if self._mh_process_index is not None:
            return int(self._mh_process_index)
        return process_index()

    def _multihost_active(self) -> bool:
        """True when rung 0 should run the multi-host engine: multihost
        enabled, a 1-D node mesh, and shards spanning > 1 process (real
        ``torch.distributed`` processes, or the injected virtual
        topology the tests drive in one process)."""
        if not self._multihost_enabled or self._mesh is None:
            return False
        mesh = self._live_mesh()
        n_dev = mesh.size
        if n_dev < 2 or mesh.axis_size(NODE_AXIS) != n_dev:
            return False
        return len(set(mesh.processes)) > 1

    def _live_mesh(self) -> Mesh:
        """The mesh the multi-host tier currently runs on: the full
        configured mesh, or the elastic submesh the last mesh-path
        membership restored over a peer subset."""
        return (self._mesh_elastic if self._mesh_elastic is not None
                else self._mesh)

    def _local_mesh(self) -> Mesh:
        """The surviving single-host mesh after a mesh demotion: this
        process's own shards, 1-D over node."""
        return submesh_for_processes(self._mesh, [self._self_process()])

    def _multihost_host_count(self) -> int:
        if self._mesh is None:
            return 1
        return len(set(self._live_mesh().processes))

    def _demote_mesh(self, reason: str) -> None:
        """The "mesh minus one host" tier: a cross-host window failure
        (dead peer, broken agreement, fabric loss) retires the
        multi-host engine in this process — the survivors' rung 0
        becomes their own single-host sharded engine (full ring
        re-seed via the engine rebuild). Within the current fabric
        incarnation the demotion is sticky; a rejoin
        (``/v1/membership`` join + :meth:`arm_mesh`) restores the
        multi-host tier under a NEW incarnation.

        Ring healing runs by DETERMINISTIC SUCCESSION at any mesh
        size: every survivor probes the peer set and computes the same
        entitled issuer — the incumbent lease holder while it
        survives, else the lowest surviving peer. Exactly ONE
        survivor therefore bumps the epoch and broadcasts the
        survivor membership; the rest hold position "degraded,
        awaiting membership" until the broadcast lands. The
        equal-epoch conflict check at apply stays as the backstop a
        partitioned prober could still trip. Displaced agents follow
        421s to the new owners and replay their spool tails — the
        existing hand-off machinery, zero windows lost."""
        self._engine = None  # next window rebuilds over the local mesh
        self._engine_serial = None  # its pinned device must be LOCAL
        self._mesh_elastic = None  # the elastic submesh died with the peer
        log.error("multi-host mesh degraded (%s): demoting to the "
                  "single-host engine over this process's devices; "
                  "displaced agents will be redirected by epoch bump",
                  reason)
        if self._ring is None:
            return
        if not self._multihost_takeover:
            # succession disabled: the operator owns the rebalance —
            # flag the wait so the probe says WHY ingest is degraded
            with self._results_lock:
                self._awaiting_membership = True
            return
        survivors = self._probe_survivors()
        if set(survivors) == set(self._ring.peers):
            # the issuer's broadcast landed BEFORE this process noticed
            # the death: membership already reflects the survivor set,
            # so there is neither a bump to issue nor one to await
            return
        holder = self._lease.holder if self._lease is not None else ""
        issuer = plan_succession(holder, survivors)
        if issuer != self._self_peer:
            with self._results_lock:
                self._awaiting_membership = True
            log.warning(
                "mesh demotion: membership succession belongs to "
                "surviving peer %s (lease %s) — holding position, "
                "awaiting its membership broadcast", issuer,
                self._lease.lease_id if self._lease is not None
                else "?")
            return
        epoch = self._ring.epoch + 1
        try:
            self.apply_membership(survivors, epoch,
                                  source="succession",
                                  issuer=self._self_peer)
        except ValueError as err:
            log.error("mesh-demotion succession failed: %s", err)
            with self._results_lock:
                self._awaiting_membership = True
            return
        self._broadcast_membership(survivors, epoch)

    def run(self, ctx: CancelContext) -> None:
        while not ctx.cancelled():
            if ctx.wait(self._interval):
                break
            try:
                self.aggregate_once()
            except Exception:
                log.exception("fleet aggregation failed")
        # deterministic drain: every dispatched window is published before
        # the loop exits — no result is abandoned in flight on shutdown
        try:
            self._drain_pipeline()
        except Exception:
            log.exception("fleet pipeline drain failed")

    # keplint: thread-role=shutdown
    def shutdown(self) -> None:
        # idempotent with the run()-exit drain (the deque is empty then);
        # covers direct aggregate_once() users who never ran the loop
        self._drain_pipeline()
        worker, self._fetch_worker = self._fetch_worker, None
        if worker is not None:
            worker.stop()
            # the daemon thread has used CUDA: let it end before the
            # caller's process may exit, or its thread teardown can race
            # the interpreter's (an abort at exit)
            worker.join(_WORKER_JOIN_S)
        self._journal.close()

    # -- ingest ------------------------------------------------------------

    def _handle_report(
            self, request: Any) -> tuple[int, dict[str, str], bytes]:
        # one telemetry cycle per ingest POST, with the decode and merge
        # legs as stages — the receive half of the delivery trace the
        # agent opened at window emit
        with telemetry.span("aggregator.ingest"):
            ctrl = self._admission
            if request.command != "POST":
                return self._ingest_report(request)
            if not self._observe_request_hlc(request):
                return self._bad_hlc_response()
            # ONE header parse per record, carried from the admission
            # peek through _ingest_payload (v1 used to re-parse the
            # same JSON up to four times; v2 makes this a struct read)
            parsed = try_parse_header(request.body)
            if ctrl is None:
                return self._ingest_report(request, parsed)
            # admission runs BEFORE any decode work: over budget the
            # request is turned away at header-peek cost, and the spool
            # on the agent side makes that loss-free — the record stays
            # durable and replays after the Retry-After hint
            retry = ctrl.admit(self._priority_of(request.body, parsed))
            if retry is not None:
                return self._throttle_response(retry)
            self._note_admitted()
            t0 = _time.perf_counter()
            try:
                return self._ingest_report(request, parsed)
            finally:
                ctrl.done(_time.perf_counter() - t0)

    def _handle_report_batch(
            self, request: Any) -> tuple[int, dict[str, str], bytes]:
        """``POST /v1/reports``: the batched spool-drain path. Each
        record runs through the SAME single-report ingest internals
        (per-record admission, dedup, quarantine, redirect), and the
        response carries a per-record status list — so one request
        replays K spooled records while every delivery/loss/dedup
        invariant stays per-record. Once admission sheds mid-batch, the
        remaining records are answered 429 without being looked at (the
        whole point is to stop paying decode cost)."""
        with telemetry.span("aggregator.ingest"):
            if request.command != "POST":
                return 405, {"Content-Type": "text/plain"}, b"POST only\n"
            if not self._observe_request_hlc(request):
                return self._bad_hlc_response()
            if fault.fire("replica.down") is not None:
                return (503, {"Content-Type": "text/plain"},
                        b"replica down (fault injection)\n")
            try:
                payloads = decode_report_batch(request.body)
            except WireError as err:
                with self._lock:
                    self._stats["rejected_total"] += 1
                    self._stats["malformed_total"] += 1
                return (400, {"Content-Type": "text/plain"},
                        f"{err}\n".encode())
            ctrl = self._admission
            results: list[dict[str, Any]] = []
            shed_retry: float | None = None
            for body in payloads:
                if shed_retry is not None:
                    # stop paying even peek cost once shedding started
                    results.append({"status": 429,
                                    "retry_after": shed_retry})
                    continue
                parsed = try_parse_header(body)
                if ctrl is not None:
                    retry = ctrl.admit(self._priority_of(body, parsed))
                    if retry is not None:
                        shed_retry = retry
                        self._note_shed_onset(retry)
                        results.append({"status": 429,
                                        "retry_after": retry})
                        continue
                    self._note_admitted()
                t0 = _time.perf_counter()
                try:
                    status, resp_headers, resp_body = \
                        self._ingest_payload(body, parsed)
                finally:
                    if ctrl is not None:
                        ctrl.done(_time.perf_counter() - t0)
                row: dict[str, Any] = {"status": status}
                if status == 421 or (
                        status == 409
                        and resp_headers.get(
                            "X-Kepler-Needs-Keyframe")):
                    # structured responses (owner redirect, needs-
                    # keyframe) keep their JSON shape per record, so
                    # the agent's guards see the same fields as on the
                    # single-record path
                    try:
                        row.update(json.loads(resp_body))
                    except ValueError:
                        pass
                elif status >= 400:
                    row["error"] = resp_body.decode(
                        errors="replace").strip()[:200]
                results.append(row)
            headers = {"Content-Type": "application/json",
                       **self._epoch_headers()}
            if shed_retry is not None:
                headers["Retry-After"] = f"{shed_retry:g}"
            return (200, headers,
                    json.dumps({"results": results}).encode())

    def _throttle_response(
            self, retry: float) -> tuple[int, dict[str, str], bytes]:
        self._note_shed_onset(retry)
        body = json.dumps({"retry_after": retry}).encode()
        return (429, {"Content-Type": "application/json",
                      "Retry-After": f"{retry:g}",
                      **self._epoch_headers()}, body)

    def _note_shed_onset(self, retry: float) -> None:
        """Journal the admission-shed ONSET (False→True edge only —
        steady-state shedding is a rate, not an event)."""
        with self._lock:
            onset = not self._shedding
            self._shedding = True
        if onset:
            self._journal.emit("admission.shed",
                               retry_after=round(float(retry), 3))

    def _note_admitted(self) -> None:
        """An admitted request closes the shed episode: the NEXT shed
        is a fresh onset."""
        if self._shedding:
            with self._lock:
                self._shedding = False

    def _priority_of(self, body: bytes,
                     parsed: "ParsedHeader | None" = None) -> int:
        """Admission priority from a CHEAP header peek (no array decode):
        replay backlogs behind fresh windows, model-estimated nodes
        behind RAPL ground truth, scoreboard-flagged reporters behind
        healthy ones — live attribution accuracy degrades last. With a
        ``parsed`` memo the peek is a dict read, not a re-parse."""
        if parsed is not None:
            name, path, mode = parsed.routing()
        else:
            name, path, mode = peek_routing(body)
        if path == "replay":
            p = PRIORITY_REPLAY_GROUND
        else:
            p = PRIORITY_FRESH_GROUND
        if mode == MODE_MODEL:
            p += 1
        if p == PRIORITY_FRESH_GROUND and name:
            with self._lock:
                flagged = self._scoreboard.flagged(name, self._clock())
            if flagged:
                p = PRIORITY_FRESH_MODEL
        return p

    def _ingest_report(
            self, request: Any,
            parsed: "ParsedHeader | None" = None
            ) -> tuple[int, dict[str, str], bytes]:
        if request.command != "POST":
            return 405, {"Content-Type": "text/plain"}, b"POST only\n"
        if fault.fire("replica.down") is not None:
            # chaos stand-in for a dying/overloaded replica: a 5xx the
            # agent counts as a send failure (failover + spool), never
            # as a permanent rejection
            return (503, {"Content-Type": "text/plain"},
                    b"replica down (fault injection)\n")
        return self._ingest_payload(request.body, parsed)

    # keplint: protocol-transition — base-row LRU touch
    def _delta_base_for(self, parsed: "ParsedHeader"
                        ) -> "_BaseRow | None":
        """Resolve a v2 delta frame's base keyframe. None = answer a
        structured 409 needs-keyframe (missing base after hand-off or
        eviction, run change, base-seq mismatch) — the agent resends
        full, nothing is charged or stored. A hostile node name raises
        into the ordinary quarantine path instead."""
        raw = parsed.header.get("node_name")
        name = sanitize_node_name(raw) if isinstance(raw, str) else ""
        if not name or name != raw:
            raise WireError("node_name must be 1-128 printable ASCII "
                            "chars")
        run = parsed.header.get("run")
        with self._lock:
            base = self._base_rows.get(name)
            if (base is None or not isinstance(run, str)
                    or not delta_base_matches(base.run, base.seq,
                                              run, parsed.base_seq)):
                self._stats["keyframe_requests_total"] += 1
                return None
            self._base_rows[name] = self._base_rows.pop(name)  # LRU touch
        return base

    def _needs_keyframe_response(
            self, parsed: "ParsedHeader"
            ) -> tuple[int, dict[str, str], bytes]:
        body = json.dumps({"needs_keyframe": True,
                           "base_seq": parsed.base_seq}).encode()
        return (409, {"Content-Type": "application/json",
                      "X-Kepler-Needs-Keyframe": "1",
                      **self._epoch_headers()}, body)

    # keplint: requires-lock=_lock
    # keplint: protocol-transition — keyframe plants the delta base
    def _store_base_locked(self, name: str, run: str, seq: int,
                           report: NodeReport,
                           zones: tuple[str, ...]) -> None:
        """Adopt a decoded v2 keyframe as the node's delta base (LRU:
        dict order = recency, oldest evicted at the cap). Runs for
        DUPLICATE keyframes too: a hand-off replay judged dup by the
        seeded tracker must still plant the base, or the agent's next
        delta would 409 forever."""
        self._base_rows.pop(name, None)
        while len(self._base_rows) >= self._base_row_cache:
            self._base_rows.pop(next(iter(self._base_rows)))
        self._base_rows[name] = _BaseRow(run=run, seq=seq,
                                         report=report,
                                         zone_names=zones)

    def _ingest_payload(
            self, body: bytes,
            parsed: "ParsedHeader | None" = None
            ) -> tuple[int, dict[str, str], bytes]:
        spec = fault.fire("aggregator.ingest_slow")
        if spec is not None:
            # chaos stand-in for a sinking ingest path (GC stall, slow
            # disk, CPU-starved replica): inflates the admission
            # controller's latency EWMA the honest way — by being slow
            _time.sleep(float(spec.arg or 0.05))
        if parsed is None:
            parsed = try_parse_header(body)
        if parsed is not None:
            # clamp to the two known versions: the counter keys a metric
            # label and must never grow with hostile frame contents
            version = 2 if parsed.version == 2 else 1
            with self._lock:
                self._ingest_bytes[version] = \
                    self._ingest_bytes.get(version, 0) + len(body)
        content_changed = True
        try:
            with telemetry.span("aggregator.decode"):
                if (parsed is not None and parsed.version == 2
                        and parsed.is_delta):
                    base = self._delta_base_for(parsed)
                    if base is None:
                        return self._needs_keyframe_response(parsed)
                    report, header, content_changed = decode_delta(
                        body, parsed, base.report, base.zone_names)
                else:
                    # v1 (the pinned JSON path — decoded off the ONE
                    # parse_header memo) or a v2 keyframe (zero-copy
                    # frombuffer views over the request body)
                    report, header = decode_report(body, parsed)
        except (WireError, ValueError) as err:
            # quarantine, charged to the sender when the header survives.
            # The header work runs OFF the store lock — a burst of
            # large malformed bodies must not stall ingest/aggregation.
            # The peeked name is UNVALIDATED wire input (the body already
            # failed decoding): sanitize before it becomes a degradation
            # key, scoreboard row, metric label, or log field (KTL112)
            if parsed is not None:
                raw = parsed.header.get("node_name")
                node = (sanitize_node_name(raw)
                        if isinstance(raw, str) else "")
            else:
                node = sanitize_node_name(peek_node_name(body) or "")
            with self._lock:
                self._stats["rejected_total"] += 1
                self._stats["quarantined_total"] += 1
                self._stats["malformed_total"] += 1
                if node:
                    self._record_degraded_locked(node, "malformed", str(err))
            return 400, {"Content-Type": "text/plain"}, f"{err}\n".encode()
        received = self._clock()
        sent_at = header.get("sent_at")
        if (self._skew_tolerance > 0
                and isinstance(sent_at, (int, float))
                and not isinstance(sent_at, bool)
                and abs(received - float(sent_at)) > self._skew_tolerance):
            # a skewed sender's reports would corrupt staleness aging and
            # cumulative-energy timestamps — quarantine instead of ingest
            skew = float(sent_at) - received
            with self._lock:
                self._stats["rejected_total"] += 1
                self._stats["quarantined_total"] += 1
                self._stats["clock_skew_total"] += 1
                self._record_degraded_locked(
                    report.node_name, "clock_skew",
                    f"sender clock skewed {skew:+.1f}s")
            return (422, {"Content-Type": "text/plain"},
                    f"report clock skewed {skew:+.1f}s beyond tolerance "
                    f"{self._skew_tolerance:g}s\n".encode())
        # header identity coercion is VALIDATING, not converting: a report
        # whose seq/run carry the wrong JSON type (a string seq, a list
        # run) is malformed input from an untrusted network — quarantine
        # and charge the sender, never raise into a 500
        seq_raw = header.get("seq", 0)
        run_raw = header.get("run", "")
        if (isinstance(seq_raw, bool) or not isinstance(seq_raw, int)
                or seq_raw < 0 or not isinstance(run_raw, str)):
            with self._lock:
                self._stats["rejected_total"] += 1
                self._stats["quarantined_total"] += 1
                self._stats["malformed_total"] += 1
                self._record_degraded_locked(
                    report.node_name, "malformed",
                    f"bad header identity: seq={seq_raw!r} run={run_raw!r}")
            return (400, {"Content-Type": "text/plain"},
                    b"seq must be a non-negative integer and run a string\n")
        # ring-header coercion, hardened exactly like run/seq: the
        # owner/epoch/acked_through fields steer redirect handling and
        # loss accounting, so hostile values (non-int, negative, bool,
        # overlong/non-printable owner) are a 400 quarantine charged to
        # the node — never a 500, never silently honored
        owner_raw = header.get("owner", "")
        epoch_val = coerce_epoch(header.get("epoch", 0))
        acked_through = coerce_epoch(header.get("acked_through", 0))
        owner_ok = owner_raw == "" or sanitize_peer(owner_raw) == owner_raw
        if epoch_val is None or acked_through is None or not owner_ok:
            with self._lock:
                self._stats["rejected_total"] += 1
                self._stats["quarantined_total"] += 1
                self._stats["malformed_total"] += 1
                self._record_degraded_locked(
                    report.node_name, "malformed",
                    f"bad ring header: owner={owner_raw!r} "
                    f"epoch={header.get('epoch')!r} "
                    f"acked_through={header.get('acked_through')!r}")
            return (400, {"Content-Type": "text/plain"},
                    b"owner must be a printable string, epoch and "
                    b"acked_through non-negative integers\n")
        # ownership: a report for a node the ring assigns elsewhere is
        # answered with a structured redirect (the agent follows it and
        # re-delivers there) — not stored, not charged, not tracked
        ring = self._ring
        if ring is not None:
            owner = ring.owner(report.node_name)
            if owner != self._self_peer:
                with self._lock:
                    self._stats["reports_redirected_total"] += 1
                    self._last_redirect_at = received
                body = json.dumps({"owner": owner,
                                   "epoch": ring.epoch}).encode()
                return (421, {"Content-Type": "application/json",
                              "X-Kepler-Owner": owner,
                              "X-Kepler-Epoch": str(ring.epoch)}, body)
        stored = _Stored(report=report,
                         zone_names=tuple(header["zone_names"]),
                         received=received,
                         seq=seq_raw,
                         run=run_raw,
                         content_seq=seq_raw,
                         wire_version=(2 if parsed is not None
                                       and parsed.version == 2 else 1))
        # scoreboard input, computed OFF the store lock: the node's
        # self-reported power this window (valid zone energy over dt)
        report_power_w = _report_power_w(report)
        with telemetry.span("aggregator.merge"), self._lock:
            prev = self._reports.get(report.node_name)
            # When BOTH sides carry a run nonce the cases are unambiguous:
            # different nonce = fresh agent process (restart), same nonce +
            # seq regression = network reorder or spool redelivery (the
            # dedup window sorts those out). A nonce that matches any run
            # a previous restart superseded is a delayed straggler from a
            # dead run — reject it outright rather than honoring it as
            # another restart (which would also wrongly mark the live run
            # as superseded).
            superseded = self._superseded_runs.get(report.node_name, [])
            if stored.run and stored.run in superseded:
                self._stats["rejected_total"] += 1
                return (409, {"Content-Type": "text/plain"},
                        b"stale run nonce (superseded by a newer agent run)\n")
            has_nonces = (prev is not None and bool(stored.run)
                          and bool(prev.run))
            restarted = has_nonces and stored.run != prev.run
            # wire v2: adopt an accepted keyframe as the node's delta
            # base BEFORE dedup (a duplicate keyframe is still a valid
            # base — see _store_base_locked) but AFTER the superseded-
            # run check, so a dead run can never plant base state
            if (parsed is not None and parsed.version == 2
                    and not parsed.is_delta and stored.run
                    and stored.seq > 0):
                self._store_base_locked(
                    report.node_name, stored.run, stored.seq, report,
                    stored.zone_names)
            # content identity: a FLAG_SAME delta asserts (and decode
            # verified) that this window's content EQUALS the base
            # keyframe's — so the content seq is the BASE's seq, not
            # this window's. Steady state pins every unchanged window
            # to the keyframe identity (zero staged rows); a node that
            # changed and then reverted gets the keyframe identity
            # back, which correctly restages it over the changed row.
            if (not content_changed and parsed is not None
                    and parsed.is_delta and parsed.base_seq > 0):
                stored.content_seq = parsed.base_seq
            if restarted:
                runs = self._superseded_runs.setdefault(
                    report.node_name, [])
                runs.append(prev.run)
                del runs[:-self._superseded_cap]
            # idempotent ingest + loss accounting (nonce-carrying agents
            # only — a pre-nonce agent's seq space restarts unannounced,
            # so gap math on it would fabricate loss). seq 0 means "no
            # sequencing" (encode_report's default): real agents number
            # from 1, and deduping a stream of constant zeros would
            # freeze the node's data on its first window forever.
            lost_windows = 0
            if stored.run and stored.seq > 0:
                tracker = self._seq_trackers.get(report.node_name)
                if tracker is None or tracker.run != stored.run:
                    # the cap tracks the LIVE fleet (2× headroom, floor
                    # for small fleets): a fixed cap below the fleet size
                    # would thrash — every round-robin arrival evicting a
                    # peer's tracker, disabling dedup and fabricating
                    # lost-window counts on every report. Memory is
                    # operator-bounded via aggregator.dedupWindow.
                    cap = max(self._tracker_cap, 2 * len(self._reports))
                    if (report.node_name not in self._seq_trackers
                            and len(self._seq_trackers) >= cap):
                        self._seq_trackers.pop(min(
                            self._seq_trackers,
                            key=lambda n: self._seq_trackers[n].touched))
                    tracker = _SeqTracker(stored.run, self._dedup_window)
                    # hand-off / restart seeding from the agent's
                    # delivered watermark (pure rule: fleet/delivery.py)
                    seed_fresh_tracker(tracker, acked_through,
                                       stored.seq)
                    self._seq_trackers[report.node_name] = tracker
                tracker.touched = received
                # ownership RETURN (elastic membership): the
                # re-seed rule — the away period's windows were 2xx'd
                # by the interim owner, not lost (pure rule:
                # fleet/delivery.py, model-checked by kepmc)
                ring_epoch = (self._ring.epoch
                              if self._ring is not None else 0)
                reseed_on_ownership_return(tracker, ring_epoch,
                                           acked_through, stored.seq)
                dup, lost = tracker.observe(stored.seq)
                if dup:
                    # at-least-once redelivery (spool replay, LB retry):
                    # acknowledge so the sender's cursor advances, ingest
                    # nothing — the earlier copy already counted. The
                    # duplicate still PROVES the sender is alive: refresh
                    # liveness, or a replay longer than stale_after would
                    # prune this tracker mid-stream and the rest of the
                    # backlog would re-ingest as fresh windows
                    if prev is not None and prev.run == stored.run:
                        prev.received = received
                    self._stats["duplicates_total"] += 1
                    self._stats["reports_total"] += 1
                    self._scoreboard.observe_duplicate(report.node_name,
                                                       received)
                    return 204, self._epoch_headers(), b""
                if lost:
                    lost_windows = lost
                    self._stats["windows_lost_total"] += lost
                    # pop-and-reinsert keeps dict order = recency of last
                    # loss, so cap eviction drops the node that stopped
                    # losing longest ago — never an actively-firing
                    # series (a mid-series counter reset breaks rate()
                    # alerting on exactly this signal)
                    total = self._lost_by_node.pop(report.node_name,
                                                   0) + lost
                    if len(self._lost_by_node) >= self._lost_node_cap:
                        self._lost_by_node.pop(
                            next(iter(self._lost_by_node)))
                    self._lost_by_node[report.node_name] = total
                    log.warning("node %s: %d window(s) lost before seq %d "
                                "(never delivered)", report.node_name,
                                lost, stored.seq)
            # NOTE: the legacy `seq == 1` restart heuristic is gone — a
            # spool replay legitimately starts at seq 1 of an OLD run and
            # must not double-ingest as a "restart"; nonce-carrying agents
            # signal restarts explicitly, and pre-nonce agents simply age
            # out via stale_after before their fresh reports land again.
            if prev is None or restarted or stored.seq >= prev.seq:
                self._reports[report.node_name] = stored
                # history push is NOT idempotent (a dup would shift the
                # window) → require a seq change OR a run change (an agent
                # restart that happens to re-send the previous run's seq
                # value is still a new window). Ratio nodes' estimator
                # output is discarded, so their windows matter only as
                # TRAINING data — accrete them when a dump dir is set.
                # The push happens HERE, under the store lock: acceptance
                # order must equal buffer order (a deferred push could let
                # a concurrent seq=N+1 land before seq=N, derailing the
                # window's time axis) — the append itself is one tiny row
                # per workload; the expensive [N, W, T, F] ASSEMBLY is
                # what runs off this lock (_history_windows).
                if (self._model_mode == "temporal"
                        and (report.mode == MODE_MODEL or self._dump_dir)
                        and (prev is None or restarted
                             or stored.seq != prev.seq)):
                    self._push_history(report)
            self._scoreboard.observe_report(report.node_name, received,
                                            report_power_w,
                                            lost=lost_windows)
            self._observe_delivery_locked(report.node_name, header,
                                          received)
            self._stats["reports_total"] += 1
        return 204, self._epoch_headers(), b""

    def _epoch_headers(self) -> dict[str, str]:
        """Accepts advertise the ring epoch so settled agents notice a
        membership bump lazily (no extra round-trips); with the journal
        enabled they ALSO carry this replica's HLC stamp, so agents'
        clocks chain causally to the aggregator's (piggyback — never an
        extra round-trip, absent entirely when the journal is off)."""
        headers: dict[str, str] = {}
        hlc_text = self._journal.header()
        if hlc_text is not None:
            headers["X-Kepler-HLC"] = hlc_text
        ring = self._ring
        if ring is not None:
            headers["X-Kepler-Epoch"] = str(ring.epoch)
        return headers

    def _observe_request_hlc(self, request: Any) -> bool:
        """Merge an inbound ``X-Kepler-HLC`` stamp into this replica's
        clock. Returns False ONLY for a present-but-hostile stamp (the
        caller answers 400) — absent headers and chaos/test stand-in
        requests without a ``headers`` attribute are fine. The clamp
        in :meth:`HlcClock.observe` bounds how far a valid-but-vaulted
        stamp can advance us (KTL112: laundered, never trusted)."""
        headers = getattr(request, "headers", None)
        if headers is None:
            return True
        raw = headers.get("X-Kepler-HLC")
        if raw is None:
            return True
        return self._journal.observe_text(raw)

    def _bad_hlc_response(self) -> tuple[int, dict[str, str], bytes]:
        with self._lock:
            self._stats["rejected_total"] += 1
            self._stats["malformed_total"] += 1
        return (400, {"Content-Type": "text/plain"},
                b"malformed X-Kepler-HLC header\n")

    # -- ingest ring (HA ingest tier) --------------------------------------

    def apply_membership(self, peers: Sequence[str], epoch: int, *,
                         source: str = "operator", issuer: str = "",
                         mesh: bool = False) -> int:
        """Adopt a new replica membership — the operator action it has
        always been (config rollout, chaos rebalance), and now ALSO
        the elastic plane's one write path: succession after a host
        death, join/leave fan-out from the lease holder, autoscale
        enactment. Swaps in a NEW ring at a HIGHER epoch and drops
        stored reports for nodes this replica no longer owns — their
        agents get redirected on their next send and replay their
        spool tails to the new owner. Seq trackers are KEPT (bounded
        by their cap): if ownership bounces back, dedup continuity
        absorbs the re-delivered overlap.

        Epoch semantics: re-applying the SAME peer set at
        the CURRENT epoch is an idempotent replay (returns 0 — a
        re-delivered broadcast, indistinguishable from a no-op); the
        same epoch with a DIFFERENT set is the split-brain detector
        firing — rejected loudly as ``equal_epoch_conflict`` and
        counted in ``kepler_fleet_membership_rejected_total``. A
        lower epoch is ``stale_epoch``. ``source`` labels the
        applied/rejected counters; ``issuer`` (default: succession
        over the new set) advances the coordinator lease in lock-step
        with the ring.

        A non-operator membership that EXCLUDES this replica retires
        it: the new ring is adopted anyway, every stored node is
        dropped, and all future ingest answers 421 toward the real
        owners — the scale-down path. The operator path keeps the
        strict self-in-set check (excluding yourself by hand is
        almost certainly a typo). ``mesh=True`` asks for the
        mesh-derived ring (and multi-host engine) to be restored over
        the new set — the rejoin path; it needs the peers to be a
        process-ordered subset of the configured list (and, after a
        fabric loss, a fresh incarnation via :meth:`arm_mesh`), and
        falls back to the plain hash ring otherwise.

        Returns the number of nodes handed off. Raises
        :class:`MembershipError` (a ``ValueError``) on rejection."""
        try:
            return self._apply_membership_checked(
                peers, epoch, source=source, issuer=issuer, mesh=mesh)
        except MembershipError as err:
            with self._lock:
                self._membership_rejected[err.reason] = \
                    self._membership_rejected.get(err.reason, 0) + 1
            log.error("membership rejected (%s, source=%s): %s",
                      err.reason, source, err)
            raise

    def _apply_membership_checked(self, peers: Sequence[str],
                                  epoch: int, *, source: str,
                                  issuer: str, mesh: bool) -> int:
        if self._ring is None:
            raise MembershipError(
                "ring_disabled",
                "ingest ring is not enabled (aggregator.peers is empty)")
        current = self._ring
        # the whole epoch/peer-set state machine is the PURE decision
        # (fleet/membership.py, model-checked by kepmc); this method
        # only wires its verdict to the ring/lease/stores
        decision = plan_membership_apply(
            current.epoch, current.peers, current.membership_digest,
            epoch, peers, self._self_peer, source)
        ep = decision.epoch
        if decision.action == "replay":
            log.info("membership replay at epoch %d ignored (same "
                     "peer set, digest %s)", ep,
                     current.membership_digest)
            return 0
        retired = decision.retired
        new = self._build_ring(list(decision.peers), ep, mesh=mesh)
        who = issuer or plan_succession(
            self._lease.holder if self._lease is not None else "",
            new.peers)
        with self._lock:
            self._ring = new
            # the lease advances in lock-step with the ring epoch —
            # adopt cannot conflict here (ep > current epoch by the
            # checks above), so succession state never splits from
            # membership state
            if self._lease is not None:
                self._lease.adopt(who, ep)
            else:
                self._lease = CoordinatorLease(who, ep)
            dropped = [n for n in self._reports
                       if retired or new.owner(n) != self._self_peer]
            for name in dropped:
                del self._reports[name]
                self._history.pop(name, None)
                self._superseded_runs.pop(name, None)
                # the new owner holds no base for it either — dropping
                # ours keeps "409 → keyframe" the one hand-off story
                self._base_rows.pop(name, None)
                # the node reports to its NEW owner now — a row left
                # here would age into a permanent false 'stale' signal
                self._scoreboard.drop(name)
            self._last_membership_at = self._clock()
            self._membership_applied[source] = \
                self._membership_applied.get(source, 0) + 1
        # black box: the apply and the lock-step lease adopt are TWO
        # events — timeline readers correlate successions across
        # replicas by the adopt, membership churn by the apply
        self._journal.emit("membership.apply", epoch=ep,
                           peers=sorted(new.peers), source=source,
                           dropped=len(dropped), retired=retired)
        self._journal.emit("lease.adopt", holder=who, epoch=ep,
                           source=source)
        if self._multihost_enabled:
            # elastic rebuild, the ladder-reset invariant: sticky maps
            # cleared, rings re-seeded — the next window does a full
            # re-pack over the new member set
            self._engine = None
            self._engine_serial = None
        with self._results_lock:
            self._awaiting_membership = False
        log.warning("ingest ring membership changed: epoch %d, %d "
                    "peer(s) (digest %s, issuer %s, source %s), %d "
                    "node(s) handed off%s", new.epoch, len(new),
                    new.membership_digest, who, source, len(dropped),
                    (" — this replica RETIRED (owns nothing, redirects "
                     "everything)" if retired else ""))
        return len(dropped)

    def _build_ring(self, peers: list[str], epoch: int,
                    mesh: bool) -> HashRing:
        """The new ring for a membership change: the mesh-derived ring
        when a mesh restore was requested AND the topology can honor
        it — the peers must be a >=2-process subset of the configured
        process-ordered list (ownership co-location is only true for
        processes the device mesh actually contains); otherwise the
        plain consistent-hash ring."""
        if mesh and self._multihost_enabled and self._mesh is not None:
            want = set(peers)
            procs = [i for i, p in enumerate(self._config_peers)
                     if p in want]
            if len(procs) == len(want) and len(procs) >= 2:
                armed, self._mesh_arm = self._mesh_arm, None
                if armed is not None:
                    # a rejoin's fresh fabric incarnation (the old
                    # one's barriers died with the departed peer)
                    self._mh_fabric = armed
                sub = submesh_for_processes(self._mesh, procs)
                order = {p: k for k, p in enumerate(procs)}
                shard_procs = [order[p] for p in sub.processes]
                peers_by_proc = [self._config_peers[p] for p in procs]
                self._mesh_elastic = sub
                with self._results_lock:
                    self._mesh_degraded = False
                log.info("mesh-derived ring restored over %d process(es) "
                         "(%d shards) at epoch %d", len(procs),
                         len(shard_procs), epoch)
                return ring_from_mesh(peers_by_proc, shard_procs,
                                      epoch=epoch)
            log.warning("mesh-path membership cannot be honored (peers "
                        "%r are not a >=2-process subset of the "
                        "configured process-ordered list); falling back "
                        "to the plain hash ring", sorted(want))
        if self._multihost_enabled:
            # a non-mesh membership while the multi-host tier runs
            # means the mesh no longer describes ownership: survivors
            # serve their ring share from their own single-host
            # engines until a mesh-path membership restores the tier
            self._mesh_elastic = None
            with self._results_lock:
                if self._multihost_active():
                    self._mesh_degraded = True
        try:
            return self._ring.with_members(peers, epoch)
        except RingError as err:
            raise MembershipError("bad_peer", str(err))

    # -- elastic membership plane ------------------------------------------

    def arm_mesh(self, fabric: Any) -> None:
        """Arm a fresh fabric incarnation for the NEXT mesh-path
        membership (the rejoin/restore handshake): the virtual
        topology passes its new :class:`HostLocalFabric`; production's
        analog is restarting the multi-process job before re-applying
        the full membership (a dead peer cannot rejoin a RUNNING job).
        One-shot: consumed by the next ``apply_membership(..., mesh=True)``."""
        self._mesh_arm = fabric

    def _peer_alive(self, peer: str) -> bool:
        """Liveness probe for one peer: the injected seam, or an HTTP
        GET of its ``/healthz`` — ANY HTTP answer (even 503) proves a
        listener; only transport failures read as death."""
        probe = self._peer_alive_fn
        if probe is not None:
            try:
                return bool(probe(peer))
            except Exception:
                return False
        import urllib.error
        import urllib.request

        try:
            with urllib.request.urlopen(
                    f"http://{peer}/healthz",
                    timeout=self._membership_probe_timeout):
                return True
        except urllib.error.HTTPError:
            return True
        except Exception:
            return False

    def _probe_survivors(self) -> list[str]:
        """The current peer set filtered by liveness (self is alive by
        definition). Every survivor runs the same probe over the same
        set, so — probe flakes aside, which the equal-epoch conflict
        check backstops — they compute the same survivor list and
        therefore the same succession issuer."""
        ring = self._ring
        if ring is None:
            return [self._self_peer]
        return [peer for peer in ring.peers
                if peer == self._self_peer or self._peer_alive(peer)]

    def _deliver_membership(self, peer: str,
                            payload: Mapping[str, Any]) -> dict:
        """POST one membership payload to ``peer`` (the injected seam,
        or HTTP ``/v1/membership``) and return its JSON reply.
        Transport failures return a structured not-ok reply instead of
        raising — broadcast is best-effort; a replica a broadcast
        misses converges via the epoch headers and the equal-epoch
        replay guard."""
        deliver = self._deliver_fn
        if deliver is not None:
            try:
                reply = deliver(peer, dict(payload))
            except Exception as err:
                return {"ok": False, "reason": "unreachable",
                        "detail": str(err)[:240]}
            if isinstance(reply, Mapping):
                return dict(reply)
            return {"ok": False, "reason": "bad_reply"}
        import urllib.error
        import urllib.request

        req = urllib.request.Request(
            f"http://{peer}/v1/membership",
            data=json.dumps(dict(payload)).encode(),
            headers={"Content-Type": "application/json"},
            method="POST")
        try:
            with urllib.request.urlopen(
                    req, timeout=self._membership_probe_timeout) as resp:
                return json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as err:
            try:
                return json.loads(err.read() or b"{}")
            except Exception:
                return {"ok": False, "reason": "unreachable",
                        "detail": f"http {err.code}"}
        except Exception as err:
            return {"ok": False, "reason": "unreachable",
                    "detail": str(err)[:240]}

    def _broadcast_membership(self, peers: Sequence[str], epoch: int,
                              extra: Sequence[str] = (),
                              mesh: bool = False) -> None:
        """Fan the just-applied membership out to every OTHER member
        (plus ``extra`` — e.g. a peer the membership just removed, so
        it retires instead of serving a stale ring)."""
        # the issuer is the CURRENT lease holder, not necessarily this
        # replica: a holder retiring itself (leave) hands the lease to
        # its successor in the local apply, and the fan-out must carry
        # that successor or receivers would adopt the departed holder
        issuer = self._self_peer
        if not _BUG_BROADCAST_SELF_ISSUER \
                and self._lease is not None and self._lease.holder:
            issuer = self._lease.holder
        payload: dict[str, Any] = {
            "op": "apply", "peers": list(peers), "epoch": int(epoch),
            "issuer": issuer, "mesh": bool(mesh)}
        if self._lease is not None:
            payload["lease"] = self._lease.lease_id
        hlc_text = self._journal.header()
        if hlc_text is not None:
            # the HLC piggyback: receivers' journals order their apply
            # AFTER the issuer's (causal chain through the broadcast)
            payload["hlc"] = hlc_text
        for peer in sorted(set(peers) | set(extra)):
            if peer == self._self_peer:
                continue
            reply = self._deliver_membership(peer, payload)
            if not reply.get("ok", False):
                log.warning("membership broadcast to %s not applied: %s",
                            peer, reply.get("reason", "unknown"))

    def request_join(self, *, mesh: bool = False, via: str = "") -> dict:
        """Rejoin/new-host registration, run on the JOINING replica:
        register with the lease holder (``via`` overrides the first
        peer to ask), follow ``not_leader`` redirects, then adopt the
        returned membership — ring at the granted epoch, INCUMBENT
        holder from the reply (a rejoining peer therefore never
        self-elects over a live lease, even when it sorts lowest), and
        with ``mesh=True`` the mesh-derived ring + multi-host engine
        over the restored set. Returns the holder's reply."""
        if self._ring is None:
            raise MembershipError(
                "ring_disabled",
                "ingest ring is not enabled (aggregator.peers is empty)")
        payload = {"op": "join", "peer": self._self_peer,
                   "mesh": bool(mesh)}
        candidates: list[str] = []
        if via and via != self._self_peer:
            candidates.append(via)
        holder = self._lease.holder if self._lease is not None else ""
        if holder and holder != self._self_peer \
                and holder not in candidates:
            candidates.append(holder)
        for p in self._ring.peers:
            if p != self._self_peer and p not in candidates:
                candidates.append(p)
        reply: dict = {"ok": False, "reason": "unreachable",
                       "detail": "no peer to register with"}
        hops = 0
        max_hops = len(self._ring.peers) + 2
        while candidates and hops < max_hops:
            target = candidates.pop(0)
            hops += 1
            reply = self._deliver_membership(target, payload)
            if reply.get("reason") == "not_leader":
                nxt = sanitize_peer(reply.get("holder"))
                if nxt and nxt != self._self_peer \
                        and nxt != target:
                    candidates.insert(0, nxt)
                continue
            if reply.get("ok"):
                break
        if not reply.get("ok"):
            with self._lock:
                self._membership_rejected["join_failed"] = \
                    self._membership_rejected.get("join_failed", 0) + 1
            raise MembershipError(
                "join_failed",
                f"no lease holder accepted the join: "
                f"{reply.get('reason', 'unreachable')}")
        peers = [sanitize_peer(p) for p in reply.get("peers", [])]
        epoch = coerce_epoch(reply.get("epoch"))
        granted_holder = sanitize_peer(reply.get("holder")) or ""
        if epoch is None or not peers or any(p is None for p in peers):
            raise MembershipError(
                "bad_payload",
                "join reply did not carry a valid membership")
        try:
            self.apply_membership(peers, epoch, source="join",
                                  issuer=granted_holder, mesh=mesh)
        except MembershipError as err:
            # the holder's broadcast may have raced ahead of the reply
            # (our epoch already advanced) — that is convergence, not
            # failure; anything else propagates
            if err.reason != "stale_epoch":
                raise
        if granted_holder and self._lease is not None and epoch is not None:
            try:
                # an equal-epoch replay above skips the lease adopt —
                # take the incumbent from the reply explicitly
                before = (self._lease.holder, self._lease.epoch)
                self._lease.adopt(granted_holder, epoch)
                if (self._lease.holder, self._lease.epoch) != before:
                    self._journal.emit("lease.adopt",
                                       holder=granted_holder,
                                       epoch=epoch, source="join_reply")
            except MembershipError:
                pass  # a fresher lease was already adopted locally
        return reply

    def _membership_join(self, peer: str, mesh: bool
                         ) -> tuple[int, dict[str, str], bytes]:
        """Lease-holder handling of a join registration: fold the peer
        into the membership at epoch+1, fan out, and answer the joiner
        with the full adopted state (peers, epoch, holder) — the
        joiner ADOPTS the incumbent lease from this reply."""
        ring, lease = self._ring, self._lease
        if peer in ring.peers:
            # idempotent re-registration: answer the current state
            body = {"ok": True, "epoch": ring.epoch,
                    "peers": list(ring.peers),
                    "holder": lease.holder if lease else "",
                    "lease": lease.lease_id if lease else "",
                    "already_member": True}
            return (200, {"Content-Type": "application/json"},
                    json.dumps(body).encode())
        peers = sorted(set(ring.peers) | {peer})
        epoch = ring.epoch + 1
        try:
            self.apply_membership(peers, epoch, source="join",
                                  issuer=self._self_peer, mesh=mesh)
        except MembershipError as err:
            body = {"ok": False, "reason": err.reason,
                    "error": str(err)}
            return (409, {"Content-Type": "application/json"},
                    json.dumps(body).encode())
        self._broadcast_membership(peers, epoch, mesh=mesh)
        ring, lease = self._ring, self._lease
        body = {"ok": True, "epoch": ring.epoch,
                "peers": list(ring.peers),
                "holder": lease.holder if lease else "",
                "lease": lease.lease_id if lease else ""}
        return (200, {"Content-Type": "application/json"},
                json.dumps(body).encode())

    def _membership_leave(self, peer: str
                          ) -> tuple[int, dict[str, str], bytes]:
        """Lease-holder handling of a graceful leave: drop the peer at
        epoch+1 and fan out — INCLUDING to the leaver, whose wire
        apply retires it (it keeps the new ring it is not in and
        redirects everything)."""
        ring = self._ring
        if peer not in ring.peers:
            body = {"ok": True, "epoch": ring.epoch,
                    "peers": list(ring.peers), "already_left": True}
            return (200, {"Content-Type": "application/json"},
                    json.dumps(body).encode())
        remaining = sorted(set(ring.peers) - {peer})
        epoch = ring.epoch + 1
        try:
            # issuer defaults to succession over the remaining set, so
            # the holder leaving ITSELF hands the lease to the lowest
            # survivor in the same apply
            self.apply_membership(remaining, epoch, source="leave")
        except MembershipError as err:
            body = {"ok": False, "reason": err.reason,
                    "error": str(err)}
            return (409, {"Content-Type": "application/json"},
                    json.dumps(body).encode())
        self._broadcast_membership(remaining, epoch, extra=[peer])
        ring, lease = self._ring, self._lease
        body = {"ok": True, "epoch": ring.epoch,
                "peers": list(ring.peers),
                "holder": lease.holder if lease else "",
                "lease": lease.lease_id if lease else ""}
        return (200, {"Content-Type": "application/json"},
                json.dumps(body).encode())

    def _membership_reject(self, status: int, reason: str, detail: str
                           ) -> tuple[int, dict[str, str], bytes]:
        with self._lock:
            self._membership_rejected[reason] = \
                self._membership_rejected.get(reason, 0) + 1
        body = {"ok": False, "reason": reason, "error": detail}
        return (status, {"Content-Type": "application/json"},
                json.dumps(body).encode())

    def _handle_membership(
            self, request: Any) -> tuple[int, dict[str, str], bytes]:
        """``POST /v1/membership``: the elastic-membership wire plane.
        Ops: ``apply`` (adopt an issuer's membership — the broadcast
        receiver), ``join`` (a rejoining/new replica registers with
        the lease holder), ``leave`` (graceful scale-down). Every
        field is laundered by ``validate_membership_payload`` before
        it can steer the ring, reach a log line, or key a metric; a
        non-holder answers join/leave with a structured ``not_leader``
        redirect naming the holder (the membership plane's 421)."""
        if request.command != "POST":
            return (405, {"Content-Type": "text/plain"},
                    b"POST membership operations\n")
        try:
            raw = json.loads(request.body or b"{}")
        except ValueError:
            return self._membership_reject(
                400, "bad_payload", "membership body must be JSON")
        try:
            cleaned = validate_membership_payload(raw)
        except MembershipError as err:
            return self._membership_reject(400, err.reason, str(err))
        if "hlc" in cleaned:
            # already laundered to an HLC by the validator; the observe
            # clamps a vaulted physical clock (KTL112)
            self._journal.observe(cleaned["hlc"])
        op = cleaned.get("op")
        if op == "apply":
            if "peers" not in cleaned or "epoch" not in cleaned:
                return self._membership_reject(
                    400, "bad_payload",
                    "membership apply needs peers and epoch")
            try:
                dropped = self.apply_membership(
                    cleaned["peers"], cleaned["epoch"], source="wire",
                    issuer=cleaned.get("issuer", ""),
                    mesh=cleaned["mesh"])
            except MembershipError as err:
                # already counted by apply_membership's wrapper
                body = {"ok": False, "reason": err.reason,
                        "error": str(err),
                        "epoch": (self._ring.epoch
                                  if self._ring is not None else 0)}
                return (409, {"Content-Type": "application/json"},
                        json.dumps(body).encode())
            ring, lease = self._ring, self._lease
            body = {"ok": True, "dropped": dropped,
                    "epoch": ring.epoch if ring is not None else 0,
                    "holder": lease.holder if lease else ""}
            return (200, {"Content-Type": "application/json"},
                    json.dumps(body).encode())
        if op in ("join", "leave"):
            if self._ring is None:
                return self._membership_reject(
                    409, "ring_disabled",
                    "ingest ring is not enabled on this replica")
            peer = cleaned.get("peer")
            if not peer:
                return self._membership_reject(
                    400, "bad_payload", f"membership {op} needs peer")
            lease = self._lease
            if lease is None or lease.holder != self._self_peer:
                body = {"ok": False, "reason": "not_leader",
                        "holder": lease.holder if lease else "",
                        "epoch": self._ring.epoch}
                return (421, {"Content-Type": "application/json"},
                        json.dumps(body).encode())
            if op == "join":
                return self._membership_join(peer, cleaned["mesh"])
            return self._membership_leave(peer)
        return self._membership_reject(
            400, "bad_op", "membership payload needs an op "
            "(apply | join | leave)")

    # -- autoscale ---------------------------------------------------------

    def _autoscale_tick(self) -> None:
        """One autoscale observation per aggregation interval: fold
        the fleet's already-recorded signals (admission load, shed
        deltas, ingest-latency EWMA, scoreboard states) into the
        hysteresis policy. Recommendations are always surfaced (gauge
        + log); they are ENACTED — through the same apply_membership
        plane as every other change — only when
        ``aggregator.membership.autoApply`` is on AND this replica
        holds the lease, so ``autoApply=false`` keeps operator-driven
        behavior byte-for-byte."""
        policy = self._autoscale
        if policy is None or self._ring is None:
            return
        ctrl = self._admission
        shed_total = (sum(ctrl.shed_by_reason().values())
                      if ctrl is not None else 0)
        now = self._clock()
        with self._lock:
            live_nodes = len(self._reports)
            states = self._scoreboard.states(now, self._stale_after)
        flagged = sum(1 for code in states.values() if code != 0)
        sig = AutoscaleSignals(
            load=ctrl.load() if ctrl is not None else 0.0,
            shed_delta=max(0, shed_total - self._autoscale_shed_seen),
            ingest_latency_s=(ctrl.latency_ewma()
                              if ctrl is not None else 0.0),
            live_nodes=live_nodes, flagged_nodes=flagged,
            replicas=len(self._ring))
        self._autoscale_shed_seen = shed_total
        decision = policy.observe(sig)
        with self._results_lock:
            self._autoscale_last = decision
            self._autoscale_decisions[decision.direction] = \
                self._autoscale_decisions.get(decision.direction, 0) + 1
        if decision.direction == "hold":
            return
        log.warning("autoscale recommendation: scale %s to %d "
                    "replica(s) — %s", decision.direction,
                    decision.replicas, decision.reason)
        if not self._membership_auto_apply:
            return
        lease = self._lease
        if lease is None or lease.holder != self._self_peer:
            return  # only the lease holder enacts membership
        try:
            self._enact_scale(decision)
        except ValueError as err:
            log.error("autoscale enactment failed: %s", err)

    def _enact_scale(self, decision: AutoscaleDecision) -> None:
        """Turn one non-hold autoscale decision into a membership:
        scale-up promotes the first unused
        ``aggregator.membership.standbyPeers`` entry; scale-down
        retires the highest-sorting non-holder peer (deterministic,
        and never the lease holder — that would orphan the lease
        mid-change)."""
        ring = self._ring
        current = set(ring.peers)
        extra: list[str] = []
        if decision.direction == "up":
            pool = [p for p in self._standby_peers if p not in current]
            if not pool:
                log.warning(
                    "autoscale wants %d replicas but "
                    "aggregator.membership.standbyPeers has no unused "
                    "entry — recommendation stands, nothing enacted",
                    decision.replicas)
                return
            peers = sorted(current | {pool[0]})
        else:
            victims = [p for p in sorted(current, reverse=True)
                       if p != self._self_peer]
            if not victims:
                return
            peers = sorted(current - {victims[0]})
            extra = [victims[0]]
        epoch = ring.epoch + 1
        self.apply_membership(peers, epoch, source="autoscale",
                              issuer=self._self_peer)
        changed = sorted(set(peers) ^ current)
        self._journal.emit("autoscale.enact",
                           direction=decision.direction, epoch=epoch,
                           peer=changed[0] if changed else "",
                           replicas=len(peers), reason=decision.reason)
        self._broadcast_membership(peers, epoch, extra=extra)

    def ring_health(self) -> dict:
        """``fleet-ring`` probe for /healthz: degraded while a hand-off
        is actively settling — a redirect answered or a membership
        change applied within ``degradedTtl``. That is the operator's
        "rebalance in progress" signal; it recovers on its own once
        displaced agents stop arriving here."""
        ring = self._ring
        now = self._clock()
        with self._lock:
            last_redirect = self._last_redirect_at
            last_membership = self._last_membership_at
            redirected = self._stats["reports_redirected_total"]
        settling = any(
            t is not None and now - t <= self._degraded_ttl
            for t in (last_redirect, last_membership))
        with self._results_lock:
            awaiting = self._awaiting_membership
        lease = self._lease
        out = {
            "ok": not settling and not awaiting,
            "epoch": ring.epoch if ring is not None else 0,
            "peers": len(ring) if ring is not None else 0,
            "self": self._self_peer,
            "redirected_total": redirected,
            "lease_holder": lease.holder if lease is not None else "",
            "lease_epoch": lease.epoch if lease is not None else 0,
        }
        if awaiting:
            out["awaiting_membership"] = True
            out["detail"] = ("degraded, awaiting membership: a peer "
                             "died and this replica is not the "
                             "succession issuer (or takeover is off) — "
                             "recovers on the issuer's broadcast or an "
                             "operator apply_membership")
        if last_redirect is not None:
            out["last_redirect_age_s"] = round(now - last_redirect, 3)
        if last_membership is not None:
            out["last_membership_age_s"] = round(now - last_membership, 3)
        return out

    # keplint: requires-lock=_lock
    def _observe_delivery_locked(self, node: str, header: Mapping,
                                 received: float) -> None:
        """Close the window's delivery trace: observe emit→ingest latency
        into ``kepler_fleet_delivery_latency_seconds``.

        Runs only for ACCEPTED reports (duplicates were already measured
        when their first copy arrived; quarantined reports never merged).
        Fresh sends measure from the agent's ``emitted_at``; spool
        replays from the ORIGINAL ``appended_at``, under ``path=replay``.
        All header fields are untrusted: non-numeric stamps mean no
        observation, and the path label is clamped to the two known
        values so hostile input can't mint series."""
        def _num(v: object) -> float | None:
            return (float(v) if isinstance(v, (int, float))
                    and not isinstance(v, bool) else None)

        emitted = _num(header.get("emitted_at"))
        if emitted is None:
            return  # pre-telemetry agent: no trace to close
        path = ("replay" if header.get("delivery_path") == "replay"
                else "fresh")
        basis = emitted
        if path == "replay":
            appended = _num(header.get("appended_at"))
            if appended is not None:
                basis = appended
        latency = max(0.0, received - basis)
        self._delivery_hist[path].observe(latency)
        if path == "fresh":
            # the scoreboard's per-node EWMA tracks network health, so
            # replay latency (outage age, not delivery speed) stays out
            self._scoreboard.observe_delivery(node, latency)
        trace = header.get("trace")
        if trace:
            log.debug("delivery trace %s closed: node=%s path=%s "
                      "latency=%.3fs", trace, node, path, latency)

    def _push_history(self, report: NodeReport) -> None:
        """Advance the node's feature-history window (temporal mode).
        Caller holds the store lock; the buffer's own lock (ordered
        store→buffer, matching _history_windows' buffer-only usage) still
        guards against a concurrent window assembly reading the node."""
        from kepler_tpu_torch.resource.informer import FeatureBatch

        entry = self._history.get(report.node_name)
        if entry is None:
            entry = (threading.Lock(),
                     HistoryBuffer(window=self._history_window))
            self._history[report.node_name] = entry
        lock, buf = entry
        kinds = (report.workload_kinds if report.workload_kinds is not None
                 else np.zeros(len(report.workload_ids), np.int8))
        batch = FeatureBatch(
            kinds=kinds,
            ids=list(report.workload_ids),
            cpu_deltas=np.asarray(report.cpu_deltas, np.float32),
            node_cpu_delta=float(report.node_cpu_delta),
            usage_ratio=float(report.usage_ratio),
        )
        with lock:
            buf.push(batch, dt_s=float(report.dt_s))

    # -- degradation accounting --------------------------------------------

    def _record_degraded_locked(self, node: str, reason: str,
                                detail: str) -> None:
        """Charge one quarantined report to ``node``. Caller holds _lock."""
        node = node[:self._degraded_name_cap]
        entry = self._degraded.get(node)
        if entry is None:
            # black box: ONSET only — the node ENTERING the degraded
            # set is the event; per-report charges are counters
            self._journal.emit("quarantine.onset", node=node,
                               reason=reason)
            if len(self._degraded) >= self._degraded_cap:
                oldest = min(self._degraded,
                             key=lambda n: self._degraded[n]["last_at"])
                del self._degraded[oldest]
            entry = {"malformed": 0, "clock_skew": 0,
                     "last_error": "", "last_at": 0.0}
            self._degraded[node] = entry
        entry[reason] += 1
        entry["last_error"] = detail
        entry["last_at"] = self._clock()
        self._scoreboard.observe_quarantine(node, entry["last_at"], reason)
        log.warning("quarantined %s report from node %s: %s",
                    reason, node, detail)

    def degraded_nodes(self) -> dict[str, dict]:
        """Nodes with quarantined reports inside the decay window."""
        now = self._clock()
        with self._lock:
            return {n: dict(e) for n, e in self._degraded.items()
                    if now - e["last_at"] <= self._degraded_ttl}

    def health(self) -> dict:
        """Probe for /healthz: degraded while any node's reports are being
        quarantined (decays after degraded_ttl of clean ingest)."""
        degraded = self.degraded_nodes()
        with self._results_lock:
            last = self._last_window_at
        out = {
            "ok": not degraded,
            "degraded_nodes": sorted(degraded),
            "quarantined_total": self._stats["quarantined_total"],
            "windows_lost_total": self._stats["windows_lost_total"],
            "duplicates_total": self._stats["duplicates_total"],
        }
        if last is not None:
            out["last_window_age_s"] = round(self._clock() - last, 3)
        return out

    def _rung_display(self, rung: int) -> str:
        """Operator-facing rung name: rung 0 reads as its multi-host or
        sharded form on a node mesh of two or more shards (only rung 0
        has one), as the "mesh minus one host" tier after a mesh
        demotion, and as the fused tier while that runs."""
        if rung == RUNG_PIPELINED:
            if self._multihost_active():
                return (RUNG_NAME_MESH_DEGRADED if self._mesh_degraded
                        else RUNG_NAME_MULTIHOST)
            if self._fused_tier_active():
                return RUNG_NAME_FUSED
            if self._shard_count > 1:
                return RUNG_NAME_SHARDED
        return RUNG_NAMES[rung]

    def _fused_tier_active(self) -> bool:
        """Whether rung 0 currently runs the fused device-resident
        window loop (aggregator.fusedWindowK > 1, packed path, single
        host, not demoted within rung 0)."""
        return (self._fused_window_k > 1 and not self._fused_degraded
                and not self._multihost_enabled and self._use_packed())

    def window_health(self) -> dict:
        """``fleet-window`` probe for /healthz: degraded while the device
        window leg runs below the full packed-pipelined rung. Names the
        rung, so operators see WHAT degraded service they are getting
        (einsum-serial = slower but exact; numpy-host = device fully
        dead, ratio attribution still correct)."""
        with self._results_lock:
            out = {
                "ok": self._rung == RUNG_PIPELINED,
                "rung": self._rung,
                "rung_name": self._rung_display(self._rung),
                "shards": (self._shard_count
                           if self._rung == RUNG_PIPELINED else 1),
                "demotions_total": self._stats["window_demotions_total"],
                "repromotions_total":
                    self._stats["window_repromotions_total"],
                "windows_since_last_failure": self._windows_since_failure,
                "fallback_enabled": self._fallback_enabled,
                "probe_backoff": self._probe_penalty,
                "windows_at_rung": self._windows_at_rung,
                "timeline_len": len(self._rung_timeline),
                # the last few transitions inline (full ring on
                # /debug/window) — enough for "what just happened"
                "timeline": list(self._rung_timeline)[-5:],
            }
            if self._last_window_failure:
                out["last_failure"] = self._last_window_failure
            if self._fused_window_k > 1:
                eng = self._engine_fused
                out["fused"] = {
                    "k": self._fused_window_k,
                    "active": (self._rung == RUNG_PIPELINED
                               and self._fused_tier_active()),
                    "degraded": self._fused_degraded,
                    # host-ring occupancy: intervals staged, not yet
                    # flushed (the next flush publishes this many + 1)
                    "pending_windows": len(self._fused_pending),
                    "sync_per_window_ms":
                        self._stats["last_sync_per_window_ms"],
                }
                if eng is not None:
                    out["fused"]["ring_occupancy"] = \
                        eng.pending_occupancy()
                if self._fused_degraded:
                    # fused is rung 0's healthy tier when configured —
                    # running packed-pipelined instead IS degraded
                    # service, mirrored on the probe like _mesh_degraded
                    out["ok"] = False
            if self._multihost_enabled:
                init = multihost_status()
                # a degraded mesh is NOT ok — the probe names the tier
                # so a half-joined or half-dead mesh is diagnosable
                lease = self._lease
                out["multihost"] = {
                    "active": self._multihost_active(),
                    "mesh_degraded": self._mesh_degraded,
                    "init_joined": bool(init.joined),
                    # the DISTINCT init failure reason (joined |
                    # unconfigured | coordinator_unreachable |
                    # init_error) — never a generic decline
                    "init_reason": init.reason,
                    "awaiting_membership": self._awaiting_membership,
                    "lease_holder": (lease.holder
                                     if lease is not None else ""),
                    "lease_epoch": (lease.epoch
                                    if lease is not None else 0),
                }
                if init.detail:
                    out["multihost"]["init_detail"] = init.detail
                if self._awaiting_membership:
                    # a peer died and this replica is NOT the succession
                    # issuer (or takeover is disabled): engines rebuilt
                    # over a stale ring would misattribute, so the probe
                    # flags it until the issuer's broadcast (or an
                    # operator apply_membership) lands
                    out["ok"] = False
                    out["multihost"]["detail"] = \
                        "degraded, awaiting membership"
                if self._mesh_degraded:
                    out["ok"] = False
        return out

    # -- degradation ladder ------------------------------------------------

    # keplint: requires-lock=_results_lock
    def _record_rung_transition_locked(self, prev: int, rung: int,
                                       reason: str,
                                       from_name: str = "") -> None:
        """Append one ladder transition to the bounded rung timeline
        (the flight recorder's demote/re-promote history). Monotonic
        time orders transitions across wall-clock steps; wall time
        anchors them for humans. ``from_name`` overrides the from-rung
        display for the mesh and fused-tier demotions, whose from/to
        share rung 0."""
        rung_name = self._rung_display(rung)
        from_rung_name = from_name or self._rung_display(prev)
        stamp = self._journal.emit(
            "rung.transition", rung=rung, rung_name=rung_name,
            from_rung=prev, from_rung_name=from_rung_name,
            reason=reason)
        entry: dict[str, Any] = {
            "rung": rung,
            "rung_name": rung_name,
            "from_rung": prev,
            "from_rung_name": from_rung_name,
            "reason": reason,
            "wall_time": self._clock(),
            "monotonic_s": _time.monotonic(),
            "windows_at_prev_rung": self._windows_at_rung,
        }
        if stamp is not None:
            # the journal's HLC stamp, when enabled — lets /debug/window
            # rows line up against the merged fleet timeline (wall +
            # monotonic stay: humans and single-process ordering)
            entry["hlc"] = stamp.to_dict()
        self._rung_timeline.append(entry)
        self._windows_at_rung = 0

    def _handle_device_failure(self, err: Exception) -> None:
        """One device-leg failure: abandon every in-flight window (their
        handles may be poisoned — a ring buffer whose in-place update
        raised holds unknown bytes), re-seed the resident ring
        and host staging from scratch, and demote one rung. The caller
        recomputes the CURRENT window at the new rung, so the interval
        still publishes."""
        reason = _failure_reason(err)
        with self._pipeline_lock:
            abandoned = len(self._inflight)
            self._inflight.clear()
        # every engine re-seeds: the failed rung's ring is poisoned and
        # the other's buffers may alias handles a drained window read —
        # re-entering either rung starts from a full re-pack
        if self._engine is not None:
            self._engine.reset()
        if self._engine_serial is not None:
            self._engine_serial.reset()
        if self._engine_fused is not None:
            # the fused ring is poisoned like any other: reset drops its
            # device block AND the host pending ring — the orphaned
            # windows republish from _fused_pending snapshots at the
            # demoted tier (zero gaps)
            self._engine_fused.reset()
        self._program = None  # a failed serial program is rebuilt fresh
        # a failure at the MULTI-HOST rung demotes to "mesh minus one
        # host" first: rung 0 is kept, but its engine becomes the
        # surviving single-host sharded engine — the next failure (a
        # genuinely dead local device) walks the ordinary ladder
        mesh_demotion = (self._multihost_active()
                         and not self._mesh_degraded
                         and self._rung == RUNG_PIPELINED)
        # likewise a failure at the FUSED tier demotes WITHIN rung 0
        # first — the fused flag flips and rung 0's engine becomes the
        # ordinary packed-pipelined one; the next failure walks the
        # ladder. Checked under _results_lock below via the same
        # rung-0 gate the dispatch path used.
        fused_demotion = (not mesh_demotion
                          and self._rung == RUNG_PIPELINED
                          and self._fused_tier_active())
        with self._results_lock:
            prev = self._rung
            prev_name = self._rung_display(prev)  # before any flag flip
            from_name = ""
            if mesh_demotion:
                from_name = prev_name
                self._mesh_degraded = True
                rung = prev  # rung 0 stays; its engine changes tier
            elif fused_demotion:
                from_name = RUNG_NAME_FUSED
                self._fused_degraded = True
                rung = prev  # rung 0 stays; its engine changes tier
            else:
                self._rung = min(prev + 1, RUNG_NUMPY)
                rung = self._rung
            self._clean_windows = 0
            self._windows_since_failure = 0
            if self._just_promoted:
                # a failed PROBE (the promoted rung died before proving
                # itself): back off the next probe exponentially
                self._probe_penalty = min(self._probe_penalty * 2,
                                          self._probe_penalty_cap)
                self._just_promoted = False
            self._demotions_by_reason[reason] = \
                self._demotions_by_reason.get(reason, 0) + 1
            self._stats["window_demotions_total"] += 1
            self._stats["window_rung"] = rung
            self._last_window_failure = f"{reason}: {err}"[:240]
            self._record_rung_transition_locked(prev, rung, reason,
                                                from_name=from_name)
        if mesh_demotion:
            self._demote_mesh(reason)
        log.error("fleet window device leg failed (%s) at rung %s; "
                  "demoting to %s, %d in-flight window(s) abandoned, "
                  "resident ring re-seeded: %s", reason,
                  from_name or prev_name, self._rung_display(rung),
                  abandoned, err)

    def _ladder_window_ok(self) -> None:
        """One window published without a device failure. At a demoted
        rung, ``repromote_after`` consecutive clean windows retry the
        rung above (one step at a time — the breaker's half-open probe,
        ladder-shaped). A failure during the retried rung demotes right
        back and restarts the count."""
        promoted = None
        with self._results_lock:
            self._windows_since_failure += 1
            self._windows_at_rung += 1
            if self._just_promoted:
                self._just_promoted = False  # the rung proved itself
                if self._rung == RUNG_PIPELINED:
                    # reset only AFTER the healthy rung publishes a clean
                    # window — resetting at promotion time would let a
                    # rung-0-specific failure probe at a constant ~2×
                    # cadence forever instead of decaying to the cap
                    self._probe_penalty = 1
            if self._rung != RUNG_PIPELINED:
                self._clean_windows += 1
                needed = self._repromote_after * self._probe_penalty
                if self._clean_windows >= needed:
                    self._rung -= 1
                    self._clean_windows = 0
                    self._just_promoted = True
                    self._stats["window_repromotions_total"] += 1
                    self._stats["window_rung"] = self._rung
                    promoted = self._rung
                    self._record_rung_transition_locked(
                        self._rung + 1, self._rung, "repromoted")
            elif self._fused_degraded and self._fused_window_k > 1:
                # within-rung-0 probe back to the fused tier: same
                # clean-window hysteresis as the ladder proper. The
                # fused engine re-seeds its ring from scratch on the
                # next interval (its reset survived with program caches
                # intact), so the probe costs one full re-pack.
                self._clean_windows += 1
                needed = self._repromote_after * self._probe_penalty
                if self._clean_windows >= needed:
                    from_name = self._rung_display(RUNG_PIPELINED)
                    self._fused_degraded = False
                    self._clean_windows = 0
                    self._just_promoted = True
                    self._stats["window_repromotions_total"] += 1
                    promoted = RUNG_PIPELINED
                    self._record_rung_transition_locked(
                        RUNG_PIPELINED, RUNG_PIPELINED, "repromoted",
                        from_name=from_name)
        if promoted is not None:
            log.info("fleet window ladder: clean-window threshold met — "
                     "re-promoted to rung %d (%s)", promoted,
                     self._rung_display(promoted))

    def _fetch_device(self, fn: "Callable[[], object]") -> object:
        """Blocking device fetch with MonitorWatchdog-style stall
        detection: the fetch runs on the persistent ``_FetchWorker``
        thread bounded by ``dispatch_timeout`` — a hung dispatch (wedged
        tunnel, dead device runtime) DEMOTES instead of wedging the
        aggregation loop forever. On a stall the worker is abandoned
        (parked in native code on a handle the ring re-seed guarantees
        nothing else reads) and replaced lazily. ``device.stall``
        injects a deterministic hang of ``arg`` seconds ahead of the
        real fetch."""
        spec = fault.fire("device.stall")

        def work() -> object:
            if spec is not None and spec.arg:
                _time.sleep(float(spec.arg))
            return fn()

        timeout = self._dispatch_timeout
        if timeout <= 0:
            return work()
        worker = self._fetch_worker
        if worker is None or not worker.alive():
            worker = self._fetch_worker = _FetchWorker()
        outcome = worker.run(work, timeout)
        if outcome is None:
            # abandon the occupied worker, but queue its stop sentinel:
            # a TRANSIENTLY stuck fetch that eventually completes lets
            # the thread exit instead of parking forever; a truly wedged
            # one is no worse off
            self._fetch_worker = None
            worker.stop()
            raise DeviceWindowError(
                "stall", f"window fetch exceeded aggregator."
                f"dispatchTimeout {timeout:g}s")
        kind, value = outcome
        if kind == "error":
            raise value
        return value

    # -- aggregation -------------------------------------------------------

    def aggregate_once(self) -> "FleetResults | None":
        """One pipeline step: dispatch this interval's window, publish the
        oldest in-flight one.

        At ``pipeline_depth`` 1 (the constructor default) the two halves
        run back-to-back — classic serial semantics, every call publishes
        the window it assembled. At depth D ≥ 2 the dispatched window
        stays in flight while the PREVIOUS window is fetched, scattered,
        and published: the device computes window N while the host
        assembles N+1, and the blocking fetch (``window.pipeline_wait``)
        only pays whatever the device hasn't already finished. Returns
        the published :class:`FleetResults` (None when nothing published
        yet — the pipeline is still filling).

        An empty fleet drains the pipeline instead of dispatching, so
        results never rot in flight when reports stop.
        """
        t_win = _time.perf_counter()
        now = self._clock()
        with self._lock:
            live = {name: s for name, s in self._reports.items()
                    if now - s.received <= self._stale_after}
            self._reports = dict(live)
            for name in [n for n in self._history if n not in live]:
                del self._history[name]
            for name in [n for n in self._superseded_runs if n not in live]:
                del self._superseded_runs[name]
            # _seq_trackers are NOT pruned here: they must survive
            # partitions longer than stale_after (see __init__ comment)
            for name in [n for n, e in self._degraded.items()
                         if now - e["last_at"] > self._degraded_ttl]:
                del self._degraded[name]
        # one autoscale observation per aggregation interval — BEFORE
        # the empty-fleet early return, so an idle fleet still feeds
        # the scale-down streak
        self._autoscale_tick()
        if not live:
            return self._drain_pipeline()
        # one telemetry cycle per non-empty fleet window, with the
        # assembly/h2d/compile/wait legs as stages (the same legs the
        # last_*_ms stats report — the histograms add distribution)
        with telemetry.span("aggregator.window"):
            stored_sorted = sorted(live.values(),
                                   key=lambda s: s.report.node_name)
            zone_names = sorted(
                {z for s in stored_sorted for z in s.zone_names})
            # degradation-ladder retry loop: a device-leg failure demotes
            # one rung and RECOMPUTES this interval's window there, so a
            # dead device costs latency, never a publish. Bounded: the
            # rung strictly increases per retry and the bottom rung's
            # failures re-raise (a NumPy bug is a bug, not degradation).
            while True:
                try:
                    # republish windows a fused-tier failure orphaned
                    # (no-op while the fused ring is intact or empty);
                    # a failure HERE re-enters the same demote+retry
                    # loop with the un-replayed snapshots preserved
                    self._replay_fused_pending()
                    return self._window_step(stored_sorted, zone_names,
                                             now, t_win)
                except Exception as err:
                    if (not self._fallback_enabled
                            or self._rung >= RUNG_NUMPY):
                        raise
                    self._handle_device_failure(err)

    def _window_step(self, stored_sorted: list, zone_names: list[str],
                     now: float, t_win: float) -> "FleetResults | None":
        """One dispatch+publish pass at the CURRENT ladder rung."""
        rung = self._rung
        if rung >= RUNG_NUMPY:
            pending = self._dispatch_numpy(stored_sorted, zone_names,
                                           now, t_win)
        elif rung >= RUNG_EINSUM or not self._use_packed():
            pending = self._dispatch_legacy(stored_sorted, zone_names,
                                            now, t_win)
        elif rung == RUNG_PIPELINED and self._fused_tier_active():
            # the fused tier publishes on its own cadence (K windows
            # per flush, all inside the flush call) — it never enters
            # the per-window pipeline deque below
            return self._window_step_fused(stored_sorted, zone_names,
                                           now, t_win)
        else:
            pending = self._dispatch_packed(stored_sorted, zone_names,
                                            now, t_win, rung)
        # every demoted rung drains each window (no in-flight handle
        # outlives its own interval); only the healthy rung pipelines —
        # the legacy path included (temporal/accuracy modes pipeline at
        # rung 0 exactly as before the ladder existed)
        depth = self._pipeline_depth if rung == RUNG_PIPELINED else 1
        with self._pipeline_lock:
            self._inflight.append(pending)
            # prune cumulative totals while the device computes —
            # host work needing no outputs overlaps the window
            for name, seen in list(self._cum_last_seen.items()):
                if now - seen > self._cum_retention:
                    del self._cum_last_seen[name]
                    self._cum.pop(name)
            published = None
            while len(self._inflight) >= depth:
                published = self._publish(self._inflight.popleft())
        if published is not None:
            self._ladder_window_ok()
        return published

    def _use_packed(self) -> bool:
        """Packed-f16 resident path is the default; the serial einsum-f32
        path serves accuracy mode (the 0.5%-budget validation config),
        temporal mode (no packed layout for [N, W, T, F] histories), and
        training-dump capture (which needs the assembled host batch)."""
        return (not self._accuracy_mode and self._model_mode != "temporal"
                and not self._dump_dir)

    def _drain_pipeline(self) -> "FleetResults | None":
        published = None
        failure: Exception | None = None
        eng = self._engine_fused
        if eng is not None and eng.pending_occupancy():
            # reports stopped arriving (or shutdown): force-flush the
            # fused ring so its staged windows publish instead of
            # rotting host-side — results never rot in flight, fused
            # tier included
            try:
                zones = self._fused_pending[-1][1]
                params = self._params_for_zones(len(zones))
                if params is None:
                    params = np.zeros((), np.float32)
                flush = eng.flush(params)
                if flush is not None:
                    published = self._dispatch_fused_flush(eng, flush,
                                                           0.0)
            except Exception as err:
                failure = err
        with self._pipeline_lock:
            while self._inflight:
                try:
                    published = self._publish(self._inflight.popleft())
                except Exception as err:
                    # a drain has no current window to recompute (empty
                    # fleet or shutdown) — abandon what's left, demote,
                    # and let the next live window run at the lower rung
                    failure = err
                    break
        if failure is not None:
            if not self._fallback_enabled:
                raise failure
            self._handle_device_failure(failure)
            # windows a failed fused flush orphaned republish at the
            # demoted tier right away (a drain has no next interval to
            # carry them); repeated failures walk the ladder like the
            # aggregate_once retry loop, and the bottom rung re-raises
            while True:
                try:
                    published = self._replay_fused_pending() or published
                    break
                except Exception as err:
                    if (not self._fallback_enabled
                            or self._rung >= RUNG_NUMPY):
                        raise
                    self._handle_device_failure(err)
        return published

    # -- dispatch half ------------------------------------------------------

    def _fused_engine(self) -> FusedWindowEngine:
        """Rung 0's fused-tier engine (lazy, like the packed engines).
        Runs over the FULL configured mesh, as the reference's does: the
        resident block and the flush's K planes are cut into the mesh's
        node blocks, each on its node row's first shard's device."""
        if self._engine_fused is None:
            self._engine_mesh = self._window_mesh()
            self._engine_fused = FusedWindowEngine(
                device=self._engine_mesh, backend=self._backend,
                model_mode=self._model_mode,
                node_bucket=self._node_bucket,
                workload_bucket=self._workload_bucket,
                shrink_after=self._bucket_shrink_after,
                fused_k=self._fused_window_k)
        return self._engine_fused

    def _window_step_fused(self, stored_sorted: list,
                           zone_names: list[str], now: float,
                           t_win: float) -> "FleetResults | None":
        """One interval at the fused tier: HOST-ONLY staging, and — on
        every K-th interval (or a forced shape-change flush) — one
        device dispatch + one batched fetch publishing all pending
        windows. Non-flush intervals return None (the ring is filling,
        same contract as a filling pipeline) and cost no device sync at
        all: that is the amortization this tier exists for."""
        engine = self._fused_engine()
        rows = [
            RowInput(name=s.report.node_name, report=s.report,
                     zone_names=s.zone_names,
                     # content identity, as on the packed path: a v2
                     # FLAG_SAME delta stages zero rows end to end
                     ident=((s.run, s.content_seq or s.seq)
                            if s.run and s.seq > 0 else None))
            for s in stored_sorted]
        params = self._params_for_zones(len(zone_names))
        if params is None:
            params = np.zeros((), np.float32)  # ratio-only: unused leaf
        # snapshot BEFORE staging: if anything below fails, the ladder
        # retry recomputes THIS interval itself, so only the snapshot is
        # popped back off; EARLIER snapshots stay until their windows
        # actually publish (the zero-gaps invariant)
        self._fused_pending.append((stored_sorted, zone_names, now,
                                    t_win))
        try:
            with telemetry.span("window.h2d_delta"):
                _meta, flush = engine.stage(rows, zone_names, params)
            t_staged = _time.perf_counter()
            # consulted AFTER the host staging, covering both flush and
            # accumulate intervals (so the flush below skips the engine's
            # own check) — a mid-flush fault abandons the ring and the
            # pending windows republish at the demoted tier
            if fault.fire("device.dispatch_error") is not None:
                raise DeviceWindowError(
                    "dispatch_error",
                    "injected dispatch failure (fused window loop)")
        except BaseException:
            self._fused_pending.pop()
            raise
        stage_ms = (t_staged - t_win) * 1e3
        if flush is None:
            # ring filling: no device leg this interval. The per-call
            # leg stats say so honestly (the previous flush's batch
            # cost must not read as THIS interval's device time).
            with self._results_lock:
                self._stats["last_assembly_ms"] = stage_ms
                self._stats["last_dispatch_ms"] = 0.0
                self._stats["last_wait_ms"] = 0.0
                self._stats["last_fetch_ms"] = 0.0
                self._stats["last_device_ms"] = 0.0
                self._stats["last_h2d_rows"] = 0
            return None
        published = self._dispatch_fused_flush(engine, flush, stage_ms)
        if published is not None:
            self._ladder_window_ok()
        return published

    def _dispatch_fused_flush(self, engine: FusedWindowEngine,
                              flush: FusedFlush,
                              stage_ms: float) -> "FleetResults | None":
        """Dispatch one fused batch, fetch ALL its outputs in one
        transfer, publish every live window oldest-first. The batch's
        whole device cost lands on its LAST window's stats sample
        (earlier windows ride free — that is the measured amortization);
        ``sync_per_window_ms`` carries the averaged per-window figure."""
        t0 = _time.perf_counter()
        with telemetry.span("window.fused_scan"):
            # the first launch of a (buckets, zones, mode, K, DB) key runs
            # inside the engine's own window.compile span
            outs = engine.dispatch(flush, inject_faults=False)
            # [K, N, W+2, Z], joined along the node axis over blocks
            copy = copy_plane_to_host_async(outs, axis=1)
        fetch_box = [0.0]

        def _materialize() -> np.ndarray:
            with telemetry.span("window.publish_fetch"):
                t_f = _time.perf_counter()
                (plane,) = copy.wait()
                fetch_box[0] = (_time.perf_counter() - t_f) * 1e3
            return plane

        with telemetry.span("window.pipeline_wait"):
            plane = self._fetch_device(_materialize)
        t_done = _time.perf_counter()
        batch_ms = (t_done - t0) * 1e3
        spw = batch_ms / max(1, flush.k_live)
        published = None
        with self._pipeline_lock:
            for j, meta in enumerate(flush.metas):
                # each published window keeps ITS OWN interval's clock
                # (snapshotted at stage time) — staleness is visible in
                # the timestamps, exactly like pipeline-depth staleness
                _, _, w_now, _ = self._fused_pending[0]
                last = j == len(flush.metas) - 1
                published = self._publish(_Pending(
                    kind="fused", out=plane[j], meta=meta, now=w_now,
                    assembly_ms=stage_ms if last else 0.0,
                    dispatch_ms=batch_ms if last else 0.0,
                    h2d_rows=flush.h2d_rows if last else 0,
                    compiled=flush.cold and last,
                    sync_per_window_ms=spw,
                    fused_fetch_ms=fetch_box[0] if last else 0.0))
                self._fused_pending.pop(0)
        return published

    def _replay_fused_pending(self) -> "FleetResults | None":
        """Republish windows ORPHANED by a fused-tier failure: the
        engine reset dropped its ring, so every remaining snapshot in
        ``_fused_pending`` is a staged-but-never-published window.
        Peek-publish-pop, oldest first — a snapshot is only popped
        after its window published, so a failure mid-replay (this
        raises; the caller demotes and retries) loses nothing. No-op
        while the fused ring is intact (its snapshots are live, not
        orphaned) or when there is nothing pending."""
        if not self._fused_pending:
            return None
        eng = self._engine_fused
        if eng is not None and eng.pending_occupancy():
            return None
        published = None
        while self._fused_pending:
            snap = self._fused_pending[0]
            published = self._window_step(*snap) or published
            self._fused_pending.pop(0)
        return published

    def _packed_engine(self, rung: int) -> PackedWindowEngine:
        """The packed engine for ``rung`` (lazy): the sharded engine owns
        rung 0 on a node mesh of two or more shards; the packed-serial
        rung then demotes to a SINGLE-device engine on the mesh's first
        shard's device, so a demoted window launches once. On a
        single-shard mesh both rungs share one engine. The resident ring
        holds one buffer per window in flight plus one."""
        if self._engine is None:
            kwargs = dict(
                backend=self._backend, model_mode=self._model_mode,
                node_bucket=self._node_bucket,
                workload_bucket=self._workload_bucket,
                shrink_after=self._bucket_shrink_after,
                staging_slots=self._pipeline_depth + 1)
            if self._multihost_active() and not self._mesh_degraded:
                # the multi-host tier: process-local rings over the LIVE
                # mesh (the elastic submesh after a membership change,
                # else the full configured mesh), owned-rows fetch
                mh_mesh = self._live_mesh()
                self._engine_mesh = mh_mesh
                self._shard_count = mh_mesh.size
                self._engine = MultiHostWindowEngine(
                    mh_mesh, process_index=self._self_process(),
                    fabric=self._mh_fabric, **kwargs)
            else:
                mesh = self._window_mesh()
                if self._multihost_enabled and self._mesh_degraded:
                    # "mesh minus one host": the survivors' own shards
                    mesh = self._local_mesh()
                self._engine_mesh = mesh
                self._shard_count = self._mesh_shard_count(mesh)
                if self._shard_count > 1:
                    self._engine = ShardedWindowEngine(mesh, **kwargs)
                else:
                    self._engine = PackedWindowEngine(device=mesh,
                                                      **kwargs)
        if rung == RUNG_PIPELINED or self._shard_count == 1:
            return self._engine
        if self._engine_serial is None:
            base = self._engine_mesh or self._window_mesh()
            self._engine_serial = PackedWindowEngine(
                device=base.devices[0], backend=self._backend,
                model_mode=self._model_mode,
                node_bucket=self._node_bucket,
                workload_bucket=self._workload_bucket,
                shrink_after=self._bucket_shrink_after,
                staging_slots=self._pipeline_depth + 1)
        return self._engine_serial

    def _dispatch_packed(self, stored_sorted: list, zone_names: list[str],
                         now: float, t_win: float,
                         rung: int = RUNG_PIPELINED) -> _Pending:
        """Sync the device-resident packed batch (delta H2D), launch the
        packed program and queue its plane's D2H copy behind it."""
        engine = self._packed_engine(rung)
        rows = [
            RowInput(name=s.report.node_name, report=s.report,
                     zone_names=s.zone_names,
                     # CONTENT identity, not delivery identity: a v2
                     # FLAG_SAME delta bumps seq but not content_seq,
                     # so an unchanged node stages zero rows end to end
                     ident=((s.run, s.content_seq or s.seq)
                            if s.run and s.seq > 0 else None))
            for s in stored_sorted]
        params = self._params_for_zones(len(zone_names))
        if params is None:
            params = np.zeros((), np.float32)  # ratio-only: unused leaf
        with telemetry.span("window.h2d_delta"):
            plan = engine.plan_window(rows, zone_names, params)
        t_planned = _time.perf_counter()
        # the engine consults device.dispatch_error AFTER the in-place
        # ring update ran (a dispatch that dies there leaves the ring
        # half-written — the state the ladder's reset() re-seed exists
        # for); the first launch of a key runs in a window.compile span
        out = engine.dispatch_window(plan)
        # D2H queues behind the launch (one copy per shard when sharded)
        copy = copy_plane_to_host_async(out)
        t_dispatched = _time.perf_counter()
        return _Pending(
            kind="packed", out=copy, meta=plan.meta, now=now,
            assembly_ms=(t_planned - t_win) * 1e3,
            dispatch_ms=(t_dispatched - t_planned) * 1e3,
            h2d_rows=plan.h2d_rows, compiled=plan.cold,
            h2d_shards=plan.h2d_shards, shards=plan.n_shards)

    def _dispatch_legacy(self, stored_sorted: list, zone_names: list[str],
                         now: float, t_win: float) -> _Pending:
        """Serial-path dispatch: full assemble, one big H2D, the fleet or
        temporal program, one async copy of its four result tensors."""
        aligned = [s.report for s in stored_sorted]
        n_zones = len(zone_names)
        zd_mat, zv_mat = align_zone_matrices(
            aligned, [s.zone_names for s in stored_sorted], zone_names)
        batch = assemble_fleet_batch(
            aligned, n_zones=n_zones, node_bucket=self._node_bucket,
            workload_bucket=self._workload_bucket,
            zone_deltas_mat=zd_mat, zone_valid_mat=zv_mat)
        cold = self._program is None
        if cold:
            if fault.fire("device.compile_error") is not None:
                raise DeviceWindowError(
                    "compile_error",
                    "injected compile failure (serial fleet program)")
            # over the mesh's node blocks, as the reference's programs
            # shard their batch by node (B1 once per block with pallas)
            mesh = self._serial_mesh()
            if self._model_mode == "temporal":
                self._program = make_temporal_fleet_program(
                    backend=self._backend,
                    accuracy_mode=self._accuracy_mode, mesh=mesh)
            else:
                self._program = make_fleet_program(
                    model_mode=self._model_mode, backend=self._backend,
                    accuracy_mode=self._accuracy_mode, mesh=mesh)
        program = self._program
        params = self._params_for_zones(n_zones)
        feat_hist = t_valid = None
        if self._model_mode == "temporal":
            feat_hist, t_valid = self._history_windows(batch)
        t_assembled = _time.perf_counter()
        if fault.fire("device.dispatch_error") is not None:
            raise DeviceWindowError(
                "dispatch_error",
                "injected dispatch failure (serial fleet program)")
        # ASYNC dispatch: the launches queue on the current stream and
        # the D2H copies queue right behind them (one event for all
        # four) instead of four synchronous copies in _publish. The
        # FIRST dispatch runs as the window.compile stage (hand kernels
        # load on first use)
        if cold:
            with telemetry.span("window.compile"):
                result = run_fleet_attribution(program, batch, params,
                                               feat_hist, t_valid)
        else:
            result = run_fleet_attribution(program, batch, params,
                                           feat_hist, t_valid)
        # the node blocks' fields into one pinned buffer, in block order
        copy = copy_blocks_to_host_async([(
            r.node_power_uw, r.node_energy_uj, r.workload_power_uw,
            r.workload_energy_uj) for r in result])
        t_dispatched = _time.perf_counter()
        return _Pending(
            kind="legacy", out=copy, meta=None, now=now,
            assembly_ms=(t_assembled - t_win) * 1e3,
            dispatch_ms=(t_dispatched - t_assembled) * 1e3,
            h2d_rows=batch.n_nodes, compiled=cold,
            batch=batch, aligned=aligned, zone_names=zone_names,
            feat_hist=feat_hist, t_valid=t_valid)

    def _dispatch_numpy(self, stored_sorted: list, zone_names: list[str],
                        now: float, t_win: float) -> _Pending:
        """Bottom ladder rung: the whole window in host NumPy — no
        torch.cuda API, no device, no compile. Ratio attribution is exact; model rows are
        served for the NumPy-mirrored estimators (linear, mlp) when the
        trained params fit this window's zone axis, and publish zero
        watts otherwise (``parallel.packed.numpy_fleet_window``). Output
        reuses the packed scatter path, so publication is identical to
        the device rungs' minus the f16 wire quantization."""
        from kepler_tpu_torch.parallel.packed import (numpy_fleet_window,
                                                      pack_fleet_inputs)

        aligned = [s.report for s in stored_sorted]
        n_zones = len(zone_names)
        zd_mat, zv_mat = align_zone_matrices(
            aligned, [s.zone_names for s in stored_sorted], zone_names)
        batch = assemble_fleet_batch(
            aligned, n_zones=n_zones, node_bucket=self._node_bucket,
            workload_bucket=self._workload_bucket,
            zone_deltas_mat=zd_mat, zone_valid_mat=zv_mat)
        packed = pack_fleet_inputs(batch)
        t_assembled = _time.perf_counter()
        params = None
        if (self._model_mode in ("linear", "mlp")
                and self._params is not None
                and self._model_out_dim() == n_zones):
            params = self._params
        watts = numpy_fleet_window(packed, batch.cpu_deltas.shape[1],
                                   n_zones, params, self._model_mode)
        t_done = _time.perf_counter()
        n_real = batch.n_nodes
        names = list(batch.node_names[:n_real])
        meta = WindowMeta(
            zones=list(zone_names),
            names=names,
            rows={name: i for i, name in enumerate(names)},
            mode=np.asarray(batch.mode, np.int32),
            dt=np.asarray(batch.dt_s, np.float32),
            counts=list(batch.workload_counts),
            ids=list(batch.workload_ids),
            kinds=([a.workload_kinds for a in aligned]
                   + [None] * (watts.shape[0] - n_real)),
            n_live=n_real,
            n_rows=watts.shape[0],
        )
        return _Pending(
            kind="numpy", out=watts, meta=meta, now=now,
            assembly_ms=(t_assembled - t_win) * 1e3,
            dispatch_ms=(t_done - t_assembled) * 1e3,
            h2d_rows=0, compiled=False)

    # -- publish half -------------------------------------------------------

    # keplint: requires-lock=_pipeline_lock
    def _publish(self, p: _Pending) -> "FleetResults":
        """Fetch one in-flight window (the pipeline's only blocking point),
        scatter it into a :class:`FleetResults`, publish, account legs.
        Holding the pipeline lock keeps a lifecycle-thread drain from
        interleaving publishes (out-of-order ``_results``) with the
        aggregation loop's own."""
        t0 = _time.perf_counter()
        fetch_ms = 0.0
        if p.kind == "packed":
            # the plane's D2H copy was queued at dispatch; the fetch
            # waits on its events (explicitly — it runs on the fetch
            # worker's thread, whose current stream is not the engine's)
            copy: HostCopy = p.out  # type: ignore[assignment]

            def _materialize() -> np.ndarray:
                with telemetry.span("window.publish_fetch"):
                    t_f = _time.perf_counter()
                    (plane,) = copy.wait()
                    nonlocal_box[0] = (_time.perf_counter() - t_f) * 1e3
                return plane

            nonlocal_box = [0.0]
            with telemetry.span("window.pipeline_wait"):
                packed = self._fetch_device(_materialize)
            fetch_ms = nonlocal_box[0]
            t_fetched = _time.perf_counter()
            results = self._scatter_packed(p, packed)
        elif p.kind in ("numpy", "fused"):
            # host rung: the "fetch" is a no-op — p.out is already a host
            # array (and consulting the stall site would be a lie: there
            # is no device leg to hang). Fused windows look the same by
            # the time they publish: the flush materialized the whole
            # K-batch in one transfer and sliced this window's plane out
            # host-side (the batched fetch cost rides in fused_fetch_ms).
            t_fetched = _time.perf_counter()
            fetch_ms = p.fused_fetch_ms
            results = self._scatter_packed(p, p.out)
        else:
            copy = p.out  # type: ignore[assignment]
            with telemetry.span("window.pipeline_wait"):
                fetched = self._fetch_device(copy.wait)
            node_power, node_energy, wl_power, wl_energy = fetched
            t_fetched = _time.perf_counter()
            results = self._scatter_legacy(p, node_power, node_energy,
                                           wl_power, wl_energy)
        t_done = _time.perf_counter()
        wait_ms = (t_fetched - t0) * 1e3
        scatter_ms = (t_done - t_fetched) * 1e3
        n_workloads = sum(results.counts)
        with self._results_lock:
            self._results = results
            self._last_window_at = p.now
            self._stats["attributions_total"] += 1
            self._stats["last_batch_nodes"] = len(results.names)
            self._stats["last_batch_workloads"] = int(n_workloads)
            self._stats["last_assembly_ms"] = p.assembly_ms
            self._stats["last_dispatch_ms"] = p.dispatch_ms
            self._stats["last_wait_ms"] = wait_ms
            self._stats["last_fetch_ms"] = fetch_ms
            self._stats["last_device_ms"] = p.dispatch_ms + wait_ms
            self._stats["last_scatter_ms"] = scatter_ms
            self._stats["last_attribution_ms"] = (
                p.assembly_ms + p.dispatch_ms + wait_ms + scatter_ms)
            self._stats["last_h2d_rows"] = p.h2d_rows
            self._stats["window_shards"] = p.shards
            self._stats["last_h2d_shards"] = list(p.h2d_shards)
            if p.sync_per_window_ms >= 0.0:
                self._stats["last_sync_per_window_ms"] = (
                    p.sync_per_window_ms)
            engines_all = (self._engine, self._engine_serial,
                           self._engine_fused)
            if any(e is not None for e in engines_all):
                self._stats["window_compiles_total"] = sum(
                    e.compile_count for e in engines_all
                    if e is not None)
            # per-window engine introspection snapshot: computed HERE
            # (the only thread that owns engine state) so /debug/window
            # and collect() read a coherent copy off-thread without
            # touching live engine internals
            engines: dict[str, dict] = {}
            for label, eng in (("pipelined", self._engine),
                               ("serial", self._engine_serial),
                               ("fused", self._engine_fused)):
                if eng is not None:
                    engines[label] = eng.introspect()
            primary = _primary_introspect(engines)
            skew = 0.0
            if primary is not None:
                occupied = [s["rows"] for s in primary["shards"]]
                if any(occupied):
                    skew = max(occupied) / (sum(occupied) / len(occupied))
            self._stats["shard_skew"] = round(skew, 4)
            self._introspect_cache = engines
        log.debug("fleet attribution: %d nodes, %d workloads, %.2f ms "
                  "(h2d rows %d)", len(results.names), n_workloads,
                  self._stats["last_attribution_ms"], p.h2d_rows)
        if p.kind == "legacy" and self._dump_dir:
            # AFTER results publication — file I/O must not delay /v1/results
            try:
                self._dump_training_window(p.batch, wl_power, p.zone_names,
                                           p.now, p.feat_hist, p.t_valid)
            except OSError as err:
                log.warning("training dump failed: %s", err)
        return results

    def _scatter_packed(self, p: _Pending,
                        packed: np.ndarray) -> "FleetResults":
        """One f16 D2H array → the published column-oriented results.

        All arrays are indexed by RESIDENT ROW (``results.rows`` maps
        names to rows — free rows simply hold zeros); node energy is
        reconstituted as power × dt, which is exact for ratio nodes
        (their power was measured energy / dt) and definitional for
        model nodes, modulo the f16 watt quantization the accuracy bench
        budgets at ≤ 0.5%.
        """
        from kepler_tpu_torch.parallel.packed import unpack_fleet_window

        m = p.meta
        wl_watts, _active_w, total_w = unpack_fleet_window(packed)
        node_power = np.multiply(total_w, 1e6, dtype=np.float32)  # W → µW
        node_energy = node_power * m.dt[:, None]  # µW·s = µJ
        row_idx = np.asarray([m.rows[name] for name in m.names],
                             np.intp)
        joules = np.zeros_like(node_power)
        if row_idx.size:
            joules[row_idx] = self._accumulate_node_energy(
                m.names, m.zones, node_energy[row_idx], p.now)
        return FleetResults(
            timestamp=p.now,
            zones=m.zones,
            names=m.names,
            rows=m.rows,
            mode=m.mode,
            node_power_uw=node_power,
            node_energy_uj=node_energy,
            node_joules_total=joules,
            workload_ids=m.ids,
            workload_kinds=m.kinds,
            counts=m.counts,
            wl_watts_f16=wl_watts,
            dt=m.dt,
        )

    def _scatter_legacy(self, p: _Pending, node_power: np.ndarray,
                        node_energy: np.ndarray, wl_power: np.ndarray,
                        wl_energy: np.ndarray) -> "FleetResults":
        """Dense-layout scatter: per-node array views published as-is;
        JSON materializes lazily in ``/v1/results`` (a per-workload
        dict scatter would be O(nodes × workloads) Python per window)."""
        batch = p.batch
        n_real = batch.n_nodes
        names = batch.node_names[:n_real]
        joules = self._accumulate_node_energy(names, p.zone_names,
                                              node_energy[:n_real], p.now)
        return FleetResults(
            timestamp=p.now,
            zones=p.zone_names,  # shared ref; treated immutable
            names=names,
            rows={name: i for i, name in enumerate(names)},
            mode=batch.mode,
            node_power_uw=node_power,
            node_energy_uj=node_energy,
            node_joules_total=joules,
            workload_ids=batch.workload_ids,
            workload_kinds=[a.workload_kinds for a in p.aligned],
            counts=batch.workload_counts,
            wl_power_uw=wl_power,
            wl_energy_uj=wl_energy,
        )

    def _accumulate_node_energy(self, names: list[str],
                                zone_names: list[str],
                                node_energy: np.ndarray,
                                now: float) -> np.ndarray:
        """store[names] += node_energy → cumulative joules [n, Z].

        Steady state (same fleet, same zone axis) is one cached gather,
        one add, one scatter (RowStore). A zone-axis change remaps the
        store's columns by name; new nodes allocate (or reuse) rows."""
        if self._cum_zones != zone_names:
            self._cum.remap_columns(self._cum_zones, zone_names)
            self._cum_zones = list(zone_names)
        vals = self._cum.accumulate(tuple(names), node_energy)
        last_seen = self._cum_last_seen
        for name in names:
            last_seen[name] = now
        return vals / 1e6

    def _params_for_zones(self, n_zones: int) -> Any:
        """Trained params when their output dim matches the canonical zone
        axis this window; otherwise a cached untrained fallback — the
        trained params are kept, so a transient zone-set change (one node
        reporting an extra zone) doesn't destroy them."""
        if not self._model_mode:
            return None
        if self._params is not None and self._model_out_dim() == n_zones:
            return self._params
        fallback = self._fallback_params.get(n_zones)
        if fallback is None:
            from kepler_tpu_torch.models.estimator import initializer
            log.warning("model output dim %s != fleet zones %d; using "
                        "untrained %s fallback for this window",
                        self._model_out_dim(), n_zones, self._model_mode)
            kwargs = {}
            if self._model_mode == "temporal":
                # the fallback's positional table must cover the window
                kwargs["t_max"] = max(128, self._history_window)
            # seeded like the reference's PRNGKey(0); the random bits
            # differ from JAX's (ROADMAP Queue C)
            fallback = initializer(self._model_mode)(
                n_zones, generator=torch.Generator().manual_seed(0),
                **kwargs)
            self._fallback_params[n_zones] = fallback
        return fallback

    def _dump_training_window(self, batch: Any, wl_power_uw: np.ndarray,
                              zone_names: list[str], now: float,
                              feat_hist: np.ndarray | None = None,
                              t_valid: np.ndarray | None = None) -> None:
        """Write one training file: RAPL rows' inputs + their ratio watts.

        Only MODE_RATIO rows carry trustworthy labels (the estimator's own
        output would be circular); rows keep the padded [n, W] layout with
        ``workload_valid`` masking. The file records its OWN zone axis
        (``zone_names``) and per-row ``zone_valid`` — the zone union varies
        across rounds as fleet membership changes, so cmd/train aligns
        columns by name and masks zones a node didn't report (their 0-watt
        rows are absence, not labels). In temporal mode the ratio rows'
        feature-HISTORY windows ([n, W, T, F] + t_valid) are saved too, so
        ``cmd/train --model temporal`` can fit from the same dumps —
        closing the train→serve loop for all five families. Oldest files
        beyond the cap are pruned so a long-running aggregator bounds its
        disk."""
        import os

        ratio_rows = np.flatnonzero(
            (np.asarray(batch.mode[:batch.n_nodes]) != MODE_MODEL))
        if ratio_rows.size == 0:
            return
        os.makedirs(self._dump_dir, exist_ok=True)
        self._dump_seq += 1
        path = os.path.join(
            self._dump_dir, f"window-{int(now * 1e3):014d}-"
            f"{self._dump_seq:06d}.npz")
        r = ratio_rows
        arrays = dict(
            zone_names=np.asarray(zone_names),
            zone_valid=batch.zone_valid[r],
            cpu_deltas=batch.cpu_deltas[r],
            workload_valid=batch.workload_valid[r],
            node_cpu_delta=batch.node_cpu_delta[r],
            usage_ratio=batch.usage_ratio[r],
            dt_s=batch.dt_s[r],
            target_watts=wl_power_uw[r] / 1e6,  # labels in watts
        )
        if feat_hist is not None:
            arrays["feat_hist"] = feat_hist[r]
            arrays["t_valid"] = t_valid[r]
        np.savez_compressed(path, **arrays)
        # prune via an in-process ledger (seeded from disk once) — no
        # per-dump directory scan
        if self._dump_files is None:
            self._dump_files = sorted(
                os.path.join(self._dump_dir, f)
                for f in os.listdir(self._dump_dir)
                if f.startswith("window-") and f.endswith(".npz"))
        else:
            self._dump_files.append(path)
        while len(self._dump_files) > self._dump_max_files:
            try:
                os.unlink(self._dump_files.pop(0))
            except OSError:
                pass

    def _history_windows(self, batch: Any) -> tuple[np.ndarray,
                                                    np.ndarray]:
        """→ (feat_hist [N, W, T, F], t_valid [N, W, T]) aligned with the
        padded fleet batch's (node, workload) layout.

        Holds only ONE node's buffer lock at a time (never the report-
        store lock), so ingest POSTs stall at most for one node's
        ``window_arrays`` — not the whole [N, W, T, F] assembly."""
        from kepler_tpu_torch.models.features import NUM_FEATURES

        n, w = batch.cpu_deltas.shape
        t = self._history_window
        hist = np.zeros((n, w, t, NUM_FEATURES), np.float32)
        tv = np.zeros((n, w, t), bool)
        with self._lock:
            entries = [self._history.get(batch.node_names[i])
                       for i in range(batch.n_nodes)]
        for i, entry in enumerate(entries):
            ids = batch.workload_ids[i]
            if entry is None or not ids:
                continue
            lock, buf = entry
            with lock:
                f, v = buf.window_arrays(ids)
            hist[i, :len(ids)] = f
            tv[i, :len(ids)] = v
        return hist, tv

    def _check_params_shape(self) -> None:
        """Fail at startup (not first window) on params/model mismatch."""
        if self._model_mode not in _REQUIRED_PARAM_KEYS:
            raise ValueError(
                f"unknown aggregator model {self._model_mode!r}; valid: "
                f"{', '.join(_REQUIRED_PARAM_KEYS)}")
        if self._params is None:
            return
        required = _REQUIRED_PARAM_KEYS[self._model_mode]
        missing = [k for k in required if k not in self._params]
        if missing:
            raise ValueError(
                f"params are missing {missing} for model "
                f"{self._model_mode!r} — were they saved from a different "
                "model kind?")
        # the input projection's feature axis must match THIS build's
        # feature vector — a checkpoint trained before a feature-set change
        # (e.g. F 6→7, node_cpu_log) must fail HERE, not as a shape
        # error inside the first window
        from kepler_tpu_torch.models.features import NUM_FEATURES

        in_key, f_axis = {"mlp": ("w0", 0), "linear": ("weight", 0),
                          "moe": ("w0", 1), "deep": ("in_proj", 0),
                          "temporal": ("in_proj", 0)}[self._model_mode]
        got_f = int(np.shape(self._params[in_key])[f_axis])
        if got_f != NUM_FEATURES:
            raise ValueError(
                f"params' {in_key} has feature dim {got_f} but this build's "
                f"feature vector is F={NUM_FEATURES} — the checkpoint "
                "predates a feature-set change; retrain it "
                "(models.features.build_features documents the vector)")
        if self._model_mode == "temporal":
            t_max = int(np.shape(self._params["pos_emb"])[0])
            if t_max < self._history_window:
                raise ValueError(
                    f"temporal params were trained with t_max={t_max} < "
                    f"aggregator.historyWindow={self._history_window} — "
                    "shrink the window or retrain with a longer t_max")

    def _model_out_dim(self) -> int | None:
        if self._params is None:
            return None
        # the mode's output bias — its LAST axis length is Z (moe's b1 is
        # [E, Z], so probing by key alone would confuse it with mlp's b1)
        key = _OUTPUT_BIAS_KEY.get(self._model_mode)
        if key is None or key not in self._params:
            return None
        return int(np.shape(self._params[key])[-1])

    # -- read endpoints ----------------------------------------------------

    def _handle_results(
            self, request: Any) -> tuple[int, dict[str, str], bytes]:
        from urllib.parse import unquote_plus

        query = ""
        if "?" in request.path:
            query = request.path.split("?", 1)[1]
        node = None
        for part in query.split("&"):
            if part.startswith("node="):
                node = unquote_plus(part[len("node="):])
        with self._results_lock:
            results = self._results  # swapped wholesale; safe to read out
            stats = dict(self._stats)
        if node is not None:
            if results is None or node not in results:
                return (404, {"Content-Type": "text/plain"},
                        f"no results for node {node!r}\n".encode())
            payload = results.render_node(node)
        else:
            nodes = ({} if results is None
                     else {name: results.render_node(name)
                           for name in results.names})
            payload = {"nodes": nodes, "stats": stats}
        return (200, {"Content-Type": "application/json"},
                json.dumps(payload).encode())

    def _handle_window_debug(
            self, request: Any) -> tuple[int, dict[str, str], bytes]:
        """``GET /debug/window``: the device plane's flight-recorder
        dump — rung + transition timeline, shard layout, bucket
        ladders, compile-cache keys with their cost stats, last H2D per
        shard, sticky-map skew. Engine state comes from the per-window
        introspection snapshot (coherent, no live engine access)."""
        with self._results_lock:
            payload: dict = {
                "rung": self._rung,
                "rung_name": self._rung_display(self._rung),
                "shards": (self._shard_count
                           if self._rung == RUNG_PIPELINED else 1),
                "windows_at_rung": self._windows_at_rung,
                "windows_since_last_failure": self._windows_since_failure,
                "fallback_enabled": self._fallback_enabled,
                "probe_backoff": self._probe_penalty,
                "timeline": list(self._rung_timeline),
                "demotions_by_reason": dict(self._demotions_by_reason),
                "engines": self._introspect_cache,
                "stats": {k: self._stats[k] for k in (
                    "last_assembly_ms", "last_dispatch_ms",
                    "last_wait_ms", "last_fetch_ms",
                    "last_sync_per_window_ms", "last_scatter_ms",
                    "last_attribution_ms", "last_h2d_rows",
                    "last_h2d_shards", "window_shards", "shard_skew",
                    "window_compiles_total", "window_rung",
                    "window_demotions_total",
                    "window_repromotions_total", "last_batch_nodes",
                    "last_batch_workloads")},
            }
            if self._fused_window_k > 1:
                eng = self._engine_fused
                payload["fused"] = {
                    "k": self._fused_window_k,
                    "active": self._fused_tier_active(),
                    "degraded": self._fused_degraded,
                    "pending_windows": len(self._fused_pending),
                    "ring_occupancy": (eng.pending_occupancy()
                                       if eng is not None else 0),
                }
            if self._last_window_failure:
                payload["last_failure"] = self._last_window_failure
        return (200, {"Content-Type": "application/json"},
                json.dumps(payload).encode())

    def _handle_ring_debug(
            self, request: Any) -> tuple[int, dict[str, str], bytes]:
        """``GET /debug/ring``: the ingest ring's membership +
        ownership view from THIS replica — epoch, peers, hash-space
        share, owned node count, redirect accounting. ``enabled: false``
        (epoch 0) when the tier runs single-replica."""
        ring = self._ring
        now = self._clock()
        with self._lock:
            redirected = self._stats["reports_redirected_total"]
            last_redirect = self._last_redirect_at
            owned = len(self._reports)
        payload: dict[str, Any] = {
            "enabled": ring is not None,
            "epoch": ring.epoch if ring is not None else 0,
            "self": self._self_peer,
            "peers": list(ring.peers) if ring is not None else [],
            "vnodes": ring.vnodes if ring is not None else 0,
            "ownership_ratio": (
                round(ring.ownership_ratio(self._self_peer), 6)
                if ring is not None else 1.0),
            "owned_nodes": owned,
            "redirected_total": redirected,
            "last_redirect_age_s": (
                round(now - last_redirect, 3)
                if last_redirect is not None else None),
        }
        if ring is not None:
            payload["digest"] = ring.membership_digest
            lease = self._lease
            with self._results_lock:
                awaiting = self._awaiting_membership
                decision = self._autoscale_last
            with self._lock:
                rejected = dict(self._membership_rejected)
                applied = dict(self._membership_applied)
            payload["membership"] = {
                "lease": lease.describe() if lease is not None else None,
                "awaiting_membership": awaiting,
                "auto_apply": self._membership_auto_apply,
                "rejected_total": rejected,
                "applied_total": applied,
                "standby_peers": list(self._standby_peers),
            }
            if decision is not None:
                payload["membership"]["autoscale"] = {
                    "direction": decision.direction,
                    "replicas": decision.replicas,
                    "reason": decision.reason,
                }
        return (200, {"Content-Type": "application/json"},
                json.dumps(payload).encode())

    def _handle_fleet_debug(self, request: Any) -> tuple[int,
                                                         dict[str, str],
                                                    bytes]:
        """``GET /debug/fleet``: the per-node scoreboard table."""
        now = self._clock()
        with self._lock:
            snap = self._scoreboard.snapshot(now, self._stale_after)
        return (200, {"Content-Type": "application/json"},
                json.dumps(snap).encode())

    def _handle_bundle_debug(self, request: Any) -> tuple[int,
                                                          dict[str, str],
                                                          bytes]:
        """``GET /debug/bundle``: the one-shot incident snapshot —
        journal + rung timeline + scoreboard + ring view + config
        fingerprint, as CANONICAL JSON (sorted keys, no whitespace) so
        two captures of the same state are byte-identical. Feed the
        file straight to ``python -m kepler_tpu_torch.blackbox``."""
        return (200, {"Content-Type": "application/json"},
                canonical_json(self.bundle()) + b"\n")

    def bundle(self) -> dict[str, Any]:
        """The incident-bundle document (kepler-bundle/v1). Pure state
        capture — safe to call from tests and the chaos conductor."""
        now = self._clock()
        ring = self._ring
        lease = self._lease
        with self._lock:
            scoreboard = self._scoreboard.snapshot(now, self._stale_after)
            stats = dict(self._stats)
        with self._results_lock:
            timeline = list(self._rung_timeline)
            rung = self._rung
        ring_view: dict[str, Any] = {
            "enabled": ring is not None,
            "epoch": ring.epoch if ring is not None else 0,
            "peers": list(ring.peers) if ring is not None else [],
            "holder": lease.holder if lease is not None else "",
        }
        if ring is not None:
            ring_view["digest"] = ring.membership_digest
        return {
            "schema": "kepler-bundle/v1",
            "node": self._journal.node or self._self_peer,
            "captured_hlc": (self._journal.hlc.now().to_dict()
                             if self._journal.enabled else None),
            "journal": self._journal.snapshot(),
            "journal_stats": self._journal.stats(),
            "rung": rung,
            "rung_timeline": timeline,
            "scoreboard": scoreboard,
            "ring": ring_view,
            "stats": {k: stats[k] for k in sorted(stats)
                      if isinstance(stats[k], (int, float, str))},
            "config_fingerprint": self._config_fingerprint,
        }

    # -- prometheus (cluster-level families) -------------------------------

    def collect(self) -> "Iterator[Any]":
        """prometheus_client custom-collector hook (kepler_fleet_*)."""
        from prometheus_client.core import (
            CounterMetricFamily,
            GaugeMetricFamily,
        )
        # black-box families ride the aggregator's registration (the
        # binary registers ONE collector; the journal's events/HLC
        # families must not need a second)
        yield from self._journal.collect()
        with self._results_lock:
            results = self._results
            stats = dict(self._stats)
            demotions_snap = sorted(self._demotions_by_reason.items())
            # replaced wholesale per published window; nested dicts are
            # never mutated after construction, so reading out is safe
            introspect_snap = self._introspect_cache
        nodes = GaugeMetricFamily(
            "kepler_fleet_nodes", "Nodes in the last fleet batch")
        nodes.add_metric([], stats["last_batch_nodes"])
        yield nodes
        workloads = GaugeMetricFamily(
            "kepler_fleet_workloads", "Workloads in the last fleet batch")
        workloads.add_metric([], stats["last_batch_workloads"])
        yield workloads
        lat = GaugeMetricFamily(
            "kepler_fleet_attribution_latency_ms",
            "Whole-window latency of the last fleet attribution "
            "(assembly + device + scatter)")
        lat.add_metric([], stats["last_attribution_ms"])
        yield lat
        legs = GaugeMetricFamily(
            "kepler_fleet_window_leg_ms",
            "Last fleet window's latency by leg (device = dispatch + "
            "pipeline wait; assembly includes the delta-H2D staging)",
            labels=["leg"])
        legs.add_metric(["assembly"], stats["last_assembly_ms"])
        legs.add_metric(["device"], stats["last_device_ms"])
        legs.add_metric(["dispatch"], stats["last_dispatch_ms"])
        legs.add_metric(["wait"], stats["last_wait_ms"])
        legs.add_metric(["scatter"], stats["last_scatter_ms"])
        yield legs
        h2d_rows = GaugeMetricFamily(
            "kepler_fleet_window_h2d_rows",
            "Node rows re-uploaded (delta H2D) for the last fleet window "
            "— 0 when the resident device batch was already current")
        h2d_rows.add_metric([], stats["last_h2d_rows"])
        yield h2d_rows
        fetch_ms = GaugeMetricFamily(
            "kepler_fleet_window_fetch_ms",
            "Publish-fetch leg of the last fleet window: per-shard "
            "addressable D2H materialization of the result plane "
            "(owned shards only on the multi-host engine, so the cost "
            "scales with owned rows, not fleet size)")
        fetch_ms.add_metric([], stats["last_fetch_ms"])
        yield fetch_ms
        sync_pw = GaugeMetricFamily(
            "kepler_fleet_window_sync_per_window_ms",
            "Amortized host↔device sync cost per published window at "
            "the fused tier: the last fused flush's whole device leg "
            "(dispatch + scan + batched K-window fetch) divided by the "
            "windows it published; 0.0 until a fused flush has run "
            "(fusedWindowK=1 or unfused rungs never set it)")
        sync_pw.add_metric([], stats["last_sync_per_window_ms"])
        yield sync_pw
        shards = GaugeMetricFamily(
            "kepler_fleet_window_shards",
            "Device shards the last fleet window ran over (node-axis "
            "mesh size on the sharded packed path; 1 = unsharded engine "
            "or a demoted single-device ladder rung)")
        shards.add_metric([], stats["window_shards"])
        yield shards
        primary = _primary_introspect(introspect_snap)
        skew = GaugeMetricFamily(
            "kepler_fleet_window_shard_skew_ratio",
            "Sticky-map load skew: max/mean per-shard resident-row "
            "occupancy (1.0 = balanced; the sparse model bucket — and "
            "so the whole mesh's estimator FLOPs — is sized by the "
            "fullest shard)")
        skew.add_metric([], stats["shard_skew"])
        yield skew
        shard_rows = GaugeMetricFamily(
            "kepler_fleet_window_shard_rows",
            "Resident-row occupancy per device shard, split by row "
            "mode (shard-count-bounded cardinality)",
            labels=["shard", "mode"])
        if primary is not None:
            for k, occ in enumerate(primary["shards"]):
                shard_rows.add_metric([str(k), "model"],
                                      occ["model_rows"])
                shard_rows.add_metric([str(k), "ratio"],
                                      occ["rows"] - occ["model_rows"])
        yield shard_rows
        h2d_by_shard = GaugeMetricFamily(
            "kepler_fleet_window_shard_h2d_rows",
            "Rows staged + uploaded per device shard for the last "
            "fleet window (delta H2D; a hot shard here means churn is "
            "landing unevenly)",
            labels=["shard"])
        for k, n in enumerate(stats["last_h2d_shards"]):
            h2d_by_shard.add_metric([str(k)], n)
        yield h2d_by_shard
        staleness = GaugeMetricFamily(
            "kepler_fleet_window_buffer_staleness_windows",
            "Windows since each ping-pong ring slot last served (0 = "
            "served the latest window; a slot stuck high means the "
            "donation rotation is wedged)",
            labels=["slot"])
        if primary is not None:
            for slot, age in enumerate(
                    primary["resident"]["staleness_windows"]):
                staleness.add_metric([str(slot)], age)
        yield staleness
        prog_flops = GaugeMetricFamily(
            "kepler_fleet_window_program_flops",
            "Operations of the hand kernel each cached fleet-window "
            "program launches (captured at its first launch; label "
            "cardinality bounded by the compile-cache cap)",
            labels=["program"])
        prog_bytes = GaugeMetricFamily(
            "kepler_fleet_window_program_bytes",
            "Bytes each cached fleet-window program's arguments and "
            "outputs occupy on the device (read + written per launch)",
            labels=["program"])
        prog_mem = GaugeMetricFamily(
            "kepler_fleet_window_program_device_memory_bytes",
            "Device footprint (arguments + outputs) of each cached "
            "fleet-window program",
            labels=["program"])
        if introspect_snap:
            seen_programs: set[str] = set()
            for eng in introspect_snap.values():
                prog_lists = [eng.get(kind, ())
                              for kind in ("programs", "updates")]
                fused_sub = eng.get("fused")
                if fused_sub:
                    prog_lists.append(fused_sub.get("programs", ()))
                for progs in prog_lists:
                    for prog in progs:
                        cost = prog.get("cost")
                        if not cost or "flops" not in cost:
                            continue
                        label = cost["label"]
                        if label in seen_programs:
                            continue  # serial engine mirrors a key
                        seen_programs.add(label)
                        prog_flops.add_metric([label], cost["flops"])
                        prog_bytes.add_metric([label],
                                              cost["bytes_accessed"])
                        if "device_memory_bytes" in cost:
                            prog_mem.add_metric(
                                [label], cost["device_memory_bytes"])
        yield prog_flops
        yield prog_bytes
        yield prog_mem
        compiles = CounterMetricFamily(
            "kepler_fleet_window_compiles_total",
            "Fleet-window program-cache misses — attribution programs "
            "AND delta scatter-updates (bucket-ladder shape changes; "
            "growth is geometric, shrink is hysteretic)")
        compiles.add_metric([], stats["window_compiles_total"])
        yield compiles
        rung = GaugeMetricFamily(
            "kepler_fleet_window_degraded",
            "Degradation-ladder rung of the window's device leg "
            "(0 = packed-f16 pipelined [healthy], 1 = packed serial, "
            "2 = einsum-f32 serial, 3 = pure-NumPy host fallback)")
        rung.add_metric([], stats["window_rung"])
        yield rung
        demotions = CounterMetricFamily(
            "kepler_fleet_window_demotions_total",
            "Window device-leg ladder demotions, by failure reason",
            labels=["reason"])
        for reason, count in demotions_snap:
            demotions.add_metric([reason], count)
        yield demotions
        repromotions = CounterMetricFamily(
            "kepler_fleet_window_repromotions_total",
            "Window ladder re-promotions (repromoteAfter consecutive "
            "clean windows at a demoted rung retried the rung above)")
        repromotions.add_metric([], stats["window_repromotions_total"])
        yield repromotions
        total = CounterMetricFamily(
            "kepler_fleet_attributions_total", "Completed fleet attributions")
        total.add_metric([], stats["attributions_total"])
        yield total
        reports = CounterMetricFamily(
            "kepler_fleet_reports_total", "Node reports received")
        reports.add_metric([], stats["reports_total"])
        yield reports
        rejected = CounterMetricFamily(
            "kepler_fleet_reports_rejected_total", "Malformed reports rejected")
        rejected.add_metric([], stats["rejected_total"])
        yield rejected
        quarantined = CounterMetricFamily(
            "kepler_fleet_reports_quarantined_total",
            "Reports quarantined before ingest, by reason",
            labels=["reason"])
        quarantined.add_metric(["malformed"], stats["malformed_total"])
        quarantined.add_metric(["clock_skew"], stats["clock_skew_total"])
        yield quarantined
        duplicates = CounterMetricFamily(
            "kepler_fleet_reports_duplicate_total",
            "Redelivered (run, seq) reports absorbed by the dedup window")
        duplicates.add_metric([], stats["duplicates_total"])
        yield duplicates
        redirected = CounterMetricFamily(
            "kepler_fleet_reports_redirected_total",
            "Reports answered with a 421 owner redirect (node owned by "
            "another ring replica; the agent follows to the owner)")
        redirected.add_metric([], stats["reports_redirected_total"])
        yield redirected
        keyframes = CounterMetricFamily(
            "kepler_fleet_reports_keyframe_requests_total",
            "Wire-v2 delta frames answered with a structured 409 "
            "needs-keyframe (base missing after hand-off/eviction or "
            "run/seq mismatch) — the agent resends full, never a loss")
        keyframes.add_metric([], stats["keyframe_requests_total"])
        yield keyframes
        with self._lock:
            ingest_bytes_snap = sorted(self._ingest_bytes.items())
            version_rollup: dict[int, int] = {1: 0, 2: 0}
            for s in self._reports.values():
                version_rollup[s.wire_version] = \
                    version_rollup.get(s.wire_version, 0) + 1
        ingest_bytes = CounterMetricFamily(
            "kepler_fleet_ingest_bytes_total",
            "Report payload bytes ingested, by wire version (v2 delta "
            "steady state runs far below v1's JSON-framed bytes)",
            labels=["version"])
        for version, count in ingest_bytes_snap:
            ingest_bytes.add_metric([str(version)], count)
        yield ingest_bytes
        wire_version = GaugeMetricFamily(
            "kepler_fleet_wire_version",
            "Live nodes by the wire version of their last stored "
            "report (the v1→v2 fleet-rollout progress rollup)",
            labels=["version"])
        for version, count in sorted(version_rollup.items()):
            wire_version.add_metric([str(version)], count)
        yield wire_version
        ctrl = self._admission
        shed = CounterMetricFamily(
            "kepler_fleet_reports_shed_total",
            "Reports shed by ingest admission control (429 + "
            "Retry-After before decode), by budget signal — loss-free: "
            "shed records stay spooled on the agent and replay later",
            labels=["reason"])
        for reason, count in sorted((ctrl.shed_by_reason() if ctrl
                                     else {}).items()):
            shed.add_metric([reason], count)
        yield shed
        inflight = GaugeMetricFamily(
            "kepler_fleet_ingest_inflight",
            "Admitted ingest requests currently being decoded/merged "
            "(admission sheds at a load-derived multiple of "
            "aggregator.admissionMaxInflight; 0 with admission off)")
        inflight.add_metric([], ctrl.inflight() if ctrl else 0)
        yield inflight
        ingest_lat = GaugeMetricFamily(
            "kepler_fleet_ingest_latency_seconds",
            "EWMA of per-record ingest service time — the admission "
            "controller's latency-budget signal (decays while shedding "
            "so recovery probes always resume; 0 with admission off)")
        ingest_lat.add_metric([], ctrl.latency_ewma() if ctrl else 0.0)
        yield ingest_lat
        ring = self._ring
        ring_epoch = GaugeMetricFamily(
            "kepler_fleet_ring_epoch",
            "Ingest ring membership epoch (monotonic, bumped per "
            "membership change; 0 = ring disabled / single-replica)")
        ring_epoch.add_metric([], ring.epoch if ring is not None else 0)
        yield ring_epoch
        ownership = GaugeMetricFamily(
            "kepler_fleet_ring_ownership_ratio",
            "Share of the consistent-hash space this replica owns "
            "(1.0 = single replica or ring disabled)")
        ownership.add_metric(
            [], ring.ownership_ratio(self._self_peer)
            if ring is not None else 1.0)
        yield ownership
        ring_peers = GaugeMetricFamily(
            "kepler_fleet_ring_peers",
            "Replicas in the current ingest-ring membership (0 = ring "
            "disabled) — the elastic fleet's replica count")
        ring_peers.add_metric([], len(ring) if ring is not None else 0)
        yield ring_peers
        with self._lock:
            rejected_snap = sorted(self._membership_rejected.items())
            applied_snap = sorted(self._membership_applied.items())
        mem_rejected = CounterMetricFamily(
            "kepler_fleet_membership_rejected_total",
            "Membership operations rejected, by structured reason "
            "(equal_epoch_conflict is the split-brain detector firing)",
            labels=["reason"])
        for reason, count in rejected_snap:
            mem_rejected.add_metric([reason], count)
        yield mem_rejected
        mem_applied = CounterMetricFamily(
            "kepler_fleet_membership_applied_total",
            "Membership changes applied, by source (operator | "
            "succession | wire | join | leave | autoscale)",
            labels=["source"])
        for source, count in applied_snap:
            mem_applied.add_metric([source], count)
        yield mem_applied
        with self._results_lock:
            awaiting_now = self._awaiting_membership
            decision_now = self._autoscale_last
            scale_snap = sorted(self._autoscale_decisions.items())
        mem_awaiting = GaugeMetricFamily(
            "kepler_fleet_membership_awaiting_state",
            "1 while this replica is degraded awaiting a membership "
            "(a peer died and it is not the succession issuer, or "
            "takeover is disabled)")
        mem_awaiting.add_metric([], 1 if awaiting_now else 0)
        yield mem_awaiting
        if self._autoscale is not None:
            rec = GaugeMetricFamily(
                "kepler_fleet_autoscale_recommended_replicas",
                "The autoscale policy's current replica recommendation "
                "(enacted only with aggregator.membership.autoApply)")
            rec.add_metric([], decision_now.replicas
                           if decision_now is not None
                           else (len(ring) if ring is not None else 0))
            yield rec
            scale_dec = CounterMetricFamily(
                "kepler_fleet_autoscale_decisions_total",
                "Autoscale observations by decision direction",
                labels=["direction"])
            for direction, count in scale_snap:
                scale_dec.add_metric([direction], count)
            yield scale_dec
        now = self._clock()
        with self._lock:
            lost_by_node = dict(self._lost_by_node)
            delivery_snap = [
                (path, h.cumulative(), h.sum)
                for path, h in sorted(self._delivery_hist.items())]
            node_states = self._scoreboard.states(now, self._stale_after)
        from prometheus_client.core import HistogramMetricFamily
        delivery = HistogramMetricFamily(
            "kepler_fleet_delivery_latency_seconds",
            "End-to-end window delivery latency, agent emit → aggregator "
            "merge (fresh sends from emitted_at; spool replays from the "
            "original appended_at)",
            labels=["path"])
        for path, buckets, total_sum in delivery_snap:
            delivery.add_metric([path], buckets=buckets,
                                sum_value=total_sum)
        yield delivery
        lost = CounterMetricFamily(
            "kepler_fleet_windows_lost_total",
            "Windows that never arrived (seq gaps), by reporting node",
            labels=["node_name"])
        for node, count in lost_by_node.items():
            lost.add_metric([node], count)
        yield lost
        degraded = GaugeMetricFamily(
            "kepler_fleet_degraded_nodes",
            "Nodes whose reports were quarantined within the decay window")
        degraded.add_metric([], len(self.degraded_nodes()))
        yield degraded
        node_state = GaugeMetricFamily(
            "kepler_fleet_node_state",
            "Scoreboard state per node (0 healthy, 1 stale, 2 lossy, "
            "3 anomalous, 4 quarantined); cardinality bounded by the "
            "scoreboard LRU cap",
            labels=["node_name"])
        state_rollup = {name: 0 for name in STATE_NAMES}
        for node, code in node_states.items():
            node_state.add_metric([node], code)
            state_rollup[STATE_NAMES[code]] += 1
        yield node_state
        scoreboard_nodes = GaugeMetricFamily(
            "kepler_fleet_scoreboard_nodes",
            "Scoreboard rollup: nodes currently in each health state",
            labels=["state"])
        for name in STATE_NAMES:
            scoreboard_nodes.add_metric([name], state_rollup[name])
        yield scoreboard_nodes
        node_watts = GaugeMetricFamily(
            "kepler_fleet_node_cpu_watts",
            "Per-node power attributed by the fleet aggregator",
            labels=["node_name", "zone", "mode"])
        node_joules = CounterMetricFamily(
            "kepler_fleet_node_cpu_joules_total",
            "Per-node cumulative energy seen by the fleet aggregator",
            labels=["node_name", "zone", "mode"])
        if results is not None:
            zones = results.zones
            for name in results.names:
                # rows map, not enumerate: the packed-resident layout
                # keeps nodes at stable row indices with holes
                i = results.rows[name]
                mode = "model" if results.mode[i] else "ratio"
                power = results.node_power_uw[i]
                joules = results.node_joules_total[i]
                for j, zone in enumerate(zones):
                    node_watts.add_metric([name, zone, mode],
                                          float(power[j]) / 1e6)
                    node_joules.add_metric([name, zone, mode],
                                           float(joules[j]))
        yield node_watts
        yield node_joules
