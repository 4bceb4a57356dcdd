"""Application configuration: defaults < YAML file < CLI flags.

Reference parity: ``config/config.go`` — three-layer precedence where only
*explicitly passed* flags override the YAML file (``config.go:285-395``),
YAML loading with unknown-key detection, sanitization, validation with
skippable host/kube checks (``config.go:418-509``), and a mergo-style
fragment-merge builder for tests (``config/builder.go:34-57``).

Dev-only settings (fake meter) are YAML-only, never flags
(``config.go:104,189``).
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import os
from dataclasses import dataclass, field
from typing import Any, Callable, IO, Mapping, Sequence

from kepler_tpu_torch.config.level import Level, parse_level


def _parse_duration(v: Any) -> float:
    """Parse a duration into seconds.

    Accepts numbers (seconds) or Go-style strings like "5s", "500ms", "1m30s"
    (the reference YAML uses Go duration syntax, e.g. ``monitor.interval: 5s``).
    """
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return float(v)
    if not isinstance(v, str):
        raise ValueError(f"invalid duration: {v!r}")
    s = v.strip()
    if not s:
        raise ValueError("empty duration")
    units = {"h": 3600.0, "m": 60.0, "s": 1.0, "ms": 1e-3, "us": 1e-6, "ns": 1e-9}
    total = 0.0
    num = ""
    i = 0
    matched = False
    while i < len(s):
        c = s[i]
        if c.isdigit() or c in ".+-":
            num += c
            i += 1
            continue
        unit = ""
        while i < len(s) and s[i].isalpha():
            unit += s[i]
            i += 1
        if unit not in units or not num:
            raise ValueError(f"invalid duration: {v!r}")
        total += float(num) * units[unit]
        num = ""
        matched = True
    if num:  # trailing bare number, e.g. "5" → seconds
        total += float(num)
        matched = True
    if not matched:
        raise ValueError(f"invalid duration: {v!r}")
    return total


def format_duration(seconds: float) -> str:
    """Render seconds as a compact Go-style duration string."""
    if seconds >= 1:
        return f"{seconds:g}s"
    if seconds >= 1e-3:
        return f"{seconds * 1e3:g}ms"
    return f"{seconds * 1e6:g}us"


# ---------------------------------------------------------------------------
# Config sections (reference config.go:21-108)
# ---------------------------------------------------------------------------


@dataclass
class LogConfig:
    level: str = "info"
    format: str = "text"  # text | json


@dataclass
class HostConfig:
    sysfs: str = "/sys"
    procfs: str = "/proc"


@dataclass
class RaplConfig:
    zones: list[str] = field(default_factory=list)  # empty = all zones


@dataclass
class MsrConfig:
    """MSR fallback meter (reference proposal EP-002). YAML-only — no CLI
    flags, so the security-sensitive backend can't be enabled by a stray
    argument (proposal §Configuration)."""

    enabled: bool = False  # opt-in: MSR reads are a PLATYPUS side channel
    force: bool = False  # use MSR even when powercap works (testing only)
    device_path: str = "/dev/cpu"


@dataclass
class MonitorConfig:
    interval: float = 5.0  # seconds (reference default 5s, config.go:207)
    staleness: float = 0.5  # seconds (reference default 500ms)
    # <0 unlimited, 0 disabled, >0 top-N by energy (config.go:51-56)
    max_terminated: int = 500
    # joules; only terminated workloads above this are tracked (config.go:58-63)
    min_terminated_energy_threshold: float = 10.0
    # watchdog: refresh-loop stall threshold; 0 = auto (3 × interval)
    stall_after: float = 0.0
    # counter-state persistence: with a path, the last raw counter
    # readings survive a restart so the first window attributes the
    # energy consumed across it ("" = off); a state file older than
    # state_max_age is ignored (a stale baseline would misattribute;
    # 0 = no freshness bound)
    state_path: str = ""
    state_max_age: float = 60.0


@dataclass
class StdoutExporterConfig:
    enabled: bool = False


@dataclass
class PrometheusExporterConfig:
    enabled: bool = True
    debug_collectors: list[str] = field(default_factory=lambda: ["go"])
    metrics_level: Level = Level.all()


@dataclass
class ExporterConfig:
    stdout: StdoutExporterConfig = field(default_factory=StdoutExporterConfig)
    prometheus: PrometheusExporterConfig = field(
        default_factory=PrometheusExporterConfig
    )


@dataclass
class PprofConfig:
    enabled: bool = False


@dataclass
class DebugConfig:
    pprof: PprofConfig = field(default_factory=PprofConfig)


@dataclass
class WebConfig:
    config_file: str = ""
    listen_addresses: list[str] = field(default_factory=lambda: [":28282"])
    # concurrent-connection cap per listener: an accept over the cap is
    # answered 503 + Connection: close WITHOUT spawning a handler
    # thread, so a connection storm (herd after a replica kill) can't
    # grow threads without bound. 0 = unbounded (pre-cap behavior).
    max_connections: int = 1024


@dataclass
class KubeConfig:
    enabled: bool = False
    config: str = ""  # kubeconfig path; empty = in-cluster
    node_name: str = ""


@dataclass
class FakeCpuMeterConfig:
    enabled: bool = False
    zones: list[str] = field(default_factory=list)


@dataclass
class TPUConfig:
    """TPU-specific settings — new in this framework (no reference analog).

    Controls where attribution math runs and how fleet batches are shaped.
    In the PyTorch/CUDA port the keys keep their meaning: ``fleetBackend:
    pallas`` runs the hand-written CUDA kernels, ``einsum`` plain tensor
    ops; ``platform``, ``meshShape``/``meshAxes`` and the XLA cache are
    read but unused (the aggregator's mesh is ``aggregator.meshShape``,
    as in the reference).
    """

    platform: str = "auto"  # auto | tpu | cpu — jax platform for attribution
    # Pad workload axis to the next multiple of this to bound recompilation
    # (bucketed batch shapes).
    workload_bucket: int = 256
    node_bucket: int = 8  # fleet aggregator node-axis bucket
    mesh_shape: list[int] = field(default_factory=list)  # [] = all devices, 1D
    mesh_axes: list[str] = field(default_factory=lambda: ["node"])
    # persistent XLA compilation cache dir ("" = off): bucket-crossing and
    # restart compiles become disk hits instead of fresh XLA runs
    compilation_cache_dir: str = ""
    # fleet attribution contraction: "einsum" (XLA-fused) | "pallas"
    # (hand-written Mosaic kernel, shard_map over the node axis)
    fleet_backend: str = "einsum"


@dataclass
class ServiceConfig:
    """Supervised service-group restarts (service.lifecycle.RestartPolicy).

    ``restart_max: 0`` (default) keeps the reference semantics: the first
    Runner crash ends the group. > 0 enables bounded restart-with-backoff
    per service.
    """

    restart_max: int = 0
    restart_backoff_initial: float = 0.5
    restart_backoff_max: float = 30.0


@dataclass
class FaultConfig:
    """Fault injection (``kepler_tpu_torch.fault``) — YAML-only, like ``dev.*``:
    a chaos plan must be a deliberate config-file choice, never a stray
    CLI argument. ``specs`` is a list of mappings with a required ``site``
    plus optional probability/count/skip/start/duration/arg (see
    fault.plan.FaultSpec)."""

    enabled: bool = False
    seed: int = 0
    specs: list[Mapping[str, Any]] = field(default_factory=list)


@dataclass
class SpoolConfig:
    """Crash-safe report spool (``fleet.spool``): the agent's durable
    at-least-once delivery queue. Disabled unless ``dir`` is set."""

    dir: str = ""  # spool directory ("" = in-memory ring only)
    max_bytes: int = 64 << 20  # byte cap; oldest segment evicted beyond
    max_records: int = 4096  # record cap (counted, never silent)
    segment_bytes: int = 1 << 20  # rotation size (eviction granularity)
    # fsync policy: "batch" (default; at most one fsync per
    # fsync_interval — nothing per-send), "always", "none"
    fsync: str = "batch"
    fsync_interval: float = 1.0


@dataclass
class DrainConfig:
    """Spool-drain overload behavior (``fleet.agent`` batched replay +
    throttle handling, docs/developer/resilience.md "Overload and
    backpressure")."""

    # spooled records shipped per /v1/reports request during recovery
    # replay (1 = the pre-batch single-record drain)
    batch_max: int = 32
    # token-bucket cap on replay records/second, so a rejoining agent
    # slews its backlog in instead of dumping it (0 = unpaced)
    replay_rps: float = 256.0
    # clamp on any server-sent Retry-After the agent will honor — an
    # adversarial owner must not be able to park an agent forever
    retry_after_max: float = 300.0


@dataclass
class WireConfig:
    """Wire-format behavior of the agent's report stream
    (``fleet.wire`` v2 fast path, docs/user/fleet.md "Wire format
    v2")."""

    # 2 (default) = binary v2 frames with delta encoding; 1 pins the
    # legacy JSON-headered v1 frames (rollout escape hatch)
    version: int = 2
    # a full keyframe every N windows even when deltas would do — bounds
    # how much state a new owner must request after a hand-off
    keyframe_every: int = 16
    # how long a replica that answered 415/400 to v2 bytes stays
    # remembered as v1-only before the agent re-probes v2
    degraded_ttl: float = 60.0


@dataclass
class AgentConfig:
    """Node-agent delivery plane (the sender half of the fleet leg).

    Transport/retry knobs historically live under ``aggregator.*``; the
    durability plane added by the spool starts the agent's own section.
    """

    spool: SpoolConfig = field(default_factory=SpoolConfig)
    drain: DrainConfig = field(default_factory=DrainConfig)
    wire: WireConfig = field(default_factory=WireConfig)


@dataclass
class JournalConfig:
    """Fleet black box (``kepler_tpu_torch.fleet.journal``): the HLC-stamped
    causal event journal behind ``/debug/journal`` and
    ``/debug/bundle``. Disabled emission costs one global read per
    event, same contract as spans."""

    enabled: bool = False
    # bounded in-memory event ring per process
    ring_size: int = 512
    # durable spool directory ("" = ring only); events are appended as
    # CRC32-framed canonical JSON so a crashed replica's last moments
    # survive for the incident bundle
    dir: str = ""
    # durable file size cap (one rotation to .1 beyond it)
    max_bytes: int = 4_000_000


@dataclass
class TelemetryConfig:
    """Self-telemetry plane (``kepler_tpu_torch.telemetry``): span tracing of
    the monitor/exporter/fleet hot paths, ``kepler_self_*`` metrics, and
    the ``/debug/traces`` endpoint. Disabled spans cost one global read
    per call, so ``enabled: false`` is within measurement noise."""

    enabled: bool = True
    # complete cycle traces kept for /debug/traces, PER cycle name
    # (newest wins; per-name rings keep a high-rate cycle like
    # aggregator ingest from evicting the rare once-per-interval ones)
    ring_size: int = 32
    # kepler_self_stage_duration_seconds bucket bounds (seconds)
    stage_buckets: list[float] = field(default_factory=list)
    # kepler_fleet_delivery_latency_seconds bucket bounds (seconds);
    # the default tail reaches hours because spool replays carry outages
    delivery_buckets: list[float] = field(default_factory=list)
    # fleet black-box event journal (docs/developer/observability.md
    # "Fleet black box")
    journal: JournalConfig = field(default_factory=JournalConfig)


@dataclass
class DevConfig:
    fake_cpu_meter: FakeCpuMeterConfig = field(default_factory=FakeCpuMeterConfig)


@dataclass
class MultihostConfig:
    """Multi-host fleet window (``docs/user/fleet.md`` "Multi-host"):
    N aggregator processes form ONE ``torch.distributed`` job (gloo)
    whose mesh spans every host's devices; rung 0 runs the multi-host
    window engine (host-local rings, each process launching its own
    shards) and — with ``aggregator.peers`` set — ingest ownership
    derives from the mesh shard map, so each replica ingests exactly the
    agents whose packed rows live on its local devices."""

    enabled: bool = False
    # coordinator endpoint host:port ("" = take MASTER_ADDR /
    # MASTER_PORT from the env, torch.distributed's convention)
    coordinator: str = ""
    # process topology (-1 = take WORLD_SIZE / RANK from the env)
    num_processes: int = -1
    process_id: int = -1
    # bound on the coordinator join — an unreachable coordinator is
    # surfaced as a DISTINCT failure reason (coordinator_unreachable) in
    # the log, the return, and the fleet-window probe (0 = 300 s)
    init_timeout: float = 0.0
    # on a mesh demotion, run coordinator-lease succession: the elected
    # issuer (incumbent lease holder if alive, else the lowest surviving
    # peer) bumps the ring epoch over the survivor set and broadcasts
    # the membership — works at ANY mesh size. Off = every survivor
    # flags itself "degraded, awaiting membership" until an operator
    # apply_membership lands
    takeover: bool = True


@dataclass
class MembershipConfig:
    """Elastic fleet membership (docs/developer/resilience.md "Elastic
    membership"): runtime host join/leave over the coordinator lease,
    plus the autoscale recommendation policy fed by the fleet's own
    overload signals (admission load, shed deltas, ingest-latency EWMA,
    scoreboard states). Recommendations are always surfaced; they are
    ENACTED only with ``autoApply`` on — the default keeps
    operator-driven behavior byte-for-byte."""

    # enact membership changes (succession already runs under
    # multihost.takeover; this additionally lets the lease holder
    # enact autoscale decisions)
    auto_apply: bool = False
    # run the autoscale policy at all (off = no recommendation gauge,
    # zero per-window overhead)
    autoscale_enabled: bool = False
    # admission load ratio at/above which a window counts toward the
    # scale-up streak, and at/below which toward scale-down; between
    # the two is the dead band (streaks preserved, nothing fires)
    scale_up_load: float = 1.0
    scale_down_load: float = 0.25
    # consecutive overloaded/idle windows before a recommendation
    # fires (up reacts in seconds, down in minutes — asymmetric
    # hysteresis so a flapping load never thrashes membership)
    up_windows: int = 3
    down_windows: int = 12
    # replica-count bounds the policy recommends within (maxReplicas
    # 0 = current membership + available standby peers)
    min_replicas: int = 1
    max_replicas: int = 0
    # endpoints a scale-up may promote into the membership (beyond
    # the live peers list); empty = scale-up recommendations are
    # surfaced but never enacted
    standby_peers: list[str] = field(default_factory=list)
    # bound on membership liveness probes (GET /healthz) and
    # membership-plane POSTs
    probe_timeout: float = 2.0


@dataclass
class AggregatorConfig:
    """Cluster aggregator role — new in this framework.

    The reference has no inter-node plane; this framework
    adds an optional gRPC aggregator that batches many nodes' feature rows into
    one TPU attribution call.
    """

    enabled: bool = False
    listen_address: str = ":28283"
    # node-agent side: where to stream feature rows ("" = standalone mode);
    # https:// scheme + URL userinfo carry TLS and basic-auth credentials
    # (https://user:pw@agg:28283) when the aggregator sets web.config-file
    endpoint: str = ""
    # accept the aggregator's TLS cert without verification (self-signed dev)
    tls_skip_verify: bool = False
    # aggregation cadence and how long a silent node stays in the batch
    interval: float = 5.0
    stale_after: float = 15.0
    # learned estimator for non-RAPL nodes: "" = ratio-only, else
    # "linear"/"mlp"/"moe"/"deep"/"temporal"; params_path = .npz from
    # models.estimator.save_params
    model: str = "mlp"
    params_path: str = ""
    # serve estimators at f32/highest matmul precision — the configuration
    # the 0.5% accuracy budget is validated under (benchmarks/accuracy.py);
    # off = bf16 throughput mode. Estimator shapes are tiny, so the cost
    # is negligible at typical fleet sizes.
    accuracy_mode: bool = False
    # temporal mode: ticks of per-workload feature history the aggregator
    # accretes per node (the model's attention window)
    history_window: int = 16
    # capture RAPL nodes' windows + ratio-watt labels as training files for
    # cmd/train ("" = off); oldest files pruned beyond the cap
    training_dump_dir: str = ""
    training_dump_max_files: int = 1000
    # node-agent side: report as a model-estimated node (no trustworthy
    # RAPL — e.g. a VM guest); the aggregator then uses the estimator
    node_mode: str = "ratio"  # ratio | model
    # -- resilience (docs/developer/resilience.md) --
    # agent send retries: exponential backoff with jitter between attempts
    backoff_initial: float = 0.1
    backoff_max: float = 5.0
    # agent circuit breaker: consecutive failures that open it, and the
    # base cooldown before a half-open probe (doubles per failed probe)
    breaker_threshold: int = 5
    breaker_cooldown: float = 10.0
    # agent shutdown: bound on the best-effort final queue flush
    flush_timeout: float = 2.0
    # aggregator: quarantine reports whose sender clock is skewed beyond
    # this (0 disables the check), and how long a node stays marked
    # degraded after its last quarantined report
    skew_tolerance: float = 120.0
    degraded_ttl: float = 60.0
    # HLC drift clamp (telemetry/hlc.py): an inbound journal clock
    # stamp whose physical component is more than this far ahead of the
    # local wall clock is clamped before merging, so one hostile or
    # broken peer cannot vault the fleet's causal clocks
    hlc_max_drift: float = 60.0
    # aggregator: per-node (run, seq) dedup window — spool replays and
    # retries are absorbed idempotently instead of double-ingesting
    dedup_window: int = 1024
    # -- window pipeline (docs/developer/observability.md) --
    # in-flight fleet windows: 1 = serial assemble→dispatch→fetch; 2
    # (the shipped default) overlaps window N's fetch/scatter behind
    # window N+1's assembly+dispatch — published results are at most
    # pipelineDepth−1 intervals stale, shutdown drains deterministically
    pipeline_depth: int = 2
    # fused window loop (rung 0's top tier): batch this many intervals'
    # delta rows host-side and run them as ONE donated lax.scan dispatch
    # + ONE batched K-window fetch — the host↔device sync cost is paid
    # once per K windows instead of once per window. Published results
    # are at most fusedWindowK−1 intervals stale (the flush publishes
    # all K at once, oldest first). 1 (the default) keeps the unfused
    # per-window dispatch exactly as before
    fused_window_k: int = 1
    # bucket hysteresis: padded batch shapes grow geometrically on
    # demand but only SHRINK after this many consecutive windows at
    # under half occupancy — a fleet hovering at a bucket edge never
    # recompile-thrashes
    bucket_shrink_after: int = 16
    # -- device-plane fault tolerance (resilience.md "Device-plane
    # faults"): any device-leg failure (dispatch error, compile failure,
    # OOM on a bucket-growth recompile, hung fetch) demotes the window
    # one ladder rung — packed pipelined → packed serial → einsum-f32
    # serial → pure-NumPy host — instead of crashing the loop
    fallback_enabled: bool = True
    # consecutive clean windows at a demoted rung before the rung above
    # is retried (hysteresis, mirroring the breaker's half-open probe)
    repromote_after: int = 8
    # stall watchdog on the window fetch: a dispatch that hasn't
    # produced its output within this bound demotes instead of wedging
    # the aggregation loop (0 disables the watchdog)
    dispatch_timeout: float = 30.0
    # device mesh the packed window path runs on: [] = all devices on a
    # 1-D node axis — with > 1 device that is the SHARDED window (per-
    # shard resident rings, per-shard delta H2D, sticky node→shard
    # assignment). A 2-D [n, m] node×model mesh falls back to the
    # unsharded engine (batch still NamedSharding-sharded)
    mesh_shape: list[int] = field(default_factory=list)
    mesh_axes: list[str] = field(default_factory=lambda: ["node"])
    # -- multi-host SPMD tier (docs/user/fleet.md "Multi-host") --
    multihost: MultihostConfig = field(default_factory=MultihostConfig)
    # -- elastic membership + autoscale (docs/developer/resilience.md
    # "Elastic membership") --
    membership: MembershipConfig = field(default_factory=MembershipConfig)
    # -- fleet scoreboard (docs/developer/observability.md "Fleet
    # scoreboard"): per-node health table served at /debug/fleet and as
    # kepler_fleet_node_state — LRU-capped (bounds memory AND metric
    # cardinality), with a rolling z-score anomaly flag on each node's
    # self-reported power (0 disables the anomaly flag)
    scoreboard_cap: int = 1024
    anomaly_z: float = 4.0
    # -- HA ingest ring (docs/developer/resilience.md "Ingest
    # hand-off"): static replica membership for the consistent-hash
    # ingest tier. peers lists every replica's dialable endpoint (the
    # SAME list on every replica and every agent); selfPeer names which
    # entry this replica is (replica role only); ringEpoch versions the
    # membership (bump it when rolling out a changed peers list);
    # ringVnodes is the virtual-node count per peer (ownership
    # granularity). Empty peers = single-replica ingest, ring inert.
    peers: list[str] = field(default_factory=list)
    self_peer: str = ""
    ring_epoch: int = 1
    ring_vnodes: int = 64
    # -- ingest admission control (docs/developer/resilience.md
    # "Overload and backpressure"): shed with 429 + Retry-After BEFORE
    # decode work when the inflight or latency budget is blown —
    # priority-aware (replay backlogs first, live RAPL ground truth
    # last). Shedding is loss-free: records stay spooled and replay.
    admission_enabled: bool = True
    admission_max_inflight: int = 64
    # EWMA ingest-latency budget the shed ladder is scaled against
    admission_latency_budget: float = 0.25
    # base Retry-After answered on a shed (load-multiplied, jittered)
    # and the clamp it can never exceed
    admission_retry_after: float = 1.0
    admission_retry_after_max: float = 30.0
    # -- wire v2 delta bases (docs/user/fleet.md "Wire format v2"):
    # per-node last-keyframe LRU the delta frames merge against; an
    # evicted base costs one 409 needs-keyframe round-trip, never loss
    base_row_cache: int = 1024


@dataclass
class Config:
    log: LogConfig = field(default_factory=LogConfig)
    host: HostConfig = field(default_factory=HostConfig)
    monitor: MonitorConfig = field(default_factory=MonitorConfig)
    rapl: RaplConfig = field(default_factory=RaplConfig)
    msr: MsrConfig = field(default_factory=MsrConfig)
    exporter: ExporterConfig = field(default_factory=ExporterConfig)
    web: WebConfig = field(default_factory=WebConfig)
    debug: DebugConfig = field(default_factory=DebugConfig)
    kube: KubeConfig = field(default_factory=KubeConfig)
    tpu: TPUConfig = field(default_factory=TPUConfig)
    aggregator: AggregatorConfig = field(default_factory=AggregatorConfig)
    agent: AgentConfig = field(default_factory=AgentConfig)
    service: ServiceConfig = field(default_factory=ServiceConfig)
    fault: FaultConfig = field(default_factory=FaultConfig)
    telemetry: TelemetryConfig = field(default_factory=TelemetryConfig)
    dev: DevConfig = field(default_factory=DevConfig)

    # ---- validation (reference config.go:418-509) ----

    SKIP_HOST_VALIDATION = "host"
    SKIP_KUBE_VALIDATION = "kube"

    def validate(self, skip: Sequence[str] = ()) -> None:
        errs: list[str] = []
        if self.log.level not in ("debug", "info", "warn", "error"):
            errs.append(f"invalid log level: {self.log.level!r}")
        if self.log.format not in ("text", "json"):
            errs.append(f"invalid log format: {self.log.format!r}")
        if self.SKIP_HOST_VALIDATION not in skip:
            if not os.path.isdir(self.host.sysfs):
                errs.append(f"host.sysfs {self.host.sysfs!r} is not a directory")
            if not os.path.isdir(self.host.procfs):
                errs.append(f"host.procfs {self.host.procfs!r} is not a directory")
        if self.monitor.interval < 0:
            errs.append("monitor.interval must be >= 0")
        if self.monitor.staleness < 0:
            errs.append("monitor.staleness must be >= 0")
        if self.monitor.min_terminated_energy_threshold < 0:
            errs.append("monitor.minTerminatedEnergyThreshold must be >= 0")
        if self.kube.enabled and self.SKIP_KUBE_VALIDATION not in skip:
            if not self.kube.node_name:
                errs.append("kube.nodeName must be set when kube.enabled")
            if self.kube.config and not os.path.isfile(self.kube.config):
                errs.append(f"kube.config {self.kube.config!r} does not exist")
        if self.tpu.workload_bucket <= 0:
            errs.append("tpu.workload_bucket must be > 0")
        if self.tpu.node_bucket <= 0:
            errs.append("tpu.node_bucket must be > 0")
        # fail at startup, not on the first aggregation window (YAML values
        # bypass the CLI flags' choices= checks)
        if self.tpu.platform not in ("auto", "tpu", "cpu"):
            errs.append(f"invalid tpu.platform: {self.tpu.platform!r}")
        if self.tpu.fleet_backend not in ("einsum", "pallas"):
            errs.append(
                f"invalid tpu.fleetBackend: {self.tpu.fleet_backend!r}")
        if self.aggregator.history_window < 1:
            errs.append("aggregator.historyWindow must be >= 1")
        if self.aggregator.training_dump_max_files < 1:
            errs.append("aggregator.trainingDumpMaxFiles must be >= 1")
        if self.aggregator.model not in ("", "linear", "mlp", "moe",
                                         "deep", "temporal"):
            errs.append(f"invalid aggregator.model: {self.aggregator.model!r}")
        if self.aggregator.node_mode not in ("ratio", "model"):
            errs.append(
                f"invalid aggregator.nodeMode: {self.aggregator.node_mode!r}")
        if self.monitor.stall_after < 0:
            errs.append("monitor.stallAfter must be >= 0")
        elif 0 < self.monitor.stall_after <= self.monitor.interval:
            # a threshold at or under one refresh interval would flap the
            # watchdog stalled/recovered on a perfectly healthy node
            errs.append("monitor.stallAfter must exceed monitor.interval "
                        "(or be 0 for auto = 3 × interval)")
        for name, val in (
                ("aggregator.backoffInitial", self.aggregator.backoff_initial),
                ("aggregator.backoffMax", self.aggregator.backoff_max),
                ("aggregator.breakerCooldown",
                 self.aggregator.breaker_cooldown),
                ("aggregator.flushTimeout", self.aggregator.flush_timeout),
                ("aggregator.skewTolerance", self.aggregator.skew_tolerance),
                ("aggregator.degradedTtl", self.aggregator.degraded_ttl),
                ("service.restartBackoffInitial",
                 self.service.restart_backoff_initial),
                ("service.restartBackoffMax",
                 self.service.restart_backoff_max)):
            if val < 0:
                errs.append(f"{name} must be >= 0")
        if self.aggregator.breaker_threshold < 1:
            errs.append("aggregator.breakerThreshold must be >= 1")
        if self.aggregator.dedup_window < 1:
            errs.append("aggregator.dedupWindow must be >= 1")
        if not 1 <= self.aggregator.pipeline_depth <= 8:
            # beyond a few intervals of staleness the "latest" results
            # stop meaning anything; 8 is already generous
            errs.append("aggregator.pipelineDepth must be in [1, 8]")
        if not 1 <= self.aggregator.fused_window_k <= 8:
            # same staleness argument as pipelineDepth: a flush that
            # publishes more than a handful of windows at once makes
            # "latest" meaningless
            errs.append("aggregator.fusedWindowK must be in [1, 8]")
        if self.aggregator.bucket_shrink_after < 1:
            errs.append("aggregator.bucketShrinkAfter must be >= 1")
        if self.aggregator.repromote_after < 1:
            errs.append("aggregator.repromoteAfter must be >= 1")
        if self.aggregator.scoreboard_cap < 1:
            errs.append("aggregator.scoreboardCap must be >= 1")
        if self.aggregator.anomaly_z < 0:
            errs.append("aggregator.anomalyZ must be >= 0 (0 disables "
                        "the anomaly flag)")
        # HA ingest ring: membership must be coherent at startup — a
        # replica that can't place itself in the ring would redirect
        # every report forever
        agg = self.aggregator
        if any(not isinstance(p, str) or not p for p in agg.peers):
            errs.append("aggregator.peers entries must be non-empty "
                        "strings")
        elif len(set(agg.peers)) != len(agg.peers):
            errs.append("aggregator.peers must not contain duplicates")
        elif agg.self_peer and agg.peers \
                and agg.self_peer not in agg.peers:
            errs.append(f"aggregator.selfPeer {agg.self_peer!r} must be "
                        "one of aggregator.peers")
        elif agg.enabled and agg.peers and not agg.self_peer:
            errs.append("aggregator.selfPeer must be set when the "
                        "aggregator role is enabled with aggregator.peers")
        if agg.ring_epoch < 1:
            errs.append("aggregator.ringEpoch must be >= 1")
        if agg.ring_vnodes < 1:
            errs.append("aggregator.ringVnodes must be >= 1")
        # overload control: admission budgets + agent drain pacing
        if agg.admission_max_inflight < 1:
            errs.append("aggregator.admissionMaxInflight must be >= 1")
        for name, val in (
                ("aggregator.admissionLatencyBudget",
                 agg.admission_latency_budget),
                ("aggregator.admissionRetryAfter",
                 agg.admission_retry_after),
                ("aggregator.admissionRetryAfterMax",
                 agg.admission_retry_after_max)):
            if val < 0:
                errs.append(f"{name} must be >= 0")
        if agg.admission_retry_after_max < agg.admission_retry_after:
            errs.append("aggregator.admissionRetryAfterMax must be >= "
                        "aggregator.admissionRetryAfter")
        if agg.base_row_cache < 1:
            errs.append("aggregator.baseRowCache must be >= 1")
        mh = agg.multihost
        if mh.init_timeout < 0:
            errs.append("aggregator.multihost.initTimeout must be >= 0 "
                        "(0 = jax's default join deadline)")
        if mh.num_processes != -1 and mh.num_processes < 1:
            errs.append("aggregator.multihost.numProcesses must be >= 1 "
                        "(or -1 = from JAX_NUM_PROCESSES)")
        if mh.process_id < -1:
            errs.append("aggregator.multihost.processId must be >= 0 "
                        "(or -1 = from JAX_PROCESS_ID)")
        if (mh.enabled and agg.peers
                and mh.num_processes not in (-1, len(agg.peers))):
            errs.append("aggregator.peers must list exactly one replica "
                        "endpoint per multihost process (in process-"
                        "index order) when both are configured")
        mem = agg.membership
        if mem.scale_up_load <= 0:
            errs.append("aggregator.membership.scaleUpLoad must be > 0")
        if mem.scale_down_load < 0:
            errs.append("aggregator.membership.scaleDownLoad must be >= 0")
        if mem.scale_down_load >= mem.scale_up_load:
            errs.append("aggregator.membership.scaleDownLoad must be "
                        "below scaleUpLoad (the gap is the hysteresis "
                        "dead band)")
        if mem.up_windows < 1:
            errs.append("aggregator.membership.upWindows must be >= 1")
        if mem.down_windows < 1:
            errs.append("aggregator.membership.downWindows must be >= 1")
        if mem.min_replicas < 1:
            errs.append("aggregator.membership.minReplicas must be >= 1")
        if mem.max_replicas < 0:
            errs.append("aggregator.membership.maxReplicas must be >= 0 "
                        "(0 = membership + standby size)")
        if mem.max_replicas and mem.max_replicas < mem.min_replicas:
            errs.append("aggregator.membership.maxReplicas must be >= "
                        "minReplicas (or 0)")
        if mem.probe_timeout <= 0:
            errs.append("aggregator.membership.probeTimeout must be > 0")
        if any(not isinstance(p, str) or not p for p in mem.standby_peers):
            errs.append("aggregator.membership.standbyPeers entries must "
                        "be non-empty strings")
        elif any(p in agg.peers for p in mem.standby_peers):
            errs.append("aggregator.membership.standbyPeers must not "
                        "overlap aggregator.peers (a standby is by "
                        "definition outside the initial membership)")
        if (mem.auto_apply or mem.autoscale_enabled) and not agg.peers:
            errs.append("aggregator.membership.autoApply/autoscaleEnabled "
                        "need aggregator.peers (the ingest ring is the "
                        "membership being scaled)")
        wire = self.agent.wire
        if wire.version not in (1, 2):
            errs.append("agent.wire.version must be 1 or 2")
        if wire.keyframe_every < 1:
            errs.append("agent.wire.keyframeEvery must be >= 1")
        if wire.degraded_ttl <= 0:
            errs.append("agent.wire.degradedTtl must be > 0")
        drain = self.agent.drain
        if drain.batch_max < 1:
            errs.append("agent.drain.batchMax must be >= 1")
        if drain.replay_rps < 0:
            errs.append("agent.drain.replayRps must be >= 0 "
                        "(0 disables replay pacing)")
        if drain.retry_after_max <= 0:
            errs.append("agent.drain.retryAfterMax must be > 0 (a zero "
                        "clamp would turn every 429 into an immediate "
                        "resend)")
        if self.web.max_connections < 0:
            errs.append("web.maxConnections must be >= 0 "
                        "(0 disables the connection cap)")
        if self.aggregator.dispatch_timeout < 0:
            errs.append("aggregator.dispatchTimeout must be >= 0 "
                        "(0 disables the stall watchdog)")
        # mesh validity beyond this (device divisibility) is checked by
        # make_mesh at startup, when the device count is known
        if not self.aggregator.mesh_axes:
            errs.append("aggregator.meshAxes must name at least one axis")
        elif self.aggregator.mesh_axes[0] != "node":
            errs.append("aggregator.meshAxes must lead with 'node' "
                        f"(got {self.aggregator.mesh_axes!r}) — the "
                        "fleet batch shards over the node axis")
        if self.aggregator.mesh_shape and (
                len(self.aggregator.mesh_shape)
                != len(self.aggregator.mesh_axes)):
            errs.append("aggregator.meshShape and aggregator.meshAxes "
                        "must have the same rank")
        if self.monitor.state_max_age < 0:
            errs.append("monitor.stateMaxAge must be >= 0")
        spool = self.agent.spool
        if spool.fsync not in ("batch", "always", "none"):
            errs.append(f"invalid agent.spool.fsync: {spool.fsync!r} "
                        "(batch | always | none)")
        if spool.fsync_interval < 0:
            errs.append("agent.spool.fsyncInterval must be >= 0")
        for name, val in (("agent.spool.maxBytes", spool.max_bytes),
                          ("agent.spool.maxRecords", spool.max_records),
                          ("agent.spool.segmentBytes", spool.segment_bytes)):
            if val < 1:
                errs.append(f"{name} must be >= 1")
        if self.service.restart_max < 0:
            errs.append("service.restartMax must be >= 0")
        if self.telemetry.ring_size < 1:
            errs.append("telemetry.ringSize must be >= 1")
        journal = self.telemetry.journal
        if journal.ring_size < 1:
            errs.append("telemetry.journal.ringSize must be >= 1")
        if journal.max_bytes < 4096:
            errs.append("telemetry.journal.maxBytes must be >= 4096 "
                        "(one rotation must fit at least a few frames)")
        if self.aggregator.hlc_max_drift <= 0:
            errs.append("aggregator.hlcMaxDrift must be > 0 (the clamp "
                        "bound on inbound HLC physical clocks)")
        for name, buckets in (
                ("telemetry.stageBuckets", self.telemetry.stage_buckets),
                ("telemetry.deliveryBuckets",
                 self.telemetry.delivery_buckets)):
            # [] = use the built-in defaults; an explicit list must be
            # strictly increasing positive bounds or the histogram's
            # cumulative rendering silently lies
            vals = list(buckets)
            if any(isinstance(b, bool) or not isinstance(b, (int, float))
                   for b in vals):
                errs.append(f"{name} must be numbers")
            elif vals and (vals[0] <= 0
                           or any(b >= a for b, a in zip(vals, vals[1:]))):
                errs.append(f"{name} must be strictly increasing and > 0")
        if self.fault.enabled:
            # a typo'd chaos plan must fail at startup, not inject nothing
            try:
                from kepler_tpu_torch.fault import FaultPlan
                FaultPlan.from_config(self.fault)
            except ValueError as err:
                errs.append(str(err))
        if errs:
            raise ValueError("invalid configuration: " + "; ".join(errs))


# ---------------------------------------------------------------------------
# YAML loading (reference config.go:241-278)
# ---------------------------------------------------------------------------

# YAML key → (section attr, field attr) spelling map for keys whose YAML name
# differs from the Python attribute (mirrors reference yaml tags). Every
# multi-word key accepts BOTH the reference-style camelCase spelling and the
# kebab-case spelling matching its CLI flag, so a flag line can be pasted
# into YAML without a spelling surprise.
_CANONICAL_YAML_KEYS: dict[str, str] = {
    "configFile": "config_file",
    "listenAddresses": "listen_addresses",
    "maxTerminated": "max_terminated",
    "minTerminatedEnergyThreshold": "min_terminated_energy_threshold",
    "debugCollectors": "debug_collectors",
    "metricsLevel": "metrics_level",
    "nodeName": "node_name",
    "listenAddress": "listen_address",
    "staleAfter": "stale_after",
    "paramsPath": "params_path",
    "tlsSkipVerify": "tls_skip_verify",
    "nodeMode": "node_mode",
    "workloadBucket": "workload_bucket",
    "nodeBucket": "node_bucket",
    "meshShape": "mesh_shape",
    "meshAxes": "mesh_axes",
    "fleetBackend": "fleet_backend",
    "historyWindow": "history_window",
    "accuracyMode": "accuracy_mode",
    "trainingDumpDir": "training_dump_dir",
    "trainingDumpMaxFiles": "training_dump_max_files",
    "fakeCpuMeter": "fake_cpu_meter",
    "devicePath": "device_path",
    "compilationCacheDir": "compilation_cache_dir",
    "stallAfter": "stall_after",
    "backoffInitial": "backoff_initial",
    "backoffMax": "backoff_max",
    "breakerThreshold": "breaker_threshold",
    "breakerCooldown": "breaker_cooldown",
    "flushTimeout": "flush_timeout",
    "skewTolerance": "skew_tolerance",
    "degradedTtl": "degraded_ttl",
    "restartMax": "restart_max",
    "restartBackoffInitial": "restart_backoff_initial",
    "restartBackoffMax": "restart_backoff_max",
    "statePath": "state_path",
    "stateMaxAge": "state_max_age",
    "dedupWindow": "dedup_window",
    "pipelineDepth": "pipeline_depth",
    "fusedWindowK": "fused_window_k",
    "bucketShrinkAfter": "bucket_shrink_after",
    "fallbackEnabled": "fallback_enabled",
    "repromoteAfter": "repromote_after",
    "dispatchTimeout": "dispatch_timeout",
    "scoreboardCap": "scoreboard_cap",
    "anomalyZ": "anomaly_z",
    "selfPeer": "self_peer",
    "ringEpoch": "ring_epoch",
    "ringVnodes": "ring_vnodes",
    "admissionEnabled": "admission_enabled",
    "numProcesses": "num_processes",
    "processId": "process_id",
    "initTimeout": "init_timeout",
    "autoApply": "auto_apply",
    "autoscaleEnabled": "autoscale_enabled",
    "scaleUpLoad": "scale_up_load",
    "scaleDownLoad": "scale_down_load",
    "upWindows": "up_windows",
    "downWindows": "down_windows",
    "minReplicas": "min_replicas",
    "maxReplicas": "max_replicas",
    "standbyPeers": "standby_peers",
    "probeTimeout": "probe_timeout",
    "admissionMaxInflight": "admission_max_inflight",
    "admissionLatencyBudget": "admission_latency_budget",
    "admissionRetryAfter": "admission_retry_after",
    "admissionRetryAfterMax": "admission_retry_after_max",
    "batchMax": "batch_max",
    "replayRps": "replay_rps",
    "retryAfterMax": "retry_after_max",
    "keyframeEvery": "keyframe_every",
    "baseRowCache": "base_row_cache",
    "maxConnections": "max_connections",
    "maxBytes": "max_bytes",
    "maxRecords": "max_records",
    "segmentBytes": "segment_bytes",
    "fsyncInterval": "fsync_interval",
    "ringSize": "ring_size",
    "stageBuckets": "stage_buckets",
    "deliveryBuckets": "delivery_buckets",
    "hlcMaxDrift": "hlc_max_drift",
}


def _kebab(camel: str) -> str:
    return "".join("-" + c.lower() if c.isupper() else c for c in camel)


_YAML_KEYS: dict[str, str] = {
    **_CANONICAL_YAML_KEYS,
    **{_kebab(k): v for k, v in _CANONICAL_YAML_KEYS.items()},
}

_DURATION_FIELDS = {"interval", "staleness", "stale_after", "stall_after",
                    "backoff_initial", "backoff_max", "breaker_cooldown",
                    "flush_timeout", "skew_tolerance", "degraded_ttl",
                    "restart_backoff_initial", "restart_backoff_max",
                    "state_max_age", "fsync_interval", "dispatch_timeout",
                    "admission_latency_budget", "admission_retry_after",
                    "admission_retry_after_max", "retry_after_max",
                    "init_timeout", "probe_timeout", "hlc_max_drift"}


def _apply_mapping(obj: Any, data: Mapping[str, Any], path: str = "") -> None:
    for raw_key, value in data.items():
        attr = _YAML_KEYS.get(raw_key, raw_key)
        where = f"{path}.{raw_key}" if path else raw_key
        if not dataclasses.is_dataclass(obj) or not hasattr(obj, attr):
            raise ValueError(f"unknown config key: {where!r}")
        current = getattr(obj, attr)
        if dataclasses.is_dataclass(current):
            if value is None:
                continue
            if not isinstance(value, Mapping):
                raise ValueError(f"config key {where!r} expects a mapping")
            _apply_mapping(current, value, where)
        elif attr == "metrics_level":
            if isinstance(value, str):
                value = [value]
            setattr(obj, attr, parse_level(value))
        elif attr in _DURATION_FIELDS:
            setattr(obj, attr, _parse_duration(value))
        elif isinstance(current, bool):
            if not isinstance(value, bool):
                raise ValueError(f"config key {where!r} expects a bool")
            setattr(obj, attr, value)
        elif isinstance(current, float) and isinstance(value, (int, float)):
            setattr(obj, attr, float(value))
        elif isinstance(current, list):
            if value is None:
                setattr(obj, attr, [])
            elif isinstance(value, list):
                setattr(obj, attr, list(value))
            else:
                raise ValueError(f"config key {where!r} expects a list")
        else:
            setattr(obj, attr, value)


def load(stream: IO[str] | str) -> Config:
    """Load configuration from a YAML stream/string over defaults."""
    cfg = default_config()
    import yaml  # only a config file needs it

    text = stream if isinstance(stream, str) else stream.read()
    data = yaml.safe_load(io.StringIO(text)) or {}
    if not isinstance(data, Mapping):
        raise ValueError("config root must be a mapping")
    _apply_mapping(cfg, data)
    return cfg


def from_file(path: str) -> Config:
    """Load configuration from a YAML file path (reference ``FromFile``)."""
    with open(path, "r", encoding="utf-8") as f:
        cfg = load(f)
    return cfg


def default_config() -> Config:
    return Config()


# ---------------------------------------------------------------------------
# Flag registration + precedence (reference config.go:285-395)
# ---------------------------------------------------------------------------


def register_flags(parser: argparse.ArgumentParser) -> None:
    """Register CLI flags. Defaults are sentinels so we can tell 'explicitly
    passed' from 'defaulted' — only explicit flags override YAML
    (reference flag-set tracking, config.go:330-394)."""
    add = parser.add_argument
    add("--config.file", dest="config_file", default=None, help="YAML config path")
    add("--log.level", dest="log_level", default=None,
        choices=["debug", "info", "warn", "error"])
    add("--log.format", dest="log_format", default=None, choices=["text", "json"])
    add("--host.sysfs", dest="host_sysfs", default=None)
    add("--host.procfs", dest="host_procfs", default=None)
    add("--monitor.interval", dest="monitor_interval", default=None,
        help="refresh interval, e.g. 5s")
    add("--monitor.max-terminated", dest="monitor_max_terminated", default=None,
        type=int)
    add("--monitor.state-path", dest="monitor_state_path", default=None,
        help="counter-state file for restart-surviving attribution")
    add("--debug.pprof", dest="debug_pprof", default=None,
        action=argparse.BooleanOptionalAction)
    add("--web.config-file", dest="web_config_file", default=None)
    add("--web.listen-address", dest="web_listen_address", default=None,
        action="append", help="repeatable listen address")
    add("--exporter.stdout", dest="exporter_stdout", default=None,
        action=argparse.BooleanOptionalAction)
    add("--exporter.prometheus", dest="exporter_prometheus", default=None,
        action=argparse.BooleanOptionalAction)
    add("--metrics", dest="metrics", default=None, action="append",
        help="cumulative metrics level: node|process|container|vm|pod|all")
    add("--kube.enable", dest="kube_enable", default=None,
        action=argparse.BooleanOptionalAction)
    add("--kube.config", dest="kube_config", default=None)
    add("--kube.node-name", dest="kube_node_name", default=None)
    add("--aggregator.enable", dest="aggregator_enable", default=None,
        action=argparse.BooleanOptionalAction)
    add("--aggregator.listen-address", dest="aggregator_listen", default=None)
    add("--aggregator.endpoint", dest="aggregator_endpoint", default=None)
    add("--aggregator.tls-skip-verify", dest="aggregator_tls_skip_verify",
        default=None, action=argparse.BooleanOptionalAction)
    add("--aggregator.model", dest="aggregator_model", default=None,
        choices=["", "linear", "mlp", "moe", "deep", "temporal"])
    add("--aggregator.params-path", dest="aggregator_params_path",
        default=None)
    add("--aggregator.node-mode", dest="aggregator_node_mode", default=None,
        choices=["ratio", "model"])
    add("--aggregator.accuracy-mode", dest="aggregator_accuracy_mode",
        default=None, action=argparse.BooleanOptionalAction)
    add("--aggregator.history-window", dest="aggregator_history_window",
        default=None, type=int)
    add("--aggregator.training-dump-dir", dest="aggregator_dump_dir",
        default=None)
    add("--aggregator.training-dump-max-files",
        dest="aggregator_dump_max_files", default=None, type=int)
    add("--aggregator.dedup-window", dest="aggregator_dedup_window",
        default=None, type=int)
    add("--aggregator.pipeline-depth", dest="aggregator_pipeline_depth",
        default=None, type=int,
        help="in-flight fleet windows (1 = serial, 2 = double-buffered)")
    add("--aggregator.fused-window-k", dest="aggregator_fused_window_k",
        default=None, type=int,
        help="intervals batched into one fused device scan (1 = unfused "
             "per-window dispatch; K>1 syncs the host once per K windows)")
    add("--aggregator.bucket-shrink-after",
        dest="aggregator_bucket_shrink_after", default=None, type=int,
        help="consecutive under-half windows before a batch bucket shrinks")
    add("--aggregator.fallback-enabled", dest="aggregator_fallback_enabled",
        default=None, action=argparse.BooleanOptionalAction,
        help="degrade the window device leg down a fallback ladder on "
             "failure instead of crashing the aggregation loop")
    add("--aggregator.repromote-after", dest="aggregator_repromote_after",
        default=None, type=int,
        help="consecutive clean windows at a demoted rung before the "
             "rung above is retried")
    add("--aggregator.dispatch-timeout", dest="aggregator_dispatch_timeout",
        default=None,
        help="stall watchdog bound on the window fetch, e.g. 30s "
             "(0 disables)")
    add("--aggregator.scoreboard-cap", dest="aggregator_scoreboard_cap",
        default=None, type=int,
        help="fleet scoreboard LRU cap (bounds memory and "
             "kepler_fleet_node_state cardinality)")
    add("--aggregator.anomaly-z", dest="aggregator_anomaly_z",
        default=None, type=float,
        help="rolling z-score threshold flagging a node's reported "
             "power as anomalous (0 disables)")
    add("--aggregator.admission-enabled",
        dest="aggregator_admission_enabled", default=None,
        action=argparse.BooleanOptionalAction,
        help="shed ingest load with 429 + Retry-After before decode "
             "when the inflight/latency budget is blown (loss-free: "
             "shed records stay spooled on the agent and replay)")
    add("--web.max-connections", dest="web_max_connections", default=None,
        type=int,
        help="concurrent-connection cap per listener; overflow is "
             "answered 503 without spawning a thread (0 = unbounded)")
    add("--aggregator.peers", dest="aggregator_peers", default=None,
        action="append",
        help="repeatable: one ingest-ring replica endpoint per flag "
             "(the same list on every replica and agent)")
    add("--aggregator.self-peer", dest="aggregator_self_peer",
        default=None,
        help="which aggregator.peers entry THIS replica is")
    add("--aggregator.ring-epoch", dest="aggregator_ring_epoch",
        default=None, type=int,
        help="ingest-ring membership epoch (bump when rolling out a "
             "changed peers list)")
    add("--aggregator.ring-vnodes", dest="aggregator_ring_vnodes",
        default=None, type=int,
        help="virtual nodes per ring peer (ownership granularity)")
    add("--agent.spool-dir", dest="agent_spool_dir", default=None,
        help="crash-safe report spool directory (empty disables)")
    add("--agent.wire-version", dest="agent_wire_version", default=None,
        type=int, choices=[1, 2],
        help="report wire format: 2 = binary delta-encoded v2 "
             "(default), 1 = legacy JSON-headered frames")
    add("--aggregator.base-row-cache",
        dest="aggregator_base_row_cache", default=None, type=int,
        help="wire-v2 delta-base LRU size (per-node last keyframes; "
             "eviction costs a 409 needs-keyframe round-trip)")
    add("--aggregator.multihost.enabled",
        dest="aggregator_multihost_enabled", default=None,
        action=argparse.BooleanOptionalAction,
        help="multi-host SPMD fleet window: join a jax.distributed "
             "cluster and run rung 0 over every host's devices "
             "(host-local rings, one SPMD dispatch, mesh-derived "
             "ingest ownership)")
    add("--aggregator.multihost.coordinator",
        dest="aggregator_multihost_coordinator", default=None,
        help="jax.distributed coordinator address (empty = "
             "JAX_COORDINATOR_ADDRESS)")
    add("--aggregator.multihost.num-processes",
        dest="aggregator_multihost_num_processes", default=None,
        type=int,
        help="process count of the multi-host job (-1 = "
             "JAX_NUM_PROCESSES)")
    add("--aggregator.multihost.process-id",
        dest="aggregator_multihost_process_id", default=None, type=int,
        help="this process's id in the multi-host job (-1 = "
             "JAX_PROCESS_ID)")
    add("--aggregator.multihost.init-timeout",
        dest="aggregator_multihost_init_timeout", default=None,
        help="bound on the coordinator join, e.g. 60s (0 = jax's "
             "default); an unreachable coordinator surfaces as the "
             "distinct coordinator_unreachable failure reason")
    add("--aggregator.multihost.takeover",
        dest="aggregator_multihost_takeover", default=None,
        action=argparse.BooleanOptionalAction,
        help="on a mesh demotion, run coordinator-lease succession: "
             "the elected issuer bumps the ring epoch over the "
             "survivor set and broadcasts it (any mesh size)")
    add("--aggregator.membership.auto-apply",
        dest="aggregator_membership_auto_apply", default=None,
        action=argparse.BooleanOptionalAction,
        help="let the lease holder ENACT autoscale membership changes "
             "(off = recommendations surfaced only; operator behavior "
             "unchanged)")
    add("--aggregator.membership.autoscale-enabled",
        dest="aggregator_membership_autoscale_enabled", default=None,
        action=argparse.BooleanOptionalAction,
        help="run the autoscale recommendation policy over the fleet's "
             "recorded overload signals")
    add("--aggregator.membership.scale-up-load",
        dest="aggregator_membership_scale_up_load", default=None,
        type=float,
        help="admission load ratio counting a window toward the "
             "scale-up streak")
    add("--aggregator.membership.scale-down-load",
        dest="aggregator_membership_scale_down_load", default=None,
        type=float,
        help="admission load ratio counting a window toward the "
             "scale-down streak")
    add("--aggregator.membership.up-windows",
        dest="aggregator_membership_up_windows", default=None, type=int,
        help="consecutive overloaded windows before a scale-up "
             "recommendation fires")
    add("--aggregator.membership.down-windows",
        dest="aggregator_membership_down_windows", default=None,
        type=int,
        help="consecutive idle windows before a scale-down "
             "recommendation fires")
    add("--aggregator.membership.min-replicas",
        dest="aggregator_membership_min_replicas", default=None,
        type=int,
        help="floor the autoscale policy never recommends below")
    add("--aggregator.membership.max-replicas",
        dest="aggregator_membership_max_replicas", default=None,
        type=int,
        help="ceiling the autoscale policy never recommends above "
             "(0 = membership + standby size)")
    add("--aggregator.membership.standby-peers",
        dest="aggregator_membership_standby_peers", default=None,
        action="append",
        help="repeatable: replica endpoint a scale-up may promote "
             "into the membership")
    add("--aggregator.membership.probe-timeout",
        dest="aggregator_membership_probe_timeout", default=None,
        help="bound on membership liveness probes and membership-plane "
             "POSTs, e.g. 2s")
    add("--tpu.platform", dest="tpu_platform", default=None,
        choices=["auto", "tpu", "cpu"])
    add("--tpu.fleet-backend", dest="tpu_fleet_backend", default=None,
        choices=["einsum", "pallas"])
    add("--telemetry.enable", dest="telemetry_enable", default=None,
        action=argparse.BooleanOptionalAction,
        help="self-telemetry span tracing + kepler_self_* metrics")
    add("--telemetry.journal.enable", dest="telemetry_journal_enable",
        default=None, action=argparse.BooleanOptionalAction,
        help="fleet black-box event journal "
             "(/debug/journal + /debug/bundle)")


def apply_flags(cfg: Config, args: argparse.Namespace) -> Config:
    """Overlay explicitly-passed flags onto cfg (highest precedence)."""
    def set_if(attr_path: tuple[str, str], value: Any,
               transform: Callable[[Any], Any] | None = None) -> None:
        if value is None:
            return
        section, attr = attr_path
        setattr(getattr(cfg, section), attr,
                transform(value) if transform else value)

    set_if(("log", "level"), args.log_level)
    set_if(("log", "format"), args.log_format)
    set_if(("host", "sysfs"), args.host_sysfs)
    set_if(("host", "procfs"), args.host_procfs)
    set_if(("monitor", "interval"), args.monitor_interval, _parse_duration)
    set_if(("monitor", "max_terminated"), args.monitor_max_terminated)
    set_if(("monitor", "state_path"), args.monitor_state_path)
    if args.debug_pprof is not None:
        cfg.debug.pprof.enabled = args.debug_pprof
    set_if(("web", "config_file"), args.web_config_file)
    if args.web_listen_address:
        cfg.web.listen_addresses = list(args.web_listen_address)
    if args.exporter_stdout is not None:
        cfg.exporter.stdout.enabled = args.exporter_stdout
    if args.exporter_prometheus is not None:
        cfg.exporter.prometheus.enabled = args.exporter_prometheus
    if args.metrics:
        cfg.exporter.prometheus.metrics_level = parse_level(args.metrics)
    set_if(("kube", "enabled"), args.kube_enable)
    set_if(("kube", "config"), args.kube_config)
    set_if(("kube", "node_name"), args.kube_node_name)
    set_if(("aggregator", "enabled"), args.aggregator_enable)
    set_if(("aggregator", "listen_address"), args.aggregator_listen)
    set_if(("aggregator", "endpoint"), args.aggregator_endpoint)
    set_if(("aggregator", "tls_skip_verify"), args.aggregator_tls_skip_verify)
    set_if(("aggregator", "model"), args.aggregator_model)
    set_if(("aggregator", "params_path"), args.aggregator_params_path)
    set_if(("aggregator", "node_mode"), args.aggregator_node_mode)
    set_if(("aggregator", "accuracy_mode"), args.aggregator_accuracy_mode)
    set_if(("aggregator", "history_window"), args.aggregator_history_window)
    set_if(("aggregator", "training_dump_dir"), args.aggregator_dump_dir)
    set_if(("aggregator", "training_dump_max_files"),
           args.aggregator_dump_max_files)
    set_if(("aggregator", "dedup_window"), args.aggregator_dedup_window)
    set_if(("aggregator", "pipeline_depth"), args.aggregator_pipeline_depth)
    set_if(("aggregator", "fused_window_k"),
           args.aggregator_fused_window_k)
    set_if(("aggregator", "bucket_shrink_after"),
           args.aggregator_bucket_shrink_after)
    set_if(("aggregator", "fallback_enabled"),
           args.aggregator_fallback_enabled)
    set_if(("aggregator", "repromote_after"), args.aggregator_repromote_after)
    set_if(("aggregator", "dispatch_timeout"),
           args.aggregator_dispatch_timeout, _parse_duration)
    set_if(("aggregator", "scoreboard_cap"), args.aggregator_scoreboard_cap)
    set_if(("aggregator", "anomaly_z"), args.aggregator_anomaly_z)
    set_if(("aggregator", "admission_enabled"),
           args.aggregator_admission_enabled)
    if args.web_max_connections is not None:
        cfg.web.max_connections = args.web_max_connections
    if args.aggregator_peers:
        cfg.aggregator.peers = list(args.aggregator_peers)
    set_if(("aggregator", "self_peer"), args.aggregator_self_peer)
    set_if(("aggregator", "ring_epoch"), args.aggregator_ring_epoch)
    set_if(("aggregator", "ring_vnodes"), args.aggregator_ring_vnodes)
    if args.agent_spool_dir is not None:
        cfg.agent.spool.dir = args.agent_spool_dir
    if args.agent_wire_version is not None:
        cfg.agent.wire.version = args.agent_wire_version
    set_if(("aggregator", "base_row_cache"),
           args.aggregator_base_row_cache)
    mh = cfg.aggregator.multihost
    if args.aggregator_multihost_enabled is not None:
        mh.enabled = args.aggregator_multihost_enabled
    if args.aggregator_multihost_coordinator is not None:
        mh.coordinator = args.aggregator_multihost_coordinator
    if args.aggregator_multihost_num_processes is not None:
        mh.num_processes = args.aggregator_multihost_num_processes
    if args.aggregator_multihost_process_id is not None:
        mh.process_id = args.aggregator_multihost_process_id
    if args.aggregator_multihost_init_timeout is not None:
        mh.init_timeout = _parse_duration(
            args.aggregator_multihost_init_timeout)
    if args.aggregator_multihost_takeover is not None:
        mh.takeover = args.aggregator_multihost_takeover
    mem = cfg.aggregator.membership
    if args.aggregator_membership_auto_apply is not None:
        mem.auto_apply = args.aggregator_membership_auto_apply
    if args.aggregator_membership_autoscale_enabled is not None:
        mem.autoscale_enabled = args.aggregator_membership_autoscale_enabled
    if args.aggregator_membership_scale_up_load is not None:
        mem.scale_up_load = args.aggregator_membership_scale_up_load
    if args.aggregator_membership_scale_down_load is not None:
        mem.scale_down_load = args.aggregator_membership_scale_down_load
    if args.aggregator_membership_up_windows is not None:
        mem.up_windows = args.aggregator_membership_up_windows
    if args.aggregator_membership_down_windows is not None:
        mem.down_windows = args.aggregator_membership_down_windows
    if args.aggregator_membership_min_replicas is not None:
        mem.min_replicas = args.aggregator_membership_min_replicas
    if args.aggregator_membership_max_replicas is not None:
        mem.max_replicas = args.aggregator_membership_max_replicas
    if args.aggregator_membership_standby_peers:
        mem.standby_peers = list(args.aggregator_membership_standby_peers)
    if args.aggregator_membership_probe_timeout is not None:
        mem.probe_timeout = _parse_duration(
            args.aggregator_membership_probe_timeout)
    set_if(("tpu", "platform"), args.tpu_platform)
    set_if(("tpu", "fleet_backend"), args.tpu_fleet_backend)
    set_if(("telemetry", "enabled"), args.telemetry_enable)
    if args.telemetry_journal_enable is not None:
        cfg.telemetry.journal.enabled = args.telemetry_journal_enable
    return cfg


def parse_args_and_config(
    argv: Sequence[str] | None = None,
    skip_validation: Sequence[str] = (),
) -> Config:
    """Full precedence chain: defaults < --config.file YAML < explicit flags.

    Reference ``cmd/kepler/main.go:80-122`` parseArgsAndConfig.
    """
    parser = argparse.ArgumentParser(prog="kepler-tpu")
    register_flags(parser)
    args = parser.parse_args(argv)
    cfg = from_file(args.config_file) if args.config_file else default_config()
    cfg = apply_flags(cfg, args)
    cfg.validate(skip=skip_validation)
    return cfg


# ---------------------------------------------------------------------------
# Builder: merge YAML fragments (reference config/builder.go:34-57)
# ---------------------------------------------------------------------------


class Builder:
    """Accumulates YAML fragments and merges them over defaults, last wins.

    Used by tests to compose configs piecemeal, like the reference's
    mergo-based builder.
    """

    def __init__(self) -> None:
        self._fragments: list[str] = []

    def use(self, yaml_fragment: str) -> "Builder":
        self._fragments.append(yaml_fragment)
        return self

    def build(self) -> Config:
        import yaml  # only a config fragment needs it

        cfg = default_config()
        for frag in self._fragments:
            data = yaml.safe_load(io.StringIO(frag)) or {}
            if not isinstance(data, Mapping):
                raise ValueError("config fragment root must be a mapping")
            _apply_mapping(cfg, data)
        return cfg
