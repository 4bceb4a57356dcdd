"""PowerMonitor: the attribution service.

Reference parity: ``internal/monitor/monitor.go`` — owns the refresh loop;
``snapshot()`` API with staleness check + singleflight dedup (:265-302
double-check pattern); atomic snapshot publication; ``data_channel`` signal
for exporter readiness; ``exported`` flag gating terminated-workload
clearing; self-rescheduling timer (:229-251).

Per refresh (reference refreshSnapshot :317-356 → calculate*Power):
1. host: read each zone's counter, exact wraparound delta (``ops.deltas``);
   failed zones are masked out this window (node.go:39-44 analog);
2. host: ``resources.refresh()`` → dense ``FeatureBatch``;
3. device: ONE ``ops.attribute`` call on the monitor's device (``cuda``
   unless the caller passes ``device="cpu"``) computes the node
   active/idle split and every workload's energy/power share — the
   reference's four per-kind loops fused into a single [W,Z] outer
   product, padded to a bucketed shape so the caching allocator sees few
   shapes. Its inputs travel in ONE host→device copy (the staged
   ``cpu[W]``, ``valid[W]``, the zone deltas and mask and three scalars in
   one page-locked buffer) and its outputs in ONE device→host copy (node
   ``[6, Z]`` and workload energy/power ``[2, w, Z]`` packed on the
   device); the per-workload ratios stay on the device (no caller reads
   them);
4. host: scatter window deltas into cumulative f64 accumulators, build the
   immutable ``Snapshot``; move terminated workloads into top-k trackers.
"""

from __future__ import annotations

import logging
import threading
import time as _time
from dataclasses import dataclass
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from kepler_tpu_torch import fault, telemetry
from kepler_tpu_torch.device import resolve_device
from kepler_tpu_torch.device.meter import CPUPowerMeter, EnergyZone
from kepler_tpu_torch.monitor.snapshot import NodeUsage, Snapshot, WorkloadTable
from kepler_tpu_torch.monitor.terminated import TerminatedTracker
from kepler_tpu_torch.ops.attribution import attribute, pad_to_bucket
from kepler_tpu_torch.ops.deltas import energy_delta
from kepler_tpu_torch.resource.informer import FeatureBatch, ResourceInformer
from kepler_tpu_torch.service.lifecycle import CancelContext

log = logging.getLogger("kepler.monitor")


class SnapshotUnavailableError(RuntimeError):
    """No snapshot exists and the refresh that would create one failed.

    Raised from ``PowerMonitor.snapshot()`` only when there is no stale
    snapshot to degrade to (the reference serves stale data on refresh
    failure when it can — :185-200); collectors catch this to render a
    scrape error rather than propagate a raw traceback."""

_UNSET = object()  # "batch plan not yet computed" (None = computed, absent)

_KINDS = ("processes", "containers", "virtual_machines", "pods")
_KIND_CODES = (
    FeatureBatch.KIND_PROCESS,
    FeatureBatch.KIND_CONTAINER,
    FeatureBatch.KIND_VM,
    FeatureBatch.KIND_POD,
)


# cumulative per-workload accumulators (shared with the fleet
# aggregator's per-node totals — one row-store implementation)
from kepler_tpu_torch.utils.rowstore import RowStore as _CumStore  # noqa: E402


@dataclass(frozen=True)
class WindowSample:
    """Raw per-refresh inputs, before attribution — the feature rows a fleet
    agent streams to the cluster aggregator (per-node agents producing
    `[pods × features]` rows; the aggregator batches them into
    `[nodes × pods × features]`)."""

    timestamp: float
    dt_s: float
    zone_names: tuple[str, ...]
    zone_deltas_uj: np.ndarray  # f64 [Z] this window
    zone_valid: np.ndarray  # bool [Z]
    usage_ratio: float
    batch: FeatureBatch


class PowerMonitor:
    def __init__(
        self,
        meter: CPUPowerMeter,
        resources: ResourceInformer,
        interval: float = 5.0,
        staleness: float = 0.5,
        max_terminated: int = 500,
        min_terminated_energy_uj: float = 10e6,
        workload_bucket: int = 256,
        clock: Callable[[], float] | None = None,
        monotonic: Callable[[], float] | None = None,
        state_path: str = "",
        state_max_age: float = 60.0,
        device: str | torch.device = "cuda",
    ) -> None:
        # the attribution leg's device; a missing CUDA device raises here
        # (the CPU runs only when the caller asks for it)
        self._device = resolve_device(device)
        self._meter = meter
        self._resources = resources
        self._interval = interval
        self._staleness = staleness
        self._max_terminated = max_terminated
        self._min_terminated_energy_uj = min_terminated_energy_uj
        self._bucket = workload_bucket
        self._clock = clock or _time.time  # wall: timestamps/staleness
        # dt for power uses a monotonic source so NTP steps can't inflate
        # watts; tests inject the same fake for both
        self._monotonic = monotonic or (clock if clock else _time.monotonic)

        # counter-state persistence: with a state_path, the last raw
        # counter readings + a wall-clock anchor survive restarts, so the
        # first post-restart window attributes the energy consumed ACROSS
        # the restart instead of discarding it as a fresh seeding read
        self._state_path = state_path
        self._state_max_age = max(0.0, state_max_age)

        self._zones: list[EnergyZone] = []
        self._zone_names: tuple[str, ...] = ()
        self._prev_counters: list[int | None] = []  # keplint: guarded-by=_snapshot_lock
        self._batch_plan = _UNSET  # lazily-resolved native zone-read plan
        self._last_read_ts: float | None = None

        # cumulative f64 accumulators: kind → dense row store (id-keyed)
        self._cumulative: dict[str, _CumStore] = {}
        # per-kind meta tuple cache: (meta_gen, view-dict ref, rows);
        # validated by gen equality + dict IDENTITY (see _meta_rows)
        self._meta_rows_cache: dict[str, tuple] = {}
        self._node_energy = np.zeros(0)
        self._node_active = np.zeros(0)
        self._node_idle = np.zeros(0)

        self._trackers: dict[str, TerminatedTracker] = {}
        # padded attribution staging, reused across refreshes (the
        # node-side analog of the aggregator's delta-H2D slice: a steady
        # window rewrites only the live prefix + the stale tail slice; a
        # churn burst that crosses a bucket boundary reallocates once):
        # one input buffer [cpu W | valid W | zone Z | zone_valid Z |
        # usage_ratio, node_cpu_delta, dt] and one output buffer
        # [node 6·Z | energy W·Z | power W·Z], page-locked on the card
        self._stage_w = -1  # bucket the buffers are sized for
        self._stage_in = torch.zeros(0)
        self._stage_out = torch.zeros(0)
        self._stage_live = 0  # rows of the staging prefix in use
        self._window_listeners: list[Callable[[WindowSample], None]] = []
        self._snapshot: Snapshot | None = None  # keplint: guarded-by=_snapshot_lock
        self._snapshot_lock = threading.Lock()  # singleflight for refresh
        self._exported = False
        self._data_event = threading.Event()  # reference dataCh signal
        # watchdog plane: when the refresh loop stalls (wedged meter,
        # deadlocked informer), MonitorWatchdog flips _stalled so /healthz
        # reports the published snapshot as stale; a completed refresh
        # clears it
        self._last_refresh_done: float | None = None  # monotonic
        self._stalled = False

    # -- service lifecycle -------------------------------------------------

    def name(self) -> str:
        return "power-monitor"

    def init(self) -> None:
        """Probe zones, seed counters, create trackers (reference Init
        :118-150)."""
        if hasattr(self._meter, "init"):
            self._meter.init()
        self._zones = list(self._meter.zones())
        self._zone_names = tuple(z.name() for z in self._zones)
        self._batch_plan = _UNSET  # re-resolve against the new zone list
        z = len(self._zones)
        self._prev_counters = [None] * z
        self._node_energy = np.zeros(z)
        self._node_active = np.zeros(z)
        self._node_idle = np.zeros(z)
        primary = self._meter.primary_energy_zone().name()
        primary_idx = self._zone_names.index(primary)
        for kind in _KINDS:
            store = self._cumulative.get(kind)
            if store is None or store.arr.shape[1] != z:
                self._cumulative[kind] = _CumStore(z)
            self._trackers[kind] = TerminatedTracker(
                n_zones=z,
                primary_zone_index=primary_idx,
                max_size=self._max_terminated,
                min_energy_uj=self._min_terminated_energy_uj,
                device=self._device,
            )
        self._restore_state()
        log.info("monitor initialized: zones=%s primary=%s",
                 self._zone_names, primary)

    def run(self, ctx: CancelContext) -> None:
        """Self-rearming collection loop (reference collectionLoop :218)."""
        if self._interval <= 0:
            ctx.wait(None)
            return
        while not ctx.cancelled():
            try:
                self.refresh()
            except Exception:
                log.exception("refresh failed")
            if ctx.wait(self._interval):
                return

    # -- read API (reference PowerDataProvider) ----------------------------

    def zone_names(self) -> Sequence[str]:
        return self._zone_names

    def data_channel(self) -> threading.Event:
        """Set once the first snapshot exists (collector readiness gate)."""
        return self._data_event

    def add_window_listener(
            self, listener: Callable[[WindowSample], None]) -> None:
        """Subscribe to raw per-window samples (fleet agent feed). Listeners
        run inside the refresh lock — they must be fast and non-blocking
        (the agent just enqueues)."""
        self._window_listeners.append(listener)

    def last_refresh_age(self) -> float | None:
        """Monotonic seconds since the last COMPLETED refresh (None before
        the first). The watchdog's stall signal."""
        done = self._last_refresh_done
        if done is None:
            return None
        return self._monotonic() - done

    def mark_stalled(self, stalled: bool) -> None:
        """Watchdog hook: flag the published snapshot as stale because the
        refresh loop stopped making progress."""
        self._stalled = stalled

    @property
    def stalled(self) -> bool:
        return self._stalled

    def health(self) -> dict:
        """Probe for /healthz: not-ok while the watchdog flags a stall."""
        out: dict = {"ok": not self._stalled, "stalled": self._stalled,
                     "snapshot": self._snapshot is not None}
        age = self.last_refresh_age()
        if age is not None:
            out["last_refresh_age_s"] = round(age, 3)
        return out

    def snapshot(self, clone: bool = True) -> Snapshot:
        """Return a deep-cloned, fresh snapshot.

        ``clone=False`` returns the published object itself — safe for
        read-only consumers because a published snapshot is never mutated
        (every refresh builds new arrays/dicts and swaps the reference);
        the exporter's direct text render uses it to skip a 10k-row deep
        copy per scrape. External callers should keep the default.

        Freshness contract (reference :185-200, :254-302): if the current
        snapshot is older than ``staleness``, refresh first; concurrent
        callers dedupe on a lock with a double-check so at most one refresh
        runs (singleflight). Degradation contract: if the refresh fails
        (meter died between init and scrape) a stale snapshot, when one
        exists, is served with a warning — matching the reference's
        serve-stale-on-error stance; with no snapshot at all the failure
        surfaces as ``SnapshotUnavailableError`` so the collector can
        render a scrape error instead of a raw traceback.
        """
        snap = self._snapshot
        if snap is None or not self._is_fresh():
            with self._snapshot_lock:
                if not self._is_fresh():  # double-check under the lock
                    try:
                        self._refresh_locked()
                    except Exception as err:
                        if self._snapshot is None:
                            raise SnapshotUnavailableError(
                                f"first refresh failed: {err}") from err
                        log.warning("refresh failed (%s); serving stale "
                                    "snapshot", err)
            snap = self._snapshot
        assert snap is not None
        self._exported = True  # terminated data now consumable→clearable
        return snap.clone() if clone else snap

    def _is_fresh(self) -> bool:
        snap = self._snapshot
        if snap is None:
            return False
        return (self._clock() - snap.timestamp) <= self._staleness

    # -- refresh -----------------------------------------------------------

    def refresh(self) -> None:
        with self._snapshot_lock:
            self._refresh_locked()

    # keplint: hot-loop
    # keplint: requires-lock=_snapshot_lock
    def _refresh_locked(self) -> None:
        # the whole refresh is one telemetry CYCLE; the stage spans below
        # feed kepler_self_stage_duration_seconds and the /debug/traces
        # ring, and exceeding one interval counts a cycle overrun. Cycle
        # timing has ONE source of truth now — the span sink (which also
        # emits the "monitor.refresh done in …" debug log the old inline
        # perf_counter line used to).
        budget = self._interval if self._interval > 0 else None
        with telemetry.span("monitor.refresh", budget_s=budget):
            self._refresh_staged()

    # keplint: hot-loop
    # keplint: requires-lock=_snapshot_lock
    def _refresh_staged(self) -> None:
        now = self._clock()
        mono = self._monotonic()
        dt = (mono - self._last_read_ts
              if self._last_read_ts is not None else 0.0)
        self._last_read_ts = mono

        with telemetry.span("monitor.device_read"):
            zone_deltas, zone_valid = self._read_zone_deltas()
        with telemetry.span("monitor.resource_scan"):
            self._resources.refresh()
            batch = self._resources.feature_batch()

        with telemetry.span("monitor.attribute"):
            node6, energy_wz, power_wz = self._attribute(
                zone_deltas, zone_valid, batch, max(dt, 0.0))
            node = self._accumulate_node(node6, batch.usage_ratio)
            tables = self._accumulate_workloads(batch, energy_wz, power_wz)
            self._handle_terminated(tables)

        with telemetry.span("monitor.publish"):
            self._snapshot = Snapshot(
                timestamp=now,
                node=node,
                terminated_processes=self._trackers["processes"].items(),
                terminated_containers=self._trackers["containers"].items(),
                terminated_virtual_machines=self._trackers[
                    "virtual_machines"].items(),
                terminated_pods=self._trackers["pods"].items(),
                **tables,
            )
            self._data_event.set()
            if self._window_listeners:
                sample = WindowSample(
                    timestamp=now, dt_s=max(dt, 0.0),
                    zone_names=self._zone_names,
                    zone_deltas_uj=zone_deltas, zone_valid=zone_valid,
                    usage_ratio=batch.usage_ratio, batch=batch,
                )
                for listener in self._window_listeners:
                    try:
                        listener(sample)
                    except Exception:
                        log.exception("window listener failed")
        if self._state_path:
            with telemetry.span("monitor.persist"):
                self._persist_state(now)
        self._last_refresh_done = self._monotonic()
        if self._stalled:
            log.info("refresh loop recovered; clearing stall flag")
            self._stalled = False

    # keplint: hot-loop
    def _attribute(self, zone_deltas: np.ndarray, zone_valid: np.ndarray,
                   batch: FeatureBatch, dt: float
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The device leg: stage, one copy in, ``ops.attribute``, pack, one
        copy out → (node f64 [6, Z] as energy, active, idle, power,
        active power, idle power; workload energy f64 [w, Z]; workload
        power f64 [w, Z])."""
        w = batch.cpu_deltas.shape[0]
        pw = pad_to_bucket(w, self._bucket)
        z = len(self._zones)
        if self._stage_w != pw:
            pin = self._device.type == "cuda"
            self._stage_in = torch.zeros(2 * pw + 2 * z + 3,
                                         dtype=torch.float32, pin_memory=pin)
            self._stage_out = torch.empty((6 + 2 * pw) * z,
                                          dtype=torch.float32,
                                          pin_memory=pin)
            self._stage_w, self._stage_live = pw, 0
        buf = self._stage_in.numpy()
        cpu, valid = buf[:pw], buf[pw:2 * pw]
        cpu[:w] = batch.cpu_deltas
        valid[:w] = 1.0
        if self._stage_live > w:  # clear the shrunk tail only
            cpu[w:self._stage_live] = 0.0
            valid[w:self._stage_live] = 0.0
        self._stage_live = w
        # f64 → f32 rounds to nearest, as the reference's jnp casts do
        buf[2 * pw:2 * pw + z] = zone_deltas
        buf[2 * pw + z:2 * pw + 2 * z] = zone_valid
        buf[2 * pw + 2 * z:] = (batch.usage_ratio, batch.node_cpu_delta, dt)

        x = self._stage_in.to(self._device, non_blocking=True)
        tail = x[2 * pw:]
        result = attribute(tail[:z], tail[z:2 * z] != 0, tail[2 * z],
                           x[:pw], x[pw:2 * pw] != 0, tail[2 * z + 1],
                           tail[2 * z + 2])
        n = result.node
        packed = torch.cat([
            torch.stack([n.energy_uj, n.active_uj, n.idle_uj, n.power_uw,
                         n.active_power_uw, n.idle_power_uw]).reshape(-1),
            result.workloads.energy_uj[:w].reshape(-1),
            result.workloads.power_uw[:w].reshape(-1)])
        out = self._stage_out[:packed.numel()]
        out.copy_(packed, non_blocking=True)
        if self._device.type == "cuda":
            torch.cuda.current_stream(self._device).synchronize()
        host = out.numpy().astype(np.float64)  # f32 → f64 is exact
        return (host[:6 * z].reshape(6, z),
                host[6 * z:(6 + w) * z].reshape(w, z),
                host[(6 + w) * z:].reshape(w, z))

    def _zone_batch_plan(self):
        """(paths, per-zone slices) when EVERY zone supports batched raw
        reads AND the native library is present — else None. Computed once;
        one C call then replaces Z×(open+read+close) Python file reads per
        tick."""
        if self._batch_plan is not _UNSET:
            return self._batch_plan
        plan = None
        if not all(hasattr(z, "energy_paths") for z in self._zones):
            self._batch_plan = None  # fake/mock zones: no fast path
            return None
        try:
            from kepler_tpu_torch.native import scanner

            native = scanner()
            if native is not None:
                paths: list[str] = []
                slices: list[slice] = []
                for zone in self._zones:
                    zp = zone.energy_paths()
                    slices.append(slice(len(paths), len(paths) + len(zp)))
                    paths.extend(zp)
                if paths:
                    plan = (native, paths, slices)
        except Exception as err:  # native build failure etc.
            log.debug("no batched zone reads: %s", err)
            plan = None
        self._batch_plan = plan
        return plan

    # keplint: hot-loop
    def _read_zone_energies(self) -> list[int | None]:
        """Current raw counter per zone (None = failed read this tick)."""
        out: list[int | None] = []
        plan = self._zone_batch_plan()
        if plan is not None:
            native, paths, slices = plan
            raw = native.read_counters(paths)
            for zone, sl in zip(self._zones, slices):
                try:
                    out.append(int(zone.energy_from_raw(raw[sl].tolist())))
                except (OSError, ValueError) as err:
                    log.warning("zone %s read failed: %s", zone.name(), err)
                    out.append(None)
            return out
        for zone in self._zones:
            try:
                out.append(int(zone.energy()))
            except (OSError, ValueError) as err:
                log.warning("zone %s read failed: %s", zone.name(), err)
                out.append(None)
        return out

    # keplint: hot-loop
    # keplint: requires-lock=_snapshot_lock
    def _read_zone_deltas(self) -> tuple[np.ndarray, np.ndarray]:
        z = len(self._zones)
        deltas = np.zeros(z, np.float64)
        valid = np.zeros(z, bool)
        for i, (zone, current) in enumerate(
                zip(self._zones, self._read_zone_energies())):
            if current is not None:
                # chaos-harness injection points: a read error masks the
                # zone this window (exactly like a real failed read); a
                # counter wrap forces the wraparound-delta path
                if fault.fire("device.read_error") is not None:
                    log.warning("fault: injected read error on zone %s",
                                zone.name())
                    current = None
                else:
                    spec = fault.fire("device.counter_wrap")
                    if spec is not None:
                        current = int(spec.arg or 0) % max(
                            1, int(zone.max_energy()))
            if current is None:
                continue  # stays masked this window
            prev = self._prev_counters[i]
            self._prev_counters[i] = current
            if prev is None:
                continue  # first reading seeds only (reference firstNodeRead)
            deltas[i] = energy_delta(current, prev, int(zone.max_energy()))
            valid[i] = True
        return deltas, valid

    # -- counter-state persistence (restart without losing a window) -------

    @staticmethod
    def _boot_id() -> str:
        """Kernel boot identity: RAPL counters reset on reboot, so a
        baseline from a previous boot must never be adopted — the wrap
        math would read the reset as a wrap and fabricate up to a full
        counter range of energy. Empty when unreadable (non-Linux): the
        check then degrades to the staleness bound alone."""
        try:
            with open("/proc/sys/kernel/random/boot_id",
                      encoding="ascii") as fh:
                return fh.read().strip()
        except OSError:
            return ""

    # keplint: role-boundary — the per-refresh atomic write of the tiny
    # counter-state file IS the durability contract; local disk,
    # bounded size, failures never break refresh
    def _persist_state(self, now: float) -> None:
        """Write the raw counter baseline + wall anchor, atomically.

        No fsync: losing the newest state file on a power cut only means
        the next start seeds counters like a cold boot — correct, just
        one window poorer. Failures are logged and never break refresh."""
        from kepler_tpu_torch.utils.atomicio import atomic_write_json

        state = {"v": 1, "saved_at": now,
                 "boot_id": self._boot_id(),
                 "zone_names": list(self._zone_names),
                 "counters": list(self._prev_counters)}
        try:
            atomic_write_json(self._state_path, state)
        except OSError as err:
            log.warning("monitor state persist failed: %s", err)

    # called from init() before any other thread exists; the annotation
    # records that it writes the lock-guarded counter baseline
    # keplint: requires-lock=_snapshot_lock
    def _restore_state(self) -> None:
        """Adopt a fresh state file's counter baseline at startup.

        The restored counters make the FIRST refresh a real window (delta
        since the previous process's last reading — wrap-aware, because
        ``_read_zone_deltas`` already routes through ``energy_delta``),
        and the wall anchor back-dates the monotonic read timestamp so
        dt covers the restart gap. Anything suspicious — missing file,
        unparseable JSON, zone-set change, stale or future ``saved_at`` —
        is IGNORED with a warning: a state file must never be able to
        prevent startup, and a stale baseline would attribute energy from
        a long-dead window to the first post-restart one."""
        import json

        if not self._state_path:
            return
        try:
            with open(self._state_path, encoding="utf-8") as fh:
                state = json.load(fh)
        except FileNotFoundError:
            return
        except (OSError, ValueError) as err:
            log.warning("monitor state file unreadable (%s); seeding "
                        "counters from scratch", err)
            return
        try:
            if not isinstance(state, dict) or state.get("v") != 1:
                raise ValueError(f"unsupported version {state.get('v')!r}")
            saved_at = state["saved_at"]
            if isinstance(saved_at, bool) or not isinstance(
                    saved_at, (int, float)):
                raise ValueError("saved_at must be a number")
            zone_names = state["zone_names"]
            counters = state["counters"]
            if not (isinstance(zone_names, list)
                    and isinstance(counters, list)
                    and len(zone_names) == len(counters)):
                raise ValueError("zone_names/counters malformed")
            for c in counters:
                if c is not None and (isinstance(c, bool)
                                      or not isinstance(c, int) or c < 0):
                    raise ValueError(f"bad counter value {c!r}")
        except (ValueError, KeyError, TypeError) as err:
            log.warning("monitor state file invalid (%s); seeding "
                        "counters from scratch", err)
            return
        now = self._clock()
        age = now - float(saved_at)
        # state_max_age == 0 means unbounded (this codebase's 0-disables
        # convention, like aggregator.skewTolerance); negative age means
        # the wall clock stepped backwards — never trust that baseline
        if age < 0 or (self._state_max_age > 0
                       and age > self._state_max_age):
            log.warning("monitor state is %.1fs old (bound %.1fs); "
                        "seeding counters from scratch", age,
                        self._state_max_age)
            return
        if tuple(zone_names) != self._zone_names:
            log.warning("monitor state zone set %s != current %s; "
                        "seeding counters from scratch",
                        zone_names, list(self._zone_names))
            return
        saved_boot = state.get("boot_id", "")
        if saved_boot != self._boot_id():
            # a reboot inside stateMaxAge: the counters RESET, they did
            # not wrap — adopting the old baseline would fabricate up to
            # a full counter range of energy in the first window
            log.warning("monitor state is from a previous boot; "
                        "seeding counters from scratch")
            return
        self._prev_counters = [None if c is None else int(c)
                               for c in counters]
        # back-date the monotonic read anchor so the first window's dt
        # spans the restart (power = energy / dt must use the real gap)
        self._last_read_ts = self._monotonic() - age
        log.info("monitor state restored (age %.1fs): first window "
                 "attributes across the restart", age)

    def _accumulate_node(self, node6: np.ndarray,
                         usage_ratio: float) -> NodeUsage:
        energy, active, idle, power, active_power, idle_power = node6
        self._node_energy += energy
        self._node_active += active
        self._node_idle += idle
        return NodeUsage(
            zone_names=self._zone_names,
            energy_uj=self._node_energy.copy(),
            active_uj=self._node_active.copy(),
            idle_uj=self._node_idle.copy(),
            power_uw=power,
            active_power_uw=active_power,
            idle_power_uw=idle_power,
            window_active_uj=active,
            usage_ratio=float(usage_ratio),
        )

    @staticmethod
    def _process_meta(p) -> Mapping[str, str]:
        m = p.meta_cache
        if m is None:
            m = {"comm": p.comm, "exe": p.exe,
                 "type": ("container" if p.container else
                          "vm" if p.virtual_machine else "regular"),
                 "container_id": p.container.id if p.container else "",
                 "vm_id": (p.virtual_machine.id
                           if p.virtual_machine else "")}
            p.meta_cache = m
        return m

    @staticmethod
    def _container_meta(c) -> Mapping[str, str]:
        m = c.meta_cache
        if m is None:
            m = {"container_name": c.name, "runtime": c.runtime.value,
                 "pod_id": c.pod_id or ""}
            c.meta_cache = m
        return m

    @staticmethod
    def _vm_meta(v) -> Mapping[str, str]:
        m = v.meta_cache
        if m is None:
            m = {"vm_name": v.name, "hypervisor": v.hypervisor.value}
            v.meta_cache = m
        return m

    @staticmethod
    def _pod_meta(p) -> Mapping[str, str]:
        m = p.meta_cache
        if m is None:
            m = {"pod_name": p.name, "namespace": p.namespace}
            p.meta_cache = m
        return m

    def _meta_rows(self, kind: str) -> tuple[Mapping[str, str], ...]:
        """Label dicts for the running workloads of ``kind``, in informer
        view order (== feature-batch row order: both walk the same dicts).
        Dicts are cached on the objects and invalidated by the informer on
        identity changes; the whole tuple is reused between ticks while the
        informer's ``meta_gen`` and the view dict are unchanged."""
        res = self._resources
        if kind == "processes":
            running, f = res.processes().running, self._process_meta
        elif kind == "containers":
            running, f = res.containers().running, self._container_meta
        elif kind == "virtual_machines":
            running, f = res.virtual_machines().running, self._vm_meta
        else:
            # pods' running dict is rebuilt every tick — not cacheable by
            # identity, and small; always materialize
            return tuple(self._pod_meta(p)
                         for p in res.pods().running.values())
        gen = getattr(res, "meta_gen", None)
        if gen is None:
            return tuple(f(o) for o in running.values())
        # The cache entry holds a STRONG reference to the view dict and
        # validates it with ``is``: identity then guarantees membership
        # AND iteration order are unchanged (a dict is append-ordered and
        # the informer never reorders in place), while ``meta_gen``
        # covers in-place label mutations. An id()-based key would be
        # unsound on the legacy informer path, which builds a fresh dict
        # every tick — a recycled address plus an unchanged gen could
        # serve another membership's meta rows.
        cached = self._meta_rows_cache.get(kind)
        if (cached is not None and cached[0] == gen
                and cached[1] is running):
            return cached[2]
        rows = tuple(f(o) for o in running.values())
        self._meta_rows_cache[kind] = (gen, running, rows)
        return rows

    # keplint: hot-loop
    def _accumulate_workloads(self, batch: FeatureBatch,
                              energy_delta_wz: np.ndarray,
                              power_wz: np.ndarray
                              ) -> dict[str, WorkloadTable]:
        tables: dict[str, WorkloadTable] = {}
        kinds = batch.kinds
        offsets = batch.kind_offsets
        nz = len(self._zone_names)
        for k, (kind_name, kind_code) in enumerate(zip(_KINDS, _KIND_CODES)):
            if offsets is not None:
                sl = slice(offsets[k], offsets[k + 1])
                ids = tuple(batch.ids[sl])
                idx: slice | np.ndarray = sl
            else:
                nz_idx = np.nonzero(kinds == kind_code)[0]
                ids = tuple(batch.ids[i] for i in nz_idx)
                idx = nz_idx
            store = self._cumulative[kind_name]
            n = len(ids)
            power_rows = power_wz[idx] if n else np.zeros((0, nz))
            # PRECONDITION: ids within a kind are unique (they come from
            # dict-keyed informer views) — a duplicate would silently drop
            # one delta in the last-writer-wins scatter inside the store,
            # so fail loudly (not assert: -O must not change accounting).
            # The check is O(1) when the id tuple is unchanged (cached).
            if n:
                energy_rows = store.accumulate(ids, energy_delta_wz[idx])
            else:
                energy_rows = np.zeros((0, nz))
            meta_rows = self._meta_rows(kind_name)
            if len(meta_rows) != n:
                raise ValueError(
                    f"{kind_name}: feature batch has {n} rows but the "
                    f"informer view has {len(meta_rows)} — views and "
                    "batch must be built from the same refresh")
            seconds = None
            if kind_name == "processes" and batch.cpu_totals is not None:
                seconds = np.asarray(batch.cpu_totals[idx], np.float64)
            # terminated ids stay in the store until _handle_terminated
            # has captured their final cumulative values
            tables[kind_name] = WorkloadTable(
                ids=ids,
                meta=meta_rows,
                energy_uj=energy_rows,
                power_uw=power_rows,
                seconds=seconds,
            )
        return tables

    def _terminated_views(self) -> dict[str, WorkloadTable]:
        """Final cumulative usage of workloads that vanished this refresh.
        Labels come straight from the informer's terminated objects (their
        cached meta survives termination)."""
        res = self._resources
        views: dict[str, WorkloadTable] = {}
        term = {
            "processes": [(str(pid), p, self._process_meta)
                          for pid, p in res.processes().terminated.items()],
            "containers": [(cid, c, self._container_meta)
                           for cid, c in res.containers()
                           .terminated.items()],
            "virtual_machines": [(vid, v, self._vm_meta)
                                 for vid, v in res.virtual_machines()
                                 .terminated.items()],
            "pods": [(pid_, p, self._pod_meta)
                     for pid_, p in res.pods().terminated.items()],
        }
        nz = len(self._zone_names)
        for kind in _KINDS:
            store = self._cumulative[kind]
            rows = [(wid, obj, f) for wid, obj, f in term[kind]
                    if wid in store]
            ids = tuple(wid for wid, _, _ in rows)
            energy = (np.stack([store.value(wid) for wid in ids])
                      if ids else np.zeros((0, nz)))
            seconds = None
            if kind == "processes":
                seconds = np.asarray(
                    [obj.cpu_total_time for _, obj, _ in rows], np.float64)
            views[kind] = WorkloadTable(
                ids=ids,
                meta=tuple(f(obj) for _, obj, f in rows),
                energy_uj=energy,
                power_uw=np.zeros((len(ids), nz)),
                seconds=seconds,
            )
        return views

    # keplint: hot-loop
    def _handle_terminated(self, tables: dict[str, WorkloadTable]) -> None:
        """Clear-after-export then absorb this window's terminated workloads
        (reference refreshSnapshot: exported flag gates clearing)."""
        views = self._terminated_views()
        for kind in _KINDS:
            if self._exported:
                self._trackers[kind].clear()
            self._trackers[kind].add_batch(views[kind])
        if self._exported:
            self._exported = False
        # now that final values are tracked, drop them from the stores
        for kind in _KINDS:
            store = self._cumulative[kind]
            for wid in views[kind].ids:
                store.pop(wid)
