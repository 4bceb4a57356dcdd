"""Resource informer: per-interval workload discovery and delta accounting.

Reference parity: ``internal/resource/informer.go`` — scan all PIDs each
refresh; cache processes/containers/VMs/pods keyed by PID/ID; compute
CPU-time deltas vs cache; classify processes as container/VM (classification
cached; re-done only when a process's CPU delta is non-negligible,
``populateProcessFields`` :512); aggregate deltas hierarchically
proc → container → pod; detect terminated entities by set difference
(:167-221); compute node totals + usage ratio (:328-345).

Design: besides the object views (``processes()`` etc., same shape
as the reference API :49-66), every refresh also materializes a
``FeatureBatch`` — dense numpy columns (cpu_time_delta per workload, stable
row ids) that feed the device attribution without per-object Python
iteration. The fleet aggregator builds one per node report too, to advance
that node's feature history (``monitor.history``).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Callable, Mapping, Protocol, Sequence

import numpy as np

from kepler_tpu_torch.resource.container import container_info_from_proc
from kepler_tpu_torch.resource.procfs import ProcFSReader, ProcInfo, ProcReader
from kepler_tpu_torch.resource.types import (
    Container,
    Node,
    Pod,
    Process,
    VirtualMachine,
)
from kepler_tpu_torch.resource.vm import vm_info_from_proc

log = logging.getLogger("kepler.resource")

# Δcpu below this (seconds) skips re-classification (reference :512-558 —
# idle processes don't pay the cgroup/environ re-read).
_RECLASSIFY_EPSILON = 1e-9


class PodLookup(Protocol):
    """Pod-metadata join point (reference pod.Informer.LookupByContainerID)."""

    def lookup_by_container_id(
        self, container_id: str
    ) -> tuple[str, str, str, str] | None:
        """→ (pod_id, pod_name, namespace, container_name) or None."""
        ...


@dataclass
class Processes:
    running: dict[int, Process] = field(default_factory=dict)
    terminated: dict[int, Process] = field(default_factory=dict)


@dataclass
class Containers:
    running: dict[str, Container] = field(default_factory=dict)
    terminated: dict[str, Container] = field(default_factory=dict)


@dataclass
class VirtualMachines:
    running: dict[str, VirtualMachine] = field(default_factory=dict)
    terminated: dict[str, VirtualMachine] = field(default_factory=dict)


@dataclass
class Pods:
    running: dict[str, Pod] = field(default_factory=dict)
    terminated: dict[str, Pod] = field(default_factory=dict)
    containers_no_pod: list[str] = field(default_factory=list)


@dataclass
class FeatureBatch:
    """Dense per-workload feature columns for one refresh window.

    Row order is stable for the lifetime of a workload (rows are appended on
    first sight and compacted on termination), so downstream per-row energy
    accumulators can be gathered/scattered by index on device. Rows are
    kind-major: all processes, then containers, then VMs, then pods
    (``kind_offsets`` marks the boundaries).
    """

    kinds: np.ndarray  # int8 [W]: 0=process 1=container 2=vm 3=pod
    ids: list[str]  # [W] workload ids (str(pid) for processes)
    cpu_deltas: np.ndarray  # f32 [W] seconds
    node_cpu_delta: float  # Σ process deltas (attribution denominator)
    usage_ratio: float  # node active/total CPU ratio
    # cumulative CPU seconds per row (f64; the process rows back
    # kepler_process_cpu_seconds_total). Optional: wire payloads omit it.
    cpu_totals: np.ndarray | None = None
    # kind-major boundaries: (0, P, P+C, P+C+V, W). Optional convenience;
    # derivable from ``kinds``.
    kind_offsets: tuple[int, int, int, int, int] | None = None

    KIND_PROCESS = 0
    KIND_CONTAINER = 1
    KIND_VM = 2
    KIND_POD = 3


class _ArrayState:
    """Row-aligned numpy state for the batched (native-scan) tick path.

    The authoritative per-PID numbers live in arrays; ``Process`` objects
    are the metadata view, touched only for rows whose numbers changed.
    Group indices (proc row → container/VM slot) turn the hierarchical
    delta rollups into ``np.bincount`` calls.
    """

    __slots__ = ("pids", "cpu", "deltas", "active", "procs", "running",
                 "pid_rows", "ids", "cont_idx", "vm_idx", "cont_slots",
                 "cont_rows", "cont_members", "cont_delta", "cont_total",
                 "cont_ids", "cont_running", "vm_slots", "vm_rows",
                 "vm_members", "vm_delta", "vm_total", "vm_ids",
                 "vm_running", "kinds", "kind_offsets")

    def __init__(self) -> None:
        self.pids = np.zeros(0, np.int32)  # [P] row-aligned scan order
        self.cpu = np.zeros(0, np.float64)  # [P] cumulative seconds
        self.deltas = np.zeros(0, np.float64)  # [P] this window
        self.active = np.zeros(0, bool)  # [P] delta > eps last window
        self.procs: list[Process] = []  # [P]
        self.running: dict[int, Process] = {}
        self.pid_rows: dict[int, int] = {}
        self.ids: list[str] = []  # [P] str(pid), cached
        # container grouping
        self.cont_idx = np.zeros(0, np.int32)  # [P] row → slot | -1
        self.cont_slots: list[Container] = []
        self.cont_rows: dict[str, int] = {}
        self.cont_members = np.zeros(0, np.int64)  # [C] live member procs
        self.cont_delta = np.zeros(0, np.float64)  # [C] this window
        self.cont_total = np.zeros(0, np.float64)  # [C] Σ deltas
        self.cont_ids: list[str] = []
        self.cont_running: dict[str, Container] = {}
        # VM grouping
        self.vm_idx = np.zeros(0, np.int32)
        self.vm_slots: list[VirtualMachine] = []
        self.vm_rows: dict[str, int] = {}
        self.vm_members = np.zeros(0, np.int64)
        self.vm_delta = np.zeros(0, np.float64)
        self.vm_total = np.zeros(0, np.float64)
        self.vm_ids: list[str] = []
        self.vm_running: dict[str, VirtualMachine] = {}
        # cached kind-major arrays for feature_batch (rebuilt on
        # membership change)
        self.kinds: np.ndarray | None = None
        self.kind_offsets: tuple[int, int, int, int, int] | None = None


class ResourceInformer:
    def __init__(
        self,
        reader: ProcReader | None = None,
        procfs_path: str = "/proc",
        pod_lookup: PodLookup | None = None,
        clock: Callable[[], float] | None = None,
    ) -> None:
        import time as _time

        self._fs: ProcReader = reader or ProcFSReader(procfs_path)
        self._pod_lookup = pod_lookup
        self._clock = clock or _time.time
        self._node = Node()
        self._proc_cache: dict[int, Process] = {}
        self._container_cache: dict[str, Container] = {}
        self._vm_cache: dict[str, VirtualMachine] = {}
        self._pod_cache: dict[str, Pod] = {}
        self._processes = Processes()
        self._containers = Containers()
        self._vms = VirtualMachines()
        self._pods = Pods()
        self._last_scan: float | None = None
        self._arr: _ArrayState | None = None
        # bumped whenever any workload's exporter labels may have changed
        # (comm/exec, classification, pod binding, membership) — lets the
        # monitor cache its per-kind meta tuples between ticks
        self.meta_gen = 0

    def name(self) -> str:
        return "resource-informer"

    def init(self) -> None:
        """Probe the proc reader once (reference Init :155)."""
        list(self._fs.all_procs())

    # -- accessors (reference informer.go:49-66) --------------------------

    def node(self) -> Node:
        return self._node

    def processes(self) -> Processes:
        return self._processes

    def containers(self) -> Containers:
        return self._containers

    def virtual_machines(self) -> VirtualMachines:
        return self._vms

    def pods(self) -> Pods:
        return self._pods

    # -- refresh ----------------------------------------------------------

    # keplint: role-boundary — reading /proc IS this component's
    # measurement seam (the meter analog); it keeps its own I/O budget
    # contract rather than inheriting the hot-loop blocking ban
    def refresh(self) -> None:
        """One full scan: processes first, then container/VM/pod rollups and
        node totals (reference Refresh :349-410 runs the rollups in three
        goroutines; they are independent dict walks, sequential here — the
        scan itself dominates)."""
        self._refresh_processes()
        self._refresh_containers()
        self._refresh_vms()
        self._refresh_pods()
        self._refresh_node()
        self._last_scan = self._clock()

    def _refresh_processes(self) -> None:
        scan = getattr(self._fs, "scan_arrays", None)
        if scan is not None:
            pids, cpus, comms = scan()
            self._refresh_from_arrays(
                np.ascontiguousarray(pids, np.int32),
                np.ascontiguousarray(cpus, np.float64),
                np.asarray(comms) if comms is not None else None)
            return
        self._arr = None
        running = {}
        for proc in self._fs.all_procs():
            try:
                entry = self._update_process_cache(proc)
            except OSError:
                continue  # PID vanished mid-scan (reference :186-190)
            except (ValueError, IndexError):
                continue  # truncated/garbage stat line mid-exit
            running[entry.pid] = entry
        terminated = {
            pid: p for pid, p in self._proc_cache.items() if pid not in running
        }
        for pid in terminated:
            del self._proc_cache[pid]
        self._processes = Processes(running=running, terminated=terminated)

    # -- batched (array) tick path ----------------------------------------

    def _refresh_from_arrays(self, pids: np.ndarray, cpus: np.ndarray,
                             comms: np.ndarray | None) -> None:
        """Tick path for readers with a batched scan (``scan_arrays``):
        the per-PID numbers live in row-aligned arrays and the steady
        state is pure numpy — ``Process`` objects are touched only for
        rows whose delta changed (comm updates come free from the scan's
        stat parse). Membership changes fall into :meth:`_rebuild_rows`,
        which batch-classifies all first-sight PIDs in one threaded
        native read."""
        st = self._arr
        if (st is None or len(st.pids) != len(pids)
                or not np.array_equal(st.pids, pids)):
            self._rebuild_rows(pids, cpus, comms)
            return
        deltas = cpus - st.cpu
        # counter REGRESSION (pid reuse): the clamp hides the drop from
        # the delta, but the object's total must still follow the
        # kernel's current value — the exporter renders
        # process_cpu_seconds_total from the object view, and the legacy
        # path refreshes it every tick (parity pinned by the dual-path
        # fuzz in tests/test_resource.py, which caught this diverging)
        regressed = np.flatnonzero(deltas < 0.0)
        np.maximum(deltas, 0.0, out=deltas)
        active = deltas > _RECLASSIFY_EPSILON
        changed = np.flatnonzero(active)
        went_idle = np.flatnonzero(st.active & ~active)
        self._touch_changed(st.procs, changed.tolist(), deltas, cpus, comms,
                            pids)
        procs = st.procs
        for i in regressed.tolist():
            procs[i].cpu_time_delta = 0.0
            procs[i].cpu_total_time = float(cpus[i])
        for i in went_idle.tolist():
            procs[i].cpu_time_delta = 0.0
        st.cpu = cpus
        st.deltas = deltas
        st.active = active
        self._processes = Processes(running=st.running, terminated={})
        self._proc_cache = st.running

    def _touch_changed(self, procs: list[Process], rows: list[int],
                       deltas: np.ndarray, cpus: np.ndarray,
                       comms: np.ndarray | None, pids: np.ndarray) -> None:
        """Write numbers (and any changed comm) onto the object views of
        rows whose CPU delta is nonzero this tick."""
        if comms is not None:
            for i in rows:
                p = procs[i]
                p.cpu_time_delta = float(deltas[i])
                p.cpu_total_time = float(cpus[i])
                cb = comms[i]
                if cb != p.comm_raw:
                    # exec changes comm; the label block must re-render
                    p.comm_raw = cb
                    p.comm = cb.decode("utf-8", "replace")
                    p.meta_cache = None
                    self.meta_gen += 1
            return
        proc_info = getattr(self._fs, "proc_info", None)
        for i in rows:
            p = procs[i]
            p.cpu_time_delta = float(deltas[i])
            p.cpu_total_time = float(cpus[i])
            if proc_info is None:
                continue
            try:
                new_comm = proc_info(int(pids[i])).comm()
            except (OSError, ValueError, IndexError):
                continue  # mid-exit garbage: keep cached identity
            if new_comm != p.comm:
                p.comm = new_comm
                p.meta_cache = None
                self.meta_gen += 1

    def _rebuild_rows(self, pids: np.ndarray, cpus: np.ndarray,
                      comms: np.ndarray | None) -> None:
        """Membership/order changed: re-align row state, batch-classify
        first-sight PIDs, detect terminated ones, rebuild group indices."""
        st_old = self._arr
        n = len(pids)
        pid_list = pids.tolist()
        old_rows = st_old.pid_rows if st_old is not None else {}
        old_procs = st_old.procs if st_old is not None else []
        get = old_rows.get
        prev_row = [get(p, -1) for p in pid_list]
        prev_row_np = np.asarray(prev_row, np.int64) if n else np.zeros(
            0, np.int64)
        known = prev_row_np >= 0
        procs: list[Process | None] = [None] * n
        new_idx: list[int] = []
        for i, r in enumerate(prev_row):
            if r >= 0:
                procs[i] = old_procs[r]
            else:
                new_idx.append(i)
        created = self._create_processes_batch(
            [pid_list[i] for i in new_idx],
            ([comms[i] for i in new_idx] if comms is not None
             else [None] * len(new_idx)),
            [float(cpus[i]) for i in new_idx])
        keep = np.ones(n, bool)
        for i, obj in zip(new_idx, created):
            if obj is None:
                keep[i] = False  # vanished between scan and classify
            else:
                procs[i] = obj
        # deltas: first sight counts its whole total as this window's
        # delta (legacy/reference semantics); known rows diff the cache
        deltas = cpus.copy()
        regressed = np.zeros(n, bool)
        if st_old is not None:
            kr = prev_row_np[known]
            raw = cpus[known] - st_old.cpu[kr]
            deltas[known] = np.maximum(raw, 0.0)
            regressed[known] = raw < 0.0
        active = deltas > _RECLASSIFY_EPSILON
        self._touch_changed(procs, np.flatnonzero(known & active).tolist(),
                            deltas, cpus, comms, pids)
        # counter regression (pid reuse): totals follow the kernel even
        # though the clamped delta is 0 — see _refresh_from_arrays
        for i in np.flatnonzero(regressed).tolist():
            procs[i].cpu_time_delta = 0.0
            procs[i].cpu_total_time = float(cpus[i])
        if st_old is not None:
            was_active = np.zeros(n, bool)
            was_active[known] = st_old.active[prev_row_np[known]]
            for i in np.flatnonzero(was_active & ~active).tolist():
                procs[i].cpu_time_delta = 0.0
        # terminated = old rows never matched by the new scan
        seen = np.zeros(len(old_procs), bool)
        if st_old is not None:
            seen[prev_row_np[known]] = True
        terminated = {pid: old_procs[r] for pid, r in old_rows.items()
                      if not seen[r]}
        if not bool(keep.all()):
            sel = np.flatnonzero(keep)
            pids = pids[sel]
            cpus = cpus[sel]
            deltas = deltas[sel]
            active = active[sel]
            procs = [procs[i] for i in sel.tolist()]
            pid_list = pids.tolist()
        st = _ArrayState()
        st.pids = pids
        st.cpu = cpus
        st.deltas = deltas
        st.active = active
        st.procs = procs  # type: ignore[assignment]
        st.running = dict(zip(pid_list, procs))
        st.pid_rows = {pid: i for i, pid in enumerate(pid_list)}
        st.ids = list(map(str, pid_list))
        self._build_groups(st, st_old)
        self._arr = st
        self.meta_gen += 1  # membership changed
        self._processes = Processes(running=st.running,
                                    terminated=terminated)
        self._proc_cache = st.running

    def _create_processes_batch(
            self, pids: list[int], comms: list, cpus: list[float]
    ) -> list[Process | None]:
        """Create+classify first-sight processes. With a native reader the
        cgroup/cmdline/environ/exe reads for ALL new PIDs happen in a few
        threaded C calls (chunked to bound transient memory), so churn
        bursts — a mass pod reschedule — stay off the per-file Python
        path. None entries mark PIDs that vanished before classification."""
        out: list[Process | None] = [None] * len(pids)
        if not pids:
            return out
        read_files = getattr(self._fs, "read_proc_files", None)
        read_links = getattr(self._fs, "read_proc_links", None)
        if read_files is None or read_links is None:
            proc_info = self._fs.proc_info
            for j, pid in enumerate(pids):
                try:
                    info = proc_info(pid)
                    comm_b = comms[j]
                    comm = (comm_b.decode("utf-8", "replace")
                            if comm_b else info.comm())
                    p = Process(pid=pid, comm=comm, exe=info.executable(),
                                cpu_total_time=cpus[j],
                                cpu_time_delta=cpus[j],
                                comm_raw=comm_b or b"")
                    self._classify(info, p)
                except (OSError, ValueError, IndexError):
                    continue  # vanished mid-scan / mid-exit garbage
                out[j] = p
            return out
        chunk = 512  # bounds transient content buffers (~24 MB/chunk)
        for lo in range(0, len(pids), chunk):
            hi = min(lo + chunk, len(pids))
            batch = pids[lo:hi]
            rels = ([f"{pid}/cgroup" for pid in batch]
                    + [f"{pid}/cmdline" for pid in batch]
                    + [f"{pid}/environ" for pid in batch])
            try:
                contents = read_files(rels)
                exes = read_links([f"{pid}/exe" for pid in batch])
            except OSError:
                contents = [None] * (3 * len(batch))
                exes = [None] * len(batch)
            k = len(batch)
            for j, pid in enumerate(batch):
                cg, cmd, env_raw = (contents[j], contents[k + j],
                                    contents[2 * k + j])
                # a content that exactly fills its slot was truncated
                # (kubelet-injected environs and java classpaths routinely
                # exceed any fixed cap) — re-read that file unbatched so
                # the container-name labels never depend on which reader
                # path classified the workload
                cmd = self._reread_if_truncated(pid, "cmdline", cmd)
                env_raw = self._reread_if_truncated(pid, "environ", env_raw)
                cg = self._reread_if_truncated(pid, "cgroup", cg)
                exe = exes[j]
                if cg is None and cmd is None and env_raw is None \
                        and exe is None:
                    continue  # vanished between scan and classification
                try:
                    out[lo + j] = self._process_from_contents(
                        pid, comms[lo + j], cpus[lo + j], cg, cmd, env_raw,
                        exe)
                except (ValueError, IndexError):
                    continue  # truncated/garbage content mid-exit
        return out

    # fallback slot size when the reader doesn't expose its own cap; a
    # content of exactly cap-1 bytes means ReadSmallFile hit the slot end
    _BATCH_FILE_CAP = 16384

    def _reread_if_truncated(self, pid: int, name: str,
                             content: bytes | None) -> bytes | None:
        # derive the threshold from the READER's actual cap so a changed
        # per_cap default can't silently disable truncation detection
        cap = getattr(self._fs, "batch_read_cap", self._BATCH_FILE_CAP)
        if content is None or len(content) < cap - 1:
            return content
        procfs = getattr(self._fs, "_procfs", "/proc")
        try:
            with open(f"{procfs}/{pid}/{name}", "rb") as f:
                return f.read()
        except OSError:
            return content

    def _process_from_contents(self, pid: int, comm_b, cpu: float,
                               cg: bytes | None, cmd: bytes | None,
                               env_raw: bytes | None,
                               exe: str | None) -> Process:
        from kepler_tpu_torch.resource.container import (
            container_info_from_cgroup_paths, container_name)
        from kepler_tpu_torch.resource.procfs import (parse_cgroup_text,
                                                parse_cmdline_bytes,
                                                parse_environ_bytes)
        from kepler_tpu_torch.resource.types import Container
        from kepler_tpu_torch.resource.vm import vm_info_from_cmdline

        paths = (parse_cgroup_text(cg.decode("utf-8", "replace"))
                 if cg else [])
        cmdline = parse_cmdline_bytes(cmd) if cmd else []
        container = vm = None
        if paths:
            runtime, cid = container_info_from_cgroup_paths(paths)
            if cid:
                env = parse_environ_bytes(env_raw) if env_raw else {}
                container = Container(
                    id=cid, name=container_name(env, cmdline, cid),
                    runtime=runtime)
        if container is None:
            vm = vm_info_from_cmdline(cmdline)
        comm_b = comm_b or b""
        return Process(pid=pid, comm=comm_b.decode("utf-8", "replace"),
                       exe=exe or "", cpu_total_time=cpu,
                       cpu_time_delta=cpu, container=container,
                       virtual_machine=vm, classified=True,
                       comm_raw=comm_b)

    def _build_groups(self, st: _ArrayState,
                      st_old: _ArrayState | None) -> None:
        """Container/VM slot tables + per-row group indices. Slots carry
        the accumulated totals forward from the previous state (the array
        analog of the legacy ``_container_cache``); slots whose ids vanish
        are recorded as terminated by the rollup refreshes."""
        n = len(st.procs)
        cont_idx = np.full(n, -1, np.int32)
        vm_idx = np.full(n, -1, np.int32)
        old_cont = st_old.cont_rows if st_old is not None else {}
        old_vm = st_old.vm_rows if st_old is not None else {}
        for i, p in enumerate(st.procs):
            c = p.container
            if c is not None:
                slot = st.cont_rows.get(c.id)
                if slot is None:
                    slot = len(st.cont_slots)
                    old = old_cont.get(c.id)
                    if old is not None:
                        entry = st_old.cont_slots[old]  # carries totals
                    else:
                        entry = c.clone()
                        entry.cpu_total_time = 0.0
                        entry.cpu_time_delta = 0.0
                        entry.meta_cache = None
                    st.cont_rows[c.id] = slot
                    st.cont_slots.append(entry)
                cont_idx[i] = slot
                continue
            v = p.virtual_machine
            if v is not None:
                slot = st.vm_rows.get(v.id)
                if slot is None:
                    slot = len(st.vm_slots)
                    old = old_vm.get(v.id)
                    if old is not None:
                        entry = st_old.vm_slots[old]
                    else:
                        entry = v.clone()
                        entry.cpu_total_time = 0.0
                        entry.cpu_time_delta = 0.0
                        entry.meta_cache = None
                    st.vm_rows[v.id] = slot
                    st.vm_slots.append(entry)
                vm_idx[i] = slot
        st.cont_idx = cont_idx
        st.vm_idx = vm_idx
        c_n = len(st.cont_slots)
        v_n = len(st.vm_slots)
        st.cont_members = np.bincount(cont_idx[cont_idx >= 0],
                                      minlength=c_n).astype(np.int64)
        st.vm_members = np.bincount(vm_idx[vm_idx >= 0],
                                    minlength=v_n).astype(np.int64)
        st.cont_delta = np.array(
            [st_old.cont_delta[old_cont[c.id]]
             if st_old is not None and c.id in old_cont else 0.0
             for c in st.cont_slots])
        st.cont_total = np.array([c.cpu_total_time for c in st.cont_slots])
        st.vm_delta = np.array(
            [st_old.vm_delta[old_vm[v.id]]
             if st_old is not None and v.id in old_vm else 0.0
             for v in st.vm_slots])
        st.vm_total = np.array([v.cpu_total_time for v in st.vm_slots])
        st.cont_ids = [c.id for c in st.cont_slots]
        st.vm_ids = [v.id for v in st.vm_slots]
        st.cont_running = dict(zip(st.cont_ids, st.cont_slots))
        st.vm_running = dict(zip(st.vm_ids, st.vm_slots))
        st.kinds = None  # feature_batch rebuilds its cached prefix

    def _update_process_cache(self, proc: ProcInfo) -> Process:
        pid = proc.pid()
        cpu = proc.cpu_time()
        cached = self._proc_cache.get(pid)
        if cached is None:
            cached = Process(pid=pid, comm=proc.comm(),
                             exe=proc.executable(),
                             cpu_total_time=cpu, cpu_time_delta=cpu)
            self._classify(proc, cached)
            self._proc_cache[pid] = cached
            return cached
        delta = max(cpu - cached.cpu_total_time, 0.0)
        cached.cpu_time_delta = delta
        cached.cpu_total_time = cpu
        if delta > _RECLASSIFY_EPSILON:
            # cheap refresh of mutable identity (comm changes on exec);
            # classification itself is cached — the cgroup/environ/cmdline
            # reads run once per PID, not per tick
            try:
                new_comm = proc.comm()
            except OSError:
                new_comm = cached.comm
            if new_comm != cached.comm:
                cached.comm = new_comm
                cached.meta_cache = None
                self.meta_gen += 1
            if not cached.classified:
                self._classify(proc, cached)
        return cached

    def _classify(self, proc: ProcInfo, entry: Process) -> None:
        """Container-vs-VM detection (reference computeTypeInfoFromProc :560
        fans the two regex passes to two goroutines; both are sub-µs host
        work here)."""
        entry.container = container_info_from_proc(proc)
        if entry.container is None:
            entry.virtual_machine = vm_info_from_proc(proc)
        entry.classified = True

    def _refresh_containers(self) -> None:
        st = self._arr
        if st is not None:
            # vectorized rollup: one bincount over the proc rows; objects
            # are touched only where this or last window's delta ≠ 0
            c_n = len(st.cont_slots)
            if c_n:
                mask = st.cont_idx >= 0
                cd = np.bincount(st.cont_idx[mask],
                                 weights=st.deltas[mask], minlength=c_n)
            else:
                cd = np.zeros(0)
            st.cont_total = st.cont_total + cd
            for i in np.flatnonzero((cd > 0) | (st.cont_delta > 0)).tolist():
                c = st.cont_slots[i]
                c.cpu_time_delta = float(cd[i])
                c.cpu_total_time = float(st.cont_total[i])
            st.cont_delta = cd
            terminated = {
                cid: c for cid, c in self._container_cache.items()
                if cid not in st.cont_running
            }
            self._container_cache = st.cont_running
            self._containers = Containers(running=st.cont_running,
                                          terminated=terminated)
            return
        running: dict[str, Container] = {}
        for p in self._processes.running.values():
            if p.container is None:
                continue
            cid = p.container.id
            entry = running.get(cid)
            if entry is None:
                cached = self._container_cache.get(cid)
                if cached is None:
                    cached = p.container.clone()
                    cached.cpu_total_time = 0.0
                    self._container_cache[cid] = cached
                entry = cached
                entry.cpu_time_delta = 0.0
                running[cid] = entry
            # hierarchical delta rollup (reference updateContainerCache :469)
            entry.cpu_time_delta += p.cpu_time_delta
            entry.cpu_total_time += p.cpu_time_delta
        terminated = {
            cid: c
            for cid, c in self._container_cache.items()
            if cid not in running
        }
        for cid in terminated:
            del self._container_cache[cid]
        self._containers = Containers(running=running, terminated=terminated)

    def _refresh_vms(self) -> None:
        st = self._arr
        if st is not None:
            v_n = len(st.vm_slots)
            if v_n:
                mask = st.vm_idx >= 0
                vd = np.bincount(st.vm_idx[mask],
                                 weights=st.deltas[mask], minlength=v_n)
            else:
                vd = np.zeros(0)
            st.vm_total = st.vm_total + vd
            for i in np.flatnonzero((vd > 0) | (st.vm_delta > 0)).tolist():
                v = st.vm_slots[i]
                v.cpu_time_delta = float(vd[i])
                v.cpu_total_time = float(st.vm_total[i])
            st.vm_delta = vd
            terminated = {
                vid: v for vid, v in self._vm_cache.items()
                if vid not in st.vm_running
            }
            self._vm_cache = st.vm_running
            self._vms = VirtualMachines(running=st.vm_running,
                                        terminated=terminated)
            return
        running: dict[str, VirtualMachine] = {}
        for p in self._processes.running.values():
            if p.virtual_machine is None:
                continue
            vid = p.virtual_machine.id
            entry = running.get(vid)
            if entry is None:
                cached = self._vm_cache.get(vid)
                if cached is None:
                    cached = p.virtual_machine.clone()
                    cached.cpu_total_time = 0.0
                    self._vm_cache[vid] = cached
                entry = cached
                entry.cpu_time_delta = 0.0
                running[vid] = entry
            entry.cpu_time_delta += p.cpu_time_delta
            entry.cpu_total_time += p.cpu_time_delta
        terminated = {
            vid: v for vid, v in self._vm_cache.items() if vid not in running
        }
        for vid in terminated:
            del self._vm_cache[vid]
        self._vms = VirtualMachines(running=running, terminated=terminated)

    def _refresh_pods(self) -> None:
        running: dict[str, Pod] = {}
        no_pod: list[str] = []
        for c in self._containers.running.values():
            info = None
            if self._pod_lookup is not None:
                info = self._pod_lookup.lookup_by_container_id(c.id)
            if info is None:
                if c.pod_id is not None:
                    c.pod_id = None
                    c.meta_cache = None
                    self.meta_gen += 1
                no_pod.append(c.id)
                continue
            pod_id, pod_name, namespace, container_name = info
            if c.pod_id != pod_id:
                c.pod_id = pod_id
                c.meta_cache = None
                self.meta_gen += 1
            if container_name and (not c.name or c.name == c.id[:12]):
                if c.name != container_name:
                    c.name = container_name
                    c.meta_cache = None
                    self.meta_gen += 1
            entry = running.get(pod_id)
            if entry is None:
                cached = self._pod_cache.get(pod_id)
                if cached is None:
                    cached = Pod(id=pod_id, name=pod_name, namespace=namespace)
                self._pod_cache[pod_id] = cached
                entry = cached
                entry.cpu_time_delta = 0.0
                running[pod_id] = entry
            entry.cpu_time_delta += c.cpu_time_delta
            entry.cpu_total_time += c.cpu_time_delta
        terminated = {
            pid_: p for pid_, p in self._pod_cache.items() if pid_ not in running
        }
        for pid_ in terminated:
            del self._pod_cache[pid_]
        self._pods = Pods(running=running, terminated=terminated,
                          containers_no_pod=no_pod)

    def _refresh_node(self) -> None:
        # running processes only: a terminated process's delta was already
        # attributed in the window it ran (reference informer.go:328-345);
        # re-adding it would deflate every running workload's ratio and
        # break Σ workload == node active conservation
        st = self._arr
        if st is not None:
            total_delta = float(st.deltas.sum())
        else:
            total_delta = sum(
                p.cpu_time_delta for p in self._processes.running.values()
            )
        self._node = Node(
            cpu_usage_ratio=self._fs.cpu_usage_ratio(),
            process_total_cpu_time_delta=total_delta,
        )

    # -- feature batch (the dense output) ---------------------------------

    def feature_batch(self) -> FeatureBatch:
        """Dense columns over all running workloads, in kind-major order."""
        st = self._arr
        if st is not None:
            p_n, c_n, v_n = len(st.ids), len(st.cont_ids), len(st.vm_ids)
            pod_ids = list(self._pods.running)
            pod_objs = self._pods.running.values()
            pod_deltas = np.fromiter(
                (p.cpu_time_delta for p in pod_objs), np.float64,
                len(pod_ids))
            pod_totals = np.fromiter(
                (p.cpu_total_time for p in self._pods.running.values()),
                np.float64, len(pod_ids))
            if st.kinds is None or st.kind_offsets[4] != (
                    p_n + c_n + v_n + len(pod_ids)):
                st.kind_offsets = (0, p_n, p_n + c_n, p_n + c_n + v_n,
                                   p_n + c_n + v_n + len(pod_ids))
                st.kinds = np.repeat(
                    np.arange(4, dtype=np.int8),
                    [p_n, c_n, v_n, len(pod_ids)])
            return FeatureBatch(
                kinds=st.kinds,
                ids=st.ids + st.cont_ids + st.vm_ids + pod_ids,
                cpu_deltas=np.concatenate(
                    [st.deltas, st.cont_delta, st.vm_delta,
                     pod_deltas]).astype(np.float32),
                node_cpu_delta=float(
                    self._node.process_total_cpu_time_delta),
                usage_ratio=float(self._node.cpu_usage_ratio),
                cpu_totals=np.concatenate(
                    [st.cpu, st.cont_total, st.vm_total, pod_totals]),
                kind_offsets=st.kind_offsets,
            )
        kinds: list[int] = []
        ids: list[str] = []
        deltas: list[float] = []
        totals: list[float] = []

        def extend(kind: int, items: Mapping, key=str) -> None:
            for k, wl in items.items():
                kinds.append(kind)
                ids.append(key(k))
                deltas.append(wl.cpu_time_delta)
                totals.append(wl.cpu_total_time)

        extend(FeatureBatch.KIND_PROCESS, self._processes.running)
        extend(FeatureBatch.KIND_CONTAINER, self._containers.running)
        extend(FeatureBatch.KIND_VM, self._vms.running)
        extend(FeatureBatch.KIND_POD, self._pods.running)
        p_n = len(self._processes.running)
        c_n = len(self._containers.running)
        v_n = len(self._vms.running)
        return FeatureBatch(
            kinds=np.asarray(kinds, dtype=np.int8),
            ids=ids,
            cpu_deltas=np.asarray(deltas, dtype=np.float32),
            node_cpu_delta=float(self._node.process_total_cpu_time_delta),
            usage_ratio=float(self._node.cpu_usage_ratio),
            cpu_totals=np.asarray(totals, dtype=np.float64),
            kind_offsets=(0, p_n, p_n + c_n, p_n + c_n + v_n, len(ids)),
        )
