"""Device-resident fleet windows: the aggregator's hot-path engines.

The counterpart of ``kepler_tpu.fleet.window``. The
serial window cycle (assemble → one big H2D → run → fetch) pays three
costs every interval that these engines remove:

* **Re-allocation + full H2D per window.** The padded packed batch is kept
  RESIDENT on the device. Each window, only the rows of nodes whose report
  changed since the last window are re-packed on the host and
  scatter-updated IN PLACE into the resident tensor — the port's form of
  the JAX engine's donated update. A buffer that a window still reads is
  never rewritten: the resident batch rotates over a ring of
  ``staging_slots`` device buffers, and every launch is ordered on one
  CUDA stream.

* **Rebuilds on fleet growth.** Padded shapes come from
  :class:`BucketLadder`\\ s: buckets grow geometrically and only SHRINK
  after ``shrink_after`` consecutive windows at under half occupancy.
  Programs are cached per (node-bucket, workload-bucket, zones, mode) key;
  a cache miss counts as a compile (``compile_count``), and the first
  launch of a key — which builds its CUDA kernels on first use — runs
  inside a ``window.compile`` span.

* **Dense mixed-fleet evaluation.** With a model mode set on the einsum
  backend, the packed program runs the estimator only on the MODE_MODEL
  rows (``parallel.packed``'s sparse variant).

Host staging: on a CUDA device the staged delta rows sit in pinned host
memory and upload with ``non_blocking=True``. The staging slots rotate,
and a slot is rewritten only after the event recorded behind its last
upload has completed, so an async copy never reads a half-rewritten slot.

Sharding: :class:`ShardedWindowEngine` spreads the resident batch over
a 1-D node mesh (``parallel.mesh``) — each shard keeps its own ring, its
own staging and its own launches, with sticky node→shard assignment —
and :class:`MultiHostWindowEngine` narrows that to the shards of this
process, agreeing bucket needs with the other processes
(:class:`HostLocalFabric` stands in for them in one process). The
unsharded engines (:class:`PackedWindowEngine`, :class:`FusedWindowEngine`)
take a mesh too: a 2-D ``node × model`` mesh, or the fused tier's full
mesh, cuts their resident batch into one block per node row, each on its
row's first shard's device, as the reference's node sharding does.

The engines own no locks and no HTTP. Entry points take ``device="cuda"``
(or a mesh of CUDA shards) by default and raise when CUDA is absent;
``device="cpu"`` runs the same engines with the kernels' plain versions
(the tests).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable, Mapping, NamedTuple, Sequence

import numpy as np
import torch

from kepler_tpu_torch import fault, telemetry
from kepler_tpu_torch.device import resolve_device
from kepler_tpu_torch.models.estimator import params_to
from kepler_tpu_torch.parallel.fleet import (MODE_MODEL, NodeReport,
                                             assemble_fleet_batch)
from kepler_tpu_torch.parallel.mesh import NODE_AXIS, Mesh
from kepler_tpu_torch.parallel.mesh import process_index as _process_index

__all__ = [
    "BucketLadder",
    "DeviceWindowError",
    "FusedFlush",
    "FusedWindowEngine",
    "HostCopy",
    "HostLocalFabric",
    "MultiHostWindowEngine",
    "PackedWindowEngine",
    "RowInput",
    "ShardedWindowEngine",
    "WindowMeta",
    "WindowPlan",
    "align_zone_matrices",
    "copy_blocks_to_host_async",
    "copy_plane_to_host_async",
    "copy_to_host_async",
    "fetch_plane",
]


class DeviceWindowError(RuntimeError):
    """A device-leg failure inside the fleet window (dispatch, compile,
    bucket-growth reallocation). ``reason`` is the bounded label a
    degradation ladder counts demotions under."""

    def __init__(self, reason: str, detail: str = "") -> None:
        super().__init__(detail or reason)
        self.reason = reason


# per-buffer row-content sentinels: _EMPTY = the device row is the packed
# empty row (cleared / never filled); _DIRTY = unknown content, must be
# re-staged before the buffer serves again (set on cross-buffer row
# reassignment). Compared by identity — they never equal a (run, seq).
_EMPTY = object()
_DIRTY = object()


class BucketLadder:
    """Geometric bucket sizing with shrink hysteresis.

    ``fit(need)`` returns the current bucket, growing it by doubling
    whenever ``need`` exceeds it (growth is immediate: a window must
    never be truncated) and shrinking it — one halving step at a time —
    only after ``shrink_after`` CONSECUTIVE fits at ≤ half occupancy.
    The bucket never drops below ``base``, and ``base`` is rounded up to
    a multiple of ``align``.
    """

    __slots__ = ("base", "align", "shrink_after", "bucket", "_under")

    def __init__(self, base: int, shrink_after: int, align: int = 1) -> None:
        align = max(1, int(align))
        base = max(1, int(base))
        if base % align:
            base = (base // align + 1) * align
        self.base = base
        self.align = align
        self.shrink_after = max(1, int(shrink_after))
        self.bucket = base
        self._under = 0

    def fit(self, need: int) -> int:
        need = max(1, int(need))
        if need > self.bucket:
            while self.bucket < need:
                self.bucket *= 2
            self._under = 0
        elif self.bucket > self.base and need <= self.bucket // 2:
            self._under += 1
            if self._under >= self.shrink_after:
                self.bucket = max(self.base, self.bucket // 2)
                self._under = 0
        else:
            self._under = 0
        return self.bucket


class RowInput(NamedTuple):
    """One live node's contribution to a window, as the engine sees it."""

    name: str
    report: NodeReport
    zone_names: tuple[str, ...]
    # data identity: (run, seq) for nonce-carrying agents. None = no
    # identity (pre-nonce agent) → the row is re-uploaded every window.
    ident: tuple[str, int] | None


@dataclass
class WindowMeta:
    """Per-window snapshot of the resident row layout (immutable once
    captured — the next window's sync mutates the engine, not this)."""

    zones: list[str]
    names: list[str]  # live node names (publication order)
    rows: dict[str, int]  # name → resident row index
    mode: np.ndarray  # int32 [N]
    dt: np.ndarray  # f32 [N] per-row report interval
    counts: list[int]  # per-ROW real workload count
    ids: list[list[str]]  # per-ROW workload ids
    kinds: list[np.ndarray | None]  # per-ROW workload kinds
    n_live: int
    n_rows: int


@dataclass
class WindowPlan:
    """Everything the caller needs to dispatch one window."""

    program: Callable
    args: tuple  # (params, resident_batch[, model_rows])
    cold: bool  # True → first launch of this key (time it as window.compile)
    meta: WindowMeta
    h2d_rows: int  # rows staged + uploaded this window (delta or full)
    h2d_shards: tuple[int, ...] = ()
    n_shards: int = 1


def fetch_plane(out: torch.Tensor | Sequence[torch.Tensor | None]
                ) -> np.ndarray:
    """Device watts plane → host array (the publish fetch; syncs). A
    sharded plane (one tensor per shard, None for shards another
    process launched) comes back as its shards' rows concatenated in
    shard order."""
    if isinstance(out, torch.Tensor):
        return out.cpu().numpy()
    return copy_plane_to_host_async(out).wait()[0]


class HostCopy:
    """Device tensors on their way to pinned host memory.

    Made by :func:`copy_to_host_async` and :func:`copy_blocks_to_host_async`.
    :meth:`wait` blocks on the events recorded behind the copies (one
    per device), then returns the host arrays. Reading a pinned buffer
    filled by a ``non_blocking`` copy before its event completes reads
    stale bytes without any error, so every read goes through
    :meth:`wait`. The events are explicit: :meth:`wait` may run on
    another thread, whose current CUDA stream is not the one the copies
    were queued on.
    """

    __slots__ = ("host", "events")

    def __init__(self, host: tuple[torch.Tensor, ...],
                 events: tuple[torch.cuda.Event, ...] = ()) -> None:
        self.host = host
        self.events = events

    def wait(self) -> tuple[np.ndarray, ...]:
        for event in self.events:
            event.synchronize()
        return tuple(h.numpy() for h in self.host)


def copy_to_host_async(*tensors: torch.Tensor) -> HostCopy:
    """Queue a D2H copy of each tensor into pinned host memory on the
    current stream (where the launches that made them were queued), with
    one event recorded right behind the copies. CPU tensors are already
    on the host and are taken as they are."""
    return copy_blocks_to_host_async([tensors])


def copy_blocks_to_host_async(
        blocks: Sequence[Sequence[torch.Tensor] | None], axis: int = 0
) -> HostCopy:
    """Queue the D2H copy of per-block results → a :class:`HostCopy` of
    each field joined over the blocks along ``axis``, in block order.

    ``blocks[b]`` is block ``b``'s fields on its device (None: launched
    by another process, skipped). On CUDA every field of every block
    lands in its slice of ONE pinned byte buffer (a copy per block and
    field — per leading index when ``axis > 0``, so both sides stay
    contiguous), with one event per device behind its copies: one host
    allocation and no host-side join, however many blocks. CPU tensors
    are joined on the host as they are."""
    parts = [tuple(b) for b in blocks if b is not None]
    first = parts[0]
    if first[0].device.type != "cuda":
        if len(parts) == 1:
            return HostCopy(tuple(t.detach() for t in first))
        return HostCopy(tuple(
            torch.from_numpy(np.concatenate(
                [p[f].detach().numpy() for p in parts], axis=axis))
            for f in range(len(first))))
    shapes, offsets, size = [], [], 0
    for f, t in enumerate(first):
        shape = list(t.shape)
        shape[axis] = sum(p[f].shape[axis] for p in parts)
        shapes.append(shape)
        offsets.append(size)
        size += -(-int(np.prod(shape)) * t.element_size() // 16) * 16
    buf = torch.empty(size, dtype=torch.uint8, pin_memory=True)
    host = tuple(
        buf[off:off + int(np.prod(shape)) * t.element_size()].view(
            t.dtype).view(shape)
        for t, shape, off in zip(first, shapes, offsets))
    at = [0] * len(first)
    for p in parts:
        for f, t in enumerate(p):
            dst = host[f].narrow(axis, at[f], t.shape[axis])
            for lead in np.ndindex(*dst.shape[:axis]):
                dst[lead].copy_(t[lead], non_blocking=True)
            at[f] += t.shape[axis]
    events = []
    for dev in dict.fromkeys(p[0].device for p in parts):
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
        events.append(event)
    return HostCopy(host, tuple(events))


def copy_plane_to_host_async(
        out: torch.Tensor | Sequence[torch.Tensor | None], axis: int = 0
) -> HostCopy:
    """Queue a result plane's D2H copy: a tensor, or one tensor per
    shard or node block (None: launched by another process) joined along
    ``axis`` (the node axis: 0 for a plane, 1 for a fused flush's
    ``[K, N, W+2, Z]`` planes; :func:`copy_blocks_to_host_async`)."""
    if isinstance(out, torch.Tensor):
        return copy_to_host_async(out)
    return copy_blocks_to_host_async(
        [None if t is None else (t,) for t in out], axis)


def align_zone_matrices(reports: Sequence[NodeReport],
                        zone_tuples: Sequence[tuple[str, ...]],
                        zone_names: Sequence[str]) -> tuple[np.ndarray,
                                                            np.ndarray]:
    """Ragged per-node zone arrays → canonical [n, Z] matrices.

    Alignment is GROUPED: nodes sharing a zone tuple (in practice the
    whole fleet) scatter into the canonical matrix with one stacked
    fancy-index per group. The homogeneous case is one stacked fill + a
    column permutation.
    """
    z_index = {z: i for i, z in enumerate(zone_names)}
    n_zones = len(zone_names)
    n = len(reports)
    zd_mat = np.empty((n, n_zones), np.float32)
    zv_mat = np.empty((n, n_zones), bool)
    if n == 0:
        return zd_mat, zv_mat
    first = zone_tuples[0]
    if all(zt is first or zt == first for zt in zone_tuples):
        # homogeneous batch (the normal case); the batch may cover only
        # PART of the canonical axis, so absent columns stay zero/invalid
        stacked_zd = np.stack([r.zone_deltas_uj for r in reports]).astype(
            np.float32, copy=False)
        stacked_zv = np.stack([r.zone_valid for r in reports]).astype(
            bool, copy=False)
        perm = np.asarray([z_index[z] for z in first])
        zd_mat[:] = 0.0
        zv_mat[:] = False
        zd_mat[:, perm] = stacked_zd
        zv_mat[:, perm] = stacked_zv
        return zd_mat, zv_mat
    zd_mat[:] = 0.0
    zv_mat[:] = False
    groups: dict[tuple[str, ...], list[int]] = {}
    for i, zt in enumerate(zone_tuples):
        groups.setdefault(zt, []).append(i)
    for ztuple, idxs in groups.items():
        perm = np.asarray([z_index[z] for z in ztuple])
        rows = np.asarray(idxs)
        zd_mat[rows[:, None], perm] = np.stack(
            [np.asarray(reports[i].zone_deltas_uj, np.float32)
             for i in idxs])
        zv_mat[rows[:, None], perm] = np.stack(
            [np.asarray(reports[i].zone_valid, bool) for i in idxs])
    return zd_mat, zv_mat


class _HostSlot:
    """One host staging slot: f32 rows + i32 indices, pinned when the
    engine's device is CUDA. ``reserve`` waits for the slot's last
    uploads to complete before handing its memory back for rewriting."""

    __slots__ = ("device", "rows", "idx", "_events")

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.rows = torch.zeros((0, 0), dtype=torch.float32)
        self.idx = torch.zeros(0, dtype=torch.int32)
        self._events: list[torch.cuda.Event] = []

    def reserve(self, rows_shape: tuple[int, ...],
                idx_shape: tuple[int, ...]) -> tuple[np.ndarray, np.ndarray]:
        """→ writable (rows, idx) host views of the requested shapes."""
        for event in self._events:
            event.synchronize()
        self._events = []
        pin = self.device.type == "cuda"
        if tuple(self.rows.shape) != rows_shape:
            self.rows = torch.empty(rows_shape, dtype=torch.float32,
                                    pin_memory=pin)
        if tuple(self.idx.shape) != idx_shape:
            self.idx = torch.empty(idx_shape, dtype=torch.int32,
                                   pin_memory=pin)
        return self.rows.numpy(), self.idx.numpy()

    def upload(self) -> tuple[torch.Tensor, torch.Tensor]:
        """→ device copies of (rows, idx), enqueued on the current stream."""
        return self.upload_blocks([self.device], whole=True)[0]

    def upload_blocks(self, devices: Sequence[torch.device], whole: bool
                      ) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """→ one device ``(rows, idx)`` per entry of ``devices``, each
        enqueued on that device's current stream: with ``whole`` the
        whole slot, moved once per DISTINCT device; else entry ``i`` is
        the slot's ``i``-th block ``(rows[i], idx[i])`` on
        ``devices[i]``."""
        moved: dict = {}
        out = []
        for i, dev in enumerate(devices):
            key = dev if whole else i
            if key not in moved:
                src = ((self.rows, self.idx) if whole
                       else (self.rows[i], self.idx[i]))
                moved[key] = self._move(src, dev)
            out.append(moved[key])
        return out

    def _move(self, src: tuple[torch.Tensor, torch.Tensor],
              dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
        if dev.type != "cuda":
            return src[0].clone(), src[1].clone()
        rows = src[0].to(dev, non_blocking=True)
        idx = src[1].to(dev, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
        self._events.append(event)
        return rows, idx


def block_local_rows(rows: Sequence[np.ndarray], n_rows: int,
                     n_blocks: int, width: int) -> np.ndarray:
    """Lists of global row indices → ``[n_blocks, len(rows), width]``
    BLOCK-LOCAL ones (``aggregator_core.block_local_index``): for each
    list, block ``b`` keeps, in order, the indices that land in its rows;
    the rest of its segment is its pad (gather-clamped,
    scatter-dropped)."""
    from kepler_tpu_torch.parallel.aggregator_core import block_local_index

    sb = n_rows // n_blocks
    out = np.full((n_blocks, len(rows), width), sb, np.int32)
    for j, r in enumerate(rows):
        for b, local in enumerate(block_local_index(r, n_rows, n_blocks)):
            hit = local[local < sb]
            out[b, j, :len(hit)] = hit
    return out


def _cost_stats(label: str, arg_bytes: int, out_bytes: int,
                kernel: tuple[int, int] | None) -> dict:
    """Cost stats of a program cache entry from what the port knows: the
    bytes its arguments and outputs occupy on the device and, for a
    hand-kernel program, the kernels' bound on an H100."""
    from kepler_tpu_torch.ops.cuda_attribution import bound_ms

    stats: dict = {
        "label": label,
        "argument_bytes": float(arg_bytes),
        "output_bytes": float(out_bytes),
        "device_memory_bytes": float(arg_bytes + out_bytes),
        "bytes_accessed": float(arg_bytes + out_bytes),
    }
    if kernel is not None:
        nbytes, ops = kernel
        ms, by = bound_ms(nbytes, ops)
        stats["kernel_bytes"] = float(nbytes)
        stats["flops"] = float(ops)
        stats["bound_ms"] = ms
        stats["bound_by"] = by
    return stats


# keplint: forbid-role=http-handler — live engine state (device buffers,
# program cache, cost ledgers) is mutated by the pipelined window thread;
# HTTP handlers read the PUBLISHED introspection snapshot the aggregator
# caches under _results_lock at _publish time (KTL113)
class PackedWindowEngine:
    """Resident packed batch + program/update cache for the packed-f16
    fleet path. Single-threaded by contract: only the aggregation loop
    calls :meth:`plan_window` and :meth:`dispatch_window`.

    ``device`` may be a :class:`~kepler_tpu_torch.parallel.mesh.Mesh`
    (the aggregator's 2-D ``node × model`` mesh, or its fused tier's
    mesh): the node bucket is then aligned to the mesh size as the
    reference aligns it, and on two or more node blocks
    (``parallel.aggregator_core.node_blocks``) the resident batch is cut
    into them, as the reference's ``P(node, None)`` sharding cuts it.
    Block ``b`` holds rows ``[b·N/n, (b+1)·N/n)`` on its node row's first
    shard's device; the staged delta uploads whole once per distinct
    device (the reference's replicated device_put) and scatters into
    every block with block-local indices, and the packed program runs
    once per block, its planes joined in block order at fetch. The
    engine stays the unsharded one all the same: one staging, one
    ``n_shards``, whole-batch H2D."""

    # a mesh cuts the resident batch into node blocks (the sharded
    # engine lays its shards out itself)
    _NODE_BLOCKS = True

    # program-cache bound: ladder moves retire old shapes; keep a few
    # around for oscillation, evict the oldest beyond this
    _CACHE_CAP = 32

    # device shards the resident batch spans (one: single device)
    n_shards = 1

    def __init__(self, device: str | torch.device | Mesh = "cuda",
                 backend: str = "einsum",
                 model_mode: str | None = None,
                 node_bucket: int = 8, workload_bucket: int = 256,
                 shrink_after: int = 16, staging_slots: int = 2) -> None:
        if backend not in ("einsum", "pallas"):
            raise ValueError(f"unknown attribution backend {backend!r}; "
                             "valid: einsum, pallas")
        from kepler_tpu_torch.parallel.aggregator_core import node_blocks

        n_dev = 1
        mesh: Mesh | None = None
        if isinstance(device, Mesh):
            mesh = device
            n_dev = mesh.size
            device = mesh.devices[0]
        self.device = resolve_device(device)
        # the resident batch's node blocks (none: one tensor on `device`)
        blocks = (node_blocks(mesh) if mesh is not None and self._NODE_BLOCKS
                  else ())
        self._blocks = blocks if len(blocks) > 1 else ()
        self._backend = backend
        self._model_mode = model_mode
        # the bucket sequence follows the mesh size, as the reference's
        # does: node rungs stay divisible by it
        self._ladder_n = BucketLadder(node_bucket, shrink_after,
                                      align=n_dev)
        self._ladder_w = BucketLadder(workload_bucket, shrink_after)
        self._ladder_m = BucketLadder(max(8, n_dev), shrink_after)
        self._ladder_d = BucketLadder(8, shrink_after)
        # sparse model evaluation needs the einsum gather path
        self._sparse = bool(model_mode) and backend == "einsum"
        # cache entries are [program, cold, cost_stats | None, label]
        self._programs: dict[tuple, list] = {}
        self._updates: dict[tuple, list] = {}  # (n, width, db) key
        self.compile_count = 0  # program-cache misses (attribution + update)
        # packed programs run per shard or node block over this mesh
        self._program_mesh: Mesh | None = mesh if self._blocks else None
        self._params_src: Any = None
        self._params_dev: dict[torch.device, dict] = {}

        # resident state (invalid until the first plan_window). The
        # resident batch rotates over `staging_slots` device buffers: the
        # in-place update never targets a buffer an in-flight window still
        # reads. Each buffer tracks its own per-row content identity, so
        # the delta staged into buffer B covers everything that changed
        # since B last served.
        self._key: tuple | None = None  # (n_bucket, w_bucket, zones)
        self._buffers: list[torch.Tensor] = []  # device f32 [N, width] ring
        self._content: list[list] = []  # per-buffer per-row ident/_EMPTY/_DIRTY
        self._buf_i = 0
        self._names: list[str | None] = []
        self._row_of: dict[str, int] = {}
        self._mode: list[int] = []
        self._dt: list[float] = []
        self._counts: list[int] = []
        self._ids: list[list[str]] = []
        self._kinds: list[np.ndarray | None] = []
        self._free: list[int] = []
        self._empty_row = np.zeros(0, np.float32)
        # reusable HOST staging slots, rotated per window (one per pipeline
        # stage plus one); the slot count also sizes the device ring
        self._stages = [_HostSlot(self.device)
                        for _ in range(max(2, staging_slots))]
        self._stage_i = 0
        # introspection: monotone window counter + per-ring-slot "last
        # window this buffer served"
        self._window_seq = 0
        self._buf_served: list[int] = []

    # -- params ------------------------------------------------------------

    def _device_params(self, params: Any,
                       device: torch.device | None = None) -> dict | None:
        """Estimator params → f32 tensors on ``device`` (default: the
        engine's), nested dicts kept (cached per params object and
        device); None for ratio-only fleets."""
        if not self._model_mode or not isinstance(params, Mapping):
            return None
        if params is not self._params_src:
            self._params_dev = {}
            self._params_src = params
        dev = self.device if device is None else device
        if dev not in self._params_dev:
            self._params_dev[dev] = params_to(params, dev)
        return self._params_dev[dev]

    # -- node blocks -------------------------------------------------------
    # An engine without node blocks is one block on its device: these
    # helpers build every per-block value as a list and hand a program
    # the list over blocks, or the one value.

    def _block_devices(self) -> list[torch.device]:
        """Each node block's device (one block, on the engine's device,
        when the batch is not cut)."""
        return [b.device for b in self._blocks] or [self.device]

    def _program_arg(self, parts: list) -> Any:
        """Per-block values → a program argument: the list over node
        blocks, or the single block's value."""
        return parts if self._blocks else parts[0]

    def _program_params(self, params: Any) -> Any:
        """The params on each block's device (cached per device)."""
        return self._program_arg([self._device_params(params, d)
                                  for d in self._block_devices()])

    def _blocks_on(self, local: np.ndarray) -> Any:
        """``[n_blocks, …]`` host array → block ``i``'s entry on its
        device, the array moving once per distinct device."""
        on: dict[torch.device, torch.Tensor] = {}
        parts = []
        for i, dev in enumerate(self._block_devices()):
            if dev not in on:
                on[dev] = torch.from_numpy(local).to(dev)
            parts.append(on[dev][i])
        return self._program_arg(parts)

    # -- program/update caches ---------------------------------------------

    def _program_for(self, nb: int, wb: int, z: int,
                     mb: int | None) -> list:
        key = (nb, wb, z, self._model_mode or "", mb)
        entry = self._programs.get(key)
        if entry is None:
            # fired BEFORE the entry caches: a failed compile leaves no
            # poisoned cache entry behind
            if fault.fire("device.compile_error") is not None:
                raise DeviceWindowError(
                    "compile_error",
                    f"injected compile failure for program key {key}")
            from kepler_tpu_torch.parallel.packed import (
                make_packed_fleet_program)

            program = make_packed_fleet_program(
                n_workloads=wb, n_zones=z, model_mode=self._model_mode,
                backend=self._backend, model_bucket=mb, device=self.device,
                mesh=self._program_mesh,
                local_model_rows=self._program_mesh is not None)
            entry = [program, True, None, self._program_label(key)]
            self._programs[key] = entry
            self.compile_count += 1
            while len(self._programs) > self._CACHE_CAP:
                self._programs.pop(next(iter(self._programs)))
        return entry

    def _update_for(self, n: int, width: int, db: int) -> list:
        key = (n, width, db)
        entry = self._updates.get(key)
        if entry is None:
            if fault.fire("device.compile_error") is not None:
                raise DeviceWindowError(
                    "compile_error",
                    f"injected compile failure for update key {key}")
            from kepler_tpu_torch.ops.cuda_attribution import scatter_rows
            from kepler_tpu_torch.parallel.aggregator_core import (
                shard_by_node)

            # over node blocks: (blocks, rows per block, local idx per
            # block) → one scatter launch per block
            update = (shard_by_node(scatter_rows, self._program_mesh)
                      if self._blocks else scatter_rows)
            entry = [update, True, None, self._update_label(key)]
            self._updates[key] = entry
            self.compile_count += 1
            while len(self._updates) > self._CACHE_CAP:
                self._updates.pop(next(iter(self._updates)))
        return entry

    # -- cost introspection ------------------------------------------------

    def _program_label(self, key: tuple) -> str:
        """Bounded metric label for an attribution-program cache key. The
        shard suffix keeps a sharded rung-0 engine's programs distinct
        from the serial demotion engine's: after a demotion both engines
        hold cost stats for the same bucket key."""
        nb, wb, z, mode, mb = key
        label = f"prog_n{nb}_w{wb}_z{z}_{mode or 'ratio'}"
        if mb is not None:
            label += f"_m{mb}"
        return label + self._label_suffix()

    def _update_label(self, key: tuple) -> str:
        n, width, db = key
        return f"upd_n{n}_x{width}_d{db}" + self._label_suffix()

    def _label_suffix(self) -> str:
        return f"_s{self.n_shards}" if self.n_shards > 1 else ""

    def _program_cost(self, entry: list, nb: int, wb: int, z: int,
                      mb: int | None) -> None:
        """Cost stats of a packed program entry, captured once."""
        if entry[2] is not None:
            return
        from kepler_tpu_torch.ops.cuda_attribution import outer_product_cost

        width = wb + 2 * z + 4
        arg = 4 * nb * width + (4 * mb if mb is not None else 0)
        out = 2 * nb * (wb + 2) * z
        kernel = (outer_product_cost(nb, wb, z)
                  if self._backend == "pallas" else None)
        entry[2] = _cost_stats(entry[3], arg, out, kernel)

    def cost_stats(self) -> dict[str, dict]:
        """label → captured cost stats for every cached program/update
        that has them (the compile-cache entries' third slot)."""
        out: dict[str, dict] = {}
        for entry in self._programs.values():
            if entry[2] is not None:
                out[entry[2]["label"]] = entry[2]
        for entry in self._updates.values():
            if entry[2] is not None:
                out[entry[2]["label"]] = entry[2]
        return out

    def buffer_staleness(self) -> list[int]:
        """Windows since each ring slot last served (0 = the slot that
        served the latest window)."""
        return [self._window_seq - s for s in self._buf_served]

    def shard_occupancy(self) -> list[dict]:
        """Per-shard resident-row occupancy, split by row mode — the
        load the sticky assignment exists to balance (one shard's model
        rows size the whole mesh's sparse estimator bucket)."""
        out = [{"rows": 0, "model_rows": 0} for _ in range(self.n_shards)]
        if self._key is None:
            return out
        per = self._key[0]  # rows per shard (the whole bucket unsharded)
        for i in self._row_of.values():
            k = min(i // per, self.n_shards - 1)
            out[k]["rows"] += 1
            if self._mode[i] == MODE_MODEL:
                out[k]["model_rows"] += 1
        return out

    def introspect(self) -> dict:
        """Engine state dump for ``/debug/window`` — everything bounded."""
        programs = [{"key": entry[3],
                     "cold": bool(entry[1]), "cost": entry[2]}
                    for entry in self._programs.values()]
        updates = [{"key": entry[3],
                    "cold": bool(entry[1]), "cost": entry[2]}
                   for entry in self._updates.values()]
        return {
            "engine": type(self).__name__,
            "n_shards": self.n_shards,
            "window_seq": self._window_seq,
            "buckets": {
                "node": self._ladder_n.bucket,
                "node_base": self._ladder_n.base,
                "workload": self._ladder_w.bucket,
                "model": self._ladder_m.bucket,
                "delta": self._ladder_d.bucket,
            },
            "resident": {
                "slots": max(len(self._buffers), len(self._stages)),
                "current_slot": self._buf_i,
                "rows": len(self._row_of),
                "staleness_windows": self.buffer_staleness(),
            },
            "shards": self.shard_occupancy(),
            "programs": programs,
            "updates": updates,
            "compile_count": self.compile_count,
        }

    # -- window planning ---------------------------------------------------

    def _fit_buckets(self, rows: Sequence[RowInput]) -> tuple[int, int]:
        """Fit the node/workload ladders to ``rows`` → (nb, wb); a bucket
        that GROWS mid-run is where a real allocation can fail."""
        need_w = max((len(r.report.cpu_deltas) for r in rows), default=1)
        prev_nb, prev_wb = self._ladder_n.bucket, self._ladder_w.bucket
        wb = self._ladder_w.fit(need_w)
        nb = self._ladder_n.fit(len(rows))
        if self._buffers and (nb > prev_nb or wb > prev_wb):
            if fault.fire("device.oom_on_grow") is not None:
                raise DeviceWindowError(
                    "oom_on_grow",
                    f"injected OOM growing buckets ({prev_nb}, {prev_wb})"
                    f" → ({nb}, {wb})")
        return nb, wb

    def _meta(self, rows: Sequence[RowInput], zones_t: tuple[str, ...],
              nb: int) -> WindowMeta:
        return WindowMeta(
            zones=list(zones_t),
            names=[r.name for r in rows],
            rows=dict(self._row_of),
            mode=np.asarray(self._mode, np.int32),
            dt=np.asarray(self._dt, np.float32),
            counts=list(self._counts),
            ids=list(self._ids),
            kinds=list(self._kinds),
            n_live=len(rows),
            n_rows=nb,
        )

    def plan_window(self, rows: Sequence[RowInput],
                    zone_names: Sequence[str], params: Any) -> WindowPlan:
        """Sync the resident batch to ``rows`` and return the dispatchable
        plan. The in-place update (if any) is enqueued HERE; the caller
        runs :meth:`dispatch_window` on the plan."""
        self._window_seq += 1
        zones_t = tuple(zone_names)
        z = len(zones_t)
        nb, wb = self._fit_buckets(rows)
        key = (nb, wb, zones_t)
        if key != self._key or not self._buffers:
            h2d_rows = self._rebuild(rows, nb, wb, zones_t)
        else:
            # rotate to the least-recently-read buffer BEFORE updating:
            # its readers (if any) are ≥ staging_slots windows old and
            # already fetched
            self._buf_i = (self._buf_i + 1) % len(self._buffers)
            h2d_rows = self._delta_sync(rows, zones_t)
        self._buf_served[self._buf_i] = self._window_seq
        meta = self._meta(rows, zones_t, nb)
        resident = self._buffers[self._buf_i]
        dev_params = self._program_params(params)
        args: tuple
        mb: int | None = None
        if self._sparse:
            model_idx = np.flatnonzero(
                np.asarray(self._mode, np.int32) == MODE_MODEL)
            mb = self._ladder_m.fit(max(1, len(model_idx)))
            local = block_local_rows([model_idx], nb,
                                     len(self._block_devices()), mb)
            args = (dev_params, resident, self._blocks_on(local[:, 0]))
        else:
            args = (dev_params, resident)
        entry = self._program_for(nb, wb, z, mb)
        program, cold = entry[0], entry[1]
        if cold:
            self._program_cost(entry, nb, wb, z, mb)
        entry[1] = False
        return WindowPlan(program=program, args=args, cold=cold, meta=meta,
                          h2d_rows=h2d_rows, h2d_shards=(h2d_rows,),
                          n_shards=1)

    def dispatch_window(self, plan: WindowPlan) -> torch.Tensor:
        """Launch one planned window → its f16 [N, W+2, Z] plane on the
        device (fetch with :func:`fetch_plane`). A device failure —
        injected at ``device.dispatch_error`` or raised by a launch —
        abandons the resident ring (:meth:`reset`) and raises
        :class:`DeviceWindowError`; the next plan re-packs in full."""
        return self._run_device(lambda: plan.program(*plan.args),
                                plan.cold, "packed window program")

    def _run_device(self, launch: Callable[[], Any], cold: bool,
                    what: str, inject_faults: bool = True) -> Any:
        if inject_faults and fault.fire("device.dispatch_error") is not None:
            self.reset()
            raise DeviceWindowError("dispatch_error",
                                    f"injected dispatch failure ({what})")
        try:
            if cold:
                # first launch of this key: builds its kernels on first use
                with telemetry.span("window.compile"):
                    return launch()
            return launch()
        except RuntimeError as err:
            self.reset()
            raise DeviceWindowError(
                "dispatch_error", f"{what} failed: {err}"[:400]) from err

    # -- failure recovery --------------------------------------------------

    def reset(self) -> None:
        """Abandon the resident ring and host staging wholesale.

        Called after ANY device-leg failure: a buffer whose update raised
        mid-scatter holds unknown bytes — so per-buffer ``(run, seq)``
        identity is invalidated across the board and the next
        :meth:`plan_window` performs a full re-pack (``_rebuild``).
        Program/update caches survive; the bucket ladders keep their
        sizes so recovery doesn't rebuild every rung from base.
        """
        self._key = None
        self._buffers = []
        self._content = []
        self._buf_i = 0
        self._names = []
        self._row_of = {}
        self._mode = []
        self._dt = []
        self._counts = []
        self._ids = []
        self._kinds = []
        self._free = []
        self._stage_i = 0
        self._stages = [_HostSlot(self.device) for _ in self._stages]
        self._buf_served = []  # _window_seq survives

    # -- resident maintenance ----------------------------------------------

    def _rebuild(self, rows: Sequence[RowInput], nb: int, wb: int,
                 zones_t: tuple[str, ...]) -> int:
        """Full re-pack: shape key or zone axis changed (or first window)."""
        from kepler_tpu_torch.parallel.packed import (PackedLayout,
                                                      pack_fleet_inputs,
                                                      packed_width)

        ordered = sorted(rows, key=lambda r: r.name)
        reports = [r.report for r in ordered]
        zd, zv = align_zone_matrices(reports,
                                     [r.zone_names for r in ordered],
                                     zones_t)
        batch = assemble_fleet_batch(reports, n_zones=len(zones_t),
                                     node_bucket=nb, workload_bucket=wb,
                                     zone_deltas_mat=zd, zone_valid_mat=zv)
        packed = pack_fleet_inputs(batch)
        if packed.shape != (nb, packed_width(wb, len(zones_t))):
            raise AssertionError(  # ladder/assembly contract violation
                f"packed shape {packed.shape} != resident bucket "
                f"({nb}, {packed_width(wb, len(zones_t))})")
        n_real = len(ordered)
        # every ring buffer starts from this full pack, each its own
        # device allocation, all content-current
        host = torch.from_numpy(packed)
        devs = self._block_devices()
        sb = nb // len(devs)
        self._buffers = [self._program_arg(
            [host[i * sb:(i + 1) * sb].to(d, copy=True)
             for i, d in enumerate(devs)]) for _ in self._stages]
        idents = ([r.ident for r in ordered]
                  + [_EMPTY] * (nb - n_real))
        self._content = [list(idents) for _ in self._buffers]
        self._buf_i = 0
        self._buf_served = [self._window_seq] * len(self._buffers)
        self._key = (nb, wb, zones_t)
        self._names = [r.name for r in ordered] + [None] * (nb - n_real)
        self._row_of = {r.name: i for i, r in enumerate(ordered)}
        self._mode = batch.mode.tolist()
        self._dt = batch.dt_s.tolist()
        self._counts = list(batch.workload_counts)
        self._ids = list(batch.workload_ids)
        self._kinds = ([r.workload_kinds for r in reports]
                       + [None] * (nb - n_real))
        self._free = list(range(nb - 1, n_real - 1, -1))
        self._empty_row = PackedLayout(wb, len(zones_t)).empty_row()
        return n_real

    def _sync_rows(self, rows: Sequence[RowInput], content: list,
                   mark_others: bool) -> tuple[list[tuple[int, RowInput]],
                                               list[int]]:
        """Shared delta bookkeeping: prune departed nodes, place joiners,
        and collect the rows whose content identity differs from what
        ``content`` holds → (changed, cleared). Content identity advances
        here. ``mark_others``: a joiner's row may still hold another
        node's data in the OTHER ring buffers — mark it unknown there."""
        nb = self._key[0]  # type: ignore[index]
        live = {r.name for r in rows}
        for name, i in list(self._row_of.items()):
            if name not in live:
                del self._row_of[name]
                self._names[i] = None
                self._mode[i] = 0
                self._dt[i] = 0.0
                self._counts[i] = 0
                self._ids[i] = []
                self._kinds[i] = None
                self._free.append(i)
        changed: list[tuple[int, RowInput]] = []
        for r in rows:
            i = self._row_of.get(r.name)
            if i is None:
                i = self._free.pop()
                self._row_of[r.name] = i
                self._names[i] = r.name
                if mark_others:
                    for other in self._content:
                        if other is not content:
                            other[i] = _DIRTY
            elif (r.ident is not None and content[i] is not _EMPTY
                    and content[i] is not _DIRTY and content[i] == r.ident):
                continue  # this buffer's row is current
            self._mode[i] = r.report.mode
            self._dt[i] = r.report.dt_s
            self._counts[i] = len(r.report.cpu_deltas)
            self._ids[i] = r.report.workload_ids
            self._kinds[i] = r.report.workload_kinds
            content[i] = r.ident
            changed.append((i, r))
        # clear every freed row this buffer still carries data for, except
        # rows a join just reclaimed — those are in `changed`, and a
        # duplicate scatter index would race the two writes
        changed_rows = {i for i, _ in changed}
        cleared = [i for i in range(nb)
                   if self._names[i] is None and content[i] is not _EMPTY
                   and i not in changed_rows]
        for i in cleared:
            content[i] = _EMPTY
        return changed, cleared

    def _fill_stage(self, stage: np.ndarray, idx: np.ndarray,
                    changed: list[tuple[int, RowInput]], cleared: list[int],
                    zones_t: tuple[str, ...]) -> None:
        """Pack the changed reports and the cleared rows into
        ``stage[:n]`` / ``idx[:n]``."""
        wb = self._key[1]  # type: ignore[index]
        if changed:
            from kepler_tpu_torch.parallel.packed import pack_reports_into

            reports = [r.report for _, r in changed]
            zd, zv = align_zone_matrices(
                reports, [r.zone_names for _, r in changed], zones_t)
            pack_reports_into(stage, reports, zd, zv, wb)
            idx[:len(changed)] = [i for i, _ in changed]
        for k, i in enumerate(cleared):
            stage[len(changed) + k] = self._empty_row
            idx[len(changed) + k] = i

    def _delta_sync(self, rows: Sequence[RowInput],
                    zones_t: tuple[str, ...]) -> int:
        """Bring the CURRENT ring buffer up to date: stage every row whose
        content identity differs from what this buffer last held (changed
        reports, joins, clears) and scatter the slice in place. → rows
        staged (0 = the buffer is already true)."""
        from kepler_tpu_torch.parallel.aggregator_core import (
            block_local_index)

        nb = self._key[0]  # type: ignore[index]
        changed, cleared = self._sync_rows(
            rows, self._content[self._buf_i], mark_others=True)
        n_stage = len(changed) + len(cleared)
        if n_stage == 0:
            return 0
        # changed and cleared rows are disjoint subsets of the nb resident
        # rows, so n_stage ≤ nb and the cap below can never truncate
        db = min(self._ladder_d.fit(n_stage), nb)
        width = self._empty_row.shape[0]
        self._stage_i = (self._stage_i + 1) % len(self._stages)
        slot = self._stages[self._stage_i]
        devs = self._block_devices()
        stage, idx = slot.reserve((db, width), (len(devs), db))
        stage[:] = 0.0
        global_idx = np.full(db, nb, np.int32)
        self._fill_stage(stage, global_idx, changed, cleared, zones_t)
        # each block's view of the whole staged delta: block-local
        # indices, every row that lands elsewhere (and every pad) dropped
        idx[:] = block_local_index(global_idx, nb, len(devs))
        entry = self._update_for(nb, width, db)
        update = entry[0]  # keplint: donates=0
        update_cold, entry[1] = entry[1], False
        resident = self._buffers[self._buf_i]
        # the whole delta once per distinct device, as the reference's
        # replicated device_put
        moved = slot.upload_blocks(devs, whole=True)
        rows_dev = self._program_arg([r for r, _ in moved])
        idx_dev = self._program_arg([i[b] for b, (_, i) in
                                     enumerate(moved)])
        if update_cold:
            entry[2] = _cost_stats(entry[3], 4 * (nb * width + db * width
                                                  + db),
                                   4 * nb * width, None)
            with telemetry.span("window.compile"):
                resident = update(resident, rows_dev, idx_dev)
        else:
            resident = update(resident, rows_dev, idx_dev)
        return n_stage


@dataclass
class FusedFlush:
    """One dispatchable fused batch: program + args for a single call that
    replays every pending interval's delta rows against the resident
    block and returns all their packed outputs in one ``[K, N, W+2, Z]``
    f16 tensor (one host sync per K windows)."""

    program: Callable
    args: tuple  # (params, resident, rows_dev, idx_dev[, model_rows_dev])
    cold: bool  # True → first launch of this key (time it as window.compile)
    metas: list[WindowMeta]  # pending windows, oldest first (len = k_live)
    k: int  # program depth (k_live padded with no-op intervals)
    k_live: int  # real windows in this batch
    h2d_rows: int  # delta rows staged across the whole batch
    # False when the ring was rebuilt AFTER this flush was cut (shape
    # change): the batch still runs against the retired old-shape block,
    # which is then dropped instead of rebound
    rebind: bool = True


class FusedWindowEngine(PackedWindowEngine):
    """Device-resident window LOOP — one host↔device sync per K windows.

    :meth:`stage` is HOST-ONLY: it runs the same delta-sync bookkeeping
    as the base engine but accretes the interval's packed delta rows into
    a host-side pending ring instead of uploading them. Every K-th
    interval it cuts a :class:`FusedFlush`: one upload of the K delta
    sets and one call of the fused program
    (``parallel.packed.make_fused_window_program``), which replays them
    against the device-resident block and returns all K packed watts
    planes in one tensor, so upload, sync and publish fetch each happen
    once per K windows. With ``backend="pallas"`` and no model, the whole
    flush is one launch of kernel B2.

    Staleness: windows 1..K−1 of a batch publish when window K flushes.

    Single resident buffer: the caller fetches each flush's output before
    the next flush is cut, and every launch is ordered on one stream, so
    the in-place update never races a reader. A failed flush abandons the
    ring wholesale — :meth:`reset` drops the pending host ring too.

    Over a mesh of two or more node blocks (the aggregator's full mesh,
    as the reference's fused tier runs on it) the resident buffer is one
    block per node block, each on its device; a flush cuts the pending
    delta sets per block (``parallel.packed.cut_deltas_by_block``: the
    rows that land there, block-local indices, at a width from the
    engine's delta ladder) straight into one pinned slot, moves each
    block's part once, runs the loop per block — with
    ``backend="pallas"`` and no model one B2 launch per block — and the
    K planes come back per block, joined along the node axis at fetch.
    """

    def __init__(self, device: str | torch.device | Mesh = "cuda",
                 backend: str = "einsum",
                 model_mode: str | None = None,
                 node_bucket: int = 8, workload_bucket: int = 256,
                 shrink_after: int = 16, fused_k: int = 4) -> None:
        super().__init__(device=device, backend=backend,
                         model_mode=model_mode,
                         node_bucket=node_bucket,
                         workload_bucket=workload_bucket,
                         shrink_after=shrink_after)
        self.fused_k = max(1, int(fused_k))
        # ONE resident buffer and ONE staging slot: _rebuild sizes the
        # device ring from the slot count
        self._stages = [_HostSlot(self.device)]
        self._fused_programs: dict[tuple, list] = {}
        # host-side pending ring, oldest first: (rows [n, width] f32,
        # idx [n] i32, model_idx i32 | None, meta)
        self._pending: list[tuple] = []

    # -- interval staging --------------------------------------------------

    def stage(self, rows: Sequence[RowInput], zone_names: Sequence[str],
              params: Any) -> tuple[WindowMeta, FusedFlush | None]:
        """Account one interval host-side and return ``(meta, flush)``;
        ``flush`` is non-None when the pending ring reached K — or when a
        shape change forced the old-shape batch out early — and the
        caller must dispatch it (then publish ``flush.metas``)."""
        self._window_seq += 1
        zones_t = tuple(zone_names)
        nb, wb = self._fit_buckets(rows)
        key = (nb, wb, zones_t)
        flush: FusedFlush | None = None
        if key != self._key or not self._buffers:
            # shape change: the pending windows were staged against the
            # OLD resident shape — cut their flush FIRST, marked no-rebind
            if self._pending:
                flush = self._make_flush(params)
                flush.rebind = False
            self._rebuild(rows, nb, wb, zones_t)
            width = self._empty_row.shape[0]
            staged = (np.zeros((0, width), np.float32),
                      np.zeros(0, np.int32))
        else:
            staged = self._stage_delta(rows, zones_t)
        self._buf_served[0] = self._window_seq
        meta = self._meta(rows, zones_t, nb)
        model_idx = None
        if self._sparse:
            model_idx = np.flatnonzero(
                np.asarray(self._mode, np.int32) == MODE_MODEL
            ).astype(np.int32)
        self._pending.append((staged[0], staged[1], model_idx, meta))
        if flush is None and len(self._pending) >= self.fused_k:
            flush = self._make_flush(params)
        return meta, flush

    def _stage_delta(self, rows: Sequence[RowInput],
                     zones_t: tuple[str, ...]) -> tuple[np.ndarray,
                                                        np.ndarray]:
        """HOST-ONLY delta accounting: the changed and cleared rows land
        in a FRESH host array that joins the pending ring. Content
        identity advances at stage time: each interval's delta is
        computed against the state the PREVIOUS pending interval will
        have written, which is exactly what the in-order replay
        produces."""
        changed, cleared = self._sync_rows(rows, self._content[0],
                                           mark_others=False)
        n_stage = len(changed) + len(cleared)
        width = self._empty_row.shape[0]
        stage = np.zeros((n_stage, width), np.float32)
        idx = np.empty(n_stage, np.int32)
        self._fill_stage(stage, idx, changed, cleared, zones_t)
        return stage, idx

    # -- flush building / dispatch -----------------------------------------

    def flush(self, params: Any) -> FusedFlush | None:
        """Force-flush the pending ring — None when nothing is pending."""
        if not self._pending:
            return None
        return self._make_flush(params)

    def _make_flush(self, params: Any) -> FusedFlush:
        """Cut the pending ring into ONE dispatchable batch: pad each
        interval's delta to a common bucketed width and the batch to K
        (no-op tail intervals: zero rows, all-pad indices → dropped,
        their outputs never published)."""
        from kepler_tpu_torch.parallel.packed import (block_delta_width,
                                                      cut_deltas_by_block)

        nb, wb, zones_t = self._key  # type: ignore[misc]
        z = len(zones_t)
        pending, self._pending = self._pending, []
        k_live = len(pending)
        k = self.fused_k
        devs = self._block_devices()
        steps = [(stage, idx) for stage, idx, _, _ in pending]
        # the delta width of one block's sets, on the engine's ladder
        need_d = block_delta_width([idx for _, idx in steps], nb, len(devs))
        db = min(self._ladder_d.fit(max(1, need_d)), nb // len(devs))
        width = self._empty_row.shape[0]
        h2d = sum(len(idx) for _, idx in steps)
        # ONE pinned slot [blocks, K, db, width], cut into in place, each
        # block's part moved once to its device
        slot = self._stages[0]
        rows_b, idx_b = slot.reserve((len(devs), k, db, width),
                                     (len(devs), k, db))
        cut_deltas_by_block(steps, nb, rows_b, idx_b)
        moved = slot.upload_blocks(devs, whole=False)
        rows_dev = self._program_arg([r for r, _ in moved])
        idx_dev = self._program_arg([i for _, i in moved])
        args_tail: list = []
        mb: int | None = None
        if self._sparse:
            need_m = max(1, max(len(mi) for _, _, mi, _ in pending))
            mb = self._ladder_m.fit(need_m)
            # no-op tail intervals take an all-pad segment
            per_step = ([mi for _, _, mi, _ in pending]
                        + [np.zeros(0, np.int32)] * (k - k_live))
            args_tail.append(self._blocks_on(block_local_rows(
                per_step, nb, len(devs), mb)))
        entry = self._fused_program_for(nb, wb, z, mb, k, db)
        program, cold = entry[0], entry[1]
        if cold:
            self._fused_cost(entry, nb, wb, z, mb, k, db)
        entry[1] = False
        args = (self._program_params(params), self._buffers[0], rows_dev,
                idx_dev, *args_tail)
        return FusedFlush(program=program, args=args, cold=cold,
                          metas=[m for _, _, _, m in pending],
                          k=k, k_live=k_live, h2d_rows=h2d)

    def dispatch(self, flush: FusedFlush, *,
                 inject_faults: bool = True) -> Any:
        """Run one fused batch → the ``[K, N, W+2, Z]`` f16 outputs on the
        device (over node blocks: each block's ``[K, N/n, W+2, Z]``, in
        block order; fetch with ``copy_plane_to_host_async(outs,
        axis=1)``). The resident block is updated in place; a flush cut
        before a rebuild (``rebind=False``) runs against the retired
        old-shape block, which is then dropped. A device failure resets
        the ring and raises :class:`DeviceWindowError`.
        ``inject_faults=False`` skips the ``device.dispatch_error`` site:
        the aggregator consults it once per interval itself, flush or
        not, as the reference aggregator does."""
        fused = flush.program  # keplint: donates=1
        params, resident = flush.args[0], flush.args[1]
        rest = flush.args[2:]
        pair = self._run_device(lambda: fused(params, resident, *rest),
                                flush.cold, "fused window loop",
                                inject_faults)
        resident = pair[0]
        if flush.rebind:
            self._buffers[0] = resident
        return pair[1]

    def _fused_program_for(self, nb: int, wb: int, z: int,
                           mb: int | None, k: int, db: int) -> list:
        key = (nb, wb, z, self._model_mode or "", mb, k, db)
        entry = self._fused_programs.get(key)
        if entry is None:
            if fault.fire("device.compile_error") is not None:
                raise DeviceWindowError(
                    "compile_error",
                    f"injected compile failure for fused key {key}")
            from kepler_tpu_torch.parallel.packed import (
                make_fused_window_program)

            program = make_fused_window_program(
                n_workloads=wb, n_zones=z, model_mode=self._model_mode,
                backend=self._backend, model_bucket=mb, device=self.device,
                mesh=self._program_mesh)
            entry = [program, True, None, self._fused_label(key)]
            self._fused_programs[key] = entry
            self.compile_count += 1
            while len(self._fused_programs) > self._CACHE_CAP:
                self._fused_programs.pop(next(iter(self._fused_programs)))
        return entry

    def _fused_label(self, key: tuple) -> str:
        nb, wb, z, mode, mb, k, db = key
        label = f"fused_n{nb}_w{wb}_z{z}_{mode or 'ratio'}"
        if mb is not None:
            label += f"_m{mb}"
        return f"{label}_k{k}_d{db}"

    def _fused_cost(self, entry: list, nb: int, wb: int, z: int,
                    mb: int | None, k: int, db: int) -> None:
        """Cost stats of a fused program entry, captured once: resident,
        K delta sets in; resident' and K planes out; the bound of B2's
        one K-step launch on the kernel path."""
        if entry[2] is not None:
            return
        from kepler_tpu_torch.ops.cuda_attribution import (
            fused_window_steps_cost)

        # over node blocks: each block's K delta sets of width db, and
        # one B2 launch per block over its N/n rows
        n_blk = len(self._block_devices())
        width = wb + 2 * z + 4
        arg = 4 * (nb * width + n_blk * k * db * (width + 1))
        if mb is not None:
            arg += 4 * n_blk * k * mb
        out = 4 * nb * width + 2 * k * nb * (wb + 2) * z
        kernel = None
        if self._backend == "pallas" and not self._model_mode:
            nbytes, ops = fused_window_steps_cost(nb // n_blk, db, wb, z, k)
            kernel = (n_blk * nbytes, n_blk * ops)
        entry[2] = _cost_stats(entry[3], arg, out, kernel)

    # -- failure recovery / introspection ----------------------------------

    def reset(self) -> None:
        """Abandon the resident block AND the pending host ring."""
        super().reset()
        self._pending = []

    def pending_occupancy(self) -> int:
        """Windows staged but not yet flushed (0 ≤ · < K)."""
        return len(self._pending)

    def cost_stats(self) -> dict[str, dict]:
        out = super().cost_stats()
        for entry in self._fused_programs.values():
            if entry[2] is not None:
                out[entry[2]["label"]] = entry[2]
        return out

    def introspect(self) -> dict:
        out = super().introspect()
        out["fused"] = {
            "k": self.fused_k,
            "pending": len(self._pending),
            "programs": [{"key": entry[3],
                          "cold": bool(entry[1]), "cost": entry[2]}
                         for entry in self._fused_programs.values()],
        }
        return out


class ShardedWindowEngine(PackedWindowEngine):
    """Packed resident batch SHARDED over the mesh's node axis — the
    aggregator's rung 0 on a 1-D node mesh of two or more shards.

    Layout: the global padded batch is ``n_shards × shard_bucket`` rows;
    shard ``k``'s slice lives as its OWN ring of buffers on shard ``k``'s
    device (several shards may share one device: each keeps its own
    buffers and launches all the same). Per window:

    * **Sticky node→shard assignment.** A node keeps its shard for life
      (joiners go to the emptiest shard, model joiners to the
      estimator-lightest); a join or report change stages rows ONLY to
      the owning shard — the other shards see zero H2D and their
      resident buffers are untouched. The whole fleet is rebalanced
      (model rows dealt first, round-robin over sorted names) only when
      the shard bucket itself moves: overflow growth (no shard has a
      free row), hysteretic shrink, or a workload/zone-axis change.
    * **Per-shard delta H2D + shard-local scatter.** Each shard's
      changed rows are packed into that shard's pinned host slot,
      uploaded to its device alone and scatter-updated in place into
      its ring buffer.
    * **Per-shard launch.** The packed program runs once per shard on
      the shard's buffer (``parallel.packed`` over the mesh; with a
      model mode the sparse gather stays shard-local, with
      ``backend="pallas"`` kernel B1 launches once per shard). The
      result is one plane per shard; the publish fetch queues each
      shard's D2H copy into its rows of one pinned host buffer, in
      shard order (``copy_blocks_to_host_async``).

    Requires a 1-D mesh over the node axis with ≥ 2 shards; the
    aggregator runs :class:`PackedWindowEngine` on single-shard and 2-D
    (node × model) meshes, and demotes to it on any shard's failure.
    """

    _NODE_BLOCKS = False

    def __init__(self, mesh: Mesh, backend: str = "einsum",
                 model_mode: str | None = None,
                 node_bucket: int = 8, workload_bucket: int = 256,
                 shrink_after: int = 16, staging_slots: int = 2) -> None:
        n_dev = mesh.size
        if mesh.axis_size(NODE_AXIS) != n_dev or n_dev < 2:
            raise ValueError(
                "ShardedWindowEngine needs a 1-D mesh over the node axis "
                f"with ≥ 2 devices; got shape {mesh.describe()}")
        super().__init__(mesh, backend=backend, model_mode=model_mode,
                         node_bucket=node_bucket,
                         workload_bucket=workload_bucket,
                         shrink_after=shrink_after,
                         staging_slots=staging_slots)
        self.n_shards = n_dev
        self._program_mesh = mesh
        self._devices = list(mesh.devices)
        # shards THIS engine stages/uploads to and launches: every shard
        # on the single-process engine; the multi-host subclass narrows
        # it to this process's shards (remote shards' buffers stay None —
        # never packed, never uploaded, never launched here)
        self._owned_shards: list[int] = list(range(n_dev))
        # the node ladder sizes the PER-SHARD bucket here (global rows =
        # n_shards × bucket, evenly shardable by construction)
        self._ladder_n = BucketLadder(max(1, node_bucket // n_dev),
                                      shrink_after)
        # per-shard delta-staging ladders: shard 3's churn burst must not
        # inflate shard 0's staging shape
        self._ladder_ds = [BucketLadder(8, shrink_after)
                           for _ in range(n_dev)]
        self._n_slots = max(2, staging_slots)
        # slot-major ring: _buffers[slot][shard] (len(_buffers) stays the
        # ring depth, as on the base engine); _content mirrors it with
        # per-shard per-row identity, _stages with pinned host slots
        self._buffers = []  # type: ignore[assignment]
        self._content = []  # type: ignore[assignment]
        self._stages = []  # type: ignore[assignment]
        self._shard_of: dict[str, int] = {}
        self._free_by_shard: list[list[int]] = [[] for _ in range(n_dev)]
        self._width = 0

    # -- failure recovery --------------------------------------------------

    def reset(self) -> None:
        """Abandon every shard's ring + staging (see the base docstring):
        all shard rings re-seed together on the next plan."""
        super().reset()
        self._stages = []
        self._shard_of = {}
        self._free_by_shard = [[] for _ in range(self.n_shards)]
        self._width = 0

    # -- introspection -----------------------------------------------------

    def introspect(self) -> dict:
        out = super().introspect()
        out["sticky"] = {
            "assigned": len(self._shard_of),
            "free_rows": [len(f) for f in self._free_by_shard],
        }
        out["buckets"]["delta_shards"] = [lad.bucket
                                          for lad in self._ladder_ds]
        return out

    # -- cross-host agreement hooks (identity on one process) --------------

    def _agree_window_needs(self, need_s: int, need_w: int,
                            zones_t: tuple[str, ...]) -> tuple[int, int]:
        """Agree the per-shard and workload bucket NEEDS across every
        process before fitting the ladders: every process must size the
        same buckets. One process = nothing to agree."""
        return need_s, need_w

    def _agree_model_need(self, need_m: int) -> int:
        """Agree the sparse model-bucket need (same contract)."""
        return need_m

    # -- window planning ---------------------------------------------------

    def plan_window(self, rows: Sequence[RowInput],
                    zone_names: Sequence[str], params: Any) -> WindowPlan:
        self._window_seq += 1
        zones_t = tuple(zone_names)
        z = len(zones_t)
        k_sh = self.n_shards
        need_w = max((len(r.report.cpu_deltas) for r in rows), default=1)
        prev_sb, prev_wb = self._ladder_n.bucket, self._ladder_w.bucket

        overflow = False
        if self._buffers:
            # release departed nodes' rows, then stick joiners to the
            # emptiest shard (deterministic: ties break on shard index)
            live = {r.name for r in rows}
            for name in [n for n in self._shard_of if n not in live]:
                k = self._shard_of.pop(name)
                i = self._row_of.pop(name)
                self._names[i] = None
                self._mode[i] = 0
                self._dt[i] = 0.0
                self._counts[i] = 0
                self._ids[i] = []
                self._kinds[i] = None
                self._free_by_shard[k].append(i - k * prev_sb)
            headroom = [len(f) for f in self._free_by_shard]
            joiners = sorted((r for r in rows
                              if r.name not in self._shard_of),
                             key=lambda r: r.name)
            model_load: list[int] | None = None
            if joiners and any(r.report.mode == MODE_MODEL
                               for r in joiners):
                # per-shard MODE_MODEL occupancy, so model joiners land
                # on the estimator-lightest shard (the sparse bucket is
                # sized by the fullest shard — see _rebuild_shards)
                model_load = [0] * k_sh
                for name, q in self._shard_of.items():
                    i = self._row_of.get(name)
                    if i is not None and self._mode[i] == MODE_MODEL:
                        model_load[q] += 1
            for r in joiners:
                open_shards = [q for q in range(k_sh) if headroom[q] > 0]
                if not open_shards:
                    overflow = True  # no shard has a free row: rebalance
                    break
                if r.report.mode == MODE_MODEL:
                    k = min(open_shards,
                            key=lambda q: (model_load[q], -headroom[q], q))
                else:
                    k = max(open_shards, key=lambda q: (headroom[q], -q))
                headroom[k] -= 1
                if model_load is not None and r.report.mode == MODE_MODEL:
                    model_load[k] += 1
                self._shard_of[r.name] = k
        if overflow or not self._buffers:
            # ceil over the shards THIS process stages (rebalanced
            # occupancy; every shard on the single-process engine)
            need_s = -(-len(rows) // max(1, len(self._owned_shards)))
        else:
            occupancy = [0] * k_sh
            for k in self._shard_of.values():
                occupancy[k] += 1
            need_s = max(1, max(occupancy, default=1))
        need_s, need_w = self._agree_window_needs(need_s, need_w, zones_t)
        wb = self._ladder_w.fit(need_w)
        sb = self._ladder_n.fit(need_s)
        if self._buffers and (sb > prev_sb or wb > prev_wb):
            if fault.fire("device.oom_on_grow") is not None:
                raise DeviceWindowError(
                    "oom_on_grow",
                    f"injected OOM growing shard buckets ({prev_sb}, "
                    f"{prev_wb}) → ({sb}, {wb})")
        key = (sb, wb, zones_t)
        if key != self._key or not self._buffers or overflow:
            h2d_shards = self._rebuild_shards(rows, sb, wb, zones_t)
        else:
            self._buf_i = (self._buf_i + 1) % len(self._buffers)
            h2d_shards = self._delta_sync_shards(rows, zones_t)
        self._buf_served[self._buf_i] = self._window_seq
        nb = k_sh * sb
        meta = self._build_meta(rows, zones_t, sb)
        resident = tuple(self._buffers[self._buf_i])
        shard_params = tuple(
            self._device_params(params, self._devices[k])
            if resident[k] is not None else None for k in range(k_sh))
        args: tuple
        mb: int | None = None
        if self._sparse:
            mode_arr = np.asarray(self._mode, np.int32)
            local_rows = [np.flatnonzero(
                mode_arr[k * sb:(k + 1) * sb] == MODE_MODEL)
                for k in range(k_sh)]
            mb = self._ladder_m.fit(self._agree_model_need(
                max(1, max(len(lk) for lk in local_rows))))
            # shard-local indices, one mb-sized segment per shard; pad sb
            # is past the shard's rows → gather-clamped, scatter-dropped
            idx = np.full(k_sh * mb, sb, np.int32)
            for k, lk in enumerate(local_rows):
                idx[k * mb:k * mb + len(lk)] = lk
            args = (shard_params, resident, self._put_model_rows(idx, mb))
        else:
            args = (shard_params, resident)
        entry = self._program_for(nb, wb, z, mb)
        program, cold = entry[0], entry[1]
        if cold:
            self._program_cost(entry, nb, wb, z, mb)
        entry[1] = False
        return WindowPlan(program=program, args=args, cold=cold, meta=meta,
                          h2d_rows=sum(h2d_shards),
                          h2d_shards=tuple(h2d_shards), n_shards=k_sh)

    def _build_meta(self, rows: Sequence[RowInput],
                    zones_t: tuple[str, ...], sb: int) -> WindowMeta:
        """Per-window row-layout snapshot. Row indices are GLOBAL here;
        the multi-host subclass re-indexes into the LOCAL result plane
        (the only rows its publish fetch materializes)."""
        return WindowMeta(
            zones=list(zones_t),
            names=[r.name for r in rows],
            rows=dict(self._row_of),
            mode=np.asarray(self._mode, np.int32),
            dt=np.asarray(self._dt, np.float32),
            counts=list(self._counts),
            ids=list(self._ids),
            kinds=list(self._kinds),
            n_live=len(rows),
            n_rows=self.n_shards * sb,
        )

    def _put_model_rows(self, idx: np.ndarray,
                        mb: int) -> tuple[torch.Tensor | None, ...]:
        """Each launched shard's segment of the shard-local sparse index
        vector, on the shard's device (None for shards not launched
        here)."""
        owned = set(self._owned_shards)
        return tuple(
            torch.from_numpy(np.ascontiguousarray(
                idx[k * mb:(k + 1) * mb])).to(self._devices[k])
            if k in owned else None for k in range(self.n_shards))

    # -- resident maintenance ----------------------------------------------

    def _rebuild_shards(self, rows: Sequence[RowInput], sb: int, wb: int,
                        zones_t: tuple[str, ...]) -> list[int]:
        """Full re-pack + REBALANCE: deal MODE_MODEL nodes first, then
        ratio nodes, round-robin over shards — per-shard occupancy stays
        within one row of even AND so does the per-shard estimator load
        (the sparse model bucket is sized by the FULLEST shard's model
        rows). Only bucket/zone moves land here — a steady fleet never
        migrates a node."""
        from kepler_tpu_torch.parallel.packed import (PackedLayout,
                                                      pack_fleet_inputs)

        k_sh = self.n_shards
        z = len(zones_t)
        layout = PackedLayout(wb, z)
        width = layout.width
        by_name = sorted(rows, key=lambda r: r.name)
        ordered = ([r for r in by_name if r.report.mode == MODE_MODEL]
                   + [r for r in by_name if r.report.mode != MODE_MODEL])
        self._shard_of = {}
        self._row_of = {}
        self._names = [None] * (k_sh * sb)
        self._mode = [0] * (k_sh * sb)
        self._dt = [0.0] * (k_sh * sb)
        self._counts = [0] * (k_sh * sb)
        self._ids = [[] for _ in range(k_sh * sb)]
        self._kinds = [None] * (k_sh * sb)
        # deal members round-robin over the shards THIS process stages
        # (all of them single-process; the local subset multi-host)
        owned = list(self._owned_shards)
        pos_of = {k: pos for pos, k in enumerate(owned)}
        shard_packed: list[np.ndarray | None] = []
        shard_idents: list[list] = []
        h2d_shards: list[int] = []
        for k in range(k_sh):
            if k not in pos_of:
                # another process's shard: never packed, never uploaded —
                # that process stages it from its own report store
                shard_packed.append(None)
                shard_idents.append([_EMPTY] * sb)
                self._free_by_shard[k] = []
                h2d_shards.append(0)
                continue
            members = ordered[pos_of[k]::len(owned)]
            n_real = len(members)
            if n_real:
                reports = [r.report for r in members]
                zd, zv = align_zone_matrices(
                    reports, [r.zone_names for r in members], zones_t)
                batch = assemble_fleet_batch(
                    reports, n_zones=z, node_bucket=sb,
                    workload_bucket=wb, zone_deltas_mat=zd,
                    zone_valid_mat=zv)
                packed = pack_fleet_inputs(batch)
                if packed.shape != (sb, width):
                    raise AssertionError(
                        f"shard {k} packed shape {packed.shape} != "
                        f"({sb}, {width})")
                base = k * sb
                self._mode[base:base + sb] = batch.mode.tolist()
                self._dt[base:base + sb] = batch.dt_s.tolist()
                self._counts[base:base + sb] = list(batch.workload_counts)
                self._ids[base:base + sb] = list(batch.workload_ids)
                self._kinds[base:base + n_real] = [r.workload_kinds
                                                   for r in reports]
                for j, r in enumerate(members):
                    self._shard_of[r.name] = k
                    self._row_of[r.name] = base + j
                    self._names[base + j] = r.name
            else:
                packed = np.tile(layout.empty_row(), (sb, 1))
            shard_packed.append(packed)
            shard_idents.append([r.ident for r in members]
                                + [_EMPTY] * (sb - n_real))
            self._free_by_shard[k] = list(range(sb - 1, n_real - 1, -1))
            h2d_shards.append(n_real)
        # every ring slot starts from this full pack, each shard's buffer
        # its own allocation on its device
        self._buffers = [
            [(torch.from_numpy(shard_packed[k]).to(self._devices[k],
                                                   copy=True)
              if shard_packed[k] is not None else None)
             for k in range(k_sh)]
            for _ in range(self._n_slots)]
        self._content = [[list(shard_idents[k]) for k in range(k_sh)]
                         for _ in range(self._n_slots)]
        self._stages = [[_HostSlot(self._devices[k]) for k in range(k_sh)]
                        for _ in range(self._n_slots)]
        self._buf_i = 0
        self._buf_served = [self._window_seq] * self._n_slots
        self._stage_i = 0
        self._key = (sb, wb, zones_t)
        self._width = width
        self._empty_row = layout.empty_row()
        return h2d_shards

    def _delta_sync_shards(self, rows: Sequence[RowInput],
                           zones_t: tuple[str, ...]) -> list[int]:
        """Per-shard delta: stage each shard's changed/joined/cleared
        rows into ITS pinned host slot, upload to ITS device alone and
        scatter in place into its ring buffer. Shards with nothing
        changed are untouched — no H2D, no launch, no staging writes."""
        sb = self._key[0]  # type: ignore[index]
        k_sh = self.n_shards
        width = self._width
        content_slot = self._content[self._buf_i]
        changed_by: list[list[tuple[int, RowInput]]] = [
            [] for _ in range(k_sh)]
        for r in rows:
            k = self._shard_of[r.name]
            content = content_slot[k]
            i = self._row_of.get(r.name)
            if i is None:
                local = self._free_by_shard[k].pop()
                i = k * sb + local
                self._row_of[r.name] = i
                self._names[i] = r.name
                # other ring slots may still hold another node's data in
                # this row — restage on their next turn
                for slot, slot_content in enumerate(self._content):
                    if slot != self._buf_i:
                        slot_content[k][local] = _DIRTY
            else:
                local = i - k * sb
                if (r.ident is not None and content[local] is not _EMPTY
                        and content[local] is not _DIRTY
                        and content[local] == r.ident):
                    continue  # this shard's slot row is current
            self._mode[i] = r.report.mode
            self._dt[i] = r.report.dt_s
            self._counts[i] = len(r.report.cpu_deltas)
            self._ids[i] = r.report.workload_ids
            self._kinds[i] = r.report.workload_kinds
            content[local] = r.ident
            changed_by[k].append((local, r))
        h2d_shards = [0] * k_sh
        self._stage_i = (self._stage_i + 1) % len(self._stages)
        stage_slot = self._stages[self._stage_i]
        # only owned shards can hold rows (the sticky map never assigns a
        # node to a shard this process doesn't stage), so remote shards
        # are untouched by construction: zero H2D, zero staging writes
        for k in self._owned_shards:
            content = content_slot[k]
            changed = changed_by[k]
            changed_locals = {local for local, _ in changed}
            base = k * sb
            cleared = [local for local in range(sb)
                       if self._names[base + local] is None
                       and content[local] is not _EMPTY
                       and local not in changed_locals]
            for local in cleared:
                content[local] = _EMPTY
            n_stage = len(changed) + len(cleared)
            h2d_shards[k] = n_stage
            if n_stage == 0:
                continue
            # the span NAME keeps the shard id (trace readability); the
            # histogram observes one shared per-shard stage, so the stage
            # label's cardinality is independent of the mesh size
            with telemetry.span(f"window.h2d_delta.s{k}",
                                stage="window.h2d_delta.shard"):
                db = min(self._ladder_ds[k].fit(n_stage), sb)
                slot = stage_slot[k]
                stage, idx = slot.reserve((db, width), (db,))
                stage[:] = 0.0
                idx[:] = sb
                if changed:
                    from kepler_tpu_torch.parallel.packed import (
                        pack_reports_into)

                    reports = [r.report for _, r in changed]
                    zd, zv = align_zone_matrices(
                        reports, [r.zone_names for _, r in changed],
                        zones_t)
                    pack_reports_into(stage, reports, zd, zv,
                                      self._key[1])  # type: ignore[index]
                    idx[:len(changed)] = [local for local, _ in changed]
                for j, local in enumerate(cleared):
                    stage[len(changed) + j] = self._empty_row
                    idx[len(changed) + j] = local
                entry = self._update_for(sb, width, db)
                update = entry[0]  # keplint: donates=0
                update_cold, entry[1] = entry[1], False
                resident = self._buffers[self._buf_i][k]
                rows_dev, idx_dev = slot.upload()
                if update_cold:
                    entry[2] = _cost_stats(
                        entry[3], 4 * (sb * width + db * width + db),
                        4 * sb * width, None)
                    with telemetry.span("window.compile"):
                        resident = update(resident, rows_dev, idx_dev)
                else:
                    resident = update(resident, rows_dev, idx_dev)
        return h2d_shards


class HostLocalFabric:
    """In-process stand-in for the cross-host mesh fabric.

    N virtual hosts run their :class:`MultiHostWindowEngine` on N
    threads; the fabric provides the two cross-host exchanges a real
    multi-process job performs:

    * :meth:`agree` — elementwise max over small int vectors (the
      bucket-need agreement that keeps every host sizing the same
      buckets);
    * :meth:`exchange` — merge per-party mappings.

    :meth:`kill` breaks the fabric: every in-flight and future
    rendezvous raises ``DeviceWindowError("host_dead")`` on the
    survivors — the same failure surface a dead host's collective
    produces — which the aggregator's ladder turns into the
    "mesh minus one host" demotion. Production multi-host runs with no
    fabric (``fabric=None``) and agrees through ``torch.distributed``
    instead.

    ``parties`` names the LIVE party ids explicitly (default
    ``range(n_parties)``). The elastic-membership plane uses it to
    stand up a fabric incarnation over a SURVIVOR subset whose ids
    keep their original process indices — e.g. ``parties=[1, 2]``
    after host 0 of a 3-host mesh died — so the survivors' rebuilt
    multi-host engines rendezvous among themselves without relabeling.
    A rejoin builds a fresh full-set incarnation (sequence numbers
    start aligned at zero on every party, matching the freshly rebuilt
    engines).
    """

    def __init__(self, n_parties: int | None = None,
                 timeout: float = 60.0,
                 parties: "Sequence[int] | None" = None) -> None:
        if parties is None:
            if n_parties is None or n_parties < 1:
                raise ValueError("fabric needs at least one party")
            parties = range(int(n_parties))
        ids = sorted({int(p) for p in parties})
        if not ids or any(p < 0 for p in ids):
            raise ValueError(
                f"fabric party ids must be non-negative, got {ids!r}")
        if n_parties is not None and len(ids) != int(n_parties):
            raise ValueError(
                f"n_parties={n_parties} but {len(ids)} party ids "
                f"given: {ids!r}")
        self._parties = tuple(ids)
        self._n = len(ids)
        self._timeout = float(timeout)
        self._lock = threading.Lock()
        self._barrier = threading.Barrier(self._n)
        self._dead = False
        self._seq = {p: 0 for p in ids}
        self._slots: dict = {}

    @property
    def n_parties(self) -> int:
        return self._n

    @property
    def parties(self) -> tuple:
        """The live party ids this incarnation rendezvouses over."""
        return self._parties

    def kill(self) -> None:
        """Simulate a host death: break every rendezvous, now and
        forever — survivors see ``DeviceWindowError("host_dead")``."""
        self._dead = True
        self._barrier.abort()

    def _rendezvous(self, party: int, name: str, value: Any) -> list:
        if self._dead:
            raise DeviceWindowError(
                "host_dead", "mesh fabric is down (peer host died)")
        if party not in self._seq:
            raise DeviceWindowError(
                "host_dead",
                f"party {party} is not in this fabric incarnation "
                f"(live parties {list(self._parties)})")
        key = (name, self._seq[party])
        self._seq[party] += 1
        with self._lock:
            entry = self._slots.setdefault(key,
                                           {"values": [], "reads": 0})
            entry["values"].append(value)
        try:
            self._barrier.wait(timeout=self._timeout)
        except threading.BrokenBarrierError:
            raise DeviceWindowError(
                "host_dead", f"mesh peer lost at {name} rendezvous")
        with self._lock:
            entry = self._slots[key]
            values = list(entry["values"])
            entry["reads"] += 1
            if entry["reads"] >= self._n:
                del self._slots[key]
        if len(values) != self._n:
            # parties rendezvoused on DIFFERENT call sites: their plan
            # paths diverged (a bug the agreement contract cannot survive)
            raise DeviceWindowError(
                "mesh_desync",
                f"{len(values)}/{self._n} parties met at {name}")
        return values

    def agree(self, party: int, name: str, vec: np.ndarray) -> np.ndarray:
        return np.maximum.reduce(self._rendezvous(party, name,
                                                  np.asarray(vec)))

    def exchange(self, party: int, name: str,
                 mapping: dict) -> dict:
        merged: dict = {}
        for m in self._rendezvous(party, name, dict(mapping)):
            merged.update(m)
        return merged


class MultiHostWindowEngine(ShardedWindowEngine):
    """The multi-host tier of the sharded window: ONE logical aggregator
    whose packed resident batch spans every process's shards, with
    everything kept strictly PROCESS-LOCAL.

    The mesh is global (``initialize_multihost()`` + ``make_mesh()``
    span all processes' devices); this engine narrows ``_owned_shards``
    to the shards of THIS process, so the inherited machinery stages,
    packs, scatters and launches only local shards:

    * **Host-local staging + delta H2D.** Joins/changes/drops touch only
      local shards (the sticky map never assigns a node to a remote
      shard); remote shards' buffers are ``None`` — never packed, never
      uploaded, never launched. Zero cross-host bytes on the ingest
      path.
    * **No global tensor.** The packed program has no cross-node math,
      so each process launches its own shards' programs on its own
      buffers; the "assembled" resident batch is the per-shard tuple of
      owned buffers.
    * **Bucket agreement.** Before fitting the ladders, the per-shard /
      workload / model bucket NEEDS (and a zone-axis hash) are agreed
      across processes with one tiny max-reduce — every process must
      size the same buckets. A zone-axis mismatch raises ``mesh_desync``.
    * **Owned-rows publish fetch.** The result plane holds the owned
      shards only, and the window meta is indexed into that local
      plane: each process publishes exactly the nodes it ingested
      (which ``fleet.ring.ring_from_mesh`` makes exactly the nodes whose
      rows live here).

    ``device_process`` maps a shard INDEX to its process (default: the
    shard's own ``process``). ``fabric`` (a :class:`HostLocalFabric`)
    replaces the cross-process agreement for in-process simulation;
    without one, agreement is a ``torch.distributed`` MAX all-reduce of
    an int64 CPU tensor over the joined gloo group.
    """

    def __init__(self, mesh: Mesh, backend: str = "einsum",
                 model_mode: str | None = None,
                 node_bucket: int = 8, workload_bucket: int = 256,
                 shrink_after: int = 16, staging_slots: int = 2,
                 process_index: int | None = None,
                 device_process: Callable[[int], int] | None = None,
                 fabric: HostLocalFabric | None = None) -> None:
        super().__init__(mesh, backend=backend, model_mode=model_mode,
                         node_bucket=node_bucket,
                         workload_bucket=workload_bucket,
                         shrink_after=shrink_after,
                         staging_slots=staging_slots)
        if device_process is None:
            def device_process(k: int) -> int:
                return mesh.shards[k].process
        if process_index is None:
            process_index = _process_index()
        self._party = int(process_index)
        procs = [int(device_process(k)) for k in range(mesh.size)]
        self._shard_processes = procs
        self._owned_shards = [k for k, p in enumerate(procs)
                              if p == self._party]
        if not self._owned_shards:
            raise ValueError(
                f"process {self._party} owns no devices of the mesh "
                f"(shard processes {procs})")
        self._host_count = len(set(procs))
        self._fabric = fabric

    # -- cross-host agreement ----------------------------------------------

    def _agree_vec(self, name: str, vec: np.ndarray) -> np.ndarray:
        if self._fabric is not None:
            return self._fabric.agree(self._party, name, vec)
        if self._host_count <= 1:
            return vec
        t = torch.from_numpy(np.asarray(vec, np.int64).copy())
        torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX)
        return t.numpy()

    def _agree_window_needs(self, need_s: int, need_w: int,
                            zones_t: tuple[str, ...]) -> tuple[int, int]:
        import hashlib

        zh = int.from_bytes(
            hashlib.blake2b(repr(zones_t).encode(),
                            digest_size=4).digest(), "big")
        # max(zh) and -max(-zh) = min(zh): equal iff every host packed
        # the same canonical zone axis (string sets can't ride the
        # max-reduce, their hash can)
        out = self._agree_vec(
            "window_needs", np.asarray([need_s, need_w, zh, -zh],
                                       np.int64))
        if int(out[2]) != zh or int(-out[3]) != zh:
            raise DeviceWindowError(
                "mesh_desync",
                "hosts disagree on the canonical zone axis")
        return int(out[0]), int(out[1])

    def _agree_model_need(self, need_m: int) -> int:
        out = self._agree_vec("model_need",
                              np.asarray([need_m], np.int64))
        return int(out[0])

    # -- host-local meta ---------------------------------------------------

    def _build_meta(self, rows: Sequence[RowInput],
                    zones_t: tuple[str, ...], sb: int) -> WindowMeta:
        """LOCAL-plane meta: row indices point into the concatenation of
        the OWNED shards' result rows (what the publish fetch
        materializes) — this host publishes exactly the nodes it
        ingested, never a remote host's rows."""
        owned = self._owned_shards
        pos_of = {k: pos for pos, k in enumerate(owned)}

        def seg(xs: list) -> list:
            return [x for k in owned for x in xs[k * sb:(k + 1) * sb]]

        local_rows = {}
        for name, i in self._row_of.items():
            k, local = divmod(i, sb)
            local_rows[name] = pos_of[k] * sb + local
        return WindowMeta(
            zones=list(zones_t),
            names=[r.name for r in rows],
            rows=local_rows,
            mode=np.asarray(seg(self._mode), np.int32),
            dt=np.asarray(seg(self._dt), np.float32),
            counts=seg(self._counts),
            ids=seg(self._ids),
            kinds=seg(self._kinds),
            n_live=len(rows),
            n_rows=len(owned) * sb,
        )

    # -- introspection -----------------------------------------------------

    def introspect(self) -> dict:
        out = super().introspect()
        out["multihost"] = {
            "hosts": self._host_count,
            "process": self._party,
            "owned_shards": list(self._owned_shards),
            "simulated_fabric": self._fabric is not None,
        }
        return out
