"""Device-resident fleet windows: the aggregator's hot-path engines.

The counterpart of ``kepler_tpu.fleet.window`` (single device). The
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

The engines own no locks and no HTTP. Entry points take ``device="cuda"``
by default and raise when CUDA is absent; ``device="cpu"`` runs the same
engines with the kernels' plain versions (the tests).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Mapping, NamedTuple, Sequence

import numpy as np
import torch

from kepler_tpu_torch import fault, telemetry
from kepler_tpu_torch.device import resolve_device
from kepler_tpu_torch.parallel.fleet import (MODE_MODEL, NodeReport,
                                             assemble_fleet_batch)

__all__ = [
    "BucketLadder",
    "DeviceWindowError",
    "FusedFlush",
    "FusedWindowEngine",
    "PackedWindowEngine",
    "RowInput",
    "WindowMeta",
    "WindowPlan",
    "align_zone_matrices",
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
    # publish-fetch override; None = ``fetch_plane`` of the whole output
    fetch: Callable[[Any], np.ndarray] | None = None


def fetch_plane(out: torch.Tensor) -> np.ndarray:
    """Device watts plane → host array (the publish fetch; syncs)."""
    return out.cpu().numpy()


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
    upload to complete before handing its memory back for rewriting."""

    __slots__ = ("device", "rows", "idx", "_event")

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.rows = torch.zeros((0, 0), dtype=torch.float32)
        self.idx = torch.zeros(0, dtype=torch.int32)
        self._event: torch.cuda.Event | None = None

    def reserve(self, rows_shape: tuple[int, ...],
                idx_shape: tuple[int, ...]) -> tuple[np.ndarray, np.ndarray]:
        """→ writable (rows, idx) host views of the requested shapes."""
        if self._event is not None:
            self._event.synchronize()
            self._event = None
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
        if self.device.type != "cuda":
            return self.rows.clone(), self.idx.clone()
        rows = self.rows.to(self.device, non_blocking=True)
        idx = self.idx.to(self.device, non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record(torch.cuda.current_stream(self.device))
        return rows, idx


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


class PackedWindowEngine:
    """Resident packed batch + program/update cache for the packed-f16
    fleet path. Single-threaded by contract: only the aggregation loop
    calls :meth:`plan_window` and :meth:`dispatch_window`."""

    # program-cache bound: ladder moves retire old shapes; keep a few
    # around for oscillation, evict the oldest beyond this
    _CACHE_CAP = 32

    # device shards the resident batch spans (one: single device)
    n_shards = 1

    def __init__(self, device: str | torch.device = "cuda",
                 backend: str = "einsum",
                 model_mode: str | None = None,
                 node_bucket: int = 8, workload_bucket: int = 256,
                 shrink_after: int = 16, staging_slots: int = 2) -> None:
        if backend not in ("einsum", "pallas"):
            raise ValueError(f"unknown attribution backend {backend!r}; "
                             "valid: einsum, pallas")
        self.device = resolve_device(device)
        self._backend = backend
        self._model_mode = model_mode
        self._ladder_n = BucketLadder(node_bucket, shrink_after)
        self._ladder_w = BucketLadder(workload_bucket, shrink_after)
        self._ladder_m = BucketLadder(8, shrink_after)
        self._ladder_d = BucketLadder(8, shrink_after)
        # sparse model evaluation needs the einsum gather path
        self._sparse = bool(model_mode) and backend == "einsum"
        # cache entries are [program, cold, cost_stats | None, label]
        self._programs: dict[tuple, list] = {}
        self._updates: dict[tuple, list] = {}  # (n, width, db) key
        self.compile_count = 0  # program-cache misses (attribution + update)
        self._params_src: Any = None
        self._params_dev: dict[str, torch.Tensor] | None = None

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

    def _device_params(self, params: Any) -> dict[str, torch.Tensor] | None:
        """Estimator params → f32 tensors on the engine's device (cached
        per params object); None for ratio-only fleets."""
        if not self._model_mode or not isinstance(params, Mapping):
            return None
        if params is not self._params_src:
            self._params_dev = {
                k: (v if isinstance(v, torch.Tensor)
                    else torch.from_numpy(np.array(v, np.float32))).to(
                        self.device, torch.float32)
                for k, v in params.items()}
            self._params_src = params
        return self._params_dev

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
                backend=self._backend, model_bucket=mb, device=self.device)
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
            from kepler_tpu_torch.ops.attribution import scatter_rows_

            entry = [scatter_rows_, True, None, self._update_label(key)]
            self._updates[key] = entry
            self.compile_count += 1
            while len(self._updates) > self._CACHE_CAP:
                self._updates.pop(next(iter(self._updates)))
        return entry

    # -- cost introspection ------------------------------------------------

    def _program_label(self, key: tuple) -> str:
        """Bounded metric label for an attribution-program cache key."""
        nb, wb, z, mode, mb = key
        label = f"prog_n{nb}_w{wb}_z{z}_{mode or 'ratio'}"
        if mb is not None:
            label += f"_m{mb}"
        return label

    def _update_label(self, key: tuple) -> str:
        n, width, db = key
        return f"upd_n{n}_x{width}_d{db}"

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
        """Resident-row occupancy split by row mode (one shard)."""
        out = {"rows": len(self._row_of), "model_rows": 0}
        for i in self._row_of.values():
            if self._mode[i] == MODE_MODEL:
                out["model_rows"] += 1
        return [out]

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
        dev_params = self._device_params(params)
        args: tuple
        mb: int | None = None
        if self._sparse:
            model_idx = np.flatnonzero(
                np.asarray(self._mode, np.int32) == MODE_MODEL)
            mb = self._ladder_m.fit(max(1, len(model_idx)))
            idx = np.full(mb, nb, np.int32)  # pad → gather-clamped, dropped
            idx[:len(model_idx)] = model_idx
            args = (dev_params, resident,
                    torch.from_numpy(idx).to(self.device))
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
        return self._run_device(plan.program, plan.args, plan.cold,
                                "packed window program")

    def _run_device(self, program: Callable, args: tuple, cold: bool,
                    what: str) -> Any:
        if fault.fire("device.dispatch_error") is not None:
            self.reset()
            raise DeviceWindowError("dispatch_error",
                                    f"injected dispatch failure ({what})")
        try:
            if cold:
                # first launch of this key: builds its kernels on first use
                with telemetry.span("window.compile"):
                    return program(*args)
            return program(*args)
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
        self._buffers = [host.to(self.device, copy=True)
                         for _ in self._stages]
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
        stage, idx = slot.reserve((db, width), (db,))
        stage[:] = 0.0
        idx[:] = nb
        self._fill_stage(stage, idx, changed, cleared, zones_t)
        entry = self._update_for(nb, width, db)
        update = entry[0]
        update_cold, entry[1] = entry[1], False
        resident = self._buffers[self._buf_i]
        rows_dev, idx_dev = slot.upload()
        if update_cold:
            entry[2] = _cost_stats(entry[3], 4 * (nb * width + db * width
                                                  + db),
                                   4 * nb * width, None)
            with telemetry.span("window.compile"):
                update(resident, rows_dev, idx_dev)
        else:
            update(resident, rows_dev, idx_dev)
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
    """

    def __init__(self, device: str | torch.device = "cuda",
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
        nb, wb, zones_t = self._key  # type: ignore[misc]
        z = len(zones_t)
        pending, self._pending = self._pending, []
        k_live = len(pending)
        k = self.fused_k
        need_d = max(1, max(len(idx) for _, idx, _, _ in pending))
        db = min(self._ladder_d.fit(need_d), nb)
        width = self._empty_row.shape[0]
        slot = self._stages[0]
        rows_b, idx_b = slot.reserve((k, db, width), (k, db))
        rows_b[:] = 0.0
        idx_b[:] = nb
        h2d = 0
        for j, (stage, idx, _, _) in enumerate(pending):
            n = len(idx)
            rows_b[j, :n] = stage
            idx_b[j, :n] = idx
            h2d += n
        rows_dev, idx_dev = slot.upload()
        args_tail: list = []
        mb: int | None = None
        if self._sparse:
            need_m = max(1, max(len(mi) for _, _, mi, _ in pending))
            mb = self._ladder_m.fit(need_m)
            mrows = np.full((k, mb), nb, np.int32)
            for j, (_, _, mi, _) in enumerate(pending):
                mrows[j, :len(mi)] = mi
            args_tail.append(torch.from_numpy(mrows).to(self.device))
        entry = self._fused_program_for(nb, wb, z, mb, k, db)
        program, cold = entry[0], entry[1]
        if cold:
            self._fused_cost(entry, nb, wb, z, mb, k, db)
        entry[1] = False
        args = (self._device_params(params), self._buffers[0],
                rows_dev, idx_dev, *args_tail)
        return FusedFlush(program=program, args=args, cold=cold,
                          metas=[m for _, _, _, m in pending],
                          k=k, k_live=k_live, h2d_rows=h2d)

    def dispatch(self, flush: FusedFlush) -> torch.Tensor:
        """Run one fused batch → the ``[K, N, W+2, Z]`` f16 outputs on the
        device. The resident block is updated in place; a flush cut
        before a rebuild (``rebind=False``) runs against the retired
        old-shape block, which is then dropped. A device failure resets
        the ring and raises :class:`DeviceWindowError`."""
        resident, outs = self._run_device(flush.program, flush.args,
                                          flush.cold, "fused window loop")
        if flush.rebind:
            self._buffers[0] = resident
        return outs

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
                backend=self._backend, model_bucket=mb, device=self.device)
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

        width = wb + 2 * z + 4
        arg = 4 * (nb * width + k * db * width + k * db)
        if mb is not None:
            arg += 4 * k * mb
        out = 4 * nb * width + 2 * k * nb * (wb + 2) * z
        kernel = None
        if self._backend == "pallas" and not self._model_mode:
            kernel = fused_window_steps_cost(nb, db, wb, z, k)
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
