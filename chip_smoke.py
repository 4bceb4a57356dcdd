"""Chip smoke test of the PyTorch/CUDA port (``kepler_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``kepler_tpu_torch/ops/csrc`` (one
``nvcc`` per source, all started together), holds each kernel against its
plain PyTorch version on the card at the main paths' shapes and times
both, then drives the port's main paths through its entry points at the
``BASELINE.json`` north-star width (1024 nodes × 100 workloads × 4 RAPL
zones, buckets N = 1024, W = 256):

1. a ratio fleet, wire-v2 keyframes then delta frames, through
   ``FusedWindowEngine(device="cuda", backend="pallas", fused_k=4)`` for
   8 intervals — kernel B2 once per flush of K = 4 intervals;
2. a 50/50 ratio/MLP fleet through ``PackedWindowEngine(device="cuda",
   backend="pallas", model_mode="mlp")`` for 4 windows — kernel B1 once
   per window;
3. the temporal fleet window (the aggregator's ``model: temporal``), a
   50/50 ratio/temporal fleet with churn: per-node ``HistoryBuffer``s
   accrete T = 16 ticks of features over 20 windows, the ``[N, W, T, F]``
   windows go through ``make_temporal_fleet_program(device="cuda",
   backend="pallas")`` and ``run_fleet_attribution`` — B1 once per
   window, B3 never (the estimator's single-query fast path);
4. the temporal model's full-sequence trunk on the same windows,
   ``predict_temporal(..., attention_fn=pallas_attention_fn())`` (d_model
   128, 4 heads of 32) — kernel B3 once per call over 262,144 sequences,
   every launch its tensor-core variant.

Beside them, the serial rung's MLP program (``make_fleet_program(
model_mode="mlp")``) is held against the CPU at bf16 and in accuracy mode,
and B2 and B3 are timed in each of their forms: B2 per window (K = 1)
and per flush (K = 4, one launch), B3's tensor-core variant against its
SIMT variant at bf16 and f32.

Every published plane and watts tensor is checked against the same
schedule through the port on ``device="cpu"`` (a 32-node subset for the
temporal model) and for energy conservation. Each kernel's launch count
is set to 0 just before a path runs and read just after. Every failed
check raises, so the run exits non-zero.

Output: one JSON object per line; the card's name and power limit as
``nvidia-smi`` prints them on a line of their own; a ``{"kernels": …}``
line; and last ``{"ok": true, "device": {...}}``. Without CUDA, or
without the repository beside it, the script exits non-zero before it
prints any result. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N_NODES, N_WORKLOADS = 1024, 100
ZONES = ["package", "core", "dram", "uncore"]
FUSED_K = 4
RATIO_INTERVALS = 8
MIXED_WINDOWS = 4
SEED = 20261016
# temporal paths: history ticks (config default ``history_window``),
# windows driven (histories go from empty to full), the node subset held
# against the CPU, and the B3 shapes (path 4; the temporal-fleet
# scenario's 256 × 64 sequences of T = 128)
HISTORY_T = 16
TEMPORAL_WINDOWS = 20
CPU_NODES = 32
B3_SHAPES = ((N_NODES * 256, 16), (256 * 64, 128))
D_MODEL, N_HEADS = 128, 4


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def f16_ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Elementwise distance in f16 ulps (monotone integer mapping)."""
    ia = a.astype(np.float16).view(np.int16).astype(np.int32)
    ib = b.astype(np.float16).view(np.int16).astype(np.int32)
    ia = np.where(ia < 0, -32768 - ia, ia)
    ib = np.where(ib < 0, -32768 - ib, ib)
    return np.abs(ia - ib)


def time_ms(fn, reps: int = 25, batch: int = 20) -> float:
    """Median over ``reps`` CUDA-event timings of ``batch`` back-to-back
    calls, per call (warm: inputs stay resident in the 50 MB L2)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def kernel_times_us(prof) -> list[tuple[float, str, int]]:
    """(device µs, name, count) of each device kernel a profile saw. Only
    the kernels' own events count: an operator's self device time repeats
    the time of the kernels it launched."""
    from torch.autograd import DeviceType

    rows = []
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CPU:
            continue
        us = float(getattr(evt, "self_device_time_total",
                           getattr(evt, "self_cuda_time_total", 0.0)))
        if us > 0:
            rows.append((us, evt.key, evt.count))
    return sorted(rows, reverse=True)


def device_ms(fn, calls: int = 20, tries: int = 3) -> float | None:
    """Device time of ``fn`` per call from ``torch.profiler``: the sum of
    the CUDA kernels' own time over ``calls`` calls, divided by ``calls``
    (no host time, no gaps). A trace is whole when it holds every kernel
    a multiple of ``calls`` times (each call launches the same kernels);
    one that dropped events is taken again, up to ``tries`` times. None
    when no trace was whole."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = kernel_times_us(prof)
        if rows and all(count % calls == 0 for _, _, count in rows):
            return sum(us for us, _, _ in rows) / calls / 1e3
    return None


def provenance() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    from kepler_tpu_torch.ops import build

    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    emit({"phase": "provenance", "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": nvcc,
          "python": sys.version.split()[0], "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0)})
    return smi


# -- kernel phases ------------------------------------------------------------

def kernel_b1(dev: torch.device) -> dict:
    """B1 at the mixed path's shapes: kernel == plain exactly."""
    from kepler_tpu_torch.ops import cuda_attribution as ca

    n, w, z = N_NODES, 256, len(ZONES)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ratio = torch.rand((n, w), generator=gen, device=dev)
    active = torch.rand((n, z), generator=gen, device=dev) * 5e8
    power = torch.rand((n, z), generator=gen, device=dev) * 1e8
    e, p = ca.outer_product_attribution(ratio, active, power)
    e_ref, p_ref = ca.outer_product_attribution_ref(ratio, active, power)
    torch.cuda.synchronize()
    err = max(float((e - e_ref).abs().max()), float((p - p_ref).abs().max()))
    check(torch.equal(e, e_ref) and torch.equal(p, p_ref),
          f"B1 kernel differs from its plain version (max abs err {err})")
    nbytes, ops = ca.outer_product_cost(n, w, z)
    bound, by = ca.bound_ms(nbytes, ops)
    row = {
        "name": "outer_product_attribution", "route": "cuda",
        "source": "kepler_tpu_torch/ops/csrc/attribution.cu",
        "replaces": "kepler_tpu/ops/pallas_attribution.py:66",
        "shape": {"N": n, "W": w, "Z": z}, "max_abs_err": err,
        "ms": time_ms(lambda: ca.outer_product_attribution(
            ratio, active, power)),
        "device_ms": device_ms(lambda: ca.outer_product_attribution(
            ratio, active, power)),
        "plain_device_ms": device_ms(lambda: ca.outer_product_attribution_ref(
            ratio, active, power)),
        "plain_ms": time_ms(lambda: ca.outer_product_attribution_ref(
            ratio, active, power)),
        "library_ms": time_ms(lambda: (
            torch.einsum("nw,nz->nwz", ratio, active),
            torch.einsum("nw,nz->nwz", ratio, power))),
        "bound_ms": bound, "bound_by": by, "bound_us": bound * 1e3,
        "bytes": nbytes, "parity": "exact",
    }
    emit({"phase": "kernel", **row})
    return row


def b2_inputs(dev: torch.device, n: int, w: int, z: int, db: int,
              seed: int | None = None):
    from kepler_tpu_torch.parallel.packed import PackedLayout

    rng = np.random.default_rng(SEED + db if seed is None else seed)
    lay = PackedLayout(w, z)

    def rows(k: int) -> np.ndarray:
        out = np.zeros((k, lay.width), np.float32)
        out[:, lay.cpu] = rng.uniform(0.0, 5.0, (k, w))
        out[:, lay.cpu][:, N_WORKLOADS:] = np.nan  # pad workload slots
        out[:, lay.zone] = rng.uniform(1e8, 1.5e9, (k, z))
        out[:, lay.zone_valid] = rng.uniform(size=(k, z)) > 0.05
        out[:, lay.col_ratio] = rng.uniform(-0.1, 1.1, k)
        out[:, lay.col_denom] = np.nansum(out[:, lay.cpu], axis=1)
        out[:, lay.col_dt] = np.where(rng.uniform(size=k) < 0.02, 0.0, 5.0)
        return out

    resident = rows(n)
    delta = rows(db)
    idx = rng.permutation(n)[:db].astype(np.int32)
    idx[rng.uniform(size=db) < 0.05] = n  # pad entries: dropped
    return (torch.from_numpy(resident).to(dev),
            torch.from_numpy(delta).to(dev), torch.from_numpy(idx).to(dev),
            lay)


def kernel_b2(dev: torch.device, db: int) -> dict:
    """B2 at N=1024, W=256, Z=4 and ``db`` delta rows: resident' exact,
    the f16 plane within 1 ulp of the plain version."""
    from kepler_tpu_torch.ops import cuda_attribution as ca

    n, w, z = N_NODES, 256, len(ZONES)
    resident, delta, idx, lay = b2_inputs(dev, n, w, z, db)
    r_kernel, r_plain = resident.clone(), resident.clone()
    _, plane = ca.fused_window_step(r_kernel, delta, idx, lay)
    _, plane_ref = ca.fused_window_step_ref(r_plain, delta, idx, lay)
    torch.cuda.synchronize()
    same_res = torch.equal(torch.nan_to_num(r_kernel, nan=-1.0),
                           torch.nan_to_num(r_plain, nan=-1.0))
    check(same_res and torch.equal(torch.isnan(r_kernel),
                                   torch.isnan(r_plain)),
          f"B2 resident' differs from its plain version at DB={db}")
    a, b = plane.cpu().numpy(), plane_ref.cpu().numpy()
    ulps = f16_ulps(a, b)
    check(int(ulps.max()) <= 1,
          f"B2 plane off by {int(ulps.max())} f16 ulps at DB={db}")
    err = float(np.abs(a.astype(np.float32) - b.astype(np.float32)).max())
    hits = int(((idx >= 0) & (idx < n)).sum())  # pad entries move no row
    nbytes, ops = ca.fused_window_step_cost(n, db, w, z, hits)
    bound, by = ca.bound_ms(nbytes, ops)
    row = {
        "name": "fused_window_step", "route": "cuda",
        "source": "kepler_tpu_torch/ops/csrc/attribution.cu",
        "replaces": "kepler_tpu/ops/pallas_attribution.py:163",
        "shape": {"N": n, "W": w, "Z": z, "DB": db, "hits": hits},
        "max_abs_err": err,
        "ulp_mismatches": int((ulps > 0).sum()),
        "ms": time_ms(lambda: ca.fused_window_step(resident, delta, idx,
                                                   lay)),
        "device_ms": device_ms(lambda: ca.fused_window_step(
            resident, delta, idx, lay)),
        "plain_device_ms": device_ms(lambda: ca.fused_window_step_ref(
            resident, delta, idx, lay)),
        "plain_ms": time_ms(lambda: ca.fused_window_step_ref(
            resident, delta, idx, lay)),
        "library_ms": None,
        "bound_ms": bound, "bound_by": by, "bound_us": bound * 1e3,
        "bytes": nbytes, "parity": "resident exact, plane <= 1 f16 ulp",
    }
    emit({"phase": "kernel", **row})
    return row


def flush_inputs(dev: torch.device, n: int, w: int, z: int, k: int,
                 db: int):
    """A resident block and K steps of ``db`` delta rows (as ``b2_inputs``
    draws them, one seed a step), row 7 hit in steps 0 and 1."""
    resident, _, _, lay = b2_inputs(dev, n, w, z, db)
    steps = [b2_inputs(dev, n, w, z, db, seed=SEED + db + 1000 * (s + 1))
             for s in range(k)]
    delta = torch.stack([d for _, d, _, _ in steps])
    idx = torch.stack([i for _, _, i, _ in steps])
    if db > 1 and k > 1:
        for s in range(2):
            idx[s][idx[s] == 7] = n
            idx[s, s] = 7
    return resident, delta.contiguous(), idx.contiguous(), lay


def kernel_b2_flush(dev: torch.device, k: int, db: int) -> dict:
    """B2 over a whole flush (K steps, one launch) at N=1024, W=256, Z=4:
    resident' exact and 0 f16 mismatches against K plain steps."""
    from kepler_tpu_torch.ops import cuda_attribution as ca

    n, w, z = N_NODES, 256, len(ZONES)
    resident, delta, idx, lay = flush_inputs(dev, n, w, z, k, db)
    r_kernel, r_plain = resident.clone(), resident.clone()
    _, planes = ca.fused_window_steps(r_kernel, delta, idx, lay)
    _, planes_ref = ca.fused_window_steps_ref(r_plain, delta, idx, lay)
    torch.cuda.synchronize()
    check(torch.equal(torch.nan_to_num(r_kernel, nan=-1.0),
                      torch.nan_to_num(r_plain, nan=-1.0))
          and torch.equal(torch.isnan(r_kernel), torch.isnan(r_plain)),
          f"B2 resident' differs from K={k} plain steps at DB={db}")
    a, b = planes.cpu().numpy(), planes_ref.cpu().numpy()
    ulps = f16_ulps(a, b)
    check(int((ulps > 0).sum()) == 0,
          f"B2 planes: {int((ulps > 0).sum())} f16 mismatches at K={k}")
    err = float(np.abs(a.astype(np.float32) - b.astype(np.float32)).max())
    live = idx[(idx >= 0) & (idx < n)]
    hits, dirty = int(live.numel()), int(torch.unique(live).numel())
    nbytes, ops = ca.fused_window_steps_cost(n, db, w, z, k, hits, dirty)
    bound, by = ca.bound_ms(nbytes, ops)
    kern = lambda: ca.fused_window_steps(resident, delta, idx, lay)  # noqa: E731
    plain = lambda: ca.fused_window_steps_ref(resident, delta, idx, lay)  # noqa: E731
    row = {
        "name": "fused_window_step", "route": "cuda",
        "source": "kepler_tpu_torch/ops/csrc/attribution.cu",
        "replaces": "kepler_tpu/ops/pallas_attribution.py:163",
        "shape": {"N": n, "W": w, "Z": z, "DB": db, "K": k, "hits": hits,
                  "dirty": dirty},
        "max_abs_err": err, "ulp_mismatches": int((ulps > 0).sum()),
        "ms": time_ms(kern), "device_ms": device_ms(kern),
        "plain_ms": time_ms(plain), "plain_device_ms": device_ms(plain),
        "library_ms": None,
        "bound_ms": bound, "bound_by": by, "bound_us": bound * 1e3,
        "bytes": nbytes, "parity": "resident exact, 0 f16 mismatches",
    }
    emit({"phase": "kernel_flush", **row})
    return row


# -- the main path --------------------------------------------------------------

class Agent:
    """One simulated node agent: v2 keyframe first, then v2 delta frames
    against its last acknowledged keyframe."""

    def __init__(self, name: str, rng: np.random.Generator,
                 mode: int = 0) -> None:
        self.name = name
        self.rng = rng
        self.seq = 0
        self.cpu = rng.uniform(0.05, 5.0, N_WORKLOADS).astype(np.float32)
        self.zones = rng.uniform(1e8, 1.5e9, len(ZONES)).astype(np.float32)
        self.ratio = float(rng.uniform(0.2, 0.95))
        self.mode = mode
        self.base: bytes | None = None

    def change(self) -> None:
        k = int(self.rng.integers(1, 10))
        hit = self.rng.choice(N_WORKLOADS, k, replace=False)
        self.cpu = self.cpu.copy()
        self.cpu[hit] = self.rng.uniform(0.05, 5.0, k)
        self.zones = self.rng.uniform(1e8, 1.5e9, len(ZONES)).astype(
            np.float32)
        self.ratio = float(self.rng.uniform(0.2, 0.95))

    def frame(self) -> bytes:
        from kepler_tpu_torch.fleet import wire
        from kepler_tpu_torch.parallel.fleet import NodeReport

        self.seq += 1
        report = NodeReport(
            node_name=self.name, zone_deltas_uj=self.zones,
            zone_valid=np.ones(len(ZONES), bool), usage_ratio=self.ratio,
            cpu_deltas=self.cpu,
            workload_ids=[f"{self.name}/pod-{i}" for i in range(N_WORKLOADS)],
            node_cpu_delta=float(self.cpu.sum(dtype=np.float32)), dt_s=5.0,
            mode=self.mode,
            workload_kinds=np.full(N_WORKLOADS, 3, np.int8))
        full = wire.encode_report_v2(report, ZONES, seq=self.seq, run="r1")
        out = full
        if self.base is not None:
            delta = wire.encode_delta_v2(full, self.base)
            check(delta is not None, "agent could not encode a delta")
            out = delta
        self.base = full  # acknowledged at once: the next delta is vs this
        return out


class Ingest:
    """The aggregator's decode side: keyframes and deltas → RowInputs with
    content identity (run, content_seq), as ``fleet.aggregator`` keeps."""

    def __init__(self) -> None:
        self.store: dict[str, tuple] = {}  # name → (report, run, cseq)

    def receive(self, frame: bytes) -> bool:
        """→ True when the frame was a FLAG_SAME delta."""
        from kepler_tpu_torch.fleet import wire

        parsed = wire.parse_header(frame)
        name = parsed.header["node_name"]
        if parsed.is_delta:
            base, run, cseq = self.store[name]
            report, header, changed = wire.decode_delta(
                frame, parsed, base, tuple(ZONES))
            if changed:
                cseq = header["seq"]
            self.store[name] = (report, run, cseq)
            return bool(parsed.same)
        report, header = wire.decode_report(frame, parsed)
        self.store[name] = (report, header["run"], header["seq"])
        return False

    def rows(self, live: list[str]) -> list:
        from kepler_tpu_torch.fleet.window import RowInput

        return [RowInput(name=n, report=self.store[n][0],
                         zone_names=tuple(ZONES),
                         ident=(self.store[n][1], self.store[n][2]))
                for n in sorted(live)]


def ratio_schedule() -> list[list]:
    """Per interval, the RowInputs the aggregator hands the engine: ~10%
    of nodes change each interval, three leave at interval 3, two join
    at interval 5, and interval 2 changes nothing (all FLAG_SAME)."""
    rng = np.random.default_rng(SEED)
    agents = {f"node-{i:04d}": Agent(f"node-{i:04d}", rng)
              for i in range(N_NODES)}
    ingest = Ingest()
    live = list(agents)
    windows = []
    for t in range(RATIO_INTERVALS):
        if t == 3:
            for name in live[10:13]:
                live.remove(name)
        if t == 5:
            for j in range(2):
                name = f"join-{j}"
                agents[name] = Agent(name, rng)
                live.append(name)
        if t > 0 and t != 2:
            for name in rng.choice(live, len(live) // 10, replace=False):
                agents[name].change()
        same = [ingest.receive(agents[name].frame()) for name in live]
        if t == 2:
            check(all(same), "interval 2 must be all FLAG_SAME deltas")
        windows.append(ingest.rows(live))
    return windows


def run_fused(eng, windows: list, on_flush=None,
              legs: dict | None = None) -> tuple[list, list]:
    """Stage every interval, dispatch and fetch every flush. ``legs``
    accumulates host-clock seconds per leg: ``stage`` (host bookkeeping
    and packing) and ``flush`` (upload, one launch, one fetch)."""
    from kepler_tpu_torch.fleet.window import fetch_plane

    legs = {} if legs is None else legs
    planes, metas = [], []
    for rows in windows:
        t0 = time.perf_counter()
        _meta, flush = eng.stage(rows, ZONES, None)
        t1 = time.perf_counter()
        legs["stage"] = legs.get("stage", 0.0) + t1 - t0
        if flush is None:
            continue
        outs = fetch_plane(eng.dispatch(flush))
        legs["flush"] = legs.get("flush", 0.0) + time.perf_counter() - t1
        if on_flush is not None:
            on_flush(flush)
        planes.extend(outs[j] for j in range(flush.k_live))
        metas.extend(flush.metas)
    check(eng.pending_occupancy() == 0, "fused ring left windows pending")
    return planes, metas


def check_conservation(plane: np.ndarray, meta, reports: dict) -> float:
    """Σ workload watts == node ACTIVE watts on ratio nodes (f16 sums:
    each term and the total carry ≤ 2^-11 relative rounding), and the
    node rows equal the RAPL split computed here in float64."""
    w = plane.shape[1] - 2
    worst = 0.0
    for name in meta.names:
        i = meta.rows[name]
        wl = plane[i, :w].astype(np.float64).sum(axis=0)
        active = plane[i, w].astype(np.float64)
        rel = np.abs(wl - active) / np.maximum(np.abs(active), 1e-3)
        worst = max(worst, float(rel.max()))
        rep = reports[name]
        want_total = np.asarray(rep.zone_deltas_uj, np.float64) / 5.0 * 1e-6
        want_active = want_total * rep.usage_ratio
        check(np.allclose(plane[i, w + 1], want_total, rtol=1e-3),
              f"node TOTAL watts of {name} off the RAPL delta")
        check(np.allclose(plane[i, w], want_active, rtol=1e-3),
              f"node ACTIVE watts of {name} off the RAPL split")
    check(worst <= 2e-3, f"conservation off by {worst:.2e} relative")
    return worst


def main_ratio(dev: torch.device) -> dict:
    """Main path 1: ratio fleet through the fused engine, B2 once per
    flush."""
    from kepler_tpu_torch.fleet.window import FusedWindowEngine
    from kepler_tpu_torch.ops import cuda_attribution as ca

    t0 = time.perf_counter()
    windows = ratio_schedule()
    ingest_s = time.perf_counter() - t0
    cpu_planes, _ = run_fused(
        FusedWindowEngine(device="cpu", backend="pallas", fused_k=FUSED_K),
        windows)

    eng = FusedWindowEngine(device=dev, backend="pallas", fused_k=FUSED_K)
    flushes: list[dict] = []

    def on_flush(flush) -> None:
        launched = ca.LAUNCHES["fused_window_step"] - sum(
            f["launches"] for f in flushes)
        check(launched == 1,
              f"B2 launched {launched} times in a flush of K={flush.k}")
        flushes.append({"launches": launched, "k_live": flush.k_live,
                        "h2d_rows": flush.h2d_rows,
                        "db": int(flush.args[2].shape[1]),
                        "cold": flush.cold})

    for name in ca.LAUNCHES:
        ca.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    planes, metas = run_fused(eng, windows, on_flush)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(ca.LAUNCHES)

    check(len(planes) == RATIO_INTERVALS, "not every interval published")
    check(launches["fused_window_step"] == len(flushes),
          "B2 launches do not match one per flush")
    check(launches["outer_product_attribution"] == 0,
          "the ratio fleet path launched B1")
    worst_ulp, worst_cons = 0, 0.0
    for t, (plane, ref, meta) in enumerate(zip(planes, cpu_planes, metas)):
        check(plane.shape == (N_NODES, 256 + 2, len(ZONES))
              and np.isfinite(plane).all(), f"interval {t}: bad plane")
        ulps = int(f16_ulps(plane, ref).max())
        check(ulps <= 1, f"interval {t}: card vs CPU engine {ulps} ulps")
        worst_ulp = max(worst_ulp, ulps)
        reports = {r.name: r.report for r in windows[t]}
        worst_cons = max(worst_cons,
                         check_conservation(plane, meta, reports))

    # steady-state flush time: the same schedule again on a warm engine
    # (kernels built, buffers sized), host clock around stage → fetch
    warm = FusedWindowEngine(device=dev, backend="pallas", fused_k=FUSED_K)
    run_fused(warm, windows)
    torch.cuda.synchronize()
    legs: dict = {}
    t0 = time.perf_counter()
    run_fused(warm, windows, legs=legs)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3 / RATIO_INTERVALS
    leg_ms = {k: v * 1e3 / RATIO_INTERVALS for k, v in legs.items()}
    row = {"phase": "main_ratio_fused", "nodes": N_NODES,
           "workloads": N_WORKLOADS, "zones": len(ZONES), "k": FUSED_K,
           "intervals": RATIO_INTERVALS, "flushes": flushes,
           "launches": launches, "max_ulps_vs_cpu_engine": worst_ulp,
           "max_conservation_rel": worst_cons,
           "wire_ingest_s": ingest_s, "first_run_s": wall_s,
           "warm_ms_per_interval": warm_ms,
           "warm_leg_ms_per_interval": leg_ms,
           "compile_count": eng.compile_count,
           "cost_stats": eng.cost_stats()}
    emit(row)
    return row


def main_mixed(dev: torch.device) -> dict:
    """Main path 2: 50/50 ratio/MLP fleet through the packed engine, B1
    in every window."""
    from kepler_tpu_torch.fleet import wire
    from kepler_tpu_torch.fleet.window import (PackedWindowEngine,
                                               fetch_plane)
    from kepler_tpu_torch.models.mlp import init_mlp
    from kepler_tpu_torch.ops import cuda_attribution as ca
    from kepler_tpu_torch.parallel.fleet import MODE_MODEL

    gen = torch.Generator().manual_seed(SEED)
    params = init_mlp(len(ZONES), generator=gen)
    # a non-zero output head (init zeroes it), drawn from the same seed
    params["w2"] = torch.randn(params["w2"].shape, generator=gen) * 0.05
    params["w_skip"] = torch.randn(params["w_skip"].shape,
                                   generator=gen) * 0.01
    params["b2"] = torch.full_like(params["b2"], 0.5)

    rng = np.random.default_rng(SEED + 1)
    agents = [Agent(f"node-{i:04d}", rng, mode=MODE_MODEL if i % 2 else 0)
              for i in range(N_NODES)]
    ingest = Ingest()
    windows = []
    for t in range(MIXED_WINDOWS):
        if t:
            for a in rng.choice(agents, N_NODES // 10, replace=False):
                a.change()
        for a in agents:
            ingest.receive(a.frame())
        windows.append(ingest.rows([a.name for a in agents]))

    def run(eng, legs: dict | None = None) -> list:
        legs = {} if legs is None else legs
        out = []
        for rows in windows:
            t0 = time.perf_counter()
            plan = eng.plan_window(rows, ZONES, params)
            t1 = time.perf_counter()
            out.append((fetch_plane(eng.dispatch_window(plan)), plan.meta))
            t2 = time.perf_counter()
            legs["plan"] = legs.get("plan", 0.0) + t1 - t0
            legs["dispatch_fetch"] = legs.get("dispatch_fetch", 0.0) + t2 - t1
        return out

    cpu_out = run(PackedWindowEngine(device="cpu", backend="pallas",
                                     model_mode="mlp"))
    eng = PackedWindowEngine(device=dev, backend="pallas", model_mode="mlp")
    for name in ca.LAUNCHES:
        ca.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    out = run(eng)
    wall_s = time.perf_counter() - t0
    launches = dict(ca.LAUNCHES)
    check(launches["outer_product_attribution"] == MIXED_WINDOWS,
          f"B1 launched {launches['outer_product_attribution']} times in "
          f"{MIXED_WINDOWS} windows")
    check(launches["fused_window_step"] == 0, "the mixed path launched B2")
    worst_ulp, worst_rel = 0, 0.0
    for t, ((plane, meta), (ref, _)) in enumerate(zip(out, cpu_out)):
        check(np.isfinite(plane).all(), f"window {t}: non-finite watts")
        ratio_rows = meta.mode != MODE_MODEL
        ulps = int(f16_ulps(plane[ratio_rows], ref[ratio_rows]).max())
        check(ulps <= 1, f"window {t}: ratio rows {ulps} ulps off")
        worst_ulp = max(worst_ulp, ulps)
        a = plane[~ratio_rows].astype(np.float32)
        b = ref[~ratio_rows].astype(np.float32)
        check(np.allclose(a, b, rtol=1e-3, atol=1e-3),
              f"window {t}: model rows off the CPU engine")
        worst_rel = max(worst_rel, float(
            (np.abs(a - b) / np.maximum(np.abs(b), 1e-3)).max()))
        check(float(np.abs(a).max()) > 0.1, "model rows are all ~zero")
    legs: dict = {}
    run(eng, legs)  # warm: every program built, buffers sized
    leg_ms = {k: v * 1e3 / MIXED_WINDOWS for k, v in legs.items()}
    row = {"phase": "main_mixed_packed", "nodes": N_NODES,
           "workloads": N_WORKLOADS, "zones": len(ZONES),
           "windows": MIXED_WINDOWS, "launches": launches,
           "max_ratio_ulps_vs_cpu_engine": worst_ulp,
           "max_model_rel_vs_cpu_engine": worst_rel, "first_run_s": wall_s,
           "warm_leg_ms_per_window": leg_ms,
           "wire_frames": len(agents) * MIXED_WINDOWS,
           "compile_count": eng.compile_count}
    emit(row)
    return row


def main_serial_mlp(dev: torch.device) -> dict:
    """The serial rung's single-tick program with the MLP
    (``make_fleet_program(model_mode="mlp")``) on the card against the
    CPU: the default bf16 trunk within rtol 1e-2 and atol 1e-2 ·
    max|watts|, accuracy mode (f32) within rtol 1e-4; ratio rows equal."""
    from kepler_tpu_torch.models.mlp import init_mlp
    from kepler_tpu_torch.parallel import (assemble_fleet_batch,
                                           make_fleet_program,
                                           run_fleet_attribution)
    from kepler_tpu_torch.parallel.fleet import MODE_MODEL

    gen = torch.Generator().manual_seed(SEED + 3)
    params = init_mlp(len(ZONES), generator=gen)
    params["w2"] = torch.randn(params["w2"].shape, generator=gen) * 0.05
    params["w_skip"] = torch.randn(params["w_skip"].shape,
                                   generator=gen) * 0.01
    params["b2"] = torch.full_like(params["b2"], 0.5)
    rng = np.random.default_rng(SEED + 3)
    agents = [Agent(f"node-{i:04d}", rng, mode=MODE_MODEL if i % 2 else 0)
              for i in range(CPU_NODES)]
    ingest = Ingest()
    for a in agents:
        ingest.receive(a.frame())
    batch = assemble_fleet_batch(
        [r.report for r in ingest.rows([a.name for a in agents])],
        n_zones=len(ZONES), node_bucket=CPU_NODES, workload_bucket=256)
    model = batch.mode == MODE_MODEL
    row = {"phase": "main_serial_mlp", "nodes": CPU_NODES}
    for accuracy in (False, True):
        out = [host_result(run_fleet_attribution(
            make_fleet_program(device=d, model_mode="mlp", backend="pallas",
                               accuracy_mode=accuracy), batch, params))[7]
            for d in (dev, "cpu")]
        a, b = out[0][model] * 1e-6, out[1][model] * 1e-6
        ok = (np.allclose(a, b, rtol=1e-4, atol=1e-6) if accuracy
              else bf16_close(a, b))
        what = "f32" if accuracy else "bf16"
        check(ok and float(np.abs(b).max()) > 0.1,
              f"serial-rung MLP ({what}) off the CPU by "
              f"{float(np.abs(a - b).max())} W")
        check(np.array_equal(out[0][~model], out[1][~model]),
              f"serial-rung ratio rows ({what}) differ from the CPU")
        row[f"{what}_max_abs_w"] = float(np.abs(a - b).max())
    emit(row)
    return row


# -- kernel B3 and the temporal paths -----------------------------------------

def sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def b3_inputs(dev: torch.device, b: int, t: int):
    """q, k, v [B, T, 4, 32] and a ragged causal-serving KV mask (right-
    padded lengths 0..T, as history windows give)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + t)
    shape = (b, t, N_HEADS, D_MODEL // N_HEADS)
    q, k, v = (torch.randn(shape, generator=gen, device=dev)
               for _ in range(3))
    lengths = torch.randint(0, t + 1, (b,), generator=gen, device=dev)
    valid = torch.arange(t, device=dev)[None, :] < lengths[:, None]
    return q, k, v, valid


def b3_check(got, want, v: torch.Tensor, cd: torch.dtype,
             what: str) -> float:
    """B3 against its plain version → max abs err over (pv, m, l).
    f32 compute: rtol = atol = 1e-5 on all three. bf16 compute: m and l
    rtol 1e-5 (atol 1e-5), pv within 1e-2 · max|v| (one bf16 rounding of
    p may flip; the kernel sums in another order)."""
    pv, m, l = got
    pv_r, m_r, l_r = want
    errs = [float((a - b).abs().max()) for a, b in ((pv, pv_r), (m, m_r),
                                                    (l, l_r))]
    check(torch.allclose(m, m_r, rtol=1e-5, atol=1e-5)
          and torch.allclose(l, l_r, rtol=1e-5, atol=1e-5),
          f"{what}: m/l off the plain version (errs {errs})")
    if cd == torch.float32:
        ok = torch.allclose(pv, pv_r, rtol=1e-5, atol=1e-5)
    else:
        ok = errs[0] <= 1e-2 * float(v.abs().max())
    check(ok, f"{what}: pv off the plain version by {errs[0]}")
    return max(errs)


def sdpa_ms(q, k, v, valid) -> tuple[float | None, str | None]:
    """``scaled_dot_product_attention`` on the same f32 inputs (causal
    and KV-validity mask) — the yardstick for ``full_attention_pallas``;
    the port never calls it. → (ms, None) or (None, why it did not run)."""
    import torch.nn.functional as F

    t = q.shape[1]
    causal = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    mask = valid[:, None, None, :] & causal
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    try:
        return time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask), reps=5, batch=4), None
    except RuntimeError as err:  # a yardstick only: record why
        return None, str(err).splitlines()[0][:200]


def b3_variant_since(before: dict) -> str:
    """The B3 variant of the one launch made since ``before``."""
    now = read_launches()
    grew = [v for v in ("tc", "simt")
            if now[f"flash_block_{v}"] == before[f"flash_block_{v}"] + 1]
    check(now["flash_block"] == before["flash_block"] + 1 and len(grew) == 1,
          "B3 did not launch exactly once")
    return grew[0]


def kernel_b3(dev: torch.device, b: int, t: int) -> dict:
    """B3 against its plain version at ``b`` sequences of ``t`` ticks
    (causal, ragged KV mask): the tensor-core variant (bf16, what the
    wrapper selects for the trunk), the SIMT variant at bf16 (PR 2's
    kernel, through its plan) and at f32 (what the wrapper selects in
    accuracy mode), timed beside the plain version and SDPA; at path 4's
    shape also the block offsets."""
    from kepler_tpu_torch.ops import cuda_attention as cat

    bf16, f32 = torch.bfloat16, torch.float32
    d = D_MODEL // N_HEADS
    q, k, v, valid = b3_inputs(dev, b, t)
    plan = cat.flash_block_plan(b, t, t, N_HEADS, d)
    check(plan.variant == "tc", f"B3 at T={t} does not plan tensor cores")
    before = read_launches()
    got = cat.flash_block_pallas(q, k, v, valid, 0, 0)
    check(b3_variant_since(before) == "tc",
          f"B3 at T={t}, bf16 did not launch the tensor-core variant")
    want = cat.flash_block_ref(q, k, v, valid, 0, 0)
    sync()
    err = b3_check(got, want, v, bf16, f"B3 (tc) at B={b}, T={t}")
    simt = cat.simt_plan(b, t, t, N_HEADS, d)
    simt_bf16 = lambda: cat.flash_block_launch(  # noqa: E731
        simt, q, k, v, valid, 0, 0)
    got = simt_bf16()
    simt_err = b3_check(got, want, v, bf16, f"B3 (simt) at B={b}, T={t}")
    del got, want
    before = read_launches()
    got = cat.flash_block_pallas(q, k, v, valid, 0, 0, compute_dtype=f32)
    check(b3_variant_since(before) == "simt",
          f"B3 at T={t}, f32 did not launch the SIMT variant")
    f32_err = b3_check(got, cat.flash_block_ref(
        q, k, v, valid, 0, 0, compute_dtype=f32), v, f32,
        f"B3 (simt) at f32, T={t}")
    del got
    bound, by = cat.flash_block_bound_ms(q, k, valid, 0, 0)
    kern = lambda: cat.flash_block_pallas(q, k, v, valid, 0, 0)  # noqa: E731
    acc = lambda: cat.flash_block_pallas(  # noqa: E731
        q, k, v, valid, 0, 0, compute_dtype=f32)
    plain = lambda: cat.flash_block_ref(q, k, v, valid, 0, 0)  # noqa: E731
    lib_ms, lib_err = sdpa_ms(q, k, v, valid)
    row = {
        "name": "flash_block", "route": "cuda",
        "source": "kepler_tpu_torch/ops/csrc/attention.cu",
        "replaces": "kepler_tpu/ops/pallas_attention.py:77",
        "shape": {"B": b, "Tq": t, "Tk": t, "H": N_HEADS, "D": d,
                  "causal": True, "compute": "bf16",
                  "plan": plan._asdict(), "simt_plan": simt._asdict()},
        "max_abs_err": err,
        "ms": time_ms(kern, reps=5, batch=4),
        "device_ms": device_ms(kern, calls=5),
        "simt_bf16_ms": time_ms(simt_bf16, reps=5, batch=4),
        "simt_bf16_device_ms": device_ms(simt_bf16, calls=5),
        "simt_bf16_max_abs_err": simt_err,
        "f32_ms": time_ms(acc, reps=5, batch=4),
        "f32_device_ms": device_ms(acc, calls=5),
        "f32_max_abs_err": f32_err,
        "plain_ms": time_ms(plain, reps=3, batch=2),
        "plain_device_ms": device_ms(plain, calls=2),
        "library_ms": lib_ms, "library": "torch.nn.functional."
        "scaled_dot_product_attention (f32, causal & KV mask)",
        "bound_ms": bound, "bound_by": by,
        "compiled": {"tc": cat.flash_block_info("tc", t, d),
                     "simt": cat.flash_block_info("simt", t, d)},
        "parity": "m, l rtol 1e-5; pv <= 1e-2 max|v| (bf16)",
    }
    if lib_err is not None:
        row["library_error"] = lib_err
    if t == HISTORY_T:
        every = torch.ones_like(valid)
        _, _, l_after = cat.flash_block_pallas(q, k, v, every, 0, t)
        check(bool(torch.all(l_after == 0)),
              "B3 with kv after q must mask everything (l == 0)")
        got = cat.flash_block_pallas(q, k, v, every, t, 0)
        check(bool(torch.all(got[2] > 0)),
              "B3 with kv before q must mask nothing (l > 0)")
        row["offsets_max_abs_err"] = b3_check(
            got, cat.flash_block_ref(q, k, v, every, t, 0), v, bf16,
            "B3 at offsets (16, 0)")
        del got
    emit({"phase": "kernel", **row})
    del q, k, v, valid
    torch.cuda.empty_cache()
    return row


def temporal_schedule() -> list[list]:
    """Per window, the NodeReports of a 50/50 ratio/temporal fleet:
    90-100 workloads a node, 0-3 of a node's workloads leave and as many
    fresh ones join each window, and 16 nodes report no workload at
    window 10 (their histories resume at window 11)."""
    from kepler_tpu_torch.parallel.fleet import MODE_MODEL, NodeReport

    rng = np.random.default_rng(SEED + 2)
    ids = [[f"node-{i:04d}/w{j}"
            for j in range(int(rng.integers(90, N_WORKLOADS + 1)))]
           for i in range(N_NODES)]
    fresh = 0
    windows = []
    for t in range(TEMPORAL_WINDOWS):
        reports = []
        for i in range(N_NODES):
            if t:
                for slot in rng.choice(len(ids[i]), int(rng.integers(0, 4)),
                                       replace=False):
                    fresh += 1
                    ids[i][slot] = f"node-{i:04d}/x{fresh}"
            live = [] if (t == 10 and i < 16) else list(ids[i])
            cpu = rng.uniform(0.05, 5.0, len(live)).astype(np.float32)
            reports.append(NodeReport(
                node_name=f"node-{i:04d}",
                zone_deltas_uj=rng.uniform(1e8, 1.5e9, len(ZONES)).astype(
                    np.float32),
                zone_valid=np.ones(len(ZONES), bool),
                usage_ratio=float(rng.uniform(0.2, 0.95)), cpu_deltas=cpu,
                workload_ids=live,
                node_cpu_delta=float(cpu.sum(dtype=np.float32)), dt_s=5.0,
                mode=MODE_MODEL if i % 2 else 0,
                workload_kinds=np.full(len(live), 3, np.int8)))
        windows.append(reports)
    return windows


class HistoryStore:
    """The aggregator's per-node feature history: ``push`` is
    ``Aggregator._push_history``, ``windows`` is ``_history_windows``."""

    def __init__(self) -> None:
        self.buffers: dict = {}

    def push(self, report) -> None:
        from kepler_tpu_torch.monitor.history import HistoryBuffer
        from kepler_tpu_torch.resource.informer import FeatureBatch

        buf = self.buffers.get(report.node_name)
        if buf is None:
            buf = self.buffers[report.node_name] = HistoryBuffer(
                window=HISTORY_T)
        buf.push(FeatureBatch(
            kinds=report.workload_kinds, ids=list(report.workload_ids),
            cpu_deltas=np.asarray(report.cpu_deltas, np.float32),
            node_cpu_delta=float(report.node_cpu_delta),
            usage_ratio=float(report.usage_ratio)), dt_s=float(report.dt_s))

    def windows(self, batch) -> tuple[np.ndarray, np.ndarray]:
        from kepler_tpu_torch.models.features import NUM_FEATURES

        n, w = batch.cpu_deltas.shape
        hist = np.zeros((n, w, HISTORY_T, NUM_FEATURES), np.float32)
        tv = np.zeros((n, w, HISTORY_T), bool)
        for i in range(batch.n_nodes):
            ids = batch.workload_ids[i]
            buf = self.buffers.get(batch.node_names[i])
            if buf is None or not ids:
                continue
            f, v = buf.window_arrays(ids)
            hist[i, :len(ids)] = f
            tv[i, :len(ids)] = v
        return hist, tv


def temporal_params() -> dict:
    """init_temporal at its default widths (d_model 128, 4 heads, t_max
    128) from the seed, with a non-zero head (init zeroes it)."""
    from kepler_tpu_torch.models.temporal import init_temporal

    gen = torch.Generator().manual_seed(SEED)
    params = init_temporal(len(ZONES), generator=gen)
    params["w_head"] = torch.randn(params["w_head"].shape,
                                   generator=gen) * 0.05
    params["w_skip"] = torch.randn(params["w_skip"].shape,
                                   generator=gen) * 0.01
    params["b_head"] = torch.full_like(params["b_head"], 0.5)
    return params


def node_subset(batch, n: int):
    """The first ``n`` node rows of a FleetBatch."""
    import dataclasses

    arrays = {f.name: getattr(batch, f.name)[:n]
              for f in dataclasses.fields(batch)
              if isinstance(getattr(batch, f.name), (np.ndarray, list))}
    return dataclasses.replace(batch, n_nodes=min(batch.n_nodes, n),
                               **arrays)


def bf16_close(a: np.ndarray, b: np.ndarray) -> bool:
    """Model watts of a bf16 trunk on two devices: rtol 1e-2, atol 1e-2 ·
    max|watts|. The trunk rounds its operands to bf16 after f32 sums, so
    a one-ulp change of those sums (another summation order) moves a
    prediction by up to ~0.5% of the largest one, whatever its own size."""
    return bool(np.allclose(a, b, rtol=1e-2,
                            atol=1e-2 * float(np.abs(b).max())))


def host_result(res) -> list[np.ndarray]:
    return [x.cpu().numpy() for x in res]


def reset_launches() -> None:
    from kepler_tpu_torch.ops import cuda_attention as cat
    from kepler_tpu_torch.ops import cuda_attribution as ca

    for table in (ca.LAUNCHES, cat.LAUNCHES):
        for name in table:
            table[name] = 0


def read_launches() -> dict:
    from kepler_tpu_torch.ops import cuda_attention as cat
    from kepler_tpu_torch.ops import cuda_attribution as ca

    return {**ca.LAUNCHES, **cat.LAUNCHES}


def profile_top(fn, k: int = 8, match: str | None = None) -> dict:
    """One call of ``fn`` under ``torch.profiler`` → device ms in all, the
    ``k`` kernels with the most device time (self time, ms) and, given
    ``match``, the device ms of the kernels whose name holds it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    rows = kernel_times_us(prof)
    out = {"device_ms": sum(r[0] for r in rows) / 1e3,
           "top": [{"kernel": key[:80], "ms": us / 1e3, "count": c}
                   for us, key, c in rows[:k]]}
    if match is not None:
        out[f"{match}_ms"] = sum(us for us, key, _ in rows
                                 if match in key) / 1e3
    return out


def main_temporal_fleet(dev: torch.device) -> tuple[dict, list, dict, list]:
    """Main path 3: the temporal fleet window, B1 in every window, B3
    never. → (row, per-window (batch, feat_hist, t_valid), params,
    per-window FleetResult on the host)."""
    from kepler_tpu_torch.parallel import (assemble_fleet_batch,
                                           make_temporal_fleet_program,
                                           run_fleet_attribution)
    from kepler_tpu_torch.parallel.fleet import MODE_MODEL

    t0 = time.perf_counter()
    windows = temporal_schedule()
    schedule_s = time.perf_counter() - t0
    params = temporal_params()
    program = make_temporal_fleet_program(device=dev, backend="pallas")
    store = HistoryStore()
    legs = {k: [] for k in ("push", "assemble", "upload", "program",
                            "fetch")}
    saved, outs = [], []
    reset_launches()
    for reports in windows:
        t0 = time.perf_counter()
        for report in reports:
            store.push(report)
        t1 = time.perf_counter()
        batch = assemble_fleet_batch(reports, n_zones=len(ZONES),
                                     node_bucket=N_NODES,
                                     workload_bucket=256)
        hist, tv = store.windows(batch)
        t2 = time.perf_counter()
        hist_d, tv_d = torch.from_numpy(hist).to(dev), torch.from_numpy(
            tv).to(dev)
        sync()
        t3 = time.perf_counter()
        res = run_fleet_attribution(program, batch, params, hist_d, tv_d)
        sync()
        t4 = time.perf_counter()
        outs.append(host_result(res))
        t5 = time.perf_counter()
        for name, dt in zip(legs, (t1 - t0, t2 - t1, t3 - t2, t4 - t3,
                                   t5 - t4)):
            legs[name].append(dt * 1e3)
        saved.append((batch, hist, tv))
        del hist_d, tv_d, res
    launches = read_launches()
    check(launches["outer_product_attribution"] == TEMPORAL_WINDOWS,
          f"B1 launched {launches['outer_product_attribution']} times in "
          f"{TEMPORAL_WINDOWS} temporal windows")
    check(launches["flash_block"] == 0, "the temporal fleet path ran B3")
    check(launches["fused_window_step"] == 0,
          "the temporal fleet path ran B2")

    # the same schedule: einsum backend on the card (ratio rows equal),
    # and the plain versions on the CPU over a node subset
    einsum = make_temporal_fleet_program(device=dev, backend="einsum")
    on_cpu = make_temporal_fleet_program(device="cpu", backend="pallas")
    worst = {"model_rel_vs_cpu": 0.0, "model_abs_vs_cpu_w": 0.0,
             "conservation_rel": 0.0}
    for t, ((batch, hist, tv), out) in enumerate(zip(saved, outs)):
        model = batch.mode == MODE_MODEL
        ratio = ~model
        check(all(np.isfinite(x).all() for x in out),
              f"window {t}: non-finite FleetResult")
        ref = host_result(run_fleet_attribution(einsum, batch, params,
                                                hist, tv))
        check(all(np.array_equal(a[ratio], b[ratio])
                  for a, b in zip(out, ref)),
              f"window {t}: ratio rows differ from the einsum program")
        wl_w = out[7] * 1e-6  # workload_power_uw → W
        check(float(wl_w[model].max()) > 0.1,
              f"window {t}: model rows are all ~zero")
        live = ratio & (batch.node_cpu_delta > 0)
        active = out[4][live].astype(np.float64)  # node_active_power_uw
        summed = out[7][live].astype(np.float64).sum(axis=1)
        rel = np.abs(summed - active) / np.maximum(np.abs(active), 1.0)
        worst["conservation_rel"] = max(worst["conservation_rel"],
                                        float(rel.max()))
        check(float(rel.max()) <= 1e-4,
              f"window {t}: Σ workload power ≠ node active power")
        sub = node_subset(batch, CPU_NODES)
        cpu = host_result(run_fleet_attribution(
            on_cpu, sub, params, hist[:CPU_NODES], tv[:CPU_NODES]))
        m = sub.mode == MODE_MODEL
        a, b = out[7][:CPU_NODES][m] * 1e-6, cpu[7][m] * 1e-6
        check(bf16_close(a, b), f"window {t}: model watts off the CPU "
              f"program by {float(np.abs(a - b).max())} W")
        worst["model_abs_vs_cpu_w"] = max(worst["model_abs_vs_cpu_w"],
                                          float(np.abs(a - b).max()))
        worst["model_rel_vs_cpu"] = max(worst["model_rel_vs_cpu"], float(
            (np.abs(a - b) / np.maximum(np.abs(b), 1e-3)).max()))
        check(np.allclose(out[7][:CPU_NODES][~m], cpu[7][~m], rtol=1e-6),
              f"window {t}: ratio rows off the CPU program")

    # accuracy mode (f32 compute) on the last window's node subset
    batch, hist, tv = saved[-1]
    sub = node_subset(batch, CPU_NODES)
    acc = [host_result(run_fleet_attribution(
        make_temporal_fleet_program(device=d, backend="pallas",
                                    accuracy_mode=True),
        sub, params, hist[:CPU_NODES], tv[:CPU_NODES]))[7]
        for d in (dev, "cpu")]
    check(np.allclose(acc[0], acc[1], rtol=1e-4, atol=10.0),
          "accuracy-mode model watts off the CPU program (rtol 1e-4)")
    worst["accuracy_abs_vs_cpu_w"] = float(np.abs(acc[0] - acc[1]).max()
                                           * 1e-6)
    worst["accuracy_rel_vs_cpu"] = float(
        (np.abs(acc[0] - acc[1]) / np.maximum(np.abs(acc[1]), 1e3)).max())

    hist_d, tv_d = (torch.from_numpy(x).to(dev) for x in (hist, tv))
    prof = profile_top(lambda: run_fleet_attribution(program, batch, params,
                                                     hist_d, tv_d))
    del hist_d, tv_d
    torch.cuda.empty_cache()
    steady = slice(HISTORY_T, None)  # histories full from here on
    row = {"phase": "main_temporal_fleet", "nodes": N_NODES,
           "workloads": N_WORKLOADS, "zones": len(ZONES),
           "history_t": HISTORY_T, "windows": TEMPORAL_WINDOWS,
           "launches": launches, "worst": worst,
           "schedule_s": schedule_s,
           "leg_ms_per_window": {k: statistics.median(v[steady])
                                 for k, v in legs.items()},
           "leg_ms_window_0": {k: v[0] for k, v in legs.items()},
           "feat_hist_mb": saved[-1][1].nbytes / 1e6,
           "program_profile": prof}
    emit(row)
    return row, saved, params, outs


def main_temporal_trunk(dev: torch.device, saved: list,
                        params: dict, fleet_outs: list) -> dict:
    """Main path 4: the full-sequence trunk through B3 on path 3's
    windows, once per window."""
    from kepler_tpu_torch.models.temporal import predict_temporal
    from kepler_tpu_torch.ops.cuda_attention import pallas_attention_fn
    from kepler_tpu_torch.parallel.fleet import MODE_MODEL

    params_d = {k: v.to(dev) for k, v in params.items()}
    attention = pallas_attention_fn()

    def inputs(batch, hist, tv, n=None):
        sl = slice(None, n)
        return (torch.from_numpy(hist[sl]).to(dev),
                torch.from_numpy(batch.workload_valid[sl]).to(dev),
                torch.from_numpy(tv[sl]).to(dev))

    reset_launches()
    call_ms, watts = [], []
    for batch, hist, tv in saved:
        h, wv, tv_d = inputs(batch, hist, tv)
        sync()
        t0 = time.perf_counter()
        out = predict_temporal(params_d, h, wv, tv_d, attention_fn=attention)
        sync()
        call_ms.append((time.perf_counter() - t0) * 1e3)
        watts.append(out.cpu().numpy())
        del h, wv, tv_d, out
    launches = read_launches()
    check(launches["flash_block"] == len(saved),
          f"B3 launched {launches['flash_block']} times in {len(saved)} "
          "trunk calls")
    check(launches["flash_block_tc"] == len(saved)
          and launches["flash_block_simt"] == 0,
          "the trunk's B3 launches did not all go through tensor cores")
    check(launches["outer_product_attribution"] == 0,
          "the trunk path ran B1")

    worst = {"vs_fast_path_abs_w": 0.0, "vs_cpu_abs_w": 0.0,
             "vs_cpu_rel": 0.0}
    for t, ((batch, hist, tv), w) in enumerate(zip(saved, watts)):
        check(np.isfinite(w).all(), f"trunk window {t}: non-finite watts")
        model = batch.mode == MODE_MODEL
        fast = fleet_outs[t][7][model] * 1e-6
        diff = float(np.abs(w[model] - fast).max())
        # bf16 operands round at other places in the two paths (softmax
        # probabilities vs B3's unnormalised p): 1e-2 · max|watts|
        check(diff <= 1e-2 * float(np.abs(fast).max()),
              f"trunk window {t}: {diff} W off the fast path")
        worst["vs_fast_path_abs_w"] = max(worst["vs_fast_path_abs_w"], diff)
    for t in (0, HISTORY_T // 2, len(saved) - 1):
        batch, hist, tv = saved[t]
        n = CPU_NODES
        ref = predict_temporal(
            params, torch.from_numpy(hist[:n]),
            torch.from_numpy(batch.workload_valid[:n]),
            torch.from_numpy(tv[:n]), attention_fn=pallas_attention_fn())
        a, b = watts[t][:n], ref.numpy()
        check(bf16_close(a, b), f"trunk window {t}: card off the plain "
              f"version on the CPU by {float(np.abs(a - b).max())} W")
        worst["vs_cpu_abs_w"] = max(worst["vs_cpu_abs_w"],
                                    float(np.abs(a - b).max()))
        worst["vs_cpu_rel"] = max(worst["vs_cpu_rel"], float(
            (np.abs(a - b) / np.maximum(np.abs(b), 1e-3)).max()))
    # f32: the full trunk through B3 equals the fast path (the JAX
    # package's own equality, rtol 1e-4)
    batch, hist, tv = saved[-1]
    h, wv, tv_d = inputs(batch, hist, tv, CPU_NODES)
    f32 = torch.float32
    full = predict_temporal(params_d, h, wv, tv_d, compute_dtype=f32,
                            attention_fn=pallas_attention_fn(
                                compute_dtype=f32))
    fast = predict_temporal(params_d, h, wv, tv_d, compute_dtype=f32)
    check(torch.allclose(full, fast, rtol=1e-4, atol=1e-5),
          "f32 full trunk through B3 differs from the fast path")
    worst["f32_vs_fast_path_abs_w"] = float((full - fast).abs().max())
    del h, wv, tv_d, full, fast

    batch, hist, tv = saved[-1]
    h, wv, tv_d = inputs(batch, hist, tv)
    torch.cuda.reset_peak_memory_stats()
    prof = profile_top(lambda: predict_temporal(params_d, h, wv, tv_d,
                                                attention_fn=attention),
                       match="flash_block")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del h, wv, tv_d
    torch.cuda.empty_cache()
    row = {"phase": "main_temporal_trunk", "sequences": N_NODES * 256,
           "history_t": HISTORY_T, "calls": len(saved),
           "launches": launches, "worst": worst,
           "call_ms_median": statistics.median(call_ms),
           "call_ms_first": call_ms[0], "peak_memory_gb": peak_gb,
           "profile": prof}
    emit(row)
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if here not in sys.path:
        sys.path.insert(0, here)
    from kepler_tpu_torch.device import resolve_device
    from kepler_tpu_torch.ops import build

    dev = resolve_device("cuda")
    smi = provenance()
    t0 = time.perf_counter()
    libs = build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {k: os.path.basename(str(v)) for k, v in libs.items()},
          "flags": list(build.NVCC_FLAGS)})

    b1 = kernel_b1(dev)
    b2_rows = {db: kernel_b2(dev, db) for db in (8, N_NODES)}
    b3_rows = [kernel_b3(dev, b, t) for b, t in B3_SHAPES]
    ratio = main_ratio(dev)
    main_db = ratio["flushes"][-1]["db"]
    if main_db not in b2_rows:
        b2_rows[main_db] = kernel_b2(dev, main_db)
    b2_flush = kernel_b2_flush(dev, FUSED_K, main_db)
    mixed = main_mixed(dev)
    main_serial_mlp(dev)
    fleet, saved, params, outs = main_temporal_fleet(dev)
    trunk = main_temporal_trunk(dev, saved, params, outs)

    b1["launches_by_path"] = {
        "main_mixed": mixed["launches"]["outer_product_attribution"],
        "main_temporal_fleet":
            fleet["launches"]["outer_product_attribution"]}
    b1["launches"] = sum(b1["launches_by_path"].values())
    b2 = dict(b2_flush)  # the main path's call: one launch per flush
    b2["launches"] = ratio["launches"]["fused_window_step"]
    b2["by_db"] = {str(db): {"ms": r["ms"], "plain_ms": r["plain_ms"],
                             "device_ms": r["device_ms"],
                             "bound_ms": r["bound_ms"]}
                   for db, r in sorted(b2_rows.items())}
    b2["by_k"] = {str(r["shape"].get("K", 1)): {
        k: r[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms")}
        for r in (b2_rows[main_db], b2_flush)}
    b3 = dict(b3_rows[0])
    b3["launches"] = trunk["launches"]["flash_block"]
    b3["launches_by_variant"] = {
        v: trunk["launches"][f"flash_block_{v}"] for v in ("tc", "simt")}
    b3["by_shape"] = {f"B{r['shape']['B']}_T{r['shape']['Tq']}": {
        k: r[k] for k in ("ms", "device_ms", "simt_bf16_device_ms",
                          "f32_device_ms", "plain_ms", "bound_ms",
                          "bound_by", "library_ms", "max_abs_err")}
        for r in b3_rows}
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "device_ms", "plain_device_ms", "shape", "by_db",
            "by_k", "by_shape", "launches_by_path", "launches_by_variant")
    print(smi, flush=True)
    emit({"kernels": [{k: row[k] for k in keys if k in row}
                      for row in (b1, b2, b3)]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
