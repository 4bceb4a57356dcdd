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
3. the Aggregator service (``fleet.aggregator.Aggregator(device="cuda")``
   behind a live ``APIServer``): the same ratio fleet over HTTP, one
   ``POST /v1/reports`` batch per interval, ``aggregate_once()`` per
   interval on the fused tier (K = 4) — B2 once per flush, the rung
   never leaving ``packed-fused-scan``, ``GET /v1/results`` checked
   against the published windows; then a 50/50 ratio/MLP fleet on the
   pipelined tier (depth 2) for 8 windows with one injected
   ``device.dispatch_error`` — B1 in every dispatched window, one
   demotion and one re-promotion;
4. the temporal fleet window through the same service (``model:
   temporal``, ``history_window`` 16), a 50/50 ratio/temporal fleet with
   churn: the ingest pushes each model node's feature history, the
   serial rung assembles the ``[N, W, T, F]`` windows and runs
   ``make_temporal_fleet_program(backend="pallas")`` — B1 once per
   window, B3 never (the estimator's single-query fast path);
5. the temporal model's full-sequence trunk on the same windows,
   ``predict_temporal(..., attention_fn=pallas_attention_fn())`` (d_model
   128, 4 heads of 32) — kernel B3 once per call over 262,144 sequences,
   every launch its tensor-core variant;
6. the node agent on one fake host of 10,000 processes (half in
   docker/kubepods cgroups, four RAPL zones, under ``/dev/shm``): the
   native /proc reader, ``RaplPowerMeter`` and ``PowerMonitor(device=
   "cuda")`` behind a ``PowerCollector``, 11 scrapes with 10 % CPU churn,
   a burst of 2,000 processes, 1,000 terminations past
   ``max_terminated=500`` and an injected read error and counter wrap —
   every tick bit-equal to the same schedule on a second tree through
   ``device="cpu"``;
7. 64 such node stacks (100 processes each), each with a real
   ``FleetAgent`` posting wire-v2 keyframes and deltas over HTTP to the
   Aggregator service on the fused tier for 8 intervals — B2 once per
   flush, every node's ``/v1/results`` watts within 1 f16 ulp of its own
   monitor's;
8. the two binaries together: ``python -m kepler_tpu_torch.cmd.aggregator``
   and ``python -m kepler_tpu_torch.cmd.main`` on the card (fake CPU
   meter over the real /proc) reporting to it, then SIGTERM to both;
9. the Aggregator's pipelined tier with the 50/50 fleet of path 3 served
   by ``model: moe`` (8 experts of 128) and by ``model: deep`` (4 blocks
   of 128), 8 windows each — B1 in every window, each window against
   ``device="cpu"``;
10. the train half of the loop: Aggregators on the card write training
   dumps (``training_dump_dir``) of the 50/50 fleet and of the temporal
   fleet, ``kepler_tpu_torch.cmd.train`` fits each of the five families
   on the card (the loss falls; a run checkpointed halfway and resumed
   ends at the same params; its first steps agree with ``--device cpu``;
   the ``.npz`` serves in the Aggregator on the card, moe's and deep's
   through ``python -m kepler_tpu_torch.cmd.aggregator`` too), and the
   binary ``python -m kepler_tpu_torch.cmd.train`` exits 0;
11. the sharded window: ``ShardedWindowEngine`` over a mesh of 8 virtual
   shards of the card (128 rows each), path 1's 8 intervals then path
   2's 4 windows, with einsum and with pallas (B1 once per shard per
   window), every node's rows against the single-device engine on the
   card and the pallas planes against the einsum planes;
12. the multi-host tier on the card: 2 virtual hosts × 4 shards
   (``MultiHostWindowEngine`` on threads over a ``HostLocalFabric``),
   the union of their rows against path 11's, then two Aggregators on
   that topology whose fabric is killed — host 0 demotes to
   ``packed-sharded-mesh-minus-host`` and keeps publishing — and one
   ``initialize_multihost`` on a one-rank gloo world;
13. kepchaos (``kepler_tpu_torch.chaos``): ``CHAOS_r01.json``'s sweep, 25
   schedules at seed 1 of faults, kills, restarts, joins, leaves and
   autoscales against 3-5 of the port's Aggregators on the card, each
   over 8 virtual shards, once with ``backend="einsum"`` (held to the
   file's verdicts, windows, events, fault fires and trace hashes) and
   once with ``backend="pallas"`` — B1 once per shard in every rung-0
   window — then the binaries ``python -m kepler_tpu_torch.chaos --schedule 0`` (the file's
   trace hash) and ``python -m kepler_tpu_torch.blackbox`` over one run's
   journals (the timeline SHA of the same run on ``device="cpu"``);
14. the parallel families on virtual shards of the card
   (``main_parallel``): ``make_ring_attention(mesh[8], backend="pallas")``
   over 4096 sequences of T = 1024 (4 heads of 32, bf16) — kernel B3
   once per shard per KV rotation, 64 launches a call, all on tensor
   cores — against the einsum ring and dense attention on 64 sequences;
   the sequence-parallel program (8 shards) at the same size and Ulysses
   (4 shards, 512 sequences) against the single-query dense path; 6
   sequence-parallel train steps with remat (512 sequences) against the
   one-shard step; the GPipe deep estimator (4 stages) and expert
   parallelism (8 experts on 8 shards, explicit and learned routing)
   over 262,144 rows against the single-device models; the DP×TP
   trainer on a 4 × 2 ``node × model`` mesh against one shard;
15. the port's static analysis (``main_analysis``): ``python -m
   kepler_tpu_torch.analysis``'s AST tiers over the port and this
   script, its protocol tier's five models over the port's fleet
   functions, and its device tier's programs run on the card — B1 in
   ``ops.pallas_attribution`` and ``packed.pallas_dense`` (once per
   shard), B2 in ``window.fused_pallas`` — each case's fingerprint
   against the same case run on the CPU, the kernel cases' outputs
   bit-equal to their plain versions.

Beside them, the serial rung's MLP program (``make_fleet_program(
model_mode="mlp")``) is held against the CPU at bf16 and in accuracy mode,
and B2 and B3 are timed in each of their forms: B2 per window (K = 1)
and per flush (K = 4, one launch), B3's tensor-core variant against its
SIMT variant at bf16 and f32.

Every published plane and watts tensor is checked against the same
schedule through the port on ``device="cpu"`` (a 32-node subset for the
temporal model; the same Aggregator and fault plan for the service
phases) and for energy conservation. Each kernel's launch count
is set to 0 just before a path runs and read just after. Every failed
check raises, so the run exits non-zero.

Output: one JSON object per line; the card's name and power limit as
``nvidia-smi`` prints them on a line of their own; a ``{"kernels": …}``
line; and last ``{"ok": true, "device": {...}}``. Without CUDA, or
without the repository beside it, the script exits non-zero before it
prints any result. It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
import json
import logging
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

N_NODES, N_WORKLOADS = 1024, 100
ZONES = ["package", "core", "dram", "uncore"]
FUSED_K = 4
RATIO_INTERVALS = 8
MIXED_WINDOWS = 4
AGG_MIXED_WINDOWS = 8
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
# the accuracy-mode check's head scale: predictions of tens of watts
ACC_SCALE = 40.0
# training (path 10): AdamW steps of each family on the card, the steps
# the CPU repeats of the same run, the dumped windows (single-tick and
# temporal) and the dump aggregators' workload bucket (100 workloads fit)
TRAIN_STEPS = 24
TRAIN_CPU_STEPS = 6
TRAIN_DUMP_WINDOWS = 2
TRAIN_TEMPORAL_WINDOWS = 6
TRAIN_W = 128
TRAIN_LOSS_RTOL = 1e-2
TRAIN_LR = "3e-3"  # deep diverges at cmd.train's default 1e-2
FAMILIES = ("linear", "mlp", "moe", "deep", "temporal")


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
        "library_device_ms": device_ms(lambda: (
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
    """One simulated node agent: a v2 keyframe first, then v2 delta frames
    against that keyframe (a node agent's delta base is its last
    acknowledged keyframe; it re-keys every 16 windows, so never here).
    A delta is FLAG_SAME exactly when nothing changed since the
    keyframe (``dirty`` is False)."""

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
        self.dirty = False

    def change(self) -> None:
        k = int(self.rng.integers(1, 10))
        hit = self.rng.choice(N_WORKLOADS, k, replace=False)
        self.cpu = self.cpu.copy()
        self.cpu[hit] = self.rng.uniform(0.05, 5.0, k)
        self.zones = self.rng.uniform(1e8, 1.5e9, len(ZONES)).astype(
            np.float32)
        self.ratio = float(self.rng.uniform(0.2, 0.95))
        self.dirty = True

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
        self.report = report
        full = wire.encode_report_v2(report, ZONES, seq=self.seq, run="r1")
        if self.base is None:
            self.base = full  # acknowledged at once
            return full
        delta = wire.encode_delta_v2(full, self.base)
        check(delta is not None, "agent could not encode a delta")
        check(wire.parse_header(delta).same == (not self.dirty),
              f"{self.name}: FLAG_SAME does not match the agent's state")
        return delta


class Ingest:
    """The aggregator's decode side for the engine-level paths: keyframes
    and deltas (merged against the node's keyframe) → RowInputs with
    content identity (run, content_seq), as ``fleet.aggregator`` keeps
    them (a FLAG_SAME delta keeps its keyframe's seq)."""

    def __init__(self) -> None:
        self.store: dict[str, tuple] = {}  # name → (report, run, cseq)
        self.bases: dict[str, tuple] = {}  # name → (keyframe report, seq)

    def receive(self, frame: bytes) -> bool:
        """→ True when the frame was a FLAG_SAME delta."""
        from kepler_tpu_torch.fleet import wire

        parsed = wire.parse_header(frame)
        name = wire.sanitize_node_name(parsed.header["node_name"])
        if parsed.is_delta:
            base, base_seq = self.bases[name]
            report, header, changed = wire.decode_delta(
                frame, parsed, base, tuple(ZONES))
            run = self.store[name][1]
            self.store[name] = (report, run,
                                header["seq"] if changed else base_seq)
            return bool(parsed.same)
        report, header = wire.decode_report(frame, parsed)
        self.bases[name] = (report, header["seq"])
        self.store[name] = (report, header["run"], header["seq"])
        return False

    def rows(self, live: list[str]) -> list:
        from kepler_tpu_torch.fleet.window import RowInput

        return [RowInput(name=n, report=self.store[n][0],
                         zone_names=tuple(ZONES),
                         ident=(self.store[n][1], self.store[n][2]))
                for n in sorted(live)]


def ratio_frames() -> list[tuple[list[str], list[bytes]]]:
    """Per interval, the live nodes and their wire-v2 frames: keyframes
    at interval 0 (and from the two nodes that join at interval 5),
    deltas otherwise; ~10% of nodes change each interval, three leave at
    interval 3, and interval 2 changes nothing — its deltas are
    FLAG_SAME for every node not changed since its keyframe."""
    rng = np.random.default_rng(SEED)
    agents = {f"node-{i:04d}": Agent(f"node-{i:04d}", rng)
              for i in range(N_NODES)}
    live = list(agents)
    out = []
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
        out.append((list(live), [agents[name].frame() for name in live]))
    return out


def ratio_schedule() -> list[list]:
    """Per interval, the RowInputs the aggregator hands the engine, from
    ``ratio_frames``."""
    ingest = Ingest()
    windows = []
    for t, (live, frames) in enumerate(ratio_frames()):
        same = [ingest.receive(frame) for frame in frames]
        if t == 2:
            check(sum(same) >= len(live) * 3 // 4,
                  "interval 2 must be mostly FLAG_SAME deltas")
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


def mlp_params(seed: int) -> dict:
    """init_mlp from ``seed`` with a non-zero output head (init zeroes
    it), drawn from the same generator."""
    from kepler_tpu_torch.models.mlp import init_mlp

    gen = torch.Generator().manual_seed(seed)
    params = init_mlp(len(ZONES), generator=gen)
    params["w2"] = torch.randn(params["w2"].shape, generator=gen) * 0.05
    params["w_skip"] = torch.randn(params["w_skip"].shape,
                                   generator=gen) * 0.01
    params["b2"] = torch.full_like(params["b2"], 0.5)
    return params


def mixed_windows() -> list[list]:
    """Per window, the RowInputs of the 50/50 ratio/MLP fleet: wire-v2
    keyframes then deltas, ~10% of nodes changing each window."""
    from kepler_tpu_torch.parallel.fleet import MODE_MODEL

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
    return windows


def main_mixed(dev: torch.device) -> dict:
    """Main path 2: 50/50 ratio/MLP fleet through the packed engine, B1
    in every window."""
    from kepler_tpu_torch.fleet.window import (PackedWindowEngine,
                                               fetch_plane)
    from kepler_tpu_torch.ops import cuda_attribution as ca
    from kepler_tpu_torch.parallel.fleet import MODE_MODEL

    params = mlp_params(SEED)
    windows = mixed_windows()

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
           "wire_frames": N_NODES * MIXED_WINDOWS,
           "compile_count": eng.compile_count}
    emit(row)
    return row


def main_serial_mlp(dev: torch.device) -> dict:
    """The serial rung's single-tick program with the MLP
    (``make_fleet_program(model_mode="mlp")``) on the card against the
    CPU: the default bf16 trunk within rtol 1e-2 and atol 1e-2 ·
    max|watts|, accuracy mode (f32) within rtol 1e-4; ratio rows equal."""
    from kepler_tpu_torch.parallel import (assemble_fleet_batch,
                                           make_fleet_program,
                                           run_fleet_attribution)
    from kepler_tpu_torch.parallel.fleet import MODE_MODEL

    params = mlp_params(SEED + 3)
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


# -- the Aggregator service -----------------------------------------------------

# the aggregator's per-interval legs, as its ``_stats`` report them
LEG_KEYS = ("last_assembly_ms", "last_dispatch_ms", "last_wait_ms",
            "last_fetch_ms", "last_scatter_ms", "last_sync_per_window_ms",
            "last_attribution_ms", "last_h2d_rows")


def make_aggregator(dev, **kw):
    """``Aggregator`` on ``dev`` at the north-star buckets, behind an
    ``APIServer`` on 127.0.0.1:0, on a fake clock that the caller moves 5
    s per interval (a node that skips an interval ages out: stale_after
    4 s). Every published window is recorded in order, as a copy that
    holds no pinned host memory: the aggregator itself keeps only its
    latest window, so the pinned buffers its fetches land in go back to
    PyTorch's host allocator and are reused, and the recorded legs are
    those a running service sees.
    → (aggregator, server, clock ticks, published windows)."""
    from kepler_tpu_torch.fleet.aggregator import Aggregator
    from kepler_tpu_torch.server.http import APIServer

    ticks = [1e9]
    server = APIServer(["127.0.0.1:0"])
    kw = {"node_bucket": N_NODES, "workload_bucket": 256, **kw}
    agg = Aggregator(server, device=dev, clock=lambda: ticks[0],
                     stale_after=4.0, skew_tolerance=0.0, **kw)
    agg.init()
    published: list = []
    publish = agg._publish

    def record(pending):
        res = publish(pending)
        kept = copy.copy(res)
        for name in type(res).__slots__:
            value = getattr(res, name)
            if isinstance(value, np.ndarray):
                setattr(kept, name, value.copy())
        published.append(kept)
        return res

    agg._publish = record
    return agg, server, ticks, published


@contextlib.contextmanager
def serving(server):
    """Run ``server`` on a thread → its base URL; stopped on exit."""
    from kepler_tpu_torch.service.lifecycle import CancelContext

    server.init()
    ctx = CancelContext()
    thread = threading.Thread(target=server.run, args=(ctx,), daemon=True)
    thread.start()
    try:
        host, port = server.addresses[0]
        yield f"http://{host}:{port}"
    finally:
        ctx.cancel()
        thread.join(timeout=30)


def http(base: str, path: str, body: bytes | None = None) -> bytes:
    req = urllib.request.Request(base + path, data=body,
                                 method="POST" if body else "GET")
    with urllib.request.urlopen(req, timeout=120) as resp:
        check(resp.status in (200, 204), f"{path}: HTTP {resp.status}")
        return resp.read()


def ingest_direct(agg, frames: list[bytes]) -> None:
    """The same frames through the aggregator's ingest, without HTTP."""
    for frame in frames:
        status = agg._ingest_payload(frame)[0]
        check(status == 204, f"ingest answered {status}")


def same_window(got, ref, what: str, model_rtol: float | None = None) -> int:
    """A published window against the CPU run's: ratio rows bit-equal
    (f16 plane, node power, node energy, cumulative joules), model rows
    within ``model_rtol`` (atol 1e-3 W) on the f16 plane. → ratio rows
    compared."""
    from kepler_tpu_torch.parallel.fleet import MODE_MODEL

    check(got.timestamp == ref.timestamp and sorted(got.names)
          == sorted(ref.names), f"{what}: another window than the CPU's")
    n_ratio = 0
    for name in ref.names:
        i, j = got.rows[name], ref.rows[name]
        a = got._wl_watts_f16[i].astype(np.float32)
        b = ref._wl_watts_f16[j].astype(np.float32)
        check(np.isfinite(a).all(), f"{what}: {name} non-finite watts")
        if int(ref.mode[j]) == MODE_MODEL:
            check(np.allclose(a, b, rtol=model_rtol, atol=1e-3),
                  f"{what}: model row {name} off the CPU by "
                  f"{float(np.abs(a - b).max())} W")
            continue
        n_ratio += 1
        check(np.array_equal(a, b)
              and np.array_equal(got.node_power_uw[i], ref.node_power_uw[j])
              and np.array_equal(got.node_energy_uj[i],
                                 ref.node_energy_uj[j])
              and np.array_equal(got.node_joules_total[i],
                                 ref.node_joules_total[j]),
              f"{what}: ratio row {name} differs from the CPU run")
    return n_ratio


def window_conservation(res, reports: dict, names=None) -> float:
    """Σ workload watts == node ACTIVE watts on ratio nodes of a
    published window (``names``, default all; f16 sums: 2e-3 relative),
    and node power equals the RAPL delta over dt (f64 here, rtol 1e-3).
    The window's zone axis is the sorted union of the reported zones."""
    worst = 0.0
    for name in res.names if names is None else names:
        i = res.rows[name]
        rep = reports[name]
        total = res.node_power_uw[i].astype(np.float64) * 1e-6
        zone = dict(zip(ZONES, np.asarray(rep.zone_deltas_uj, np.float64)))
        want = np.asarray([zone[z] for z in res.zones]) / 5.0 * 1e-6
        check(np.allclose(total, want, rtol=1e-3),
              f"node power of {name} off the RAPL delta")
        wl = res._wl_watts_f16[i, :res.counts[i]].astype(np.float64)
        active = want * min(max(rep.usage_ratio, 0.0), 1.0)
        rel = np.abs(wl.sum(axis=0) - active) / np.maximum(active, 1e-3)
        worst = max(worst, float(rel.max()))
    check(worst <= 2e-3, f"conservation off by {worst:.2e} relative")
    return worst


class GcClock:
    """Host ms the interpreter's cyclic garbage collector ran while
    installed (``gc.callbacks``), any thread."""

    def __init__(self) -> None:
        self.ms = 0.0
        self._start: float | None = None

    def __call__(self, phase: str, _info: dict) -> None:
        if phase == "start":
            self._start = time.perf_counter()
        elif self._start is not None:
            self.ms += (time.perf_counter() - self._start) * 1e3
            self._start = None


def serve_intervals(agg, server, ticks, intervals: list,
                    after=None) -> tuple[list, list]:
    """Serve ``agg`` over HTTP and drive ``intervals``: one ``POST
    /v1/reports`` batch per interval, then ``aggregate_once()``;
    ``after(base)`` runs against the live server at the end.
    → (the aggregator's legs per interval with the garbage collector's
    ms during the ingest, HTTP ingest seconds)."""
    import gc

    from kepler_tpu_torch.fleet import wire

    legs, ingest_s = [], []
    with serving(server) as base:
        for _live, frames in intervals:
            ticks[0] += 5.0
            batch = wire.encode_report_batch(frames)
            clock = GcClock()
            gc.callbacks.append(clock)
            t0 = time.perf_counter()
            try:
                body = http(base, "/v1/reports", batch)
            finally:
                ingest_s.append(time.perf_counter() - t0)
                gc.callbacks.remove(clock)
            statuses = {r["status"] for r in json.loads(body)["results"]}
            check(statuses == {204}, f"batch ingest answered {statuses}")
            agg.aggregate_once()
            legs.append({**{k: agg._stats[k] for k in LEG_KEYS},
                         "ingest_gc_ms": clock.ms})
        torch.cuda.synchronize()
        if after is not None:
            after(base)
    return legs, ingest_s


def pinned_alloc_ms(shape: tuple, n: int = 3) -> list[float]:
    """Host ms of ``n`` pinned f16 allocations of ``shape`` held at once
    (each one page-locks fresh memory), then of one more after they are
    released (served from the host allocator's cache)."""
    held, out = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        held.append(torch.empty(shape, dtype=torch.float16, pin_memory=True))
        out.append((time.perf_counter() - t0) * 1e3)
    del held
    t0 = time.perf_counter()
    torch.empty(shape, dtype=torch.float16, pin_memory=True)
    out.append((time.perf_counter() - t0) * 1e3)
    return out


def main_aggregator_fused(dev: torch.device) -> dict:
    """The Aggregator service on the fused tier: ``ratio_frames`` over
    real HTTP (one ``POST /v1/reports`` batch per interval) into
    ``Aggregator(backend="pallas", model_mode=None, fused_window_k=4)``
    and ``aggregate_once()`` per interval — kernel B2 once per flush."""
    from kepler_tpu_torch.fleet import wire

    intervals = ratio_frames()
    kw = dict(backend="pallas", model_mode=None, fused_window_k=FUSED_K)
    cpu, _, cpu_ticks, cpu_pub = make_aggregator("cpu", **kw)
    snapshots = []
    for _live, frames in intervals:
        cpu_ticks[0] += 5.0
        ingest_direct(cpu, frames)
        snapshots.append({n: s.report for n, s in cpu._reports.items()})
        cpu.aggregate_once()
    check(len(cpu_pub) == RATIO_INTERVALS, "the CPU run skipped a window")

    agg, server, ticks, published = make_aggregator(dev, **kw)
    queried: list[str] = []

    def query(base: str) -> None:
        last = published[-1]
        queried.extend([last.names[0], last.names[len(last.names) // 2],
                        "join-1"])
        for name in queried:
            got = json.loads(http(base, f"/v1/results?node={name}"))
            check(got == json.loads(json.dumps(last.render_node(name))),
                  f"/v1/results?node={name} differs from the window")

    reset_launches()
    t0 = time.perf_counter()
    legs, ingest_s = serve_intervals(agg, server, ticks, intervals, query)
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    health = agg.window_health()
    check(launches["fused_window_step"] == RATIO_INTERVALS // FUSED_K,
          f"B2 launched {launches['fused_window_step']} times in "
          f"{RATIO_INTERVALS} intervals")
    check(launches["outer_product_attribution"] == 0
          and launches["flash_block"] == 0, "the fused tier ran B1 or B3")
    check(health["rung_name"] == "packed-fused-scan"
          and agg._stats["window_demotions_total"] == 0
          and not agg._rung_timeline, f"the ladder moved: {health}")
    check(len(published) == RATIO_INTERVALS, "not every interval published")
    worst = 0.0
    for t, (got, ref) in enumerate(zip(published, cpu_pub)):
        same_window(got, ref, f"interval {t}")
        worst = max(worst, window_conservation(got, snapshots[t]))
    # the same schedule through a second service in this warm process
    # (kernels loaded, the host allocator holding pinned blocks): the
    # legs a running service sees after its first flushes
    del agg, server, published
    warm_legs, warm_ingest_s = serve_intervals(*make_aggregator(dev, **kw)[:3],
                                               intervals)
    row = {"phase": "main_aggregator_fused", "nodes": N_NODES,
           "workloads": N_WORKLOADS, "zones": len(ZONES), "k": FUSED_K,
           "intervals": RATIO_INTERVALS, "launches": launches,
           "rung": health["rung_name"], "max_conservation_rel": worst,
           "results_queried": queried, "first_run_s": wall_s,
           "http_ingest_s": ingest_s, "legs_ms_per_interval": legs,
           "warm_http_ingest_s": warm_ingest_s,
           "warm_legs_ms_per_interval": warm_legs,
           "pinned_alloc_ms": pinned_alloc_ms((FUSED_K, N_NODES, 258,
                                               len(ZONES))),
           "batch_bytes": [len(wire.encode_report_batch(f))
                           for _, f in intervals[:3]]}
    emit(row)
    return row


def mixed_intervals(seed: int, windows: int = AGG_MIXED_WINDOWS
                    ) -> tuple[list[list[bytes]], list[dict]]:
    """aggregator-mixed's schedule: 1024 nodes, every odd one a model
    node, ~10% of nodes change each interval after the first. → per
    interval the wire-v2 frames and the reports they carry by node."""
    from kepler_tpu_torch.parallel.fleet import MODE_MODEL

    rng = np.random.default_rng(seed)
    agents = [Agent(f"node-{i:04d}", rng, mode=MODE_MODEL if i % 2 else 0)
              for i in range(N_NODES)]
    frames, reports = [], []
    for t in range(windows):
        if t:
            for a in rng.choice(agents, N_NODES // 10, replace=False):
                a.change()
        frames.append([a.frame() for a in agents])
        reports.append({a.name: a.report for a in agents})
    return frames, reports


def main_aggregator_mixed(dev: torch.device) -> dict:
    """The Aggregator on the pipelined tier with a 50/50 ratio/MLP fleet
    (``pipeline_depth=2``, ``backend="pallas"``): B1 in every dispatched
    window; one injected ``device.dispatch_error`` demotes one rung and
    the ladder re-promotes after ``repromote_after=2`` clean windows."""
    from kepler_tpu_torch import fault
    from kepler_tpu_torch.parallel.fleet import MODE_MODEL

    params = mlp_params(SEED + 4)
    intervals, _ = mixed_intervals(SEED + 4)
    kw = dict(backend="pallas", model_mode="mlp", model_params=params,
              pipeline_depth=2, repromote_after=2)
    spec = fault.FaultSpec(site="device.dispatch_error", skip=2, count=1)

    def run(device, on_card: bool):
        agg, _, ticks, published = make_aggregator(device, **kw)
        calls, legs = [], []
        with fault.installed(fault.FaultPlan([spec])) as plan:
            if on_card:
                reset_launches()
            for frames in intervals:
                ticks[0] += 5.0
                ingest_direct(agg, frames)
                calls.append(agg.aggregate_once() is not None)
                legs.append({k: agg._stats[k] for k in LEG_KEYS})
            agg._drain_pipeline()
            if on_card:
                torch.cuda.synchronize()
                launches = read_launches()
        check(plan.fired("device.dispatch_error") == 1,
              "the injected dispatch error did not fire once")
        return agg, published, calls, legs, (launches if on_card else None)

    cpu, cpu_pub, cpu_calls, _, _ = run("cpu", False)
    t0 = time.perf_counter()
    agg, published, calls, legs, launches = run(dev, True)
    wall_s = time.perf_counter() - t0
    check(launches["outer_product_attribution"] == AGG_MIXED_WINDOWS,
          f"B1 launched {launches['outer_product_attribution']} times for "
          f"{AGG_MIXED_WINDOWS} dispatched windows")
    check(launches["fused_window_step"] == 0, "the mixed tier ran B2")
    check(agg._demotions_by_reason == {"dispatch_error": 1}
          and agg._stats["window_repromotions_total"] == 1
          and agg.window_health()["rung_name"] == "packed-pipelined",
          f"ladder: {agg._demotions_by_reason}, "
          f"{agg._stats['window_repromotions_total']} repromotions")
    # every call publishes but the pipeline's fill slots (at start and
    # right after the re-promotion), exactly as on the CPU
    gaps = [i for i, ok in enumerate(calls) if not ok]
    check(calls == cpu_calls and gaps == [0, 2 + 2],
          f"publish gaps {gaps} (CPU: {cpu_calls})")
    check(len(published) == len(cpu_pub), "published count differs")
    ratio_rows = sum(same_window(got, ref, f"window {t}", model_rtol=1e-3)
                     for t, (got, ref) in enumerate(zip(published,
                                                        cpu_pub)))
    model_w = max(float(np.abs(r._wl_watts_f16[r.mode == MODE_MODEL]).max())
                  for r in published)
    check(model_w > 0.1, "model rows are all ~zero")
    row = {"phase": "main_aggregator_mixed", "nodes": N_NODES,
           "workloads": N_WORKLOADS, "zones": len(ZONES),
           "windows": AGG_MIXED_WINDOWS, "launches": launches,
           "published": len(published), "publish_gaps": gaps,
           "ratio_rows_bit_equal": ratio_rows,
           "timeline": [{k: e[k] for k in ("rung_name", "from_rung_name",
                                           "reason")}
                        for e in agg._rung_timeline],
           "first_run_s": wall_s, "legs_ms_per_window": legs}
    emit(row)
    return row


def main_aggregator_cmd(model: str = "", params_path: str = "") -> dict:
    """The aggregator binary on the card: ``python -m
    kepler_tpu_torch.cmd.aggregator`` (flags only, ``/metrics`` off, the
    default 5 s interval, depth 1; ratio attribution, or ``model`` with
    the params in ``params_path`` for every odd node), 64 nodes POST one
    wire-v2 keyframe each, ``/v1/results`` answers for them after the
    next window, and SIGTERM shuts the process down cleanly."""
    import signal
    import socket

    from kepler_tpu_torch.fleet import wire
    from kepler_tpu_torch.parallel.fleet import MODE_MODEL, NodeReport

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    cmd = [sys.executable, "-m", "kepler_tpu_torch.cmd.aggregator",
           "--tpu.fleet-backend", "pallas", "--aggregator.model", model,
           "--aggregator.pipeline-depth", "1", "--no-exporter.prometheus",
           "--aggregator.listen-address", f"127.0.0.1:{port}"]
    if params_path:
        cmd += ["--aggregator.params-path", params_path]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=here, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.perf_counter() + 120
        while True:  # the binary builds (or finds) the kernels at init
            check(proc.poll() is None, "the aggregator binary exited")
            try:
                http(base, "/readyz")
                break
            except OSError:
                check(time.perf_counter() < deadline, "binary never ready")
                time.sleep(0.25)
        ready_s = time.perf_counter() - t0
        rng = np.random.default_rng(SEED + 5)
        names = [f"node-{i:04d}" for i in range(64)]
        for i, name in enumerate(names):
            cpu = rng.uniform(0.05, 5.0, N_WORKLOADS).astype(np.float32)
            report = NodeReport(
                node_name=name,
                zone_deltas_uj=rng.uniform(1e8, 1.5e9, len(ZONES)).astype(
                    np.float32),
                zone_valid=np.ones(len(ZONES), bool),
                usage_ratio=float(rng.uniform(0.2, 0.95)), cpu_deltas=cpu,
                workload_ids=[f"{name}/pod-{i}" for i in range(N_WORKLOADS)],
                node_cpu_delta=float(cpu.sum(dtype=np.float32)), dt_s=5.0,
                mode=MODE_MODEL if model and i % 2 else 0,
                workload_kinds=np.full(N_WORKLOADS, 3, np.int8))
            http(base, "/v1/report",
                 wire.encode_report_v2(report, ZONES, seq=1, run="r1"))
        t1 = time.perf_counter()
        while True:  # one window after the next 5 s tick
            try:
                node = json.loads(http(base, f"/v1/results?node={names[7]}"))
                break
            except OSError:
                check(time.perf_counter() < t1 + 30, "no window published")
                time.sleep(0.25)
        first_window_s = time.perf_counter() - t1
        watts = np.asarray([w["power_uw"] for w in node["workloads"]])
        check(watts.shape == (N_WORKLOADS, len(ZONES))
              and np.isfinite(watts).all() and watts.sum() > 0,
              "the binary published no watts")
        window = json.loads(http(base, "/debug/window"))
        health = json.loads(http(base, "/healthz"))
        check(window["rung_name"] == "packed-pipelined"
              and window["stats"]["last_batch_nodes"] == len(names),
              f"binary window: {window['rung_name']}")
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            out, _ = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
    check(proc.returncode == 0 and "Graceful shutdown completed" in out,
          f"binary exit {proc.returncode}: {out[-500:]}")
    row = {"phase": "main_aggregator_cmd" + (f"_{model}" if model else ""),
           "nodes": len(names),
           "ready_s": ready_s, "first_window_s": first_window_s,
           "rung": window["rung_name"], "healthz_ok": health.get("status"),
           "exit": proc.returncode,
           "device_line": [ln for ln in out.splitlines()
                           if "aggregator" in ln and " on " in ln][:1]}
    emit(row)
    return row


def single_tick_params(mode: str, seed: int) -> dict:
    """init_moe (E = 8, H = 128) or init_deep (S = 4, D = 128) at their
    default widths from ``seed``, with non-zero output layers (the
    initialisers zero them) drawn from the same generator."""
    from kepler_tpu_torch.models import initializer

    gen = torch.Generator().manual_seed(seed)
    params = initializer(mode)(len(ZONES), generator=gen)
    out_w, out_b = ("w1", "b1") if mode == "moe" else ("w_head", "b_head")
    params[out_w] = torch.randn(params[out_w].shape, generator=gen) * 0.05
    params["w_skip"] = torch.randn(params["w_skip"].shape,
                                   generator=gen) * 0.01
    params[out_b] = torch.full_like(params[out_b], 0.5)
    return params


def mixed_conservation(res, reports: dict) -> float:
    """Σ workload watts = node active watts in every row of a published
    mixed window: ratio rows against their RAPL split
    (``window_conservation``), model rows against the node power the
    program summed from the same predictions (f16 terms: 2e-3)."""
    from kepler_tpu_torch.parallel.fleet import MODE_MODEL

    model = [n for n in res.names if res.mode[res.rows[n]] == MODE_MODEL]
    ratio = [n for n in res.names if res.mode[res.rows[n]] != MODE_MODEL]
    worst = window_conservation(res, reports, ratio)
    for name in model:
        i = res.rows[name]
        wl = res._wl_watts_f16[i, :res.counts[i]].astype(np.float64)
        node = res.node_power_uw[i].astype(np.float64) * 1e-6
        rel = np.abs(wl.sum(axis=0) - node) / np.maximum(node, 1e-3)
        worst = max(worst, float(rel.max()))
    check(worst <= 2e-3, f"conservation off by {worst:.2e} relative")
    return worst


def main_aggregator_models(dev: torch.device) -> dict:
    """The Aggregator's pipelined tier (depth 2, ``backend="pallas"``)
    with aggregator-mixed's 50/50 schedule, once with ``model: moe`` (E =
    8, H = 128) and once with ``model: deep`` (S = 4, D = 128): B1 in
    every window; each window against ``device="cpu"`` (ratio rows
    bit-equal, model rows within 1e-3 on the f16 plane) and conserving.
    The last window runs under the profiler for the program's device
    ms."""
    from kepler_tpu_torch.parallel.fleet import MODE_MODEL

    intervals, reports = mixed_intervals(SEED + 4)
    row = {"phase": "main_aggregator_models", "nodes": N_NODES,
           "workloads": N_WORKLOADS, "zones": len(ZONES),
           "windows": AGG_MIXED_WINDOWS}
    for mode in ("moe", "deep"):
        kw = dict(backend="pallas", model_mode=mode, pipeline_depth=2,
                  model_params=single_tick_params(mode, SEED + 7))

        def run(device, on_card: bool):
            agg, _, ticks, published = make_aggregator(device, **kw)
            legs, prof, launches = [], None, None
            if on_card:
                reset_launches()
            for t, frames in enumerate(intervals):
                ticks[0] += 5.0
                ingest_direct(agg, frames)
                if on_card and t == len(intervals) - 1:
                    prof = profile_top(agg.aggregate_once, k=6)
                else:
                    agg.aggregate_once()
                legs.append({k: agg._stats[k] for k in LEG_KEYS})
            agg._drain_pipeline()
            if on_card:
                torch.cuda.synchronize()
                launches = read_launches()
            return agg, published, legs, launches, prof

        t0 = time.perf_counter()
        _, cpu_pub, _, _, _ = run("cpu", False)
        cpu_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        agg, published, legs, launches, prof = run(dev, True)
        wall_s = time.perf_counter() - t0
        check(launches["outer_product_attribution"] == AGG_MIXED_WINDOWS,
              f"{mode}: B1 launched {launches['outer_product_attribution']}"
              f" times for {AGG_MIXED_WINDOWS} windows")
        check(launches["fused_window_step"] == 0
              and launches["flash_block"] == 0, f"{mode}: B2 or B3 ran")
        check(agg.window_health()["rung_name"] == "packed-pipelined"
              and agg._stats["window_demotions_total"] == 0,
              f"{mode}: left the pipelined tier")
        check(len(published) == len(cpu_pub) == AGG_MIXED_WINDOWS,
              f"{mode}: {len(published)} windows published")
        ratio_rows = sum(
            same_window(got, ref, f"{mode} window {t}", model_rtol=1e-3)
            for t, (got, ref) in enumerate(zip(published, cpu_pub)))
        worst_rel = 0.0
        for got, ref in zip(published, cpu_pub):
            m = ref.mode == MODE_MODEL
            a = got._wl_watts_f16[m].astype(np.float32)
            b = ref._wl_watts_f16[m].astype(np.float32)
            worst_rel = max(worst_rel, float(
                (np.abs(a - b) / np.maximum(np.abs(b), 1e-3)).max()))
        conservation = max(mixed_conservation(res, reports[t])
                           for t, res in enumerate(published))
        model_w = max(float(np.abs(r._wl_watts_f16[r.mode == MODE_MODEL])
                            .max()) for r in published)
        check(model_w > 0.1, f"{mode}: model rows are all ~zero")
        row[mode] = {"launches": launches, "ratio_rows_bit_equal": ratio_rows,
                     "max_model_rel_vs_cpu": worst_rel,
                     "max_model_watts": model_w,
                     "conservation_rel": conservation,
                     "first_run_s": wall_s, "cpu_run_s": cpu_s,
                     "legs_ms_per_window": legs,
                     "profiled_window": prof}
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


def sdpa_ms(q, k, v, valid) -> tuple[float | None, float | None,
                                       str | None]:
    """``scaled_dot_product_attention`` on the same f32 inputs (causal
    and KV-validity mask) — the yardstick for ``full_attention_pallas``;
    the port never calls it. → (ms, device ms, None) or (None, None, why
    it did not run)."""
    import torch.nn.functional as F

    t = q.shape[1]
    causal = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    mask = valid[:, None, None, :] & causal
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def call():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

    try:
        return (time_ms(call, reps=5, batch=4), device_ms(call, calls=4),
                None)
    except RuntimeError as err:  # a yardstick only: record why
        return None, None, str(err).splitlines()[0][:200]


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
    lib_ms, lib_device_ms, lib_err = sdpa_ms(q, k, v, valid)
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
        "library_ms": lib_ms, "library_device_ms": lib_device_ms,
        "library": "torch.nn.functional."
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


def temporal_params(scale: float = 1.0, t_max: int = 128) -> dict:
    """init_temporal at its default widths (d_model 128, 4 heads; t_max
    128 unless given) from the seed, with a non-zero head (init zeroes
    it); ``scale`` multiplies the head, the skip path and the bias (40
    makes the predictions tens of watts)."""
    from kepler_tpu_torch.models.temporal import init_temporal

    gen = torch.Generator().manual_seed(SEED)
    params = init_temporal(len(ZONES), t_max=t_max, generator=gen)
    params["w_head"] = torch.randn(params["w_head"].shape,
                                   generator=gen) * 0.05 * scale
    params["w_skip"] = torch.randn(params["w_skip"].shape,
                                   generator=gen) * 0.01 * scale
    params["b_head"] = torch.full_like(params["b_head"], 0.5 * scale)
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
    """Main path 4: the temporal fleet window through the Aggregator
    service (``model_mode="temporal"``, ``backend="pallas"``,
    ``history_window=16``): each window's reports ingest as wire-v2
    keyframes (the ingest pushes every model node's feature history),
    then ``aggregate_once()`` runs the serial rung — B1 in every window,
    B3 never. → (row, per-window (batch, feat_hist, t_valid) as the
    aggregator dispatched them, params, per-window published workload
    watts in µW)."""
    from kepler_tpu_torch.fleet import wire
    from kepler_tpu_torch.parallel import (make_temporal_fleet_program,
                                           run_fleet_attribution)
    from kepler_tpu_torch.parallel.fleet import MODE_MODEL

    t0 = time.perf_counter()
    windows = temporal_schedule()
    frames = [[wire.encode_report_v2(r, ZONES, seq=t + 1, run="r1")
               for r in reports] for t, reports in enumerate(windows)]
    schedule_s = time.perf_counter() - t0
    params = temporal_params()
    agg, _, ticks, published = make_aggregator(
        dev, backend="pallas", model_mode="temporal",
        history_window=HISTORY_T, model_params=params)
    program = make_temporal_fleet_program(device=dev, backend="pallas")
    saved = []
    dispatch = agg._dispatch_legacy

    def keep(*args):
        pending = dispatch(*args)
        saved.append((pending.batch, pending.feat_hist, pending.t_valid))
        return pending

    agg._dispatch_legacy = keep
    legs = {k: [] for k in ("ingest", "assembly", "dispatch", "wait",
                            "scatter", "window")}
    reset_launches()
    for batch_frames in frames:
        ticks[0] += 5.0
        t0 = time.perf_counter()
        ingest_direct(agg, batch_frames)
        t1 = time.perf_counter()
        check(agg.aggregate_once() is not None, "a window did not publish")
        t2 = time.perf_counter()
        legs["ingest"].append((t1 - t0) * 1e3)
        legs["window"].append((t2 - t1) * 1e3)
        for k in ("assembly", "dispatch", "wait", "scatter"):
            legs[k].append(agg._stats[f"last_{k}_ms"])
    sync()
    launches = read_launches()
    check(launches["outer_product_attribution"] == TEMPORAL_WINDOWS,
          f"B1 launched {launches['outer_product_attribution']} times in "
          f"{TEMPORAL_WINDOWS} temporal windows")
    check(launches["flash_block"] == 0, "the temporal fleet path ran B3")
    check(launches["fused_window_step"] == 0,
          "the temporal fleet path ran B2")
    check(len(published) == len(saved) == TEMPORAL_WINDOWS
          and agg._stats["window_demotions_total"] == 0,
          "the temporal windows did not all publish at rung 0")
    outs = [r.wl_power_uw for r in published]

    # the same windows: einsum backend on the card (ratio rows equal),
    # and the plain versions on the CPU over a node subset
    einsum = make_temporal_fleet_program(device=dev, backend="einsum")
    on_cpu = make_temporal_fleet_program(device="cpu", backend="pallas")
    worst = {"model_rel_vs_cpu": 0.0, "model_abs_vs_cpu_w": 0.0,
             "conservation_rel": 0.0}
    for t, ((batch, hist, tv), res) in enumerate(zip(saved, published)):
        model = batch.mode == MODE_MODEL
        ratio = ~model
        # the four arrays the aggregator fetches, in FleetResult order
        out = {0: res.node_energy_uj, 3: res.node_power_uw,
               6: res.wl_energy_uj, 7: res.wl_power_uw}
        check(all(np.isfinite(x).all() for x in out.values()),
              f"window {t}: non-finite published window")
        ref = host_result(run_fleet_attribution(einsum, batch, params,
                                                hist, tv))
        check(all(np.array_equal(a[ratio], ref[k][ratio])
                  for k, a in out.items()),
              f"window {t}: ratio rows differ from the einsum program")
        wl_w = out[7] * 1e-6  # workload_power_uw → W
        check(float(wl_w[model].max()) > 0.1,
              f"window {t}: model rows are all ~zero")
        live = ratio & (batch.node_cpu_delta > 0)
        share = np.clip(batch.usage_ratio[live], 0.0, 1.0)[:, None]
        active = out[3][live].astype(np.float64) * share
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

    # accuracy mode (f32 compute) on the last window's node subset, with
    # the head scaled so the model predicts tens of watts: rtol 1e-4 with
    # an atol of 1e-5 · max|watts| (a prediction the 0 W floor leaves just
    # above it carries the f32 noise of its sum's largest terms)
    batch, hist, tv = saved[-1]
    sub = node_subset(batch, CPU_NODES)
    m = sub.mode == MODE_MODEL
    acc_params = temporal_params(scale=ACC_SCALE)
    acc = [host_result(run_fleet_attribution(
        make_temporal_fleet_program(device=d, backend="pallas",
                                    accuracy_mode=True),
        sub, acc_params, hist[:CPU_NODES], tv[:CPU_NODES]))[7]
        for d in (dev, "cpu")]
    a, b = acc[0][m] * 1e-6, acc[1][m] * 1e-6  # µW → W
    top = float(np.abs(b).max())
    check(top > 10.0, f"accuracy-mode model watts peak at {top} W")
    check(np.allclose(a, b, rtol=1e-4, atol=1e-5 * top),
          "accuracy-mode model watts off the CPU program (rtol 1e-4, "
          "atol 1e-5 · max|watts|)")
    check(np.array_equal(acc[0][~m], acc[1][~m]) or np.allclose(
        acc[0][~m], acc[1][~m], rtol=1e-6), "accuracy-mode ratio rows")
    gap = np.abs(a - b)
    big = np.abs(b) >= 1e-2 * top
    worst["accuracy_max_watts"] = top
    worst["accuracy_abs_vs_cpu_w"] = float(gap.max())
    worst["accuracy_abs_over_max"] = float(gap.max()) / top
    # over predictions of at least 1% of the largest; below, a prediction
    # is the f32 cancellation of terms of tens of watts
    worst["accuracy_rel_vs_cpu"] = float((gap[big] / np.abs(b[big])).max())
    worst["accuracy_rtol_holds_above_w"] = float(
        np.abs(b[gap > 1e-4 * np.abs(b)]).max(initial=0.0))

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
           "rung": agg.window_health()["rung_name"],
           "schedule_and_encode_s": schedule_s,
           "leg_ms_per_window": {k: statistics.median(v[steady])
                                 for k, v in legs.items()},
           "leg_ms_window_0": {k: v[0] for k, v in legs.items()},
           "feat_hist_mb": saved[-1][1].nbytes / 1e6,
           "program_profile": prof}
    emit(row)
    return row, saved, params, outs


def main_temporal_trunk(dev: torch.device, saved: list,
                        params: dict, fleet_outs: list) -> dict:
    """Main path 5: the full-sequence trunk through B3 on path 4's
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
        fast = fleet_outs[t][model] * 1e-6
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


# -- training (path 10) ------------------------------------------------------------

class TrainLog(logging.Handler):
    """``cmd.train``'s per-step losses and the step it resumed from, read
    from its log records."""

    def __init__(self) -> None:
        super().__init__()
        self.losses: list[float] = []
        self.resumed: int | None = None

    def emit(self, record: logging.LogRecord) -> None:
        if record.msg.startswith("step "):
            self.losses.append(float(record.args[2]))
        elif record.msg.startswith("resumed"):
            self.resumed = int(record.args[0])


def train_cli(argv: list[str]) -> TrainLog:
    """``kepler_tpu_torch.cmd.train.main(argv)`` in this process; fails
    the run unless it exits 0."""
    from kepler_tpu_torch.cmd import train as cmd

    logger = logging.getLogger("kepler.train")
    handler = TrainLog()
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    logger.propagate = False  # per-step lines stay off stderr
    try:
        rc = cmd.main(argv)
    finally:
        logger.removeHandler(handler)
    check(rc == 0, f"cmd.train {' '.join(argv)} exited {rc}")
    return handler


def train_dumps(dev: torch.device, root: str, mixed: list,
                temporal: list) -> tuple[str, str]:
    """Training dumps written by Aggregators on the card
    (``training_dump_dir``): ``mixed``'s first windows on the MLP serial
    rung, and ``temporal``'s windows with ``model: temporal`` (the last
    window's file kept, its histories up to that many ticks long). →
    (single-tick dump dir, temporal dump dir)."""
    from kepler_tpu_torch.fleet import wire

    single_dir = os.path.join(root, "dump-single")
    temporal_dir = os.path.join(root, "dump-temporal")
    agg, _, ticks, _ = make_aggregator(
        dev, backend="pallas", model_mode="mlp",
        model_params=mlp_params(SEED + 8), training_dump_dir=single_dir,
        workload_bucket=TRAIN_W)
    for frames in mixed[:TRAIN_DUMP_WINDOWS]:
        ticks[0] += 5.0
        ingest_direct(agg, frames)
        agg.aggregate_once()
    agg._drain_pipeline()
    agg, _, ticks, _ = make_aggregator(
        dev, backend="pallas", model_mode="temporal",
        history_window=HISTORY_T, model_params=temporal_params(),
        training_dump_dir=temporal_dir, training_dump_max_files=1,
        workload_bucket=TRAIN_W)
    for t, reports in enumerate(temporal[:TRAIN_TEMPORAL_WINDOWS]):
        ticks[0] += 5.0
        ingest_direct(agg, [wire.encode_report_v2(r, ZONES, seq=t + 1,
                                                  run="r1")
                            for r in reports])
        check(agg.aggregate_once() is not None, "a dump window is missing")
    agg._drain_pipeline()
    check(len(os.listdir(single_dir)) == TRAIN_DUMP_WINDOWS
          and len(os.listdir(temporal_dir)) == 1,
          "the aggregators wrote other dumps than asked")
    return single_dir, temporal_dir


def train_step_ms(argv: list[str], dev: torch.device,
                  steps: int = 10) -> tuple[float, float]:
    """The family's train step as ``cmd.train`` builds it, on the card:
    CUDA-event ms per step over ``steps`` after two warm steps, and the
    peak device memory (MiB) from building the state on."""
    from kepler_tpu_torch.cmd import train as cmd

    args = cmd.parse_args(argv)
    data, _ = cmd.load_windows(args.data)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, step_fn, inputs = cmd.build_trainer(args, data, dev)
    for _ in range(2):
        state, _ = step_fn(state, *inputs)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        state, _ = step_fn(state, *inputs)
    end.record()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**20
    del state, step_fn, inputs
    torch.cuda.empty_cache()
    return start.elapsed_time(end) / steps, peak


def serve_trained(dev: torch.device, family: str, path: str,
                  frames: list[list[bytes]]) -> dict:
    """The ``.npz`` ``cmd.train`` wrote, served by the Aggregator on the
    card (``backend="pallas"``) for ``frames``' windows: every window
    publishes, model rows finite and not all zero."""
    from kepler_tpu_torch.models.estimator import load_params
    from kepler_tpu_torch.parallel.fleet import MODE_MODEL

    kw = dict(backend="pallas", model_mode=family,
              model_params=load_params(path))
    if family == "temporal":
        kw["history_window"] = HISTORY_T
    agg, _, ticks, published = make_aggregator(dev, **kw)
    for batch in frames:
        ticks[0] += 5.0
        ingest_direct(agg, batch)
        agg.aggregate_once()
    agg._drain_pipeline()
    check(len(published) == len(frames)
          and agg._stats["window_demotions_total"] == 0,
          f"{family}: the trained params did not serve every window")
    top = 0.0
    for res in published:
        w = res.wl_power_uw[res.mode == MODE_MODEL] * 1e-6
        check(np.isfinite(w).all(), f"{family}: non-finite served watts")
        top = max(top, float(np.abs(w).max()))
    check(top > 0.01, f"{family}: the trained model serves ~0 W")
    return {"windows": len(published), "max_model_watts": top,
            "rung": agg.window_health()["rung_name"]}


def main_train(dev: torch.device) -> dict:
    """Path 10, the train half of the loop on the card: dumps from the
    Aggregator (``training_dump_dir``), then ``cmd.train.main`` for each
    of the five families on ``cuda`` for TRAIN_STEPS AdamW steps (the
    loss must fall); the same run checkpointed halfway and resumed ends
    at the same params; the run's first TRAIN_CPU_STEPS steps with
    ``--device cpu`` give the same losses within TRAIN_LOSS_RTOL (bf16
    trunks round their operands after sums taken in another order); the
    output ``.npz`` serves in the Aggregator on the card (moe's and
    deep's through the aggregator binary too); and the binary ``python -m
    kepler_tpu_torch.cmd.train`` exits 0. Training launches
    no kernel (as in JAX); the dumps and the serving windows launch B1."""
    from kepler_tpu_torch.cmd.train import load_windows
    from kepler_tpu_torch.fleet import wire
    from kepler_tpu_torch.models.estimator import load_params, param_leaves

    here = os.path.dirname(os.path.abspath(__file__))
    mixed, _ = mixed_intervals(SEED + 8, windows=TRAIN_DUMP_WINDOWS)
    temporal_windows = temporal_schedule()[:TRAIN_TEMPORAL_WINDOWS]
    temporal_frames = [[wire.encode_report_v2(r, ZONES, seq=t + 1, run="r1")
                        for r in reports]
                       for t, reports in enumerate(temporal_windows[:2])]
    row = {"phase": "main_train", "steps": TRAIN_STEPS,
           "cpu_steps": TRAIN_CPU_STEPS, "loss_rtol": TRAIN_LOSS_RTOL,
           "families": {}}
    with tempfile.TemporaryDirectory(prefix="kt-train-") as root:
        reset_launches()
        t0 = time.perf_counter()
        single_dir, temporal_dir = train_dumps(dev, root, mixed,
                                               temporal_windows)
        row["dump_s"] = time.perf_counter() - t0
        for name, d in (("single", single_dir), ("temporal", temporal_dir)):
            data, files = load_windows(d)
            row[f"{name}_rows"] = list(data["cpu_deltas"].shape)
            row[f"{name}_labelled"] = int(data["workload_valid"].sum())
        for fam in FAMILIES:
            data = temporal_dir if fam == "temporal" else single_dir
            out = os.path.join(root, fam)
            base = ["--data", data, "--model", fam, "--lr", TRAIN_LR,
                    "--log-every", "1"]
            t0 = time.perf_counter()
            straight = train_cli(base + ["--steps", str(TRAIN_STEPS),
                                         "--out", f"{out}-straight.npz"])
            card_s = time.perf_counter() - t0
            losses = straight.losses
            check(len(losses) == TRAIN_STEPS and losses[-1] < losses[0],
                  f"{fam}: the loss did not fall ({losses[:1]} → "
                  f"{losses[-1:]})")
            ck = f"{out}-ck"
            train_cli(base + ["--steps", str(TRAIN_STEPS // 2), "--out",
                              f"{out}-half.npz", "--ckpt-dir", ck])
            resumed = train_cli(base + ["--steps", str(TRAIN_STEPS),
                                        "--out", f"{out}-resumed.npz",
                                        "--ckpt-dir", ck,
                                        "--ckpt-every", "5"])
            check(resumed.resumed == TRAIN_STEPS // 2,
                  f"{fam}: resumed from {resumed.resumed}")
            a = param_leaves(load_params(f"{out}-straight.npz"))
            b = param_leaves(load_params(f"{out}-resumed.npz"))
            resume_diff = max(float((x - y).abs().max())
                              for x, y in zip(a, b))
            check(resume_diff == 0.0, f"{fam}: the resumed run ends "
                  f"{resume_diff} away from the straight run")
            t0 = time.perf_counter()
            cpu = train_cli(base + ["--steps", str(TRAIN_CPU_STEPS),
                                    "--device", "cpu",
                                    "--out", f"{out}-cpu.npz"])
            cpu_s = time.perf_counter() - t0
            rel = [abs(g - c) / abs(c) for g, c in
                   zip(losses[:TRAIN_CPU_STEPS], cpu.losses)]
            check(len(cpu.losses) == TRAIN_CPU_STEPS
                  and max(rel) <= TRAIN_LOSS_RTOL,
                  f"{fam}: card losses off the CPU's by {max(rel):.2e}")
            ms, peak = train_step_ms(
                base + ["--steps", "1", "--out", f"{out}-x.npz"], dev)
            served = serve_trained(
                dev, fam, f"{out}-straight.npz",
                temporal_frames if fam == "temporal" else mixed)
            row["families"][fam] = {
                "loss_first": losses[0], "loss_last": losses[-1],
                "loss_rel_vs_cpu": max(rel),
                "loss_at_cpu_steps": [losses[TRAIN_CPU_STEPS - 1],
                                      cpu.losses[-1]],
                "resume_max_abs_diff": resume_diff,
                "ms_per_step": ms, "peak_mib": peak,
                "straight_run_s": card_s, "cpu_run_s": cpu_s,
                "served": served}
        for fam in ("moe", "deep"):  # the trained params in the binary
            row[f"aggregator_cmd_{fam}"] = main_aggregator_cmd(
                fam, os.path.join(root, f"{fam}-straight.npz"))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "kepler_tpu_torch.cmd.train", "--data",
             single_dir, "--model", "mlp", "--steps", str(TRAIN_STEPS),
             "--out", os.path.join(root, "binary.npz")],
            cwd=here, env=dict(os.environ, PYTHONPATH=here),
            capture_output=True, text=True, timeout=600, check=False)
        check(proc.returncode == 0
              and os.path.exists(os.path.join(root, "binary.npz"))
              and f"for {TRAIN_STEPS} steps" in proc.stderr,
              f"the training binary exited {proc.returncode}: "
              f"{proc.stderr[-800:]}")
        row["binary"] = {"exit": proc.returncode,
                         "seconds": time.perf_counter() - t0,
                         "device_line": [ln for ln in
                                         proc.stderr.splitlines()
                                         if "loaded" in ln][:1]}
        torch.cuda.synchronize()
        launches = read_launches()
    want_b1 = TRAIN_DUMP_WINDOWS + TRAIN_TEMPORAL_WINDOWS + 2 * len(FAMILIES)
    # (the binaries' windows run in their own processes: not counted here)
    check(launches["outer_product_attribution"] == want_b1,
          f"B1 launched {launches['outer_product_attribution']} times in "
          f"the dump and serving windows, not {want_b1}")
    check(launches["flash_block"] == 0 and launches["fused_window_step"] == 0,
          "training or its windows launched B2 or B3")
    row["launches"] = launches
    emit(row)
    return row


# -- the node agent (paths 6-8) -----------------------------------------------

NODE_PROCS = 10_000
NODE_TICKS = 11  # refreshes: one that seeds the counters, then ten windows
NODE_BURST, NODE_BURST_TICK = 2_000, 3
NODE_KILL, NODE_KILL_TICK = 1_000, 6
NODE_MAX_TERMINATED = 500
# (site, skip, arg): each site is checked once per zone and tick, and
# counter_wrap only on a zone whose read survived — a read error on tick
# 4's first zone (16 checks before it), a wrap to 0 on tick 8's second
# (31 checks in ticks 0-7, one more on tick 8's first zone)
NODE_FAULTS = (("device.read_error", 16, None),
               ("device.counter_wrap", 32, 0.0))
FLEET_HOSTS, FLEET_PROCS, FLEET_INTERVALS = 64, 100, 8
# the fake hosts' powercap zones (directory, name): the four RAPL zones
# the fleet phases use
RAPL_ZONES = (("intel-rapl:0", "package-0"), ("intel-rapl:0:0", "core"),
              ("intel-rapl:0:1", "uncore"), ("intel-rapl:0:2", "dram"))
RUNTIME_CGROUPS = (
    "0::/system.slice/docker-{cid}.scope\n",
    "0::/kubepods.slice/kubepods-burstable.slice/"
    "kubepods-burstable-pod{pod}.slice/cri-containerd-{cid}.scope\n",
)


def write_stat_line(d: str, pid: int, comm: str, utime: int,
                    stime: int) -> None:
    head = f"{pid} ({comm}) S 1 1 1 0 -1 4194560 100 0 0 0"
    tail = (f"{utime} {stime} 0 0 20 0 1 0 100 0 0 "
            + " ".join(["0"] * 29))
    with open(os.path.join(d, "stat"), "w") as f:
        f.write(head + " " + tail)


def write_proc_stat(proc: str, tick: int) -> None:
    base = 1_000_000 + tick * 5_000
    idle = 4_000_000 + tick * 2_000
    with open(os.path.join(proc, "stat"), "w") as f:
        f.write(f"cpu  {base} {base // 10} {base // 2} {idle} "
                f"{idle // 8} 0 0 0 0 0\n")


def write_proc(proc: str, pid: int, cgroup: str, comm: str, utime: int,
               environ: bytes = b"") -> None:
    d = os.path.join(proc, str(pid))
    os.makedirs(d)
    write_stat_line(d, pid, comm, utime, utime // 3)
    for name, data in (("cgroup", cgroup.encode()),
                       ("comm", f"{comm}\n".encode()),
                       ("cmdline", f"/bin/{comm}".encode() + b"\0"),
                       ("environ", environ)):
        with open(os.path.join(d, name), "wb") as f:
            f.write(data)


def build_fake_host(root: str, n_procs: int, pct_container: float = 0.5,
                    seed: int = 0) -> tuple[str, str, list[int]]:
    """A fake /proc and powercap /sys tree (the benchmark's node host):
    ``n_procs`` processes, a ``pct_container`` share of them in docker or
    kubepods cgroups (pods 0-996), the four RAPL zones.
    → (proc dir, sysfs dir, pids)."""
    rng = np.random.default_rng(seed)
    proc = os.path.join(root, "proc")
    sysfs = os.path.join(root, "sys")
    os.makedirs(proc)
    pids = list(range(100, 100 + n_procs))
    for i, pid in enumerate(pids):
        utime = int(rng.integers(100, 100000))
        if rng.random() < pct_container:
            cgroup = RUNTIME_CGROUPS[i % 2].format(
                cid=f"{pid:064x}"[-64:], pod=f"pod{pid % 997}")
        else:
            cgroup = "0::/system.slice/ssh.service\n"
        write_proc(proc, pid, cgroup, f"proc-{pid}", utime)
    write_proc_stat(proc, tick=0)
    for dirname, name in RAPL_ZONES:
        zd = os.path.join(sysfs, "class", "powercap", dirname)
        os.makedirs(zd)
        for fname, val in (("name", name), ("energy_uj", 10_000_000),
                           ("max_energy_range_uj", 2**40)):
            with open(os.path.join(zd, fname), "w") as f:
                f.write(f"{val}\n")
    return proc, sysfs, pids


def advance_host(proc: str, sysfs: str, pids: list[int], tick: int,
                 churn_frac: float = 0.1) -> None:
    """One interval: a rotating ``churn_frac`` slice of ``pids`` burns CPU,
    /proc/stat advances, the RAPL counters accrete."""
    n = len(pids)
    span = max(1, int(n * churn_frac))
    lo = (tick * span) % n
    for pid in (pids + pids)[lo:lo + span]:
        utime = 100_000 + tick * 150 + pid % 97
        write_stat_line(os.path.join(proc, str(pid)), pid, f"proc-{pid}",
                        utime, utime // 3)
    write_proc_stat(proc, tick)
    for i, (dirname, _) in enumerate(RAPL_ZONES):
        path = os.path.join(sysfs, "class", "powercap", dirname,
                            "energy_uj")
        with open(path, "w") as f:
            f.write(f"{10_000_000 + tick * (40_000_000 + i * 7_000_000)}\n")


def spawn_burst(proc: str, start_pid: int, n: int) -> list[int]:
    """A mass pod reschedule: ``n`` new containerized processes appear in
    one tick → their pids."""
    rng = np.random.default_rng(start_pid)
    new = list(range(start_pid, start_pid + n))
    for i, pid in enumerate(new):
        cgroup = RUNTIME_CGROUPS[i % 2].format(cid=f"{pid:064x}"[-64:],
                                               pod=f"pod{pid % 997}")
        write_proc(proc, pid, cgroup, f"burst-{pid}",
                   int(rng.integers(100, 100000)),
                   environ=b"CONTAINER_NAME=burst\0")
    return new


def kill_procs(proc: str, pids: list[int]) -> None:
    import shutil

    for pid in pids:
        shutil.rmtree(os.path.join(proc, str(pid)))


class FakeClock:
    """The monitors' wall and monotonic clock; the schedule moves it 5 s
    per interval, so dt (and every watt) is the same in every run."""

    def __init__(self, t: float = 1e9) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t


def node_host(root: str, device, n_procs: int, seed: int, clock, **kw):
    """A fake host and the port's node stack over it: the native /proc
    reader, ``RaplPowerMeter`` and ``PowerMonitor(device=device)`` (every
    refresh a new window, on ``clock``) behind a ``PowerCollector``.
    → (monitor, collector, reader, proc, sysfs, pids)."""
    from kepler_tpu_torch.device import RaplPowerMeter
    from kepler_tpu_torch.exporter.prometheus import PowerCollector
    from kepler_tpu_torch.monitor import PowerMonitor
    from kepler_tpu_torch.resource import ResourceInformer, make_proc_reader

    proc, sysfs, pids = build_fake_host(root, n_procs, seed=seed)
    reader = make_proc_reader(proc, use_native=True)
    monitor = PowerMonitor(
        RaplPowerMeter(sysfs_path=sysfs),
        ResourceInformer(reader=reader, procfs_path=proc, clock=clock),
        interval=0, staleness=0.0, clock=clock, device=device, **kw)
    monitor.init()
    collector = PowerCollector(monitor, node_name="smoke-node")
    return monitor, collector, reader, proc, sysfs, pids


def exposition_series(text: bytes) -> dict[str, set]:
    """family → the label sets of its samples in a classic-text render."""
    out: dict[str, set] = {}
    for line in text.decode().splitlines():
        if not line or line.startswith("#"):
            continue
        series = line.rsplit(" ", 1)[0]
        name, _, labels = series.partition("{")
        out.setdefault(name, set()).add(labels)
    return out


def node_state(snap) -> dict:
    """A snapshot's arrays, ids, meta and terminated tables, as numpy."""
    kinds = ("processes", "containers", "virtual_machines", "pods")
    out = {f"node.{k}": np.array(getattr(snap.node, k))
           for k in ("energy_uj", "active_uj", "idle_uj", "power_uw",
                     "active_power_uw", "idle_power_uw")}
    for kind in kinds:
        for tag in ("", "terminated_"):
            table = getattr(snap, tag + kind)
            out[f"{tag}{kind}.ids"] = table.ids
            out[f"{tag}{kind}.meta"] = [dict(m) for m in table.meta]
            out[f"{tag}{kind}.energy_uj"] = np.array(table.energy_uj)
            out[f"{tag}{kind}.power_uw"] = np.array(table.power_uw)
    return out


def node_schedule(device, root: str, on_card: bool) -> dict:
    """The node phase's schedule on one fresh tree: a refresh that seeds
    the counters, then ``NODE_TICKS - 1`` scrapes (each a refresh, as
    ``staleness=0`` makes it, then the render) with 10 % CPU
    churn, a burst of ``NODE_BURST`` processes, ``NODE_KILL``
    terminations and the fault plan. → per-tick states, renders and
    host timings (and, on the card, the launches and device time of
    the attribution leg)."""
    from kepler_tpu_torch import fault, telemetry
    from kepler_tpu_torch.native import lib_path
    from kepler_tpu_torch.resource import FastProcFSReader
    from kepler_tpu_torch.telemetry.spans import SpanRecorder

    t0 = time.perf_counter()
    clock = FakeClock()
    monitor, collector, reader, proc, sysfs, pids = node_host(
        root, device, NODE_PROCS, SEED + 6, clock,
        max_terminated=NODE_MAX_TERMINATED, min_terminated_energy_uj=0.0)
    build_s = time.perf_counter() - t0
    check(isinstance(reader, FastProcFSReader),
          f"the node ran the {type(reader).__name__}, not the native reader")
    attribute_ms: list[float] = []
    leg = monitor._attribute

    def timed_leg(*args):
        t = time.perf_counter()
        try:
            return leg(*args)
        finally:
            attribute_ms.append((time.perf_counter() - t) * 1e3)

    monitor._attribute = timed_leg
    specs = [fault.FaultSpec(site=s, skip=skip, count=1, arg=arg)
             for s, skip, arg in NODE_FAULTS]
    live = list(pids)
    states, series, scrape_ms, render_ms, burst_ms = [], [], [], [], None
    conservation = 0.0
    killed: list[str] = []
    prof = None
    with fault.installed(fault.FaultPlan(specs)) as plan, \
            telemetry.installed(SpanRecorder()) as rec:
        for tick in range(NODE_TICKS):
            clock.t += 5.0
            if tick == NODE_BURST_TICK:
                live += spawn_burst(proc, 10_000_000, NODE_BURST)
            if tick == NODE_KILL_TICK:
                gone = live[:NODE_KILL]
                kill_procs(proc, gone)
                live = live[NODE_KILL:]
                killed = [str(p) for p in gone]
            advance_host(proc, sysfs, live, tick)
            if tick == 0:  # seeds the counters; the collector is ready
                monitor.refresh()
                states.append(node_state(monitor._snapshot))
                continue
            if on_card and tick == NODE_TICKS - 1:
                # the last scrape under the profiler (untimed): its device
                # work is the attribution leg's copies and kernels
                held: list[bytes] = []
                prof = profile_top(lambda: held.append(
                    collector.render_text()))
                out = held[0]
            else:
                t = time.perf_counter()
                out = collector.render_text()  # refresh + render
                scrape_ms.append((time.perf_counter() - t) * 1e3)
                if tick == NODE_BURST_TICK:
                    burst_ms = scrape_ms[-1]
            monitor._staleness = 1e9  # render alone, no refresh
            t = time.perf_counter()
            collector.render_text()
            render_ms.append((time.perf_counter() - t) * 1e3)
            monitor._staleness = 0.0
            snap = monitor._snapshot
            states.append(node_state(snap))
            series.append(exposition_series(out))
            # Σ process power == node active power (the attribution
            # denominator is Σ process Δcpu)
            got = snap.processes.power_uw.sum(axis=0)
            want = snap.node.active_power_uw
            rel = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
            conservation = max(conservation, float(rel.max()))
        fired = {s: plan.fired(s) for s, _, _ in NODE_FAULTS}
        refresh_ms = [ev.duration_s * 1e3 for tr in rec.recent_traces()
                      for ev in tr.events if ev.name == "monitor.refresh"]
    # the first refresh classifies every process; on the card the last
    # one ran under the profiler
    first_refresh_ms = refresh_ms[0]
    refresh_ms = refresh_ms[1:-1] if on_card else refresh_ms[1:]
    check(all(n == 1 for n in fired.values()), f"faults fired {fired}")
    check(conservation <= 1e-5,
          f"Σ process power off node active power by {conservation:.2e}")
    term = states[NODE_KILL_TICK]["terminated_processes.ids"]
    check(len(term) == NODE_MAX_TERMINATED and set(term) <= set(killed),
          f"{len(term)} terminated processes tracked after {NODE_KILL} "
          f"ended (top-k of {NODE_MAX_TERMINATED})")
    check(len(states[-1]["processes.ids"]) == NODE_PROCS + NODE_BURST
          - NODE_KILL, "the process table lost rows")
    return {"states": states, "series": series, "scrape_ms": scrape_ms,
            "render_ms": render_ms, "refresh_ms": refresh_ms,
            "first_refresh_ms": first_refresh_ms,
            "burst_ms": burst_ms, "attribute_ms": attribute_ms,
            "profile": prof, "build_s": build_s,
            "reader": type(reader).__name__, "library": lib_path(),
            "zones": list(monitor.zone_names()),
            "conservation_rel": conservation, "fired": fired,
            "pods": len(states[-1]["pods.ids"]),
            "containers": len(states[-1]["containers.ids"])}


def same_state(got: dict, ref: dict, what: str) -> None:
    """Every array of ``node_state`` bit-equal, every id and label equal."""
    for key, want in ref.items():
        have = got[key]
        if isinstance(want, np.ndarray):
            equal = have.shape == want.shape and np.array_equal(have, want)
            check(equal, f"{what}: {key} differs from the CPU run "
                  f"({have.shape} vs {want.shape})")
        else:
            check(have == want, f"{what}: {key} differs from the CPU run")


def pct(vals: list[float], q: float) -> float:
    vals = sorted(vals)
    return vals[min(len(vals) - 1, max(0, int(np.ceil(q * len(vals))) - 1))]


def main_node_agent(dev: torch.device) -> dict:
    """Path 6: one node at full width on the card. A fake host of 10,000
    processes (half in docker/kubepods cgroups) with four RAPL zones; the
    native /proc reader, ``RaplPowerMeter`` and ``PowerMonitor(device=
    "cuda", interval=0, staleness=0)`` behind a ``PowerCollector``; 11
    scrapes with 10 % churn, a burst of 2,000 processes, 1,000
    terminations past ``max_terminated=500`` and a read error and a
    counter wrap from a fault plan. The same schedule on a second tree
    through ``device="cpu"`` is the reference: every tick's node and
    workload arrays bit-equal, ids, meta and terminated tables equal,
    and the same exposition families and label sets."""
    import shutil
    import tempfile

    base = "/dev/shm" if os.path.isdir("/dev/shm") else None
    root = tempfile.mkdtemp(prefix="kt-node-", dir=base)
    try:
        card = node_schedule(dev, os.path.join(root, "card"), True)
        cpu = node_schedule("cpu", os.path.join(root, "cpu"), False)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for t, (got, ref) in enumerate(zip(card["states"], cpu["states"])):
        same_state(got, ref, f"node tick {t}")
    for t, (got, ref) in enumerate(zip(card["series"], cpu["series"])):
        check(got == ref, f"node tick {t}: the exposition's families or "
              "label sets differ from the CPU run")
    fams = card["series"][-1]
    check(any(f.startswith("kepler_node_cpu_") for f in fams)
          and any(f.startswith("kepler_process_cpu_") for f in fams),
          "the render lacks kepler_node_cpu_* or kepler_process_cpu_*")
    prof = card["profile"]
    row = {"phase": "main_node_agent", "processes": NODE_PROCS,
           "ticks": NODE_TICKS, "zones": card["zones"],
           "reader": card["reader"],
           "native_library": os.path.basename(card["library"]),
           "containers": card["containers"], "pods": card["pods"],
           "tree_build_s": card["build_s"],
           "first_refresh_ms": card["first_refresh_ms"],
           "refresh_ms_p50": pct(card["refresh_ms"], 0.5),
           "refresh_ms_p99": pct(card["refresh_ms"], 0.99),
           "render_ms_p50": pct(card["render_ms"], 0.5),
           "scrape_to_export_ms_p50": pct(card["scrape_ms"], 0.5),
           "scrape_to_export_ms_p99": pct(card["scrape_ms"], 0.99),
           "burst_new_procs": NODE_BURST,
           "burst_refresh_ms": card["burst_ms"],
           "attribute_leg_host_ms_p50": pct(card["attribute_ms"], 0.5),
           "attribute_leg_host_ms": card["attribute_ms"],
           "attribute_leg_device_ms": prof["device_ms"],
           "profile_top": prof["top"],
           "cpu_run": {k: pct(cpu[k], 0.5) for k in
                       ("refresh_ms", "render_ms", "scrape_ms",
                        "attribute_ms")},
           "conservation_rel": card["conservation_rel"],
           "faults_fired": card["fired"],
           "bit_equal_ticks": len(card["states"])}
    emit(row)
    return row


def fleet_run(device, root: str, on_card: bool) -> dict:
    """64 node stacks (``node_host``, 100 processes each) on ``device``,
    each with a real ``FleetAgent`` (wire v2: a keyframe, then deltas)
    posting over HTTP to the port's ``Aggregator(device=device,
    backend="pallas", fused_window_k=4)`` behind a live ``APIServer``; 8
    intervals with 10 % CPU churn, 3 hosts losing and 2 gaining processes
    per interval. The agents drain synchronously after each refresh (the
    send path of their thread, without the thread); ``aggregate_once()``
    then runs. → the published windows, each node's monitor snapshot per
    interval, /v1/results after each flush (window index → node → payload),
    the legs."""
    from kepler_tpu_torch.fleet import FleetAgent

    agg, server, ticks, published = make_aggregator(
        device, backend="pallas", model_mode=None, fused_window_k=FUSED_K)
    def clock() -> float:  # one clock for the hosts and the service
        return ticks[0]

    hosts = []
    for h in range(FLEET_HOSTS):
        monitor, _, _, proc, sysfs, pids = node_host(
            os.path.join(root, f"node-{h:02d}"), device, FLEET_PROCS,
            SEED + 100 + h, clock)
        advance_host(proc, sysfs, pids, 0)
        monitor.refresh()  # seeds the counters; no agent listens yet
        hosts.append({"name": f"node-{h:02d}", "monitor": monitor,
                      "proc": proc, "sysfs": sysfs, "pids": list(pids)})
    snaps, results, legs, drain_s = [], {}, [], []
    with serving(server) as base:
        endpoint = base.removeprefix("http://")
        for host in hosts:
            agent = FleetAgent(host["monitor"], endpoint=endpoint,
                               node_name=host["name"], clock=clock,
                               jitter_seed=0)
            agent.init()
            host["agent"] = agent
        if on_card:
            reset_launches()
        for t in range(1, FLEET_INTERVALS + 1):
            ticks[0] += 5.0
            for h, host in enumerate(hosts):
                if (h - 3 * t) % FLEET_HOSTS < 3:  # loses 2 processes
                    kill_procs(host["proc"], host["pids"][:2])
                    host["pids"] = host["pids"][2:]
                if (h - 5 * t) % FLEET_HOSTS < 2:  # gains 2 processes
                    host["pids"] += spawn_burst(host["proc"],
                                                200_000 + 10 * t, 2)
                advance_host(host["proc"], host["sysfs"], host["pids"], t)
            t0 = time.perf_counter()
            for host in hosts:
                host["monitor"].refresh()
                host["agent"]._drain(None)
            drain_s.append(time.perf_counter() - t0)
            agg.aggregate_once()
            legs.append({k: agg._stats[k] for k in LEG_KEYS})
            snaps.append({host["name"]: host["monitor"]._snapshot
                          for host in hosts})
            if t % FUSED_K == 0:  # a flush published K windows
                results[t - 1] = {host["name"]: json.loads(http(
                    base, f"/v1/results?node={host['name']}"))
                    for host in hosts}
        sync()
        launches = read_launches() if on_card else None
        for host in hosts:
            check(host["agent"]._stats["send_failures"] == 0,
                  f"{host['name']}: agent send failures "
                  f"{host['agent']._stats}")
        sent = {k: sum(h["agent"]._stats[k] for h in hosts)
                for k in ("keyframes_sent", "deltas_sent")}
    return {"agg": agg, "published": published, "snaps": snaps,
            "results": results, "legs": legs, "drain_s": drain_s,
            "launches": launches, "sent": sent}


def main_node_fleet(dev: torch.device) -> dict:
    """Path 7: 64 node agents into the Aggregator on the card. Every
    window holds all 64 nodes on the fused tier (B2 once per flush of
    K = 4, which publishes its K windows); each node's results payload
    in every window (fetched over ``/v1/results`` for the newest window
    of each flush) is within 1 f16 ulp of its own monitor's snapshot
    power for the window; Σ process watts equals
    node active watts; every window equals the same schedule through
    ``device="cpu"``."""
    import shutil
    import tempfile

    from kepler_tpu_torch.parallel.fleet import MODE_RATIO

    base = "/dev/shm" if os.path.isdir("/dev/shm") else None
    root = tempfile.mkdtemp(prefix="kt-fleet-", dir=base)
    try:
        t0 = time.perf_counter()
        card = fleet_run(dev, os.path.join(root, "card"), True)
        wall_s = time.perf_counter() - t0
        cpu = fleet_run("cpu", os.path.join(root, "cpu"), False)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    agg, published = card["agg"], card["published"]
    launches = card["launches"]
    check(launches["fused_window_step"] == FLEET_INTERVALS // FUSED_K,
          f"B2 launched {launches['fused_window_step']} times in "
          f"{FLEET_INTERVALS} intervals")
    check(launches["outer_product_attribution"] == 0
          and launches["flash_block"] == 0, "the fleet ran B1 or B3")
    health = agg.window_health()
    check(health["rung_name"] == "packed-fused-scan"
          and agg._stats["window_demotions_total"] == 0,
          f"the ladder moved: {health}")
    check(len(published) == FLEET_INTERVALS == len(cpu["published"]),
          "not every interval published")
    worst_ulps, worst_cons, rows = 0, 0.0, 0
    for t, (got, ref) in enumerate(zip(published, cpu["published"])):
        check(len(got.names) == FLEET_HOSTS,
              f"window {t} holds {len(got.names)} nodes")
        same_window(got, ref, f"fleet window {t}")
        served = card["results"].get(t, {})
        for name in got.names:
            # the payload /v1/results serves for this window; the latest
            # window of each flush was also fetched over HTTP
            res = json.loads(json.dumps(got.render_node(name)))
            check(served.get(name, res) == res,
                  f"/v1/results?node={name} differs from window {t}")
            snap = card["snaps"][t][name]
            zi = [list(snap.node.zone_names).index(z) for z in res["zones"]]
            mine = {}
            for kind in ("processes", "containers", "virtual_machines",
                         "pods"):
                table = getattr(snap, kind)
                for wid, p in zip(table.ids, table.power_uw):
                    mine[wid] = p[zi]
            check(len(mine) == len(res["workloads"]),
                  f"window {t}: {name} row count differs from its monitor")
            got_w = np.asarray([w["power_uw"] for w in res["workloads"]])
            want_w = np.asarray([mine[w["id"]] for w in res["workloads"]])
            ulps = f16_ulps(got_w * 1e-6, want_w * 1e-6)
            worst_ulps = max(worst_ulps, int(ulps.max()))
            rows += len(got_w)
            # conservation: Σ process watts == node active watts
            check(res["mode"] == MODE_RATIO, f"{name} is not a ratio node")
            procs = np.asarray([w["kind"] == 0 for w in res["workloads"]])
            active = snap.node.active_power_uw[zi] * 1e-6
            total = got_w[procs].sum(axis=0) * 1e-6
            rel = np.abs(total - active) / np.maximum(active, 1e-3)
            worst_cons = max(worst_cons, float(rel.max()))
    check(worst_ulps <= 1, f"/v1/results watts {worst_ulps} f16 ulps off "
          "the agents' own monitors")
    check(worst_cons <= 2e-3, f"conservation off by {worst_cons:.2e}")
    row = {"phase": "main_node_fleet", "nodes": FLEET_HOSTS,
           "processes_per_node": FLEET_PROCS, "intervals": FLEET_INTERVALS,
           "k": FUSED_K, "launches": launches, "rung": health["rung_name"],
           "wire_frames": card["sent"],
           "results_fetched": sum(len(r) for r in card["results"].values()),
           "workload_rows_checked": rows,
           "max_f16_ulps_vs_monitor": worst_ulps,
           "max_conservation_rel": worst_cons, "run_s": wall_s,
           "agents_refresh_and_send_s": card["drain_s"],
           "legs_ms_per_interval": card["legs"]}
    emit(row)
    return row


def wait_http(proc, base: str, path: str, deadline_s: float,
              what: str) -> bytes:
    """GET ``path`` until it answers (the process must stay alive)."""
    deadline = time.perf_counter() + deadline_s
    while True:
        check(proc.poll() is None, f"the {what} exited")
        try:
            return http(base, path)
        except OSError:
            check(time.perf_counter() < deadline, f"{what}: {path} never "
                  "answered")
            time.sleep(0.1)


def stop_all(procs: list) -> list[str]:
    """SIGTERM every process, then wait for each (killed after 60 s)
    → their outputs."""
    import signal

    for proc in procs:
        proc.send_signal(signal.SIGTERM)
    outs = []
    for proc in procs:
        try:
            out, _ = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
        outs.append(out)
    return outs


def main_node_cmd() -> dict:
    """Path 8: the two binaries together on the card. ``python -m
    kepler_tpu_torch.cmd.aggregator`` (interval 2 s), then ``python -m
    kepler_tpu_torch.cmd.main`` (default ``--device cuda``, the fake CPU
    meter over this machine's real /proc, interval 2 s, reporting to the
    aggregator): ``/metrics`` has node and process families, ``/healthz``
    is ok, the aggregator's ``/v1/results`` returns the node within two
    intervals, and SIGTERM stops both cleanly."""
    import socket
    import tempfile

    ports = []
    for _ in range(2):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            ports.append(sock.getsockname()[1])
    agg_port, node_port = ports
    interval = 2.0
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    tmp = tempfile.mkdtemp(prefix="kt-cmd-")
    agg_cfg = os.path.join(tmp, "aggregator.yaml")
    node_cfg = os.path.join(tmp, "node.yaml")
    # the interval of the aggregator and the fake meter have no flags
    with open(agg_cfg, "w") as f:
        f.write(f"aggregator:\n  interval: {interval:g}s\n")
    with open(node_cfg, "w") as f:
        f.write("dev:\n  fake-cpu-meter:\n    enabled: true\n")
    popen = dict(cwd=here, env=env, stdout=subprocess.PIPE,
                 stderr=subprocess.STDOUT, text=True)
    agg = subprocess.Popen(
        [sys.executable, "-m", "kepler_tpu_torch.cmd.aggregator",
         "--config.file", agg_cfg, "--tpu.fleet-backend", "pallas",
         "--aggregator.model", "", "--aggregator.pipeline-depth", "1",
         "--no-exporter.prometheus",
         "--aggregator.listen-address", f"127.0.0.1:{agg_port}"], **popen)
    node = None
    agg_base = f"http://127.0.0.1:{agg_port}"
    node_base = f"http://127.0.0.1:{node_port}"
    try:
        wait_http(agg, agg_base, "/readyz", 120, "aggregator binary")
        t0 = time.perf_counter()
        node = subprocess.Popen(
            [sys.executable, "-m", "kepler_tpu_torch.cmd.main",
             "--config.file", node_cfg, "--monitor.interval",
             f"{interval:g}s", "--web.listen-address",
             f"127.0.0.1:{node_port}", "--kube.node-name", "smoke-node",
             "--aggregator.endpoint", f"127.0.0.1:{agg_port}"], **popen)
        wait_http(node, node_base, "/readyz", 120, "node binary")
        ready_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        res = json.loads(wait_http(agg, agg_base,
                                   "/v1/results?node=smoke-node", 30,
                                   "aggregator binary"))
        results_s = time.perf_counter() - t1
        # two intervals, and the poll's own 0.1 s step
        check(results_s <= 2 * interval + 0.2,
              f"the node reached /v1/results after {results_s:.2f} s")
        check(len(res["workloads"]) > 0 and np.isfinite(np.asarray(
            [w["power_uw"] for w in res["workloads"]])).all(),
            "the node's results hold no finite workload watts")
        fams = exposition_series(http(node_base, "/metrics"))
        check(any(f.startswith("kepler_node_cpu_") for f in fams)
              and any(f.startswith("kepler_process_cpu_") for f in fams),
              f"node /metrics families: {sorted(fams)[:12]}")
        health = json.loads(http(node_base, "/healthz"))
        check(health.get("status") == "ok", f"node /healthz: {health}")
    finally:
        import shutil

        procs = [p for p in (node, agg) if p is not None]
        outs = dict(zip(procs, stop_all(procs)))
        shutil.rmtree(tmp, ignore_errors=True)
    for proc, what in ((node, "node binary"), (agg, "aggregator binary")):
        check(proc.returncode == 0
              and "Graceful shutdown completed" in outs[proc],
              f"{what} exit {proc.returncode}: {outs[proc][-800:]}")
    node_out = outs[node]
    row = {"phase": "main_node_cmd", "node_ready_s": ready_s,
           "results_after_ready_s": results_s,
           "result_workloads": len(res["workloads"]),
           "node_families": sorted(f for f in fams
                                   if f.startswith("kepler_"))[:40],
           "healthz": health.get("status"),
           "device_line": [ln for ln in node_out.splitlines()
                           if "kepler-tpu" in ln and " on " in ln][:1]}
    emit(row)
    return row


# -- kepchaos on the card --------------------------------------------------

CHAOS_SEED, CHAOS_SCHEDULES = 1, 25  # CHAOS_r01.json's sweep
# -- the sharded and multi-host fleet window --------------------------------------

SHARDS = 8  # virtual shards of the one card (128 rows each at N = 1024)
MH_HOSTS = 2  # virtual hosts of the multi-host phase, 4 shards each
MH_PEERS = ["127.0.0.1:28291", "127.0.0.1:28292"]


def sharded_phases() -> list[tuple[str, str | None, list]]:
    """(label, model mode, windows): the ratio fleet's 8 intervals of
    churn, then the 50/50 ratio/MLP fleet's 4 windows."""
    return [("ratio", None, ratio_schedule()),
            ("mlp", "mlp", mixed_windows())]


def run_windows(eng, windows: list, params, per_window: list | None = None
                ) -> list:
    """plan → launch → fetch per window → [(plane, meta)]. ``per_window``
    collects each window's host legs (ms), per-shard H2D rows and B1
    launches."""
    from kepler_tpu_torch.fleet.window import fetch_plane
    from kepler_tpu_torch.ops import cuda_attribution as ca

    out = []
    for rows in windows:
        b1 = ca.LAUNCHES["outer_product_attribution"]
        t0 = time.perf_counter()
        plan = eng.plan_window(rows, ZONES, params)
        t1 = time.perf_counter()
        launched = eng.dispatch_window(plan)
        t2 = time.perf_counter()
        plane = fetch_plane(launched)
        t3 = time.perf_counter()
        out.append((plane, plan.meta))
        if per_window is not None:
            per_window.append({
                "plan_ms": (t1 - t0) * 1e3, "launch_ms": (t2 - t1) * 1e3,
                "fetch_ms": (t3 - t2) * 1e3,
                "h2d_shards": list(plan.h2d_shards),
                "b1": ca.LAUNCHES["outer_product_attribution"] - b1})
    return out


def same_rows(got: tuple, ref: tuple, what: str) -> float:
    """Node by node (by name), ``got``'s plane rows against ``ref``'s:
    ratio rows bit-equal, model rows within rtol 1e-3 (atol 1e-3 W). →
    the worst relative difference of a model row."""
    from kepler_tpu_torch.parallel.fleet import MODE_MODEL

    (plane, meta), (ref_plane, ref_meta) = got, ref
    check(np.isfinite(plane).all(), f"{what}: non-finite watts")
    names = sorted(meta.rows)
    i = np.asarray([meta.rows[n] for n in names])
    j = np.asarray([ref_meta.rows[n] for n in names])
    a, b = plane[i], ref_plane[j]
    model = meta.mode[i] == MODE_MODEL
    check(np.array_equal(model, ref_meta.mode[j] == MODE_MODEL),
          f"{what}: row modes differ")
    check(np.array_equal(a[~model].view(np.int16), b[~model].view(np.int16)),
          f"{what}: ratio rows not bit-equal")
    if not model.any():
        return 0.0
    x, y = a[model].astype(np.float32), b[model].astype(np.float32)
    check(np.allclose(x, y, rtol=1e-3, atol=1e-3),
          f"{what}: model rows off by more than 1e-3")
    return float((np.abs(x - y) / np.maximum(np.abs(y), 1e-3)).max())


def main_sharded(dev: torch.device, phases: list) -> tuple[dict, dict]:
    """The sharded fleet window: ``ShardedWindowEngine`` over a mesh of 8
    virtual shards of the card (128 rows a shard at N = 1024), the ratio
    fleet's 8 intervals then the 50/50 ratio/MLP fleet's 4 windows, with
    einsum and with pallas — B1 once per shard per pallas window. Every
    node's rows are held against the single-device ``PackedWindowEngine``
    on the card, and the pallas planes against the einsum planes.
    ``phases``: :func:`sharded_phases`. → (row, the einsum planes per
    phase label)."""
    from kepler_tpu_torch.fleet.window import (PackedWindowEngine,
                                               ShardedWindowEngine,
                                               fetch_plane)
    from kepler_tpu_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    params = mlp_params(SEED)
    mesh = make_mesh([SHARDS], devices=[dev] * SHARDS)
    check(mesh.devices == (dev,) * SHARDS, f"mesh off the card: {mesh}")
    single = {label: run_windows(PackedWindowEngine(device=dev,
                                                    model_mode=mode),
                                 wins, params if mode else None)
              for label, mode, wins in phases}

    reset_launches()
    out: dict = {}
    legs: dict = {}
    engines: dict = {}
    for backend in ("einsum", "pallas"):
        for label, mode, wins in phases:
            eng = ShardedWindowEngine(mesh, backend=backend,
                                      model_mode=mode)
            per: list = []
            out[backend, label] = run_windows(eng, wins,
                                              params if mode else None, per)
            legs[f"{backend}_{label}"] = per
            engines[backend, label] = eng
    torch.cuda.synchronize()
    launches = read_launches()

    worst_model = 0.0
    for (backend, label), res in out.items():
        for t, got in enumerate(res):
            what = f"sharded {backend} {label} window {t}"
            worst_model = max(worst_model,
                              same_rows(got, single[label][t], what))
            if backend == "pallas":
                ref = out["einsum", label][t]
                same_rows(got, ref, what + " vs einsum")
                if label == "ratio":
                    check(np.array_equal(got[0].view(np.int16),
                                         ref[0].view(np.int16)),
                          f"{what}: plane differs from einsum")
            b1 = legs[f"{backend}_{label}"][t]["b1"]
            want = SHARDS if backend == "pallas" else 0
            check(b1 == want, f"{what}: B1 launched {b1} times, not {want}")
    n_pallas = sum(len(w) for _, _, w in phases)
    check(launches["outer_product_attribution"] == SHARDS * n_pallas,
          f"B1 launched {launches['outer_product_attribution']} times")
    check(launches["fused_window_step"] == 0, "the sharded path ran B2")

    # one window's launches, steady state: each phase's last window
    # planned on a warm engine, its launches repeated on the resident
    # buffers — 8 shards against the single-device engine. CUDA events
    # per call of back-to-back launches (``ms``, host-bound at these
    # sizes) and, for the ratio windows, the kernels' own device time
    ms_per_window, device_per_window = {}, {}
    for label, mode, wins in phases:
        for backend in ("einsum", "pallas"):
            for kind in ("sharded", "single"):
                eng = (engines[backend, label] if kind == "sharded" else
                       PackedWindowEngine(device=dev, backend=backend,
                                          model_mode=mode))
                plan = eng.plan_window(wins[-1], ZONES,
                                       params if mode else None)
                fetch_plane(eng.dispatch_window(plan))
                key = f"{kind}_{backend}_{label}"
                ms_per_window[key] = time_ms(
                    lambda: eng.dispatch_window(plan), reps=10, batch=5)
                if mode is None:
                    device_per_window[key] = device_ms(
                        lambda: eng.dispatch_window(plan))
    eng = engines["pallas", "ratio"]
    row = {"phase": "main_sharded", "nodes": N_NODES,
           "workloads": N_WORKLOADS, "zones": len(ZONES), "shards": SHARDS,
           "rows_per_shard": eng._ladder_n.bucket,
           "windows": {label: len(w) for label, _, w in phases},
           "launches": launches, "max_model_rel_vs_single": worst_model,
           "ms_per_window": ms_per_window,
           "device_ms_per_window": device_per_window,
           "legs": legs, "sticky": eng.introspect()["sticky"],
           "seconds": time.perf_counter() - t_phase}
    emit(row)
    return row, {label: out["einsum", label] for label, _, _ in phases}


def run_hosts(engines: list, rows_by_host: list, params) -> list:
    """One window on every virtual host, on one thread each (the fabric's
    barriers demand lockstep) → per host (plane, meta)."""
    from kepler_tpu_torch.fleet.window import fetch_plane

    out: list = [None] * len(engines)
    errs: list = [None] * len(engines)

    def run(p: int) -> None:
        try:
            plan = engines[p].plan_window(rows_by_host[p], ZONES, params)
            out[p] = (fetch_plane(engines[p].dispatch_window(plan)),
                      plan.meta)
        except BaseException as err:  # re-raised on the caller thread
            errs[p] = err

    threads = [threading.Thread(target=run, args=(p,), daemon=True)
               for p in range(len(engines))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    check(not any(t.is_alive() for t in threads), "a virtual host hung")
    for err in errs:
        if err is not None:
            raise err
    return out


def main_multihost_virtual(dev: torch.device, phases: list,
                           sharded: dict) -> dict:
    """The multi-host tier on the card: 2 virtual hosts × 4 virtual
    shards, each host a ``MultiHostWindowEngine`` on its own thread,
    agreeing buckets through a ``HostLocalFabric`` and launching only its
    own shards. The union of the hosts' published rows must equal
    ``main_sharded``'s einsum planes, node by node. Then two Aggregators
    on that topology (pallas): a window together, ``fabric.kill()``, and
    host 0's next window fails in the agreement, demotes to
    ``packed-sharded-mesh-minus-host`` (succession bumps the epoch) and
    still publishes from its local 4-shard engine. Last, one
    ``initialize_multihost`` on a one-rank gloo world. ``phases``:
    :func:`sharded_phases`; ``sharded``: ``main_sharded``'s planes."""
    import socket

    from kepler_tpu_torch.fleet.aggregator import (RUNG_NAME_MESH_DEGRADED,
                                                   RUNG_NAME_MULTIHOST,
                                                   Aggregator)
    from kepler_tpu_torch.fleet.ring import ring_from_mesh
    from kepler_tpu_torch.fleet.window import (HostLocalFabric,
                                               MultiHostWindowEngine,
                                               ShardedWindowEngine)
    from kepler_tpu_torch.parallel.mesh import (initialize_multihost,
                                                make_mesh)
    from kepler_tpu_torch.server.http import APIServer

    t_phase = time.perf_counter()
    per = SHARDS // MH_HOSTS
    mesh = make_mesh([SHARDS], devices=[dev] * SHARDS)
    ring = ring_from_mesh(MH_PEERS, [k // per for k in range(SHARDS)])
    params = mlp_params(SEED)
    owned_rows = [0] * MH_HOSTS
    worst_model = 0.0
    for label, mode, wins in phases:
        fabric = HostLocalFabric(MH_HOSTS, timeout=300)
        engines = [MultiHostWindowEngine(
            mesh, model_mode=mode, process_index=p,
            device_process=lambda k: k // per, fabric=fabric)
            for p in range(MH_HOSTS)]
        for t, rows in enumerate(wins):
            by_host = [[r for r in rows
                        if MH_PEERS.index(ring.owner(r.name)) == p]
                       for p in range(MH_HOSTS)]
            published = set()
            for p, got in enumerate(run_hosts(engines, by_host,
                                              params if mode else None)):
                check(sorted(got[1].rows) == sorted(r.name
                                                    for r in by_host[p]),
                      f"host {p} published another host's nodes")
                worst_model = max(worst_model, same_rows(
                    got, sharded[label][t], f"host {p} {label} window {t}"))
                published |= set(got[1].rows)
                owned_rows[p] = got[0].shape[0]
            check(published == {r.name for r in rows},
                  f"{label} window {t}: the union misses nodes")
    hosts_s = time.perf_counter() - t_phase

    # the mesh demotion through two Aggregators' window path
    t0 = time.perf_counter()
    frames = ratio_frames()[:3]
    fabric = HostLocalFabric(MH_HOSTS, timeout=300)
    ticks = [1e9]
    aggs = []
    for p in range(MH_HOSTS):
        agg = Aggregator(
            APIServer(), device=dev, mesh=mesh, backend="pallas",
            model_mode=None, node_bucket=N_NODES, workload_bucket=256,
            stale_after=1e9, skew_tolerance=0.0, clock=lambda: ticks[0],
            multihost_enabled=True,
            multihost_topology={"process_index": p,
                                "device_process": lambda k: k // per,
                                "fabric": fabric},
            membership_topology={
                "peer_alive": lambda peer: peer == MH_PEERS[0],
                "deliver": lambda peer, payload: {}},
            peers=list(MH_PEERS), self_peer=MH_PEERS[p])
        agg.init()
        aggs.append(agg)

    def ingest(agg, interval: int) -> set:
        ticks[0] = 1e9 + 5.0 * (interval + 1)
        live, fr = frames[interval]
        took = set()
        for name, frame in zip(live, fr):
            if agg._ingest_payload(frame)[0] == 204:
                took.add(name)
        return took

    owned0 = [ingest(agg, 0) for agg in aggs]
    check(not owned0[0] & owned0[1]
          and len(owned0[0] | owned0[1]) == len(frames[0][0]),
          "the mesh-derived ring does not partition the fleet")
    reset_launches()
    results: list = [None] * MH_HOSTS
    threads = [threading.Thread(target=lambda p=p: results.__setitem__(
        p, aggs[p].aggregate_once())) for p in range(MH_HOSTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    b1_together = read_launches()["outer_product_attribution"]
    for p in range(MH_HOSTS):
        check(results[p] is not None
              and set(results[p].names) == owned0[p],
              f"host {p} did not publish its own nodes")
        check(aggs[p]._rung_display(0) == RUNG_NAME_MULTIHOST,
              f"host {p} rung 0 is {aggs[p]._rung_display(0)}")
    check(b1_together == SHARDS, f"B1 launched {b1_together} times over "
          f"the {MH_HOSTS} hosts' window, not {SHARDS}")
    epoch = aggs[0]._ring.epoch
    fabric.kill()
    agg = aggs[0]
    after = []
    for interval in (1, 2):
        live = set(frames[interval][0])
        ingest(agg, interval)
        reset_launches()
        res = agg.aggregate_once()
        after.append(read_launches()["outer_product_attribution"])
        check(res is not None and set(res.names) >= owned0[0] & live,
              f"interval {interval}: host 0 stopped publishing its nodes")
        check(np.isfinite(res.node_power_uw).all(), "non-finite watts")
    health = agg.window_health()
    check(agg._rung_display(0) == RUNG_NAME_MESH_DEGRADED
          and health["rung_name"] == RUNG_NAME_MESH_DEGRADED,
          f"rung 0 reads {health['rung_name']} after the fabric died")
    check(agg._rung_timeline[-1]["reason"] == "host_dead",
          f"demotion reason {agg._rung_timeline[-1]['reason']}")
    check(agg._ring.epoch == epoch + 1, "succession did not bump the epoch")
    check(type(agg._engine) is ShardedWindowEngine
          and agg._engine.n_shards == per,
          "the survivor does not run its local sharded engine")
    check(after == [per, per], f"B1 after the demotion: {after}")
    for a in aggs:
        a.shutdown()
    demote_s = time.perf_counter() - t0

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        addr = f"127.0.0.1:{s.getsockname()[1]}"
    joined = initialize_multihost(coordinator_address=addr,
                                  num_processes=1, process_id=0,
                                  init_timeout=60)
    try:
        check(bool(joined) and joined.reason == "joined",
              f"one-rank gloo join: {joined}")
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    row = {"phase": "main_multihost_virtual", "hosts": MH_HOSTS,
           "shards_per_host": per, "owned_rows": owned_rows,
           "max_model_rel_vs_sharded": worst_model,
           "b1_two_hosts_window": b1_together,
           "b1_per_window_after_demotion": after,
           "rung_after_kill": health["rung_name"],
           "epoch": [epoch, agg._ring.epoch], "join": joined.reason,
           "hosts_s": hosts_s, "demotion_s": demote_s,
           "seconds": time.perf_counter() - t_phase}
    emit(row)
    return row


CHAOS_BLACKBOX_INDEX = 0


def chaos_sweep(device, backend: str):
    """The reference's sweep (default ``ChaosConfig``: 3 replicas, 1
    standby, 4 agents, 24 windows) → (report, artifact, seconds)."""
    from kepler_tpu_torch.chaos.conductor import run_many
    from kepler_tpu_torch.chaos.harness import ChaosConfig

    t0 = time.perf_counter()
    report = run_many(CHAOS_SEED, CHAOS_SCHEDULES,
                      ChaosConfig(device=str(device), backend=backend),
                      do_shrink=False)
    torch.cuda.synchronize()
    return report, report.to_artifact(), time.perf_counter() - t0


def chaos_rerun_cpu(index: int):
    """One schedule of the sweep again, on ``device="cpu"``."""
    from kepler_tpu_torch.chaos.conductor import run_schedule
    from kepler_tpu_torch.chaos.harness import ChaosConfig
    from kepler_tpu_torch.chaos.schedule import generate

    cfg = ChaosConfig(device="cpu")
    peers = [f"10.99.0.{i + 1}:28283"
             for i in range(cfg.replicas + cfg.standbys)]
    return run_schedule(generate(CHAOS_SEED, index, horizon=cfg.horizon,
                                 members=peers[:cfg.replicas],
                                 standbys=peers[cfg.replicas:]), cfg)


def main_chaos(dev: torch.device) -> dict:
    """Path 11: kepchaos on the card. The reference's 25-schedule sweep
    at seed 1 drives the port's replicated Aggregators, each over a mesh
    of 8 virtual shards of the card (the harness's default, as the
    reference's sweep runs on 8 host devices), twice: with
    ``backend="einsum"`` (as the reference runs it) held to
    ``CHAOS_r01.json`` (all green, windows published, events, fault
    fires and all 25 trace hashes; a schedule whose hash differs is
    compared event by event with a rerun on ``device="cpu"`` for the
    diagnosis), then with ``backend="pallas"`` — B1 once per shard in
    every rung-0 window of the sharded engine and once per window on
    the single-device rungs, under dispatch errors, compile errors and
    re-promotions, with the same 25 hashes. Then the two binaries: ``python -m
    kepler_tpu_torch.chaos --schedule 0`` (its trace hash is the
    file's) and ``python -m kepler_tpu_torch.blackbox`` over one run's
    journals, whose timeline SHA is the one the CPU run gives."""
    from kepler_tpu_torch.blackbox import (analyze, merge_events,
                                           timeline_sha256)

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "CHAOS_r01.json")) as f:
        ref = json.load(f)
    t_phase = time.perf_counter()
    quiet = logging.getLogger("kepler")
    level = quiet.level
    quiet.setLevel(logging.CRITICAL)  # every membership change logs
    try:
        report, art, einsum_s = chaos_sweep(dev, "einsum")
        reset_launches()
        p_report, p_art, pallas_s = chaos_sweep(dev, "pallas")
        launches = read_launches()
        mismatched = []
        for i, h in sorted(art["trace_hashes"].items(), key=lambda kv:
                           int(kv[0])):
            if h == ref["trace_hashes"][i]:
                continue
            # diagnosis only: which event first differs from the CPU
            card = report.results[int(i)]
            cpu = chaos_rerun_cpu(int(i))
            kinds = [a["kind"] for a, b in zip(card.trace.events,
                                                cpu.trace.events) if a != b]
            mismatched.append({
                "index": int(i), "cpu_hash_equal":
                    cpu.trace_hash == card.trace_hash,
                "first_diff_kind_vs_cpu": kinds[0] if kinds else None})
        bb_card = report.results[CHAOS_BLACKBOX_INDEX].record.journals
        bb_cpu = chaos_rerun_cpu(CHAOS_BLACKBOX_INDEX).record.journals
    finally:
        quiet.setLevel(level)
    for what, a in (("einsum", art), ("pallas", p_art)):
        check(a["verdicts"] == {"green": CHAOS_SCHEDULES, "red": 0},
              f"chaos {what}: verdicts {a['verdicts']} "
              f"{a.get('failure')}")
    check(art["windows_published"] == ref["windows_published"],
          f"chaos einsum: {art['windows_published']} windows published, "
          f"the file {ref['windows_published']}")
    check(art["events_total"] == ref["events_total"],
          f"chaos einsum: {art['events_total']} events")
    check(art["fault_fires"] == ref["fault_fires"],
          f"chaos einsum: fault fires {art['fault_fires']}")
    check(p_art["windows_published"] == art["windows_published"]
          and p_art["fault_fires"] == art["fault_fires"],
          f"chaos pallas: {p_art['windows_published']} windows, fires "
          f"{p_art['fault_fires']}")
    check(launches["outer_product_attribution"] > 0,
          "the pallas sweep launched B1 no time")
    # every published row's digest is in the trace, and the einsum pass
    # is B1's plain version on the same inputs: this holds B1 bit for
    # bit against it at the chaos path's shapes
    differ = sorted((int(i) for i, h in p_art["trace_hashes"].items()
                     if h != art["trace_hashes"][i]))
    check(not differ and p_art["trace_hashes"].keys()
          == art["trace_hashes"].keys(),
          f"chaos pallas: trace hashes differ from einsum at {differ}")
    check(launches["fused_window_step"] == 0, "the chaos sweep ran B2")
    # the reference's sweep ran on an 8-device mesh, the port's on 8
    # virtual shards of the card: every trace hash is the file's
    check(not mismatched, f"chaos einsum: trace hashes differ from "
          f"CHAOS_r01.json: {mismatched}")

    env = dict(os.environ, PYTHONPATH=here)
    tmp = tempfile.mkdtemp(prefix="kt-chaos-")
    try:
        art_path = os.path.join(tmp, "schedule0.json")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "kepler_tpu_torch.chaos", "--seed",
             str(CHAOS_SEED), "--schedule", "0", "--artifact", art_path],
            cwd=here, env=env, capture_output=True, text=True, timeout=300)
        cli_s = time.perf_counter() - t0
        check(proc.returncode == 0,
              f"chaos binary exit {proc.returncode}: "
              f"{(proc.stdout + proc.stderr)[-800:]}")
        with open(art_path) as f:
            cli_hash = json.load(f)["trace_hashes"]["0"]
        check(cli_hash == ref["trace_hashes"]["0"],
              f"chaos binary trace {cli_hash}")
        bundles = []
        for k, inc in enumerate(sorted(bb_card)):
            path = os.path.join(tmp, f"bundle{k}.json")
            with open(path, "w") as f:
                json.dump({"schema": "kepler-bundle/v1", "node": inc,
                           "journal": bb_card[inc]}, f)
            bundles.append(path)
        proc = subprocess.run(
            [sys.executable, "-m", "kepler_tpu_torch.blackbox", "--sha",
             *bundles], cwd=here, env=env, capture_output=True, text=True,
            timeout=120)
        check(proc.returncode == 0,
              f"blackbox binary exit {proc.returncode}: {proc.stderr[-800:]}")
        bb_sha = proc.stdout.strip()
        merged = merge_events(bb_cpu[inc] for inc in sorted(bb_cpu))
        cpu_sha = timeline_sha256(merged, analyze(merged))
        check(bb_sha == cpu_sha,
              f"black-box timeline {bb_sha} on the card, {cpu_sha} on the CPU")
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    row = {"phase": "main_chaos", "seed": CHAOS_SEED,
           "schedules": CHAOS_SCHEDULES,
           "einsum": {k: art[k] for k in ("verdicts", "windows_published",
                                          "events_total", "fault_fires")},
           "einsum_s": einsum_s,
           "einsum_hashes_equal_file": sum(
               h == ref["trace_hashes"][i]
               for i, h in art["trace_hashes"].items()),
           "einsum_hash_mismatches": mismatched,
           "pallas": {k: p_art[k] for k in ("verdicts", "windows_published",
                                            "fault_fires")},
           "pallas_s": pallas_s, "launches": launches,
           "pallas_hashes_equal_einsum": sum(
               h == art["trace_hashes"][i]
               for i, h in p_art["trace_hashes"].items()),
           "cli_trace": cli_hash[:16], "cli_s": cli_s,
           "blackbox_bundles": len(bundles), "blackbox_sha": bb_sha,
           "blackbox_events": len(merged),
           "seconds": time.perf_counter() - t_phase}
    emit(row)
    return row


# -- the parallel families (path 14) ---------------------------------------------

# The ring at the estimators' full width: 4096 sequences of T = 1024
# ticks over 8 virtual shards (one 128-tick block a shard: B3 on tensor
# cores at Tq = Tk = 128), 4 heads of 32; the dense references run on
# PARALLEL_DENSE_SEQS of them (the whole [T, T] scores would be 64 GB).
PARALLEL_B, PARALLEL_T, PARALLEL_SHARDS = 4096, 1024, 8
PARALLEL_DENSE_SEQS = 64
# cut: Ulysses holds dense [T, T] scores per shard, and training keeps
# the ring's block activations for the backward
PARALLEL_ULYSSES_B = 512
PARALLEL_TRAIN_B = 512
PARALLEL_TRAIN_STEPS = 6
# 262,144 rows (1024 nodes × 256 workloads) for the pipeline, the
# experts and the trainer
PARALLEL_ROWS = N_NODES * 256
TRAIN_F32_RTOL = 1e-4  # f32 train steps, as tests/test_torch_train.py


def parallel_mesh(dev: torch.device, n: int, axes=("seq",), shape=None):
    from kepler_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(list(shape or [n]), list(axes), devices=[dev] * n)


def ragged_lengths(gen: torch.Generator, dev: torch.device, b: int,
                   t: int) -> torch.Tensor:
    """Right-padded history lengths 0..T with every 16th sequence fully
    masked (length 0)."""
    lengths = torch.randint(1, t + 1, (b,), generator=gen, device=dev)
    lengths[::16] = 0
    return torch.arange(t, device=dev)[None, :] < lengths[:, None]


def timed_call(fn) -> tuple[object, float]:
    """(result, host ms of one call ended by a synchronize)."""
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, (time.perf_counter() - t0) * 1e3


def parallel_ring(dev: torch.device) -> dict:
    """The ring with ``backend="pallas"``: 64 B3 launches per call, all
    on tensor cores, against the einsum ring (B3's bound, 1e-2 · max|v|)
    and dense ``full_attention`` on PARALLEL_DENSE_SEQS sequences; B3
    timed at the per-launch shape beside its bound, its plain version
    and SDPA."""
    from kepler_tpu_torch.ops import cuda_attention as cat
    from kepler_tpu_torch.ops.attention import full_attention
    from kepler_tpu_torch.parallel.ring import make_ring_attention

    b, t, n = PARALLEL_B, PARALLEL_T, PARALLEL_SHARDS
    t_loc = t // n
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    shape = (b, t, N_HEADS, D_MODEL // N_HEADS)
    q, k, v = (torch.randn(shape, generator=gen, device=dev)
               for _ in range(3))
    valid = ragged_lengths(gen, dev, b, t)
    mesh = parallel_mesh(dev, n)
    ring = make_ring_attention(mesh, backend="pallas")
    einsum = make_ring_attention(mesh)

    reset_launches()
    out, first_ms = timed_call(lambda: ring(q, k, v, valid))
    launches = read_launches()
    check(launches["flash_block"] == n * n
          and launches["flash_block_tc"] == n * n,
          f"the ring launched B3 {launches['flash_block']} times "
          f"({launches['flash_block_tc']} on tensor cores), not {n * n}")
    check(launches["outer_product_attribution"] == 0
          and launches["fused_window_step"] == 0, "the ring ran B1 or B2")
    check(bool(torch.isfinite(out).all()), "the ring's output is not finite")
    empty = valid.sum(dim=1) == 0
    check(bool(torch.all(out[empty] == 0)),
          "fully masked sequences are not exactly zero")
    bound_v = 1e-2 * float(v.abs().max())
    ref = einsum(q, k, v, valid)
    err_einsum = float((out - ref).abs().max())
    check(err_einsum <= bound_v,
          f"pallas ring off the einsum ring by {err_einsum} (> {bound_v})")
    del ref
    sl = slice(0, PARALLEL_DENSE_SEQS)
    dense = full_attention(q[sl], k[sl], v[sl], t_valid=valid[sl])
    err_dense = float((out[sl] - dense).abs().max())
    check(err_dense <= bound_v, f"pallas ring off dense attention on "
          f"{PARALLEL_DENSE_SEQS} sequences by {err_dense} (> {bound_v})")
    del dense, out

    ring_ms = time_ms(lambda: ring(q, k, v, valid), reps=3, batch=1)
    einsum_ms = time_ms(lambda: einsum(q, k, v, valid), reps=3, batch=1)
    prof = profile_top(lambda: ring(q, k, v, valid), match="flash_block")
    ring_bound = 0.0
    for i in range(n):
        qi = q[:, i * t_loc:(i + 1) * t_loc]
        for src in range(n):
            kv = slice(src * t_loc, (src + 1) * t_loc)
            ring_bound += cat.flash_block_bound_ms(
                qi, k[:, kv], valid[:, kv], i * t_loc, src * t_loc)[0]
    # one launch at the per-launch shape: shard 3's diagonal block
    blk = slice(3 * t_loc, 4 * t_loc)
    qb, kb, vb = (x[:, blk].contiguous() for x in (q, k, v))
    vab = valid[:, blk].contiguous()
    start = 3 * t_loc
    kern = lambda: cat.flash_block_pallas(  # noqa: E731
        qb, kb, vb, vab, start, start)
    plain = lambda: cat.flash_block_ref(qb, kb, vb, vab, start, start)  # noqa: E731
    got = kern()
    err_blk = b3_check(got, plain(), vb, torch.bfloat16,
                       f"B3 at the ring's block shape B={b}, T={t_loc}")
    del got
    bound, by = cat.flash_block_bound_ms(qb, kb, vab, start, start)
    lib_ms, lib_device_ms, lib_err = sdpa_ms(qb, kb, vb, vab)
    launch = {"B": b, "Tq": t_loc, "Tk": t_loc, "H": N_HEADS,
              "D": D_MODEL // N_HEADS, "q_start": start, "kv_start": start,
              "plan": cat.flash_block_plan(b, t_loc, t_loc, N_HEADS,
                                           D_MODEL // N_HEADS)._asdict(),
              "ms": time_ms(kern, reps=5, batch=4),
              "device_ms": device_ms(kern, calls=5),
              "plain_ms": time_ms(plain, reps=3, batch=2),
              "plain_device_ms": device_ms(plain, calls=2),
              "library_ms": lib_ms, "library_device_ms": lib_device_ms,
              "bound_ms": bound, "bound_by": by, "max_abs_err": err_blk}
    if lib_err is not None:
        launch["library_error"] = lib_err
    del q, k, v, valid, qb, kb, vb, vab
    torch.cuda.empty_cache()
    return {"shape": {"B": b, "T": t, "H": N_HEADS,
                      "D": D_MODEL // N_HEADS, "shards": n,
                      "compute": "bf16", "causal": True},
            "launches": launches, "first_call_ms": first_ms,
            "call_ms": ring_ms, "einsum_call_ms": einsum_ms,
            "profile": prof, "b3_ms_per_call": prof["flash_block_ms"],
            "b3_device_ms_per_launch": prof["flash_block_ms"] / (n * n),
            "b3_bound_ms_per_call": ring_bound,
            "max_abs_err_vs_einsum": err_einsum,
            "max_abs_err_vs_dense": err_dense, "err_bound": bound_v,
            "per_launch": launch}


def temporal_inputs(dev: torch.device, b: int, t: int, seed: int):
    """Feature history [B, T, 7] with right-padded ragged windows, the
    workloads' validity and targets of tens of watts."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    hist = torch.rand((b, t, 7), generator=gen, device=dev)
    tv = ragged_lengths(gen, dev, b, t)
    hist = torch.where(tv[..., None], hist, 0.0)
    wv = torch.rand((b,), generator=gen, device=dev) > 0.05
    targets = torch.rand((b, len(ZONES)), generator=gen, device=dev) * 40
    return hist, wv, tv, targets


def parallel_temporal(dev: torch.device) -> dict:
    """The sequence-parallel program (einsum ring, 8 shards) at B = 4096,
    T = 1024 and the Ulysses program (4 shards) at B = 512 against the
    single-query dense path; then the sequence-parallel train step with
    remat against the single-device train step."""
    from kepler_tpu_torch.models import train
    from kepler_tpu_torch.models.estimator import params_to
    from kepler_tpu_torch.models.temporal import predict_temporal
    from kepler_tpu_torch.parallel import (make_sequence_parallel_train_step,
                                           make_temporal_program,
                                           make_ulysses_temporal_program)

    t = PARALLEL_T
    params = params_to(temporal_params(ACC_SCALE, t_max=t), dev)
    out = {}
    for label, b, build in (
            ("sequence", PARALLEL_B, lambda: make_temporal_program(
                parallel_mesh(dev, PARALLEL_SHARDS))),
            ("ulysses", PARALLEL_ULYSSES_B, lambda: make_ulysses_temporal_program(
                parallel_mesh(dev, 4)))):
        hist, wv, tv, _ = temporal_inputs(dev, b, t, SEED + b)
        program = build()
        reset_launches()
        got, ms = timed_call(lambda: program(params, hist, wv, tv))
        launches = read_launches()
        check(not any(launches.values()), f"{label}: a kernel launched "
              f"({launches}); JAX's program runs none")
        want, dense_ms = timed_call(
            lambda: predict_temporal(params, hist, wv, tv))
        a, r = got.cpu().numpy(), want.cpu().numpy()
        check(np.isfinite(a).all(), f"{label}: non-finite watts")
        check(bf16_close(a, r), f"{label} program off the dense path by "
              f"{float(np.abs(a - r).max())} W")
        out[label] = {"B": b, "T": t, "call_ms": ms, "dense_ms": dense_ms,
                      "max_abs_err_w": float(np.abs(a - r).max()),
                      "max_w": float(np.abs(r).max()), "launches": launches}
        del hist, wv, tv, got, want, program
        torch.cuda.empty_cache()

    b = PARALLEL_TRAIN_B
    hist, wv, tv, targets = temporal_inputs(dev, b, t, SEED + 3)
    runs = {}
    for label, step in (
            ("sp_remat", make_sequence_parallel_train_step(
                parallel_mesh(dev, PARALLEL_SHARDS), remat=True)),
            ("one_shard", train.make_temporal_train_step(
                compute_dtype=torch.float32))):
        state = train.create_train_state(params, train.make_optimizer(1e-3))
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        losses, ms = [], []
        for _ in range(PARALLEL_TRAIN_STEPS):
            (state, loss), step_ms = timed_call(
                lambda: step(state, hist, wv, tv, targets))
            losses.append(float(loss))
            ms.append(step_ms)
        check(not any(read_launches().values()),
              f"{label}: a kernel launched in training")
        runs[label] = {"losses": losses, "ms_per_step": statistics.median(ms),
                       "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                       "params": train.detached(state.params)}
        del state
        torch.cuda.empty_cache()
    sp, one = runs["sp_remat"], runs["one_shard"]
    check(all(np.isfinite(sp["losses"])), "SP training: non-finite loss")
    check(sp["losses"][-1] < sp["losses"][0], "SP training: no fall")
    rel = float(np.max(np.abs(np.asarray(sp["losses"])
                              / np.asarray(one["losses"]) - 1)))
    check(rel <= TRAIN_F32_RTOL, f"SP losses off the one-shard step by {rel}")
    param_err = max(float((sp["params"][key] - one["params"][key])
                          .abs().max()) for key in sp["params"])
    out["sequence_training"] = {
        "B": b, "T": t, "steps": PARALLEL_TRAIN_STEPS, "remat": True,
        "compute": "f32", "losses": sp["losses"],
        "one_shard_losses": one["losses"], "max_loss_rel": rel,
        "max_param_abs_diff": param_err,
        "ms_per_step": sp["ms_per_step"],
        "one_shard_ms_per_step": one["ms_per_step"],
        "peak_gb": sp["peak_gb"], "one_shard_peak_gb": one["peak_gb"]}
    del hist, wv, tv, targets, runs, sp, one, params
    torch.cuda.empty_cache()
    return out


def parallel_rows(dev: torch.device) -> dict:
    """The GPipe deep estimator (4 stages, 4 microbatches) and expert
    parallelism (8 experts on 8 shards; explicit ids and learned top-1)
    over 262,144 rows against the single-device models."""
    from kepler_tpu_torch.models.deep import predict_deep
    from kepler_tpu_torch.models.estimator import params_to
    from kepler_tpu_torch.models.moe import expert_forward, predict_moe
    from kepler_tpu_torch.parallel import (make_expert_parallel_moe,
                                           make_pipelined_deep, top1_route)

    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    rows = PARALLEL_ROWS
    feats = torch.rand((rows, 7), generator=gen, device=dev)
    valid = torch.rand((rows,), generator=gen, device=dev) > 0.1
    out = {}

    deep = params_to(single_tick_params("deep", SEED + 16), dev)
    pipe = make_pipelined_deep(parallel_mesh(dev, 4, ("stage",)),
                               n_microbatches=4)
    reset_launches()
    got, ms = timed_call(lambda: pipe(deep, feats, valid))
    check(not any(read_launches().values()), "pipeline: a kernel launched")
    want, dense_ms = timed_call(lambda: predict_deep(deep, feats, valid))
    a, r = got.cpu().numpy(), want.cpu().numpy()
    check(np.isfinite(a).all() and bf16_close(a, r), "pipelined deep off "
          f"predict_deep by {float(np.abs(a - r).max())} W")
    out["pipeline"] = {"rows": rows, "stages": 4, "blocks": 4,
                       "microbatches": 4, "call_ms": ms,
                       "dense_ms": dense_ms,
                       "max_abs_err_w": float(np.abs(a - r).max()),
                       "max_w": float(np.abs(r).max())}
    del deep, got, want

    moe = params_to(single_tick_params("moe", SEED + 17), dev)
    ep = make_expert_parallel_moe(parallel_mesh(dev, PARALLEL_SHARDS,
                                                ("expert",)))
    eid = torch.randint(0, 8, (rows,), generator=gen, device=dev,
                        dtype=torch.int32)
    ones = torch.ones(rows, device=dev)
    learned = top1_route(moe, feats)
    per = expert_forward(moe, feats.expand(8, rows, 7))  # [E, rows, Z]
    picked = per[learned[0].long(), torch.arange(rows, device=dev)]
    for label, (ids, gate), ref in (
            ("explicit", (eid, ones), lambda: predict_moe(
                moe, feats[:, None], torch.ones((rows, 1), dtype=torch.bool,
                                                device=dev),
                clamp=False, expert_id=eid)[:, 0]),
            ("top1", learned, lambda: picked * learned[1][:, None])):
        reset_launches()
        got, ms = timed_call(lambda: ep(moe, feats, ids, gate))
        check(not any(read_launches().values()), "EP: a kernel launched")
        a, r = got.cpu().numpy(), ref().cpu().numpy()
        check(np.isfinite(a).all() and bf16_close(a, r), f"EP ({label}) off "
              f"the dense MoE by {float(np.abs(a - r).max())} W")
        out[f"expert_{label}"] = {"rows": rows, "experts": 8, "shards": 8,
                                  "call_ms": ms,
                                  "max_abs_err_w": float(np.abs(a - r).max()),
                                  "max_w": float(np.abs(r).max())}
    del moe, per, picked, feats, valid
    torch.cuda.empty_cache()
    return out


def parallel_trainer(dev: torch.device) -> dict:
    """DP×TP on a 4 × 2 ``node × model`` mesh: ``init_mlp`` at its
    defaults, features [1024, 256, 7], 6 steps, at the default bf16 and
    at f32 against ``make_train_step(predict_mlp)`` on one shard, then
    the gathered params served."""
    import functools

    from kepler_tpu_torch.models import train
    from kepler_tpu_torch.models.mlp import init_mlp, predict_mlp
    from kepler_tpu_torch.parallel import (gather_params,
                                           make_distributed_train_step,
                                           shard_train_state)

    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    feats = torch.rand((N_NODES, 256, 7), generator=gen, device=dev) * 3
    valid = torch.rand((N_NODES, 256), generator=gen, device=dev) > 0.2
    targets = feats[..., :1] * torch.tensor([4.0, 2.0, 1.0, 0.5],
                                            device=dev) * 10
    params = init_mlp(len(ZONES), generator=torch.Generator().manual_seed(
        SEED + 19), device=dev)
    lr = float(TRAIN_LR)
    mesh = parallel_mesh(dev, 8, ("node", "model"), (4, 2))
    out = {}
    for cd, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        runs = {}
        for label in ("dp_tp", "one_shard"):
            state = train.create_train_state(params,
                                             train.make_optimizer(lr))
            if label == "dp_tp":
                state = shard_train_state(state, mesh)
                step = make_distributed_train_step(mesh, compute_dtype=cd)
            else:
                step = train.make_train_step(functools.partial(
                    predict_mlp, compute_dtype=cd))
            reset_launches()
            losses, ms = [], []
            for _ in range(TRAIN_CPU_STEPS):
                (state, loss), step_ms = timed_call(
                    lambda: step(state, feats, valid, targets))
                losses.append(float(loss))
                ms.append(step_ms)
            check(not any(read_launches().values()),
                  "trainer: a kernel launched")
            whole = (gather_params(state) if label == "dp_tp"
                     else train.detached(state.params))
            runs[label] = (losses, whole, statistics.median(ms))
        (dl, dp, dms), (ol, op, oms) = runs["dp_tp"], runs["one_shard"]
        rel = float(np.max(np.abs(np.asarray(dl) / np.asarray(ol) - 1)))
        diff = max(float((dp[k] - op[k]).abs().max()) for k in dp)
        # bf16: the train loss tolerance, and Adam's near-sign steps flip
        # for a gradient near zero (2 · lr a step); f32: summation order
        rtol, atol = ((TRAIN_LOSS_RTOL, 2 * lr * TRAIN_CPU_STEPS)
                      if name == "bf16" else (TRAIN_F32_RTOL, 1e-5))
        check(dl[-1] < dl[0], f"DP×TP ({name}): the loss does not fall")
        check(rel <= rtol, f"DP×TP ({name}) losses off one shard by {rel}")
        check(diff <= atol, f"DP×TP ({name}) params off one shard by {diff}")
        served = predict_mlp(dp, feats, valid)
        ref = predict_mlp(op, feats, valid)
        a, r = served.cpu().numpy(), ref.cpu().numpy()
        check(bf16_close(a, r), f"DP×TP ({name}) params serve off one "
              f"shard's by {float(np.abs(a - r).max())} W")
        out[name] = {"losses": dl, "one_shard_losses": ol,
                     "max_loss_rel": rel, "max_param_abs_diff": diff,
                     "ms_per_step": dms, "one_shard_ms_per_step": oms,
                     "served_max_abs_err_w": float(np.abs(a - r).max())}
    del feats, valid, targets
    torch.cuda.empty_cache()
    return {"mesh": {"node": 4, "model": 2}, "batch": [N_NODES, 256, 7],
            "steps": TRAIN_CPU_STEPS, "lr": lr, **out}


def main_parallel(dev: torch.device) -> dict:
    """Path 14: the parallel families on virtual shards of the card, each
    against its single-device form: the ring (B3 once per shard per KV
    rotation), sequence parallelism (serving and training), Ulysses,
    the GPipe pipeline, expert parallelism and the DP×TP trainer."""
    t_phase = time.perf_counter()
    row = {"phase": "main_parallel", "ring": parallel_ring(dev)}
    row.update(parallel_temporal(dev))
    row.update(parallel_rows(dev))
    row["trainer"] = parallel_trainer(dev)
    row["seconds"] = time.perf_counter() - t_phase
    emit(row)
    return row


# the port's protocol models at the registry scopes, as the reference
# package's explorations reach them: (states, transitions) per case
# (tests/test_torch_protocol.py holds these against JAX's kepmc)
PROTOCOL_COUNTS = {
    "lease.succession/n2_e4": (77, 102),
    "lease.succession/n3_e5": (4493, 9092),
    "lease.partitioned/n3_e4_suspects": (16135, 36223),
    "seq.delivery/k6_w2_e4": (36885, 207605),
    "spool.cursor/r5_s2": (90, 203),
    "keyframe.delta/k4_every2": (421, 1745),
}


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-equal tensors (NaN payloads included)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        view = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        a, b = (x.view(view[x.element_size()]) for x in (a, b))
    return bool(torch.equal(a, b))


def main_analysis(dev: torch.device) -> dict:
    """Path 15: the port's static analysis. keplint over its default
    trees (the port and this script) with the port's empty baseline; the
    protocol tier's models over the port's fleet functions; the device
    tier's registered programs run on the card — KTL120-122 clean, each
    case's fingerprint equal to the same case run on the CPU in this
    process, its kernels and collectives equal to the committed snapshot
    (a histogram drift, a torch-version effect, is printed), and the
    kernel entries' outputs (B1, B2) bit-equal to their plain versions
    on the same inputs."""
    import contextlib
    import io

    from kepler_tpu_torch.analysis import __main__ as keplint
    from kepler_tpu_torch.analysis.device import (DEVICE_PROGRAMS,
                                                  analyze_device_programs,
                                                  load_snapshots, trace_all)
    from kepler_tpu_torch.analysis.device.trace import fingerprint
    from kepler_tpu_torch.analysis.protocol import (PROTOCOL_SPECS,
                                                    analyze_protocol_specs,
                                                    explore_case)

    here = os.path.dirname(os.path.abspath(__file__))
    row: dict = {"phase": "main_analysis"}
    t = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = keplint.main([os.path.join(here, tree)
                           for tree in keplint.DEFAULT_TREES])
    check(rc == 0 and out.getvalue().strip() == "keplint: clean",
          f"keplint over the port: rc {rc}, {out.getvalue()[-400:]}")
    row["keplint_s"] = time.perf_counter() - t

    t = time.perf_counter()
    diags = analyze_protocol_specs(here)
    check(not diags, "protocol tier: " + "; ".join(
        d.render()[:200] for d in diags[:3]))
    counts = {}
    for spec in PROTOCOL_SPECS:
        for case in spec.cases:
            res = explore_case(spec, case).result
            counts[f"{spec.name}/{case.name}"] = (res.states,
                                                  res.transitions)
    check(counts == PROTOCOL_COUNTS, f"protocol counts {counts}")
    row["protocol_s"] = time.perf_counter() - t
    row["protocol_counts"] = counts

    t = time.perf_counter()
    reset_launches()
    diags = analyze_device_programs(
        here, only={"KTL120", "KTL121", "KTL122"}, device="cuda")
    torch.cuda.synchronize()
    row["launches"] = read_launches()
    row["device_tier_cuda_s"] = time.perf_counter() - t
    check(not diags, "device tier on the card: " + "; ".join(
        d.render()[:240] for d in diags[:4]))
    cuda_reports, errors = trace_all(DEVICE_PROGRAMS, "cuda")
    check(not errors, f"device tier errors {errors[:2]}")
    t = time.perf_counter()
    cpu_reports, errors = trace_all(DEVICE_PROGRAMS, "cpu")
    row["device_tier_cpu_s"] = time.perf_counter() - t
    check(not errors, f"device tier errors on the CPU {errors[:2]}")
    snapshots = load_snapshots(here) or {}
    drift, kernel_cases = {}, {}

    def pinned(f: dict) -> tuple:
        """What no torch version may move: kernels and collectives."""
        return ({k: v for k, v in f["ops"].items()
                 if k.startswith("kernel:")}, f["collectives"])

    for got, ref in zip(cuda_reports, cpu_reports):
        fp, fp_cpu = fingerprint(got), fingerprint(ref)
        check(fp == fp_cpu, f"{got.key}: the card's fingerprint differs "
              f"from the CPU's: " + json.dumps(
                  {k: (fp[k], fp_cpu[k]) for k in fp
                   if fp[k] != fp_cpu[k]})[:600])
        snap = snapshots.get(got.key)
        check(snap is not None, f"{got.key}: no committed snapshot")
        check(pinned(fp) == pinned(snap), f"{got.key}: kernels or "
              f"collectives {pinned(fp)} != snapshot {pinned(snap)}")
        moved = sorted(k for k in fp if fp[k] != snap.get(k))
        if moved:
            drift[got.key] = {k: {"snapshot": snap.get(k), "run": fp[k]}
                              for k in moved}
        if got.spec.kernels:
            check(len(got.outputs) == len(ref.outputs) and all(
                same_bits(a, b) for a, b in zip(got.outputs, ref.outputs)),
                f"{got.key}: {got.spec.kernels} on the card differ from "
                f"their plain versions")
            kernel_cases[got.key] = list(got.spec.kernels)
    check(row["launches"]["outer_product_attribution"] >= 1
          and row["launches"]["fused_window_step"] >= 1,
          f"device tier launched {row['launches']}")
    row["cases"] = len(cuda_reports)
    row["kernel_cases_bit_equal"] = kernel_cases
    row["snapshot_drift_cases"] = sorted(drift)
    if drift:
        emit({"phase": "main_analysis_snapshot_drift",
              "torch": torch.__version__, "drift": drift})
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
    t_script = time.perf_counter()
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
    agg_fused = main_aggregator_fused(dev)
    agg_mixed = main_aggregator_mixed(dev)
    main_aggregator_cmd()
    agg_models = main_aggregator_models(dev)
    fleet, saved, params, outs = main_temporal_fleet(dev)
    trunk = main_temporal_trunk(dev, saved, params, outs)
    del saved, outs
    train = main_train(dev)
    main_node_agent(dev)
    node_fleet = main_node_fleet(dev)
    main_node_cmd()
    phases = sharded_phases()
    sharded, sharded_planes = main_sharded(dev, phases)
    multihost = main_multihost_virtual(dev, phases, sharded_planes)
    del phases, sharded_planes
    chaos = main_chaos(dev)
    parallel = main_parallel(dev)
    analysis = main_analysis(dev)

    b1["launches_by_path"] = {
        "main_mixed": mixed["launches"]["outer_product_attribution"],
        "main_aggregator_mixed":
            agg_mixed["launches"]["outer_product_attribution"],
        "main_aggregator_models_moe":
            agg_models["moe"]["launches"]["outer_product_attribution"],
        "main_aggregator_models_deep":
            agg_models["deep"]["launches"]["outer_product_attribution"],
        "main_temporal_fleet":
            fleet["launches"]["outer_product_attribution"],
        "main_train": train["launches"]["outer_product_attribution"],
        "main_sharded": sharded["launches"]["outer_product_attribution"],
        "main_multihost_virtual": multihost["b1_two_hosts_window"]
        + sum(multihost["b1_per_window_after_demotion"]),
        "main_chaos_pallas":
            chaos["launches"]["outer_product_attribution"],
        "main_analysis": analysis["launches"]["outer_product_attribution"]}
    b1["launches"] = sum(b1["launches_by_path"].values())
    b2 = dict(b2_flush)  # the main path's call: one launch per flush
    b2["launches_by_path"] = {
        "main_ratio_fused": ratio["launches"]["fused_window_step"],
        "main_aggregator_fused": agg_fused["launches"]["fused_window_step"],
        "main_node_fleet": node_fleet["launches"]["fused_window_step"],
        "main_analysis": analysis["launches"]["fused_window_step"]}
    b2["launches"] = sum(b2["launches_by_path"].values())
    b2["by_db"] = {str(db): {"ms": r["ms"], "plain_ms": r["plain_ms"],
                             "device_ms": r["device_ms"],
                             "bound_ms": r["bound_ms"]}
                   for db, r in sorted(b2_rows.items())}
    b2["by_k"] = {str(r["shape"].get("K", 1)): {
        k: r[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms")}
        for r in (b2_rows[main_db], b2_flush)}
    b3 = dict(b3_rows[0])
    ring = parallel["ring"]
    b3["launches_by_path"] = {
        "main_temporal_trunk": trunk["launches"]["flash_block"],
        "main_parallel_ring": ring["launches"]["flash_block"]}
    b3["launches"] = sum(b3["launches_by_path"].values())
    b3["launches_by_variant"] = {
        v: trunk["launches"][f"flash_block_{v}"]
        + ring["launches"][f"flash_block_{v}"] for v in ("tc", "simt")}
    b3["by_shape"] = {f"B{r['shape']['B']}_T{r['shape']['Tq']}": {
        k: r[k] for k in ("ms", "device_ms", "simt_bf16_device_ms",
                          "f32_device_ms", "plain_ms", "bound_ms",
                          "bound_by", "library_ms", "library_device_ms",
                          "max_abs_err")}
        for r in b3_rows}
    b3["by_shape"]["B{B}_T{Tq}_ring_block".format(
        **ring["per_launch"])] = {
        **{k: ring["per_launch"][k] for k in (
            "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_device_ms", "max_abs_err")},
        "ring_call_b3_device_ms": ring["b3_ms_per_call"],
        "ring_b3_device_ms_per_launch": ring["b3_device_ms_per_launch"],
        "ring_call_b3_bound_ms": ring["b3_bound_ms_per_call"]}
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_device_ms", "device_ms",
            "plain_device_ms", "shape", "by_db",
            "by_k", "by_shape", "launches_by_path", "launches_by_variant")
    emit({"phase": "total", "seconds": time.perf_counter() - t_script})
    print(smi, flush=True)
    emit({"kernels": [{k: row[k] for k in keys if k in row}
                      for row in (b1, b2, b3)]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
