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
   every launch its tensor-core variant; then in accuracy mode (f32) on
   the last window's 262,144 sequences — B3 once, on its KV-tiled
   variant — against the fast path; the trunk at d_model 512 (4 heads of
   128) over 65,536 sequences at bf16 and f32 — B3 once a call, tiled —
   and at d_model 2048 (4 heads of 512) over 4,096 sequences — B3 once a
   call on the tiled variant's wide path — each against the fast path
   and the trunk through plain attention;
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
   the same ring on 2 shards at bf16 (B3 on 512-row blocks, 4 launches)
   and on 8 shards at f32 (64 launches), all on B3's KV-tiled variant,
   against the einsum ring (on 256 sequences for the 512-row blocks) and
   dense attention;
   the sequence-parallel program (8 shards) once under the op recorder
   at 512 sequences (no op returns an axis of the whole sequence: the
   trunk runs on each shard's 128-tick block), then at the ring's size,
   and Ulysses (4 shards, 512 sequences), each against the single-query
   dense path with its call time and peak device memory; 6
   sequence-parallel train steps with remat (512 sequences) against the
   one-shard step, with the peak; the GPipe deep estimator (4 stages) and expert
   parallelism (8 experts on 8 shards, explicit and learned routing)
   over 262,144 rows against the single-device models; the DP×TP
   trainer on a 4 × 2 ``node × model`` mesh against one shard;
15. the port's static analysis (``main_analysis``): ``python -m
   kepler_tpu_torch.analysis``'s AST tiers over the port and this
   script, its protocol tier's five models over the port's fleet
   functions, and its device tier's programs run on the card — B1 in
   ``ops.pallas_attribution`` and ``packed.pallas_dense`` (once per
   shard), B2 in ``window.fused_pallas``, the row scatter in the
   ``window.update`` entries, the hi/lo split in ``trainer.train_step`` —
   each case's fingerprint against the same case run on the CPU (its
   bf16 products on the card's route), the kernel cases' outputs
   bit-equal to their plain versions;
16. the Aggregator's whole-mesh programs per node block (``main_mesh``,
   phase ``mesh``), on 8 virtual shards of the card as an 8-shard
   ``node`` mesh and a 4 × 2 ``node × model`` mesh (one block per node
   row, on its first shard): the fused tier (path 3's ratio schedule, K =
   4, pallas) on both meshes — B2 once per node block per flush, every
   window bit-equal to the one-shard Aggregator's on the card; the
   temporal window (history 16, 6 windows) on the 8-shard mesh — B1 once
   per block per window; the einsum-serial rung on the 4 × 2 mesh with
   the 50/50 MLP fleet, reached through two injected
   ``device.dispatch_error`` s; and the op shapes of each block's
   program, none of which may hold all 1024 rows;
17. the families across processes (``main_dist``, phase ``dist``): two
   ranks (``torch.multiprocessing``, under a time limit of their own)
   share the card, each owning 4 of an 8-shard ``seq`` mesh, and join
   NCCL through ``initialize_multihost(device="cuda")``. NCCL refuses
   two ranks on one device; its words are printed, and the same two
   ranks run over NCCL with a host id each (``NCCL_HOSTID``), which it
   takes. Each rank runs the pallas ring at path 14's size (B3 for its 4
   shards, 32 launches, then held against its plain version), the ring's
   serving program at f32 and bf16 and one sequence-parallel train step
   with remat; every output against the same mesh in one process (bit-
   equal; bf16 watts within 1e-2 · max|watts|), with each call's wall
   time and the bytes each collective handed to NCCL.

Beside them, the serial rung's MLP program (``make_fleet_program(
model_mode="mlp")``) is held against the CPU at bf16 and in accuracy mode,
and B2 and B3 are timed in each of their forms: B2 per window (K = 1)
and per flush (K = 4, one launch), B3's tensor-core variant against its
KV-tiled variant at bf16, the tiled variant at f32 (accuracy mode), on
the rings' blocks (one score pass on the 128-row blocks, K and V
resident on the 512-row ones), at D = 128 and at D = 512 and 320 (the
wide path), each against the bound of its compute type. The delta update's
row scatter (``kt_scatter_rows``, a repair kernel: the reference's
update is XLA's scatter, not a Pallas kernel) is held bit-equal to its
plain version at N = 16,384 and DB = 8, 512 and 1,024, pads and a
duplicate index included, and timed beside ``index_put_``; every packed
window's update on paths 2, 3, 9, 11 and 13 launches it. The hi/lo split
of a bf16 backward's incoming gradient (``kt_hi_lo``, no TPU kernel) is
held bit-equal to its plain version at the refit cells' five gradient
shapes and timed beside its byte bound; path 10's bf16 train steps, the
DP×TP steps of paths 14 and 17 at bf16 and path 15's train step launch
it, and no f32 step does.

``--phases a,b`` runs only the named phases (of ``PHASES``: ``kernels``,
``ratio``, ``mixed``, ``serial_mlp``, ``aggregator``, ``temporal``,
``train``, ``node``, ``sharded``, ``mesh``, ``chaos``, ``parallel``,
``dist``, ``analysis``), e.g. ``python3 chip_smoke.py --phases parallel``; with no
argument every phase runs. The ``kernels`` line then carries the
launches of the phases that ran, and each kernel's timings only when the
``kernels`` phase ran.

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
# path 5c: the trunk at d_model 512 (4 heads of 128: B3's tiled variant)
# over as many sequences as keep q, k and v at 2.1 GB each
TRUNK_WIDE_D, TRUNK_WIDE_B = 512, 65536
# path 5d: the trunk at d_model 2048 (4 heads of 512: B3's wide path)
# over as many sequences as keep q, k and v at 0.54 GB each
TRUNK_WIDEST_D, TRUNK_WIDEST_B = 2048, 4096
# B3's wide path (D above 256): the kernel rows' head dims (512: path 5d's
# heads; 320: five 64-column chunks, no power of two) over as many
# sequences of T = 16 as path 5d
B3_WIDE_DS, B3_WIDE_B = (512, 320), 4096
# profiler traces taken before a kernel row reports its device ms as not
# whole
DEVICE_MS_TRIES = 10
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


def time_ms(fn, reps: int = 25, batch: int = 20, warm: int = 5) -> float:
    """Median over ``reps`` CUDA-event timings of ``batch`` back-to-back
    calls, per call, after ``warm`` calls (warm: inputs stay resident in
    the 50 MB L2)."""
    for _ in range(warm):
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


def device_ms(fn, calls: int = 20, tries: int = 3,
              match: str | None = None) -> tuple[float | None, int]:
    """Device time of ``fn`` per call from ``torch.profiler``: the sum of
    the CUDA kernels' own time over ``calls`` calls, divided by ``calls``
    (no host time, no gaps). A trace is whole when it holds every kernel
    a multiple of ``calls`` times (each call launches the same kernels);
    one that dropped events is taken again, up to ``tries`` times. → (ms,
    traces taken), ms None when no trace was whole. Given ``match``, only
    the kernels whose name holds it count: work that another thread of
    the process launched inside the window neither adds to the time nor
    spoils the trace."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for n in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = [r for r in kernel_times_us(prof)
                if match is None or match in r[1]]
        if rows and all(count % calls == 0 for _, _, count in rows):
            return sum(us for us, _, _ in rows) / calls / 1e3, n
    return None, tries


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
            ratio, active, power))[0],
        "plain_device_ms": device_ms(lambda: ca.outer_product_attribution_ref(
            ratio, active, power))[0],
        "plain_ms": time_ms(lambda: ca.outer_product_attribution_ref(
            ratio, active, power)),
        "library_ms": time_ms(lambda: (
            torch.einsum("nw,nz->nwz", ratio, active),
            torch.einsum("nw,nz->nwz", ratio, power))),
        "library_device_ms": device_ms(lambda: (
            torch.einsum("nw,nz->nwz", ratio, active),
            torch.einsum("nw,nz->nwz", ratio, power)))[0],
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
            resident, delta, idx, lay))[0],
        "plain_device_ms": device_ms(lambda: ca.fused_window_step_ref(
            resident, delta, idx, lay))[0],
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
        "ms": time_ms(kern), "device_ms": device_ms(kern)[0],
        "plain_ms": time_ms(plain), "plain_device_ms": device_ms(plain)[0],
        "library_ms": None,
        "bound_ms": bound, "bound_by": by, "bound_us": bound * 1e3,
        "bytes": nbytes, "parity": "resident exact, 0 f16 mismatches",
    }
    emit({"phase": "kernel_flush", **row})
    return row


SCATTER_N, SCATTER_DBS = 16_384, (8, 512, 1024)


def scatter_inputs(dev: torch.device, n: int, width: int, db: int):
    """A resident batch, DB delta rows (a NaN slot among them) and their
    target rows: distinct rows, a quarter of them pads (N), one beyond
    the pad value, and two entries naming one row (the later wins)."""
    gen = torch.Generator().manual_seed(SEED + db)
    resident = torch.randn((n, width), generator=gen)
    rows = torch.randn((db, width), generator=gen)
    rows[0, 0] = float("nan")
    idx = torch.randperm(n, generator=gen)[:db].to(torch.int32)
    idx[torch.rand(db, generator=gen) < 0.25] = n
    idx[-1] = n + 7
    if db >= 3:
        idx[2] = idx[1] = 5
    return resident.to(dev), rows.to(dev), idx.to(dev)


def kernel_scatter_rows(dev: torch.device, db: int) -> dict:
    """The delta update's row scatter (a repair kernel) at N = 16,384 and
    the fleet's packed width: resident' bit-equal to the plain version,
    timed beside its byte bound, its plain version and ``index_put_`` of
    the rows that land."""
    from kepler_tpu_torch.ops import cuda_attribution as ca
    from kepler_tpu_torch.ops.attribution import scatter_rows_
    from kepler_tpu_torch.parallel.packed import packed_width

    n, width = SCATTER_N, packed_width(256, len(ZONES))
    resident, rows, idx = scatter_inputs(dev, n, width, db)
    r_kernel, r_plain = resident.clone(), resident.clone()
    before = ca.LAUNCHES["scatter_rows"]
    ca.scatter_rows(r_kernel, rows, idx)
    scatter_rows_(r_plain, rows, idx)
    torch.cuda.synchronize()
    check(ca.LAUNCHES["scatter_rows"] == before + 1,
          "the row scatter did not launch once")
    check(same_bits(r_kernel, r_plain),
          f"the row scatter differs from its plain version at DB={db}")
    err = float((torch.nan_to_num(r_kernel) - torch.nan_to_num(r_plain))
                .abs().max())
    # the rows that land: valid targets, each at its last entry
    host = idx.cpu().numpy()
    last = {int(t): j for j, t in enumerate(host) if 0 <= t < n}
    keep = torch.tensor(sorted(last.values()), dtype=torch.int64,
                        device=dev)
    lands = int(keep.numel())
    nbytes, ops = ca.scatter_rows_cost(db, width, lands)
    bound, by = ca.bound_ms(nbytes, ops)
    target, landing = idx[keep].long(), rows[keep]
    kern = lambda: ca.scatter_rows(resident, rows, idx)  # noqa: E731
    plain = lambda: scatter_rows_(resident, rows, idx)  # noqa: E731
    lib = lambda: resident.index_put_((target,), landing)  # noqa: E731
    r_lib = resident.clone()
    r_lib.index_put_((target,), landing)
    check(same_bits(r_lib, r_plain), "index_put_ of the landing rows "
          "differs from the plain version")
    row = {
        "name": "scatter_rows", "route": "cuda", "kind": "repair kernel",
        "source": "kepler_tpu_torch/ops/csrc/attribution.cu",
        "replaces": "kepler_tpu/fleet/window.py:370 (XLA's scatter "
                    "resident.at[idx].set(rows, mode='drop'); no TPU kernel)",
        "shape": {"N": n, "width": width, "DB": db, "lands": lands},
        "max_abs_err": err, "parity": "bit-equal, pads and a duplicate",
        "ms": time_ms(kern), "device_ms": device_ms(kern)[0],
        "plain_ms": time_ms(plain), "plain_device_ms": device_ms(plain)[0],
        "library_ms": time_ms(lib), "library_device_ms": device_ms(lib)[0],
        "library": "index_put_ of the landing rows (chosen off the clock)",
        "bound_ms": bound, "bound_by": by, "bound_us": bound * 1e3,
        "bytes": nbytes,
    }
    emit({"phase": "kernel_scatter_rows", **row})
    return row


# the incoming gradients a bf16 refit step splits (``models.nn.HalfProduct``)
# in the benchmark's refit cells: the MLP's hidden and output products over
# 9,830,400 labelled rows, and the temporal estimator's K and V over
# 655,360 slots × 16 ticks, its scores and its per-head values
HI_LO_SHAPES = {"temporal_kv": (10_485_760, 128),
                "mlp_hidden": (9_830_400, 128), "mlp_out": (9_830_400, 4),
                "temporal_scores": (655_360, 16, 4),
                "temporal_values": (655_360, 4, 128)}


def kernel_hi_lo(dev: torch.device) -> dict:
    """The backward's hi/lo split (a kernel with no TPU counterpart) at
    the refit cells' gradient shapes: the pair bit-equal to its plain
    version, both timed beside the byte bound (the gradient read once,
    its two bf16 halves written once). → the row at the temporal K/V
    shape, the others under ``by_shape``."""
    from kepler_tpu_torch.ops import cuda_attribution as ca
    from kepler_tpu_torch.ops import hi_lo as hl

    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows: dict = {}
    for name, shape in HI_LO_SHAPES.items():
        g = torch.randn(shape, device=dev, generator=gen)
        g.mul_(torch.randn(shape, device=dev, generator=gen).mul_(4).exp_())
        before = hl.LAUNCHES["hi_lo"]
        got = hl.hi_lo(g, bf)
        want = hl.hi_lo_ref(g, bf)
        torch.cuda.synchronize()
        check(hl.LAUNCHES["hi_lo"] == before + 1,
              "the hi/lo split did not launch once")
        check(same_bits(got, want),
              f"the hi/lo split differs from its plain version at {shape}")
        del got, want
        nbytes = 8 * g.numel()
        bound, by = ca.bound_ms(nbytes, 0)
        kern = lambda: hl.hi_lo(g, bf)  # noqa: E731
        plain = lambda: hl.hi_lo_ref(g, bf)  # noqa: E731
        rows[name] = {
            "shape": {"g": list(shape)}, "max_abs_err": 0.0,
            "ms": time_ms(kern),
            "device_ms": device_ms(kern, tries=DEVICE_MS_TRIES,
                                   match="hi_lo")[0],
            "plain_ms": time_ms(plain),
            "plain_device_ms": device_ms(plain, tries=DEVICE_MS_TRIES)[0],
            "bound_ms": bound, "bound_by": by, "bytes": nbytes}
        del g
        torch.cuda.empty_cache()
    main = rows["temporal_kv"]
    row = {
        "name": "hi_lo", "route": "cuda", "kind": "backward kernel",
        "source": "kepler_tpu_torch/ops/csrc/hi_lo.cu",
        "replaces": "no TPU kernel: the transpose of the reference's "
                    "f32-result dot takes the f32 cotangent as it is",
        **main, "parity": "bit-equal", "by_shape": rows}
    emit({"phase": "kernel_hi_lo", **row})
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


def sdpa_ms(q, k, v, valid, tries: int = 3
            ) -> tuple[float | None, float | None, int, str | None]:
    """``scaled_dot_product_attention`` on the same f32 inputs (causal
    and KV-validity mask) — the yardstick for ``full_attention_pallas``;
    the port never calls it. → (ms, device ms, traces taken, None) or
    (None, None, 0, why it did not run); the device ms from up to
    ``tries`` traces (None where none was whole)."""
    import torch.nn.functional as F

    t = q.shape[1]
    causal = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    mask = valid[:, None, None, :] & causal
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def call():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

    try:
        return (time_ms(call, reps=5, batch=4),
                *device_ms(call, calls=4, tries=tries), None)
    except RuntimeError as err:  # a yardstick only: record why
        return None, None, 0, str(err).splitlines()[0][:200]


def b3_variant_since(before: dict) -> str:
    """The B3 variant of the one launch made since ``before``."""
    now = read_launches()
    grew = [v for v in ("tc", "tiled")
            if now[f"flash_block_{v}"] == before[f"flash_block_{v}"] + 1]
    check(now["flash_block"] == before["flash_block"] + 1 and len(grew) == 1,
          "B3 did not launch exactly once")
    return grew[0]


def b3_plain(q, k, v, valid, q_start: int, kv_start: int,
             cd: torch.dtype, chunk: int | None = None):
    """B3's plain version on the same inputs, in chunks of ``chunk``
    sequences where its [B, H, Tq, Tk] scores would not fit the card."""
    from kepler_tpu_torch.ops import cuda_attention as cat

    chunk = chunk or q.shape[0]
    parts = [cat.flash_block_ref(q[i:i + chunk], k[i:i + chunk],
                                 v[i:i + chunk], valid[i:i + chunk],
                                 q_start, kv_start, compute_dtype=cd)
             for i in range(0, q.shape[0], chunk)]
    return tuple(torch.cat(x) for x in zip(*parts))


def kernel_b3(dev: torch.device, b: int, t: int) -> dict:
    """B3 against its plain version at ``b`` sequences of ``t`` ticks
    (causal, ragged KV mask): the tensor-core variant (bf16, what the
    wrapper selects for the trunk), the KV-tiled variant at bf16 (through
    its plan) and at f32 (what the wrapper selects in accuracy mode),
    timed beside the plain version and SDPA, each against the bound of
    its compute type; at path 5's shape also the block offsets."""
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
    tiled = cat.tiled_plan(b, t, t, d)
    tiled_bf16 = lambda: cat.flash_block_launch(  # noqa: E731
        tiled, q, k, v, valid, 0, 0)
    before = read_launches()
    got = tiled_bf16()
    check(b3_variant_since(before) == "tiled",
          f"B3's tiled plan at T={t}, bf16 did not launch the tiled variant")
    tiled_err = b3_check(got, want, v, bf16, f"B3 (tiled) at B={b}, T={t}")
    del got, want
    before = read_launches()
    got = cat.flash_block_pallas(q, k, v, valid, 0, 0, compute_dtype=f32)
    check(b3_variant_since(before) == "tiled",
          f"B3 at T={t}, f32 did not launch the tiled variant")
    f32_err = b3_check(got, cat.flash_block_ref(
        q, k, v, valid, 0, 0, compute_dtype=f32), v, f32,
        f"B3 (tiled) at f32, T={t}")
    del got
    bound, by = cat.flash_block_bound_ms(q, k, valid, 0, 0)
    bound32, by32 = cat.flash_block_bound_ms(q, k, valid, 0, 0,
                                             compute_dtype=f32)
    kern = lambda: cat.flash_block_pallas(q, k, v, valid, 0, 0)  # noqa: E731
    acc = lambda: cat.flash_block_pallas(  # noqa: E731
        q, k, v, valid, 0, 0, compute_dtype=f32)
    plain = lambda: cat.flash_block_ref(q, k, v, valid, 0, 0)  # noqa: E731
    plain32 = lambda: cat.flash_block_ref(  # noqa: E731
        q, k, v, valid, 0, 0, compute_dtype=f32)
    lib_ms, lib_device_ms, _, lib_err = sdpa_ms(q, k, v, valid)
    row = {
        "name": "flash_block_tc", "route": "cuda",
        "source": "kepler_tpu_torch/ops/csrc/attention.cu",
        "replaces": "kepler_tpu/ops/pallas_attention.py:77",
        "shape": {"B": b, "Tq": t, "Tk": t, "H": N_HEADS, "D": d,
                  "causal": True, "compute": "bf16",
                  "plan": plan._asdict(), "tiled_plan": tiled._asdict()},
        "max_abs_err": err,
        "ms": time_ms(kern, reps=5, batch=4),
        "device_ms": device_ms(kern, calls=5)[0],
        "tiled_bf16_ms": time_ms(tiled_bf16, reps=5, batch=4),
        "tiled_bf16_device_ms": device_ms(tiled_bf16, calls=5)[0],
        "tiled_bf16_max_abs_err": tiled_err,
        "f32_ms": time_ms(acc, reps=5, batch=4),
        "f32_device_ms": device_ms(acc, calls=5)[0],
        "f32_max_abs_err": f32_err,
        "f32_bound_ms": bound32, "f32_bound_by": by32,
        "plain_ms": time_ms(plain, reps=3, batch=2),
        "plain_device_ms": device_ms(plain, calls=2)[0],
        "f32_plain_ms": time_ms(plain32, reps=3, batch=2),
        "f32_plain_device_ms": device_ms(plain32, calls=2)[0],
        "library_ms": lib_ms, "library_device_ms": lib_device_ms,
        "library": "torch.nn.functional."
        "scaled_dot_product_attention (f32, causal & KV mask)",
        "bound_ms": bound, "bound_by": by,
        "compiled": {"tc": cat.flash_block_info("tc", t, d),
                     "tiled_bf16": cat.flash_block_info("tiled", t, d, bf16),
                     "tiled_f32": cat.flash_block_info("tiled", t, d, f32)},
        "parity": "m, l rtol 1e-5; pv rtol 1e-5 (f32), <= 1e-2 max|v| "
                  "(bf16)",
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


def b3_launch(q, k, v, valid, start: int, cd: torch.dtype, what: str,
              chunk: int | None = None) -> dict:
    """One launch of B3 at a main path's shape (a diagonal block: q and KV
    both from ``start``), on the variant its plan picks, against its
    plain version (in chunks of ``chunk`` sequences), timed beside the
    plain version and SDPA, with the bound of ``cd``."""
    from kepler_tpu_torch.ops import cuda_attention as cat

    b, tq, h, d = q.shape
    plan = cat.flash_block_plan(b, tq, k.shape[1], h, d, cd)
    kern = lambda: cat.flash_block_pallas(  # noqa: E731
        q, k, v, valid, start, start, compute_dtype=cd)
    plain = lambda: b3_plain(q, k, v, valid, start, start, cd,  # noqa: E731
                             chunk)
    before = read_launches()
    got = kern()
    check(b3_variant_since(before) == plan.variant,
          f"{what}: B3 did not launch the {plan.variant} variant")
    err = b3_check(got, plain(), v, cd, what)
    del got
    bound, by = cat.flash_block_bound_ms(q, k, valid, start, start,
                                         compute_dtype=cd)
    kern_ms, kern_traces = device_ms(kern, calls=5, match="flash_block",
                                     tries=DEVICE_MS_TRIES)
    lib_ms, lib_device_ms, lib_traces, lib_err = sdpa_ms(
        q, k, v, valid, tries=DEVICE_MS_TRIES)
    row = {"B": b, "Tq": tq, "Tk": k.shape[1], "H": h, "D": d,
           "q_start": start, "kv_start": start,
           "compute": "bf16" if cd == torch.bfloat16 else "f32",
           "plan": plan._asdict(), "max_abs_err": err,
           "ms": time_ms(kern, reps=5, batch=4),
           "device_ms": kern_ms, "device_ms_traces": kern_traces,
           "plain_ms": time_ms(plain, reps=2, batch=1, warm=1),
           "plain_device_ms": device_ms(plain, calls=1)[0],
           "library_ms": lib_ms, "library_device_ms": lib_device_ms,
           "library_device_ms_traces": lib_traces,
           "bound_ms": bound, "bound_by": by,
           "compiled": cat.flash_block_info(
               plan.variant, k.shape[1] if plan.variant == "tiled" else tq,
               d, cd, path=plan.path)}
    if lib_err is not None:
        row["library_error"] = lib_err
    return row


def kernel_b3_wide(dev: torch.device, cd: torch.dtype) -> dict:
    """B3's tiled variant at path 5c's shape: TRUNK_WIDE_B sequences of
    T = 16, 4 heads of 128 (the trunk at d_model 512)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    shape = (TRUNK_WIDE_B, HISTORY_T, N_HEADS, TRUNK_WIDE_D // N_HEADS)
    q, k, v = (torch.randn(shape, generator=gen, device=dev)
               for _ in range(3))
    valid = ragged_lengths(gen, dev, TRUNK_WIDE_B, HISTORY_T)
    row = b3_launch(q, k, v, valid, 0, cd, f"B3 at D = 128, {str(cd)[6:]}")
    check(row["plan"]["variant"] == "tiled",
          "B3 at D = 128 does not plan the tiled variant")
    emit({"phase": "kernel", "name": "flash_block_tiled", **row})
    del q, k, v, valid
    torch.cuda.empty_cache()
    return row


def kernel_b3_wide_path(dev: torch.device, cd: torch.dtype, d: int) -> dict:
    """B3's wide path (D above 256, in chunks of 64 columns): B3_WIDE_B
    sequences of T = 16, 4 heads of ``d``, causal with a ragged mask,
    against its plain version (at D = 512 the launch path 5d makes)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 43)
    shape = (B3_WIDE_B, HISTORY_T, N_HEADS, d)
    q, k, v = (torch.randn(shape, generator=gen, device=dev)
               for _ in range(3))
    valid = ragged_lengths(gen, dev, B3_WIDE_B, HISTORY_T)
    row = b3_launch(q, k, v, valid, 0, cd, f"B3 at D = {d}, {str(cd)[6:]}")
    check(row["plan"]["variant"] == "tiled"
          and row["plan"]["path"] == "wide",
          f"B3 at D = {d} does not plan the tiled variant's wide "
          f"path: {row['plan']}")
    emit({"phase": "kernel", "name": "flash_block_tiled", **row})
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


def temporal_params(scale: float = 1.0, t_max: int = 128,
                    d_model: int = D_MODEL) -> dict:
    """init_temporal at its default widths (d_model 128, 4 heads; t_max
    128 unless given) from the seed, with a non-zero head (init zeroes
    it); ``scale`` multiplies the head, the skip path and the bias (40
    makes the predictions tens of watts)."""
    from kepler_tpu_torch.models.temporal import init_temporal

    gen = torch.Generator().manual_seed(SEED)
    params = init_temporal(len(ZONES), d_model=d_model, t_max=t_max,
                           generator=gen)
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
    from kepler_tpu_torch.ops import hi_lo as hl

    for table in (ca.LAUNCHES, cat.LAUNCHES, cat.TILED_PATH_LAUNCHES,
                  hl.LAUNCHES):
        for name in table:
            table[name] = 0


def read_launches() -> dict:
    """Every kernel's launch count, and B3's tiled variant's by path as
    ``flash_block_tiled_<path>``."""
    from kepler_tpu_torch.ops import cuda_attention as cat
    from kepler_tpu_torch.ops import cuda_attribution as ca
    from kepler_tpu_torch.ops import hi_lo as hl

    return {**ca.LAUNCHES, **cat.LAUNCHES, **hl.LAUNCHES,
            **{f"flash_block_tiled_{path}": n
               for path, n in cat.TILED_PATH_LAUNCHES.items()}}


def kernels_but_split(launches: dict) -> dict:
    """The kernels of ``launches`` that launched, but for the hi/lo split
    (``ops.hi_lo``), which a bf16 train step's backward on the card
    launches (``models.nn.HalfProduct``) and an f32 one does not."""
    return {k: n for k, n in launches.items() if n and k != "hi_lo"}


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
           "kernel_launches": sum(r[2] for r in rows),
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
          and launches["flash_block_tiled"] == 0,
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
    # path 5b, accuracy mode: the full trunk at f32 over the last
    # window's 262,144 sequences, B3 once on its tiled variant, equals
    # the fast path (the JAX package's own equality, rtol 1e-4)
    batch, hist, tv = saved[-1]
    h, wv, tv_d = inputs(batch, hist, tv)
    f32 = torch.float32
    acc_fn = pallas_attention_fn(compute_dtype=f32)
    reset_launches()
    full, acc_ms = timed_call(lambda: predict_temporal(
        params_d, h, wv, tv_d, compute_dtype=f32, attention_fn=acc_fn))
    acc_launches = read_launches()
    check(acc_launches["flash_block"] == 1
          and acc_launches["flash_block_tiled_one-pass"] == 1,
          f"the accuracy-mode trunk launched B3 {acc_launches['flash_block']}"
          f" times ({acc_launches['flash_block_tiled_one-pass']} on the "
          f"tiled variant's one-pass path), not once")
    fast = predict_temporal(params_d, h, wv, tv_d, compute_dtype=f32)
    check(bool(torch.isfinite(full).all()), "f32 trunk: non-finite watts")
    check(torch.allclose(full, fast, rtol=1e-4, atol=1e-5),
          "f32 full trunk through B3 differs from the fast path by "
          f"{float((full - fast).abs().max())} W")
    worst["f32_vs_fast_path_abs_w"] = float((full - fast).abs().max())
    accuracy = {"sequences": int(h.shape[0] * h.shape[1]),
                "launches": acc_launches, "call_ms": acc_ms,
                "max_abs_err_w_vs_fast_path": worst["f32_vs_fast_path_abs_w"]}
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
           "launches": launches, "worst": worst, "accuracy": accuracy,
           "call_ms_median": statistics.median(call_ms),
           "call_ms_first": call_ms[0], "peak_memory_gb": peak_gb,
           "profile": prof}
    emit(row)
    return row


def main_trunk_wide(dev: torch.device) -> dict:
    """Path 5c: the trunk at d_model = 512 (4 heads of 128) over
    TRUNK_WIDE_B sequences of T = 16, at bf16 and f32, through
    ``pallas_attention_fn`` — B3 once a call on its tiled variant's
    one-pass path — against the same trunk through plain attention and
    against the fast path (:func:`trunk_at_width`)."""
    return trunk_at_width(dev, "main_trunk_wide", TRUNK_WIDE_D,
                          TRUNK_WIDE_B, SEED + 40, "one-pass")


def main_trunk_widest(dev: torch.device) -> dict:
    """Path 5d: the trunk at d_model = 2048 (4 heads of 512) over
    TRUNK_WIDEST_B sequences of T = 16, at bf16 and f32, through
    ``pallas_attention_fn`` — B3 once a call on its tiled variant's wide
    path — against the same trunk through plain attention and against
    the fast path (:func:`trunk_at_width`)."""
    return trunk_at_width(dev, "main_trunk_widest", TRUNK_WIDEST_D,
                          TRUNK_WIDEST_B, SEED + 44, "wide")


def trunk_at_width(dev: torch.device, phase: str, d_model: int, b: int,
                   seed: int, b3_path: str) -> dict:
    """The temporal trunk at ``d_model`` (4 heads) over ``b`` sequences of
    T = 16, at bf16 and f32, through ``pallas_attention_fn``: B3 once a
    call on its tiled variant's ``b3_path``, against the same trunk
    through plain attention (``ops.attention.full_attention``) and
    against the fast path: bf16 within 1e-2 · max|watts|, f32 the
    accuracy-mode bound (rtol 1e-4, atol 1e-5 · max|watts|: predictions
    of tens of watts, f32 sums in another order through wide layers)."""
    from kepler_tpu_torch.models.estimator import params_to
    from kepler_tpu_torch.models.temporal import predict_temporal
    from kepler_tpu_torch.ops.attention import full_attention
    from kepler_tpu_torch.ops.cuda_attention import pallas_attention_fn

    params = params_to(temporal_params(ACC_SCALE, d_model=d_model), dev)
    hist, wv, tv, _ = temporal_inputs(dev, b, HISTORY_T, seed)
    row: dict = {"phase": phase, "d_model": d_model,
                 "head_dim": d_model // N_HEADS, "sequences": b,
                 "history_t": HISTORY_T, "b3_path": b3_path}
    on_path = f"flash_block_tiled_{b3_path}"
    for name, cd in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        fn = pallas_attention_fn(compute_dtype=cd)
        reset_launches()
        out, ms = timed_call(lambda: predict_temporal(
            params, hist, wv, tv, compute_dtype=cd, attention_fn=fn))
        launches = read_launches()
        check(launches["flash_block"] == 1 and launches[on_path] == 1,
              f"the d_model {d_model} trunk ({name}) launched B3 "
              f"{launches['flash_block']} times ({launches[on_path]} on "
              f"the tiled variant's {b3_path} path), not once")

        def plain_attention(q, k, v, t_valid, cd=cd):
            return full_attention(q, k, v, t_valid=t_valid,
                                  compute_dtype=cd)

        plain = predict_temporal(params, hist, wv, tv, compute_dtype=cd,
                                 attention_fn=plain_attention)
        fast = predict_temporal(params, hist, wv, tv, compute_dtype=cd)
        a, p, f = (x.cpu().numpy() for x in (out, plain, fast))
        check(np.isfinite(a).all(),
              f"d_model {d_model} trunk ({name}): non-finite")
        if cd == torch.bfloat16:
            ok_plain, ok_fast = bf16_close(a, p), bf16_close(a, f)
        else:
            atol = 1e-5 * float(np.abs(f).max())
            ok_plain = np.allclose(a, p, rtol=1e-4, atol=atol)
            ok_fast = np.allclose(a, f, rtol=1e-4, atol=atol)
        check(ok_plain, f"d_model {d_model} trunk ({name}) off the trunk "
              f"through plain attention by {float(np.abs(a - p).max())} W")
        check(ok_fast, f"d_model {d_model} trunk ({name}) off the fast "
              f"path by {float(np.abs(a - f).max())} W")
        row[name] = {"launches": launches, "call_ms": ms,
                     "max_abs_err_w_vs_plain_attention":
                         float(np.abs(a - p).max()),
                     "max_abs_err_w_vs_fast_path": float(np.abs(a - f).max()),
                     "max_abs_w": float(np.abs(f).max())}
        del out, plain, fast
    del hist, wv, tv, params
    torch.cuda.empty_cache()
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
    kepler_tpu_torch.cmd.train`` exits 0. The dumps and the serving
    windows launch B1; a bf16 train step's backward launches the hi/lo
    split (``ops.hi_lo``) once for each product it takes to tensor cores
    (``models.nn.HalfProduct``), the same number every step, and linear's,
    which has none, launches nothing."""
    from kepler_tpu_torch.ops import hi_lo as hl
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
            split0 = hl.LAUNCHES["hi_lo"]
            straight = train_cli(base + ["--steps", str(TRAIN_STEPS),
                                         "--out", f"{out}-straight.npz"])
            card_s = time.perf_counter() - t0
            splits = hl.LAUNCHES["hi_lo"] - split0
            check(splits % TRAIN_STEPS == 0
                  and (splits > 0) == (fam != "linear"),
                  f"{fam}: the hi/lo split launched {splits} times in "
                  f"{TRAIN_STEPS} steps")
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
                "hi_lo_per_step": splits // TRAIN_STEPS,
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
                        lambda: eng.dispatch_window(plan))[0]
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


# -- the Aggregator's whole-mesh programs per node block ------------------------

#: the meshes of the ``mesh`` phase: name → (shape, axes), 8 virtual
#: shards of the card each; node blocks are the node rows (8 and 4)
MESH_SHAPES = {"node8": ([8], ("node",)),
               "node4_model2": ([4, 2], ("node", "model"))}
MESH_TEMPORAL_WINDOWS = 6


def card_mesh(dev: torch.device, name: str | None):
    """The named mesh over 8 virtual shards of the card (None: one
    shard, the reference run of each check)."""
    from kepler_tpu_torch.parallel.mesh import make_mesh

    if name is None:
        return make_mesh([1], devices=[dev])
    shape, axes = MESH_SHAPES[name]
    return make_mesh(shape, axes, devices=[dev] * SHARDS)


def keep_calls(agg, method: str, saved: list):
    """Wrap ``agg.<method>``: the arguments of every call that returns
    land in ``saved`` (with the result last)."""
    inner = getattr(agg, method)

    def kept(*args, **kw):
        out = inner(*args, **kw)
        saved.append((args, kw, out))
        return out

    setattr(agg, method, kept)


def same_published(got, ref, what: str, model: str | None = None) -> int:
    """A published window of the mesh run against the one-shard run's, by
    node: ratio rows bit-equal (the f16 plane, or µW on the serial rung;
    node power and energy, cumulative joules); model rows within rtol
    1e-3 (``model="packed"``, atol 1e-3 W) or the bf16 bound
    (``"bf16"``: rtol 1e-2, atol 1e-2 · max|watts|). → ratio rows."""
    from kepler_tpu_torch.parallel.fleet import MODE_MODEL

    check(got.timestamp == ref.timestamp
          and sorted(got.names) == sorted(ref.names),
          f"{what}: another window than the one-shard run's")

    def watts(res, i):
        if res._wl_watts_f16 is not None:
            return res._wl_watts_f16[i].astype(np.float32)
        return res.wl_power_uw[i] * 1e-6

    scale = max((float(np.abs(watts(ref, ref.rows[n])).max(initial=0.0))
                 for n in ref.names if ref.mode[ref.rows[n]] == MODE_MODEL),
                default=0.0)
    n_ratio = 0
    for name in ref.names:
        i, j = got.rows[name], ref.rows[name]
        a, b = watts(got, i), watts(ref, j)
        check(np.isfinite(a).all(), f"{what}: {name} non-finite watts")
        if int(ref.mode[j]) == MODE_MODEL:
            ok = (np.allclose(a, b, rtol=1e-3, atol=1e-3) if model ==
                  "packed" else np.allclose(a, b, rtol=1e-2,
                                            atol=1e-2 * scale))
            check(model is not None and ok, f"{what}: model row {name} off "
                  f"the one-shard run by {float(np.abs(a - b).max())} W")
            continue
        n_ratio += 1
        check(np.array_equal(a, b)
              and np.array_equal(got.node_power_uw[i], ref.node_power_uw[j])
              and np.array_equal(got.node_energy_uj[i],
                                 ref.node_energy_uj[j])
              and np.array_equal(got.node_joules_total[i],
                                 ref.node_joules_total[j]),
              f"{what}: ratio row {name} differs from the one-shard run")
    return n_ratio


@contextlib.contextmanager
def kept_inputs(module, name: str, saved: list):
    """Within: every call of ``module.<name>`` first keeps clones of its
    tensor arguments in ``saved`` (the call may update them in place)."""
    inner = getattr(module, name)

    def kept(*args, **kw):
        saved.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a
                           for a in args))
        return inner(*args, **kw)

    setattr(module, name, kept)
    try:
        yield saved
    finally:
        setattr(module, name, inner)


def blocks_against_plain(kernel, plain, calls: list, rows: int,
                         what: str) -> dict:
    """Each kept per-block call replayed through the kernel's wrapper and
    its plain version on clones of the same inputs: every output bit for
    bit (NaN payloads included) and every call over ``rows`` node rows
    (one block's). → the calls checked and the largest abs error."""
    check(len(calls) > 0, f"{what}: no per-block call was kept")
    err = 0.0
    for args in calls:
        check(args[0].shape[0] == rows,
              f"{what}: a call over {args[0].shape[0]} rows, not {rows}")
        got = kernel(*(a.clone() if isinstance(a, torch.Tensor) else a
                       for a in args))
        want = plain(*(a.clone() if isinstance(a, torch.Tensor) else a
                       for a in args))
        sync()
        for g, w in zip(got, want):
            check(same_bits(g, w), f"{what}: a block's output differs "
                  "from the plain version's")
            diff = (g.float() - w.float()).abs().nan_to_num(0.0)
            err = max(err, float(diff.max()) if diff.numel() else 0.0)
    return {"calls": len(calls), "rows": rows, "max_abs_err": err,
            "parity": "bit-equal"}


def ops_over_rows(fn, n: int) -> dict:
    """Run ``fn`` under ``ops.recorder.OutputShapes`` → how many float
    ops it ran and which returned an axis of ``n`` (the whole batch's
    node rows: none may, each block's program sees its own rows)."""
    from kepler_tpu_torch.ops.recorder import OutputShapes

    with OutputShapes() as rec:
        fn()
        sync()
    wide = [(op, list(s)) for op, s in rec.shapes if n in s]
    check(rec.shapes and not wide,
          f"{len(wide)} ops returned an axis of all {n} rows: {wide[:3]}")
    return {"float_ops": len(rec.shapes), "ops_with_an_axis_of_n": len(wide),
            "largest": max((list(s) for _, s in rec.shapes),
                           key=lambda s: int(np.prod(s)))}


def mesh_fused(dev: torch.device) -> dict:
    """(a) The fused tier through the Aggregator over each mesh: the
    ratio schedule (8 intervals, K = 4, pallas), every published window
    bit-equal to the one-shard Aggregator's on the card, B2 once per
    node block per flush; device and host ms per flush beside the
    one-shard form's; B2 at each block's shapes against its plain
    version."""
    from kepler_tpu_torch.ops import cuda_attribution as ca
    from kepler_tpu_torch.parallel.packed import PackedLayout

    intervals = ratio_frames()
    kw = dict(backend="pallas", model_mode=None, fused_window_k=FUSED_K)

    def run(name):
        agg, _, ticks, published = make_aggregator(
            dev, mesh=card_mesh(dev, name), **kw)
        flushes: list = []
        keep_calls(agg, "_dispatch_fused_flush", flushes)
        legs = []
        reset_launches()
        for _live, frames in intervals:
            ticks[0] += 5.0
            ingest_direct(agg, frames)
            agg.aggregate_once()
            legs.append({k: agg._stats[k] for k in LEG_KEYS})
        sync()
        launches = read_launches()
        check(agg.window_health()["rung_name"] == "packed-fused-scan"
              and len(published) == RATIO_INTERVALS
              and len(flushes) == RATIO_INTERVALS // FUSED_K,
              f"{name}: the fused tier did not publish every interval")
        flush = flushes[-1][0][1]  # (engine, flush, stage_ms)
        timing = {
            "flush_device_ms": device_ms(
                lambda: flush.program(*flush.args))[0],
            "flush_call_ms": time_ms(lambda: flush.program(*flush.args),
                                     reps=5, batch=5),
            "flush_host_ms": [legs[i]["last_dispatch_ms"]
                              for i in range(FUSED_K - 1,
                                             RATIO_INTERVALS, FUSED_K)],
            "legs_ms_per_interval": legs}
        return agg, published, flush, launches, timing

    _, ref, _, _, one = run(None)
    out: dict = {"one_shard": one}
    total: dict = {}
    for name in MESH_SHAPES:
        agg, published, flush, launches, timing = run(name)
        blocks = len(agg._engine_fused._blocks)
        flushes = RATIO_INTERVALS // FUSED_K
        check(launches["fused_window_step"] == blocks * flushes,
              f"{name}: B2 launched {launches['fused_window_step']} times "
              f"for {blocks} node blocks × {flushes} flushes")
        check(launches["outer_product_attribution"] == 0
              and launches["scatter_rows"] == 0
              and launches["flash_block"] == 0,
              f"{name}: the fused tier launched another kernel: {launches}")
        ratio_rows = sum(same_published(got, want, f"fused {name} "
                                        f"interval {t}")
                         for t, (got, want) in enumerate(zip(published,
                                                             ref)))
        timing["structure"] = ops_over_rows(
            lambda: flush.program(*flush.args), N_NODES)
        # B2 at the blocks' own shapes (block-local indices, per-block
        # DB) against its plain version: the flush's residents as they
        # stand, its delta sets
        lay = PackedLayout(agg._engine_fused._key[1], len(ZONES))
        _, residents, rows, idxs = flush.args
        timing["b2_per_block"] = blocks_against_plain(
            lambda r, d, i: ca.fused_window_steps(r, d, i, lay),
            lambda r, d, i: ca.fused_window_steps_ref(r, d, i, lay),
            list(zip(residents, rows, idxs)), N_NODES // blocks,
            f"{name} B2 per block")
        out[name] = {"node_blocks": blocks, "launches": launches,
                     "ratio_rows_bit_equal": ratio_rows, **timing}
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    out["launches"] = total
    return out


def mesh_temporal(dev: torch.device) -> dict:
    """(b) The temporal window (``model: temporal``, history 16, pallas)
    over the 8-shard mesh, 6 windows: B1 once per node block per window,
    ratio rows bit-equal to the one-shard window on the card, model
    watts within the bf16 bound; the program's device ms (its inputs
    already on the card) and the window's host legs beside the
    one-shard form's."""
    from kepler_tpu_torch.fleet import wire
    from kepler_tpu_torch.models.estimator import params_to
    from kepler_tpu_torch.ops import cuda_attribution as ca
    from kepler_tpu_torch.parallel.aggregator_core import (node_blocks,
                                                           put_blocks)

    windows = temporal_schedule()[:MESH_TEMPORAL_WINDOWS]
    frames = [[wire.encode_report_v2(r, ZONES, seq=t + 1, run="r1")
               for r in reports] for t, reports in enumerate(windows)]
    params = temporal_params()

    def run(name):
        agg, _, ticks, published = make_aggregator(
            dev, mesh=card_mesh(dev, name), backend="pallas",
            model_mode="temporal", history_window=HISTORY_T,
            model_params=params)
        saved: list = []
        keep_calls(agg, "_dispatch_legacy", saved)
        legs = []
        reset_launches()
        for batch_frames in frames:
            ticks[0] += 5.0
            ingest_direct(agg, batch_frames)
            check(agg.aggregate_once() is not None,
                  f"{name}: a temporal window did not publish")
            legs.append({k: agg._stats[k] for k in LEG_KEYS})
        sync()
        launches = read_launches()
        last = saved[-1][2]  # the last window's _Pending
        b = last.batch
        mesh = agg._program.mesh
        blocks = put_blocks([b.zone_deltas_uj, b.zone_valid, b.usage_ratio,
                             b.cpu_deltas, b.workload_valid,
                             b.node_cpu_delta, b.dt_s, b.mode,
                             last.feat_hist, last.t_valid], mesh)
        p = [params_to(params, blk.device) for blk in node_blocks(mesh)]

        def call():
            return agg._program(p, *zip(*blocks))

        timing = {"program_profile": profile_top(call),
                  "legs_ms_per_window": legs}
        if name is not None:
            timing["structure"] = ops_over_rows(call, N_NODES)
            # B1 at the blocks' own shapes against its plain version
            with kept_inputs(ca, "outer_product_attribution", []) as b1:
                call()
            timing["b1_per_block"] = blocks_against_plain(
                ca.outer_product_attribution,
                ca.outer_product_attribution_ref, b1,
                N_NODES // len(node_blocks(mesh)), f"{name} B1 per block")
        return len(node_blocks(mesh)), published, launches, timing

    _, ref, _, one = run(None)
    blocks, published, launches, timing = run("node8")
    check(launches["outer_product_attribution"]
          == blocks * MESH_TEMPORAL_WINDOWS,
          f"B1 launched {launches['outer_product_attribution']} times for "
          f"{blocks} node blocks × {MESH_TEMPORAL_WINDOWS} windows")
    check(launches["flash_block"] == 0 and launches["fused_window_step"] == 0,
          f"the temporal window launched B2 or B3: {launches}")
    ratio_rows = sum(same_published(got, want, f"temporal window {t}",
                                    model="bf16")
                     for t, (got, want) in enumerate(zip(published, ref)))
    return {"node_blocks": blocks, "windows": MESH_TEMPORAL_WINDOWS,
            "launches": launches, "ratio_rows_bit_equal": ratio_rows,
            **timing, "one_shard": one}


def mesh_serial(dev: torch.device) -> dict:
    """(c) The einsum-serial rung over the 4 × 2 mesh: the 50/50
    ratio/MLP fleet of ``main_aggregator_mixed`` (pallas, depth 2) with
    two injected ``device.dispatch_error`` s, which walk the window down
    to ``einsum-serial`` and back up, against the one-shard Aggregator
    on the card under the same plan: the same rung timeline, ratio rows
    bit-equal, model rows within 1e-3 on the packed rungs and the bf16
    bound on the serial rung (its bf16 trunk); B1 once per node block in
    every dispatched window."""
    from kepler_tpu_torch import fault
    from kepler_tpu_torch.parallel.aggregator_core import node_blocks

    params = mlp_params(SEED + 4)
    intervals, _ = mixed_intervals(SEED + 4)
    spec = fault.FaultSpec(site="device.dispatch_error", skip=2, count=2)

    def run(name):
        mesh = card_mesh(dev, name)
        agg, _, ticks, published = make_aggregator(
            dev, mesh=mesh, backend="pallas", model_mode="mlp",
            model_params=params, pipeline_depth=2, repromote_after=2)
        packed: list = []
        serial: list = []
        keep_calls(agg, "_dispatch_packed", packed)
        keep_calls(agg, "_dispatch_legacy", serial)
        legs = []
        with fault.installed(fault.FaultPlan([spec])) as plan:
            reset_launches()
            for frames in intervals:
                ticks[0] += 5.0
                ingest_direct(agg, frames)
                agg.aggregate_once()
                legs.append({k: agg._stats[k] for k in LEG_KEYS})
            agg._drain_pipeline()
            sync()
            launches = read_launches()
        check(plan.fired("device.dispatch_error") == 2,
              f"{name}: the injected dispatch errors did not fire twice")
        # every device rung spans the node blocks here: on a one-shard
        # or 2-D mesh the packed-serial rung is rung 0's unsharded
        # engine, as in the reference
        dispatched = len(packed) + len(serial)
        blocks = len(node_blocks(mesh))
        check(launches["outer_product_attribution"] == blocks * dispatched,
              f"{name}: B1 launched {launches['outer_product_attribution']}"
              f" times for {dispatched} windows over {blocks} node blocks")
        timeline = [e["rung_name"] for e in agg._rung_timeline]
        check("einsum-serial" in timeline,
              f"{name}: the ladder never reached einsum-serial: {timeline}")
        return (agg, published, launches, timeline, legs,
                {"dispatched_windows": dispatched,
                 "einsum_serial_windows": len(serial)})

    _, ref, _, ref_timeline, ref_legs, _ = run(None)
    agg, published, launches, timeline, legs, counts = run("node4_model2")
    check(timeline == ref_timeline,
          f"rung timeline {timeline} != one-shard {ref_timeline}")
    check(len(published) == len(ref), "published count differs")
    ratio_rows = sum(same_published(
        got, want, f"serial window {t}",
        model="packed" if got._wl_watts_f16 is not None else "bf16")
        for t, (got, want) in enumerate(zip(published, ref)))
    return {"node_blocks": 4, "launches": launches, "timeline": timeline,
            "ratio_rows_bit_equal": ratio_rows, **counts,
            "legs_ms_per_window": legs, "one_shard_legs_ms_per_window":
            ref_legs}


def mesh_engine_structure(dev: torch.device) -> dict:
    """(d) The unsharded engine over the 4 × 2 mesh under
    ``OutputShapes``: a full pack, then a delta window (the update once
    per node block, block-local indices), each program per block — no
    op returns an axis of all 1024 rows."""
    from kepler_tpu_torch.fleet.window import PackedWindowEngine, fetch_plane
    from kepler_tpu_torch.ops import cuda_attribution as ca
    from kepler_tpu_torch.ops.attribution import scatter_rows_

    params = mlp_params(SEED)
    wins = mixed_windows()[:2]
    eng = PackedWindowEngine(device=card_mesh(dev, "node4_model2"),
                             backend="pallas", model_mode="mlp",
                             node_bucket=N_NODES)
    single = PackedWindowEngine(device=dev, backend="pallas",
                                model_mode="mlp", node_bucket=N_NODES)
    out: dict = {}
    scatters: list = []
    for t, rows in enumerate(wins):
        want = run_windows(single, [rows], params)[0]

        def window():
            plan = eng.plan_window(rows, ZONES, params)
            out[t] = (fetch_plane(eng.dispatch_window(plan)), plan.meta)

        # the engine binds the row scatter when the delta window first
        # needs it: its per-block calls are kept from then on
        with kept_inputs(ca, "scatter_rows", scatters):
            shapes = ops_over_rows(window, N_NODES)
        worst = same_rows(out[t], want, f"2-D engine window {t}")
        out[f"window_{t}"] = {**shapes, "model_rel_vs_one_device": worst}
    res = {k: v for k, v in out.items() if isinstance(k, str)}
    # kt_scatter_rows at the blocks' own shapes against its plain version
    res["scatter_per_block"] = blocks_against_plain(
        lambda r, d, i: (ca.scatter_rows(r, d, i),),
        lambda r, d, i: (scatter_rows_(r, d, i),), scatters,
        N_NODES // 4, "2-D engine scatter per block")
    return res


def main_mesh(dev: torch.device) -> dict:
    """Path 16: the Aggregator's whole-mesh programs per node block, on
    8 virtual shards of the card as an 8-shard ``node`` mesh (8 blocks)
    and a 4 × 2 ``node × model`` mesh (4 blocks, one per node row on its
    first shard): (a) the fused tier, (b) the temporal window, (c) the
    einsum-serial rung, (d) the unsharded engine's op shapes. On one card
    the blocks share the card, so the times measure the overhead of
    blocks, not scaling."""
    t0 = time.perf_counter()
    fused = mesh_fused(dev)
    temporal = mesh_temporal(dev)
    serial = mesh_serial(dev)
    engine = mesh_engine_structure(dev)
    launches: dict = {}
    for part in (fused, temporal, serial):
        for k, v in part["launches"].items():
            launches[k] = launches.get(k, 0) + v
    row = {"phase": "main_mesh", "nodes": N_NODES,
           "workloads": N_WORKLOADS, "zones": len(ZONES),
           "meshes": {k: {"shape": v[0], "axes": list(v[1])}
                      for k, v in MESH_SHAPES.items()},
           "launches": launches, "fused": fused, "temporal": temporal,
           "einsum_serial": serial, "engine_2d": engine,
           "note": "8 virtual shards of one card: overhead of node "
                   "blocks, not scaling",
           "seconds": time.perf_counter() - t0}
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


# the rings of path 14, (shards, compute type): 8 shards at bf16 (B3 on
# tensor cores at 128-row blocks), 2 at bf16 (512-row blocks) and 8 at
# f32, both on B3's tiled variant. Where a shard's block exceeds 128
# rows the einsum reference runs on the first PARALLEL_REF_SEQS
# sequences (its [B, H, T/n, T/n] scores) and B3's plain version in
# chunks of as many.
PARALLEL_RINGS = ((8, torch.bfloat16), (2, torch.bfloat16),
                  (8, torch.float32))
# where each ring's B3 blocks must run: tensor cores (128-row bf16 blocks),
# the tiled variant with K and V resident (512-row bf16 blocks) or in one
# score pass (128-row f32 blocks)
PARALLEL_RING_PATHS = {(8, torch.bfloat16): "tc",
                       (2, torch.bfloat16): "tiled_resident",
                       (8, torch.float32): "tiled_one-pass"}
PARALLEL_REF_SEQS = 256


def parallel_ring(dev: torch.device, n: int, cd: torch.dtype) -> dict:
    """The ring with ``backend="pallas"`` on ``n`` shards at compute type
    ``cd``: n² B3 launches a call, all on the variant B3 plans for the
    T/n-row blocks, against the einsum ring (f32: rtol = atol = 1e-5;
    bf16: B3's bound, 1e-2 · max|v|) and dense ``full_attention`` on
    PARALLEL_DENSE_SEQS sequences; B3 timed at one diagonal launch beside
    its bound, its plain version and SDPA, and in the ring call beside
    the call's bound."""
    from kepler_tpu_torch.ops import cuda_attention as cat
    from kepler_tpu_torch.ops.attention import full_attention
    from kepler_tpu_torch.parallel.ring import make_ring_attention

    b, t, d = PARALLEL_B, PARALLEL_T, D_MODEL // N_HEADS
    t_loc = t // n
    f32 = cd == torch.float32
    name = f"{n} shards, {'f32' if f32 else 'bf16'}"
    plan = cat.flash_block_plan(b, t_loc, t_loc, N_HEADS, d, cd)
    variant, path = plan.variant, PARALLEL_RING_PATHS[n, cd]
    check(path == "_".join(filter(None, (variant, plan.path))),
          f"the ring ({name}) plans B3 {plan}, not {path}")
    gen = torch.Generator(device=dev).manual_seed(
        SEED + 14 + PARALLEL_RINGS.index((n, cd)))
    shape = (b, t, N_HEADS, d)
    q, k, v = (torch.randn(shape, generator=gen, device=dev)
               for _ in range(3))
    valid = ragged_lengths(gen, dev, b, t)
    mesh = parallel_mesh(dev, n)
    ring = make_ring_attention(mesh, backend="pallas", compute_dtype=cd)
    einsum = make_ring_attention(mesh, compute_dtype=cd)

    reset_launches()
    out, first_ms = timed_call(lambda: ring(q, k, v, valid))
    launches = read_launches()
    check(launches["flash_block"] == n * n
          and launches[f"flash_block_{variant}"] == n * n
          and launches[f"flash_block_{path}"] == n * n,
          f"the ring ({name}) launched B3 {launches['flash_block']} times "
          f"({launches[f'flash_block_{path}']} {path}), not {n * n}")
    check(launches["outer_product_attribution"] == 0
          and launches["fused_window_step"] == 0, "the ring ran B1 or B2")
    check(bool(torch.isfinite(out).all()),
          f"the ring's output ({name}) is not finite")
    empty = valid.sum(dim=1) == 0
    check(bool(torch.all(out[empty] == 0)),
          f"the ring ({name}): fully masked sequences are not exactly zero")
    bound_v = 1e-2 * float(v.abs().max())

    def close(got, want, against: str) -> float:
        err = float((got - want).abs().max())
        ok = (torch.allclose(got, want, rtol=1e-5, atol=1e-5) if f32
              else err <= bound_v)
        check(ok, f"pallas ring ({name}) off {against} by {err}")
        return err

    ref_n = b if t_loc <= 128 else PARALLEL_REF_SEQS
    ref = lambda: einsum(q[:ref_n], k[:ref_n], v[:ref_n],  # noqa: E731
                         valid[:ref_n])
    err_einsum = close(out[:ref_n], ref(), "the einsum ring")
    sl = slice(0, PARALLEL_DENSE_SEQS)
    err_dense = close(out[sl], full_attention(
        q[sl], k[sl], v[sl], t_valid=valid[sl], compute_dtype=cd),
        f"dense attention on {PARALLEL_DENSE_SEQS} sequences")
    del out

    ring_ms = time_ms(lambda: ring(q, k, v, valid), reps=3, batch=1)
    einsum_ms = time_ms(ref, reps=3, batch=1)
    prof = profile_top(lambda: ring(q, k, v, valid), match="flash_block")
    ring_bound = 0.0
    for i in range(n):
        qi = q[:, i * t_loc:(i + 1) * t_loc]
        for src in range(n):
            kv = slice(src * t_loc, (src + 1) * t_loc)
            ring_bound += cat.flash_block_bound_ms(
                qi, k[:, kv], valid[:, kv], i * t_loc, src * t_loc,
                compute_dtype=cd)[0]
    # one launch at the per-launch shape: a diagonal block (shard 3's on
    # 8 shards)
    start = min(3, n - 1) * t_loc
    blk = slice(start, start + t_loc)
    qb, kb, vb = (x[:, blk].contiguous() for x in (q, k, v))
    vab = valid[:, blk].contiguous()
    launch = b3_launch(qb, kb, vb, vab, start, cd,
                       f"B3 at the ring's block ({name}), B={b}, "
                       f"T={t_loc}", chunk=PARALLEL_REF_SEQS)
    del q, k, v, valid, qb, kb, vb, vab
    torch.cuda.empty_cache()
    return {"shape": {"B": b, "T": t, "H": N_HEADS, "D": d, "shards": n,
                      "compute": "f32" if f32 else "bf16", "causal": True},
            "launches": launches, "first_call_ms": first_ms,
            "call_ms": ring_ms, "einsum_call_ms": einsum_ms,
            "einsum_sequences": ref_n, "profile": prof,
            "b3_ms_per_call": prof["flash_block_ms"],
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


# the figures PERF.md §5-§6 records for these programs when their trunk
# ran on the whole tensor (NVIDIA H100 80GB HBM3, 700.00 W), printed
# beside this run's
RECORDED_SEQUENCE_CALL_MS = 885.0
RECORDED_TRAIN_STEP_MS, RECORDED_TRAIN_PEAK_GB = 350.0, 44.6
PER_SHARD_B = 512


def parallel_per_shard(dev: torch.device) -> dict:
    """The sequence program's structure on the card: one call at B = 512,
    T = 1024 over 8 shards under the port's op recorder. No op may return
    a float tensor with an axis as long as the sequence (T, or B · T
    flattened): after the split every trunk op sees one shard's T/n
    ticks. The largest recorded shape is printed."""
    from kepler_tpu_torch.models.estimator import params_to
    from kepler_tpu_torch.ops.recorder import OutputShapes
    from kepler_tpu_torch.parallel import make_temporal_program

    b, t, n = PER_SHARD_B, PARALLEL_T, PARALLEL_SHARDS
    params = params_to(temporal_params(ACC_SCALE, t_max=t), dev)
    hist, wv, tv, _ = temporal_inputs(dev, b, t, SEED + 20)
    program = make_temporal_program(parallel_mesh(dev, n))
    with OutputShapes() as rec:
        watts = program(params, hist, wv, tv)
    sync()
    long_axes = [(name, s) for name, s in rec.shapes if t in s or b * t in s]
    check(not long_axes, f"per-shard program: {len(long_axes)} ops return "
          f"an axis of the whole sequence, e.g. {long_axes[:3]}")
    check(bool(torch.isfinite(watts).all()), "per-shard program: non-finite")
    name, largest = max(rec.shapes, key=lambda x: (int(np.prod(x[1])), x[0]))
    del hist, wv, tv, params, watts
    torch.cuda.empty_cache()
    return {"B": b, "T": t, "shards": n, "block_T": t // n,
            "float_ops_recorded": len(rec.shapes),
            "ops_with_a_whole_sequence_axis": len(long_axes),
            "largest_float_output": {"op": name, "shape": list(largest)}}


def whole_trunk_serving(dev: torch.device, params, hist, wv, tv,
                        per_shard: torch.Tensor) -> dict:
    """The sequence program's whole-tensor form on the same inputs: the
    trunk on the whole tensor around the whole-tensor ring (the port's
    ``predict_temporal(..., attention_fn=ring)``), its call time and
    peak device memory beside the per-shard program's, and its watts
    against them (bf16, 1e-2 · max|watts|)."""
    from kepler_tpu_torch.models.temporal import predict_temporal
    from kepler_tpu_torch.parallel import ring_attention_shardmap

    ring = ring_attention_shardmap(parallel_mesh(dev, PARALLEL_SHARDS))
    call = lambda: predict_temporal(params, hist, wv, tv,  # noqa: E731
                                    attention_fn=ring)
    sync()
    torch.cuda.reset_peak_memory_stats()
    got, ms = timed_call(call)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _, warm_ms = timed_call(call)
    a, r = per_shard.cpu().numpy(), got.cpu().numpy()
    check(bf16_close(a, r), f"per-shard program off the whole-tensor "
          f"trunk by {float(np.abs(a - r).max())} W")
    del got
    torch.cuda.empty_cache()
    return {"call_ms": ms, "warm_call_ms": warm_ms, "peak_gb": peak_gb,
            "max_abs_err_w_vs_per_shard": float(np.abs(a - r).max())}


def parallel_temporal(dev: torch.device) -> dict:
    """The sequence-parallel program (einsum ring, 8 shards) at B = 4096,
    T = 1024 and the Ulysses program (4 shards) at B = 512 against the
    single-query dense path, each with its call time and peak device
    memory, the sequence program beside the whole-tensor trunk; then
    the sequence-parallel train step with remat against the whole-tensor
    trunk's step and the single-device train step."""
    from kepler_tpu_torch.models import train
    from kepler_tpu_torch.models.estimator import params_to
    from kepler_tpu_torch.models.temporal import predict_temporal
    from kepler_tpu_torch.parallel import (make_sequence_parallel_train_step,
                                           make_temporal_program,
                                           make_ulysses_temporal_program,
                                           ring_attention_shardmap)

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
        sync()
        torch.cuda.reset_peak_memory_stats()
        base_gb = torch.cuda.memory_allocated() / 1e9
        got, ms = timed_call(lambda: program(params, hist, wv, tv))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        launches = read_launches()
        check(not any(launches.values()), f"{label}: a kernel launched "
              f"({launches}); JAX's program runs none")
        _, warm_ms = timed_call(lambda: program(params, hist, wv, tv))
        want, dense_ms = timed_call(
            lambda: predict_temporal(params, hist, wv, tv))
        a, r = got.cpu().numpy(), want.cpu().numpy()
        check(np.isfinite(a).all(), f"{label}: non-finite watts")
        check(bf16_close(a, r), f"{label} program off the dense path by "
              f"{float(np.abs(a - r).max())} W")
        out[label] = {"B": b, "T": t, "call_ms": ms, "warm_call_ms": warm_ms,
                      "peak_gb": peak_gb, "inputs_and_params_gb": base_gb,
                      "dense_ms": dense_ms,
                      "max_abs_err_w": float(np.abs(a - r).max()),
                      "max_w": float(np.abs(r).max()), "launches": launches}
        if label == "sequence":
            out[label]["recorded_whole_trunk_call_ms"] = \
                RECORDED_SEQUENCE_CALL_MS
            out[label]["whole_trunk"] = whole_trunk_serving(
                dev, params, hist, wv, tv, got)
        del hist, wv, tv, got, want, program
        torch.cuda.empty_cache()

    b = PARALLEL_TRAIN_B
    hist, wv, tv, targets = temporal_inputs(dev, b, t, SEED + 3)
    runs = {}
    for label, step in (
            ("sp_remat", make_sequence_parallel_train_step(
                parallel_mesh(dev, PARALLEL_SHARDS), remat=True)),
            # the whole-tensor trunk around the ring
            ("whole_trunk_remat", train.make_temporal_train_step(
                torch.float32, remat=True,
                attention_fn=ring_attention_shardmap(
                    parallel_mesh(dev, PARALLEL_SHARDS),
                    compute_dtype=torch.float32))),
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
                       "params": {k: v.detach().clone()
                                  for k, v in state.params.items()}}
        if label != "one_shard":  # one more step: its device time
            runs[label]["profile"] = profile_top(
                lambda: step(state, hist, wv, tv, targets), k=4)
        del state
        torch.cuda.empty_cache()
    sp, one = runs["sp_remat"], runs["one_shard"]
    whole = runs["whole_trunk_remat"]
    whole_rel = float(np.max(np.abs(np.asarray(whole["losses"])
                                    / np.asarray(sp["losses"]) - 1)))
    check(whole_rel <= TRAIN_F32_RTOL, f"SP losses off the whole-tensor "
          f"trunk's by {whole_rel}")
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
        "step_profile": sp["profile"],
        "one_shard_ms_per_step": one["ms_per_step"],
        "peak_gb": sp["peak_gb"], "one_shard_peak_gb": one["peak_gb"],
        "recorded_whole_trunk_ms_per_step": RECORDED_TRAIN_STEP_MS,
        "recorded_whole_trunk_peak_gb": RECORDED_TRAIN_PEAK_GB,
        "whole_trunk": {"ms_per_step": whole["ms_per_step"],
                        "step_profile": whole["profile"],
                        "peak_gb": whole["peak_gb"],
                        "max_loss_rel_vs_per_shard": whole_rel}}
    del hist, wv, tv, targets, runs, sp, one, whole, params
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
            launches = read_launches()
            check(not kernels_but_split(launches)
                  and (launches["hi_lo"] > 0) == (cd == torch.bfloat16),
                  f"trainer ({name}): launched {launches}")
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
    rotation; on 8 shards at bf16 through tensor cores, on 2 shards at
    bf16 and on 8 at f32 through the tiled variant), sequence
    parallelism (serving and training), Ulysses,
    the GPipe pipeline, expert parallelism and the DP×TP trainer."""
    t_phase = time.perf_counter()
    row = {"phase": "main_parallel", "rings": {
        f"{n}_shards_{str(cd)[6:]}": parallel_ring(dev, n, cd)
        for n, cd in PARALLEL_RINGS}}
    row["per_shard"] = parallel_per_shard(dev)
    row.update(parallel_temporal(dev))
    row.update(parallel_rows(dev))
    row["trainer"] = parallel_trainer(dev)
    row["seconds"] = time.perf_counter() - t_phase
    emit(row)
    return row


# -- the families across processes (path 17) -----------------------------------

# two ranks on the one card, each owning half of a mesh's shards: in
# blocks (of 8: 0-3, 4-7) for the sequence programs, the pipeline and the
# experts, interleaved (shard k on rank k % 2) for the DP×TP step, so
# that every node row spans both ranks; each spawn under a time limit of
# its own
DIST_RANKS = 2
DIST_ATTEMPT_S, DIST_RUN_S = 150, 480
DIST_SEED = SEED + 30
DIST_TRAIN_STEPS = 2  # DP×TP steps per dtype
#: the calls of :func:`dist_rows` held bit-equal to one process
DIST_ROW_CALLS = ("pipeline", "expert_explicit", "expert_top1", "dp_tp_bf16",
                  "dp_tp_f32")


def dist_mesh(dev: torch.device, ranks: int | None,
              n: int = PARALLEL_SHARDS, axes=("seq",), shape=None,
              interleaved: bool = False):
    """n shards of ``dev`` as a mesh over ``axes``: this process's
    (``ranks=None``), or ``ranks`` ranks' in blocks (shard k on rank
    k · ranks // n) or ``interleaved`` (on rank k % ranks)."""
    from kepler_tpu_torch.parallel.mesh import Shard, make_mesh

    shards = ([dev] * n if ranks is None else
              [Shard(dev, k % ranks if interleaved else k * ranks // n)
               for k in range(n)])
    return make_mesh(list(shape or [n]), list(axes), devices=shards)


def digest(x: torch.Tensor) -> list[int]:
    """Two wrapping int64 sums over ``x``'s 32-bit words, plain and
    position-weighted: two runs with equal digests hold (short of a
    collision) the same bits. In slices, to bound the memory."""
    words = x.detach().contiguous().view(torch.int32).reshape(-1)
    total = weighted = 0
    step = 1 << 25
    for at in range(0, words.numel(), step):
        w = words[at:at + step].to(torch.int64)
        pos = torch.arange(at, at + w.numel(), device=w.device) % 65521 + 1
        total += int(w.sum())
        weighted += int((w * pos).sum())
    return [total % (1 << 64), weighted % (1 << 64)]


def dist_calls(dev: torch.device, ranks: int | None) -> dict:
    """The dist phase's calls on :func:`dist_mesh` → each call's wall ms,
    B3 launches and bytes by collective, and what it returned: the
    pallas ring at B = 4096, T = 1024 (as a :func:`digest`; on a rank, B3
    then held against its plain version on the diagonal block of the
    rank's first shard), the ring's serving program at f32 and bf16 on
    the same B and T, one sequence-parallel train step with remat at
    B = 512 (loss, gradients, updated params), then at the parallel
    phase's width (:func:`dist_rows`) the pipelined deep, expert
    parallelism and the DP×TP step."""
    from kepler_tpu_torch.models import train
    from kepler_tpu_torch.models.estimator import params_to
    from kepler_tpu_torch.ops import cuda_attention as cat
    from kepler_tpu_torch.parallel import (local_shards, make_ring_attention,
                                           make_sequence_parallel_train_step,
                                           make_temporal_program)
    from kepler_tpu_torch.parallel import collectives as col

    mesh = dist_mesh(dev, ranks)
    out: dict = {"calls": {}}

    def call(label: str, fn):
        col.reset_crossing()
        reset_launches()
        res, ms = timed_call(fn)
        out["calls"][label] = {
            "ms": ms, "launches": read_launches(),
            "bytes": {k: v["bytes"] for k, v in col.CROSSING.items()},
            "crossings": {k: v["calls"] for k, v in col.CROSSING.items()}}
        return res

    b, t, n = PARALLEL_B, PARALLEL_T, PARALLEL_SHARDS
    gen = torch.Generator(device=dev).manual_seed(DIST_SEED)
    q, k, v = (torch.randn((b, t, N_HEADS, D_MODEL // N_HEADS),
                           generator=gen, device=dev) for _ in range(3))
    valid = ragged_lengths(gen, dev, b, t)
    ring = make_ring_attention(mesh, backend="pallas")
    got = call("ring_b3", lambda: ring(q, k, v, valid))
    check(bool(torch.isfinite(got).all()), "dist ring: non-finite output")
    out["ring_b3_digest"] = digest(got)
    del got
    if ranks is not None:
        t_loc = t // n
        blk = slice(local_shards(mesh)[0] * t_loc,
                    (local_shards(mesh)[0] + 1) * t_loc)
        qb, kb, vb = (x[:, blk].contiguous() for x in (q, k, v))
        vab = valid[:, blk].contiguous()
        start = blk.start
        out["b3_max_abs_err"] = b3_check(
            cat.flash_block_pallas(qb, kb, vb, vab, start, start),
            cat.flash_block_ref(qb, kb, vb, vab, start, start), vb,
            torch.bfloat16, f"B3 on rank {torch.distributed.get_rank()}'s "
            "diagonal block")
        del qb, kb, vb, vab
    del q, k, v, valid
    torch.cuda.empty_cache()

    params = params_to(temporal_params(ACC_SCALE, t_max=t), dev)
    hist, wv, tv, _ = temporal_inputs(dev, b, t, DIST_SEED + 1)
    for cd, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        program = make_temporal_program(mesh, compute_dtype=dtype)
        out[f"serve_{cd}"] = call(f"serve_{cd}", lambda: program(
            params, hist, wv, tv)).cpu()
    del hist, wv, tv
    torch.cuda.empty_cache()

    hist, wv, tv, targets = temporal_inputs(dev, PARALLEL_TRAIN_B, t,
                                            DIST_SEED + 2)
    state = train.create_train_state(params, train.make_optimizer(1e-3))
    step = make_sequence_parallel_train_step(mesh, remat=True)
    state, loss = call("train_step", lambda: step(state, hist, wv, tv,
                                                  targets))
    out["train_loss"] = loss.cpu()
    out["train_params"] = {key: p.detach().cpu()
                           for key, p in state.params.items()}
    out["train_grads"] = {key: p.grad.cpu()
                          for key, p in state.params.items()}
    del hist, wv, tv, targets, state, params
    torch.cuda.empty_cache()
    out.update(dist_rows(dev, ranks, call))
    return out


def dist_rows(dev: torch.device, ranks: int | None, call) -> dict:
    """The families over rows, as :func:`parallel_rows` and
    :func:`parallel_trainer` run them, through ``call`` (which times
    each and counts its bytes): the pipelined deep (4 stages in blocks, 4
    microbatches, D = 128) and expert parallelism (8 experts on 8 shards
    in blocks; explicit ids and learned top-1) over PARALLEL_ROWS rows,
    then DIST_TRAIN_STEPS DP×TP steps per dtype on the 4 × 2 grid
    interleaved, every node row across the ranks (features [N_NODES,
    256, 7]) → each output, loss and gathered param, on the host."""
    from kepler_tpu_torch.models import train
    from kepler_tpu_torch.models.estimator import params_to
    from kepler_tpu_torch.models.mlp import init_mlp
    from kepler_tpu_torch.parallel import (gather_params,
                                           make_distributed_train_step,
                                           make_expert_parallel_moe,
                                           make_pipelined_deep,
                                           shard_train_state, top1_route)

    out: dict = {}
    gen = torch.Generator(device=dev).manual_seed(DIST_SEED + 3)
    rows = PARALLEL_ROWS
    feats = torch.rand((rows, 7), generator=gen, device=dev)
    valid = torch.rand((rows,), generator=gen, device=dev) > 0.1
    deep = params_to(single_tick_params("deep", DIST_SEED + 4), dev)
    pipe = make_pipelined_deep(dist_mesh(dev, ranks, 4, ("stage",)),
                               n_microbatches=4)
    out["pipeline"] = call("pipeline", lambda: pipe(deep, feats,
                                                    valid)).cpu()
    moe = params_to(single_tick_params("moe", DIST_SEED + 5), dev)
    ep = make_expert_parallel_moe(dist_mesh(dev, ranks, PARALLEL_SHARDS,
                                            ("expert",)))
    eid = torch.randint(0, 8, (rows,), generator=gen, device=dev,
                        dtype=torch.int32)
    for label, route in (("expert_explicit",
                          (eid, torch.ones(rows, device=dev))),
                         ("expert_top1", top1_route(moe, feats))):
        out[label] = call(label, lambda: ep(moe, feats, *route)).cpu()
    del feats, valid, deep, moe, eid
    torch.cuda.empty_cache()

    tfeats = torch.rand((N_NODES, 256, 7), generator=gen, device=dev) * 3
    tvalid = torch.rand((N_NODES, 256), generator=gen, device=dev) > 0.2
    targets = tfeats[..., :1] * torch.tensor([4.0, 2.0, 1.0, 0.5],
                                             device=dev) * 10
    mlp = init_mlp(len(ZONES), generator=torch.Generator().manual_seed(
        DIST_SEED + 6), device=dev)
    grid = dist_mesh(dev, ranks, PARALLEL_SHARDS, ("node", "model"), (4, 2),
                     interleaved=True)
    for cd, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        state = shard_train_state(train.create_train_state(
            mlp, train.make_optimizer(float(TRAIN_LR))), grid)
        step = make_distributed_train_step(grid, compute_dtype=dtype)
        losses = []
        for s in range(DIST_TRAIN_STEPS):
            state, loss = call(f"dp_tp_{cd}_step{s}", lambda: step(
                state, tfeats, tvalid, targets))
            losses.append(loss.cpu())
        out[f"dp_tp_{cd}"] = {"losses": torch.stack(losses),
                              **{k: v.cpu() for k, v in
                                 gather_params(state).items()}}
    del tfeats, tvalid, targets, mlp, state
    torch.cuda.empty_cache()
    return out


def dist_rank(rank: int, world: int, addr: str, host_ids: bool,
              prefix: str) -> None:
    """One rank of the dist phase (``torch.multiprocessing``): join NCCL
    on the card (``host_ids``: each rank first names itself a host of its
    own, ``NCCL_HOSTID``), run :func:`dist_calls` over the ranks' mesh,
    and write what it got, or what failed, to ``{prefix}-rank{rank}.pt``."""
    result: dict = {"rank": rank}
    try:
        if host_ids:
            os.environ["NCCL_HOSTID"] = f"kepler-dist-rank-{rank}"
        from kepler_tpu_torch.parallel.mesh import initialize_multihost

        dev = torch.device("cuda", 0)
        t0 = time.perf_counter()
        initialize_multihost(coordinator_address=addr, num_processes=world,
                             process_id=rank, init_timeout=60, device=dev)
        result["join_s"] = time.perf_counter() - t0
        result["backend"] = str(torch.distributed.get_backend())
        result.update(dist_calls(dev, world))
        torch.distributed.destroy_process_group()
    except Exception as err:  # the parent reads and reports it
        result["error"] = f"{type(err).__name__}: {err}"[-3000:]
    torch.save(result, f"{prefix}-rank{rank}.pt")


def dist_spawn(host_ids: bool, tmp: str, limit_s: float) -> list[dict]:
    """:func:`dist_rank` on DIST_RANKS processes, all killed at
    ``limit_s`` → each rank's result (a rank that died or ran out of time
    reads as an error)."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        addr = f"127.0.0.1:{sock.getsockname()[1]}"
    prefix = os.path.join(tmp, "host-ids" if host_ids else "plain")
    ctx = mp.spawn(dist_rank, args=(DIST_RANKS, addr, host_ids, prefix),
                   nprocs=DIST_RANKS, join=False)
    deadline = time.monotonic() + limit_s
    failure = None
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                failure = f"no result within {limit_s} s"
                break
    except Exception as err:  # a rank exited with an error code
        failure = f"{type(err).__name__}: {err}"
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join()
    results = []
    for rank in range(DIST_RANKS):
        path = f"{prefix}-rank{rank}.pt"
        results.append(torch.load(path, weights_only=False)
                       if os.path.exists(path) else
                       {"rank": rank, "error": failure or "no result"})
    return results


def main_dist(dev: torch.device) -> dict:
    """Path 17: the families across processes. Two ranks share the card,
    each owning 4 of the 8 shards, over NCCL (``initialize_multihost(
    device="cuda")``). NCCL refuses two ranks on one device in this
    build; that refusal is printed as it came, and the same two ranks
    run over NCCL with a host id each, which makes NCCL take them (its
    traffic then goes through its socket transport on the host's
    loopback, not NVLink: correctness and overhead only). Their calls
    (:func:`dist_calls`) against the same mesh in one process: the ring
    and the f32 serving program and train step bit-equal, the bf16
    serving program within 1e-2 · max|watts|, B3 launched for each
    rank's 4 shards (32 a rank) and held against its plain version; the
    pipelined deep, both expert routings and the DP×TP steps' losses and
    gathered params bit-equal, with no kernel launched."""
    t_phase = time.perf_counter()
    one = dist_calls(dev, None)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        plain = dist_spawn(False, tmp, DIST_ATTEMPT_S)
        refusal = None
        if any("error" in r for r in plain):
            refusal = [r.get("error", "joined") for r in plain]
            emit({"phase": "main_dist", "nccl_two_ranks_one_card":
                  "refused", "said": refusal})
            ranks = dist_spawn(True, tmp, DIST_RUN_S)
        else:
            ranks = plain
    transport = ("nccl, a host id each (NCCL_HOSTID)" if refusal
                 else "nccl")
    for r in ranks:
        check("error" not in r, f"dist rank {r['rank']} over {transport}: "
              f"{r.get('error')}")
        check("nccl" in r["backend"], f"rank {r['rank']} joined "
              f"{r['backend']}, not NCCL")
    per = PARALLEL_SHARDS * PARALLEL_SHARDS // DIST_RANKS
    for r in ranks:
        got = r["calls"]["ring_b3"]["launches"]
        check(got["flash_block"] == per and got["flash_block_tc"] == per,
              f"rank {r['rank']} launched B3 {got['flash_block']} times "
              f"({got['flash_block_tc']} on tensor cores), not {per}")
        check(r["ring_b3_digest"] == one["ring_b3_digest"],
              f"rank {r['rank']}'s ring output differs from one process's")
        check(same_bits(r["serve_f32"], one["serve_f32"]),
              f"rank {r['rank']}'s f32 watts differ from one process's")
        bound = 1e-2 * float(one["serve_bf16"].abs().max())
        err = float((r["serve_bf16"] - one["serve_bf16"]).abs().max())
        check(err <= bound, f"rank {r['rank']}'s bf16 watts off one "
              f"process's by {err} (> {bound})")
        check(same_bits(r["train_loss"], one["train_loss"])
              and all(same_bits(r[f][key], one[f][key])
                      for f in ("train_params", "train_grads")
                      for key in one[f]),
              f"rank {r['rank']}'s train step differs from one process's")
        for label in DIST_ROW_CALLS:
            check(same_bits(r[label], one[label]) if torch.is_tensor(
                one[label]) else all(same_bits(r[label][key], val)
                                     for key, val in one[label].items()),
                  f"rank {r['rank']}'s {label} differs from one process's")
        for label, row in r["calls"].items():
            split = row["launches"]["hi_lo"] > 0  # a bf16 backward
            check(label == "ring_b3"
                  or (not kernels_but_split(row["launches"])
                      and split == label.startswith("dp_tp_bf16")),
                  f"rank {r['rank']}'s {label} launched {row['launches']}")
    launches = {key: sum(r["calls"]["ring_b3"]["launches"][key]
                         for r in ranks)
                for key in ranks[0]["calls"]["ring_b3"]["launches"]}
    row = {"phase": "main_dist", "ranks": DIST_RANKS,
           "shards_per_rank": PARALLEL_SHARDS // DIST_RANKS,
           "transport": transport, "nccl_refusal": refusal,
           "backend": ranks[0]["backend"],
           "join_s": [r["join_s"] for r in ranks],
           "gpu": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True, text=True,
               check=True, timeout=60).stdout.strip(),
           "shapes": {"ring_and_serving": {"B": PARALLEL_B,
                                           "T": PARALLEL_T},
                      "train_step": {"B": PARALLEL_TRAIN_B,
                                     "T": PARALLEL_T, "remat": True},
                      "pipeline": {"rows": PARALLEL_ROWS, "stages": 4,
                                   "microbatches": 4, "D": D_MODEL,
                                   "layout": "blocks"},
                      "experts": {"rows": PARALLEL_ROWS, "experts": 8,
                                  "shards": PARALLEL_SHARDS,
                                  "layout": "blocks"},
                      "dp_tp": {"grid": [4, 2], "batch": [N_NODES, 256, 7],
                                "steps_per_dtype": DIST_TRAIN_STEPS,
                                "layout": "interleaved: every node row "
                                          "across the ranks"}},
           "calls": {label: {"one_process_ms": one["calls"][label]["ms"],
                             "ms_by_rank": [r["calls"][label]["ms"]
                                            for r in ranks],
                             "bytes_by_rank": [r["calls"][label]["bytes"]
                                               for r in ranks],
                             "crossings_by_rank": [
                                 r["calls"][label]["crossings"]
                                 for r in ranks]}
                     for label in one["calls"]},
           "b3_max_abs_err_by_rank": [r["b3_max_abs_err"] for r in ranks],
           "bf16_max_abs_err_w": max(float(
               (r["serve_bf16"] - one["serve_bf16"]).abs().max())
               for r in ranks),
           "bf16_bit_equal": all(same_bits(r["serve_bf16"],
                                           one["serve_bf16"])
                                 for r in ranks),
           "launches": launches,
           "seconds": time.perf_counter() - t_phase}
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
    process (whose bf16 products take the card's route,
    ``models.nn.card_route``), its kernels and collectives
    equal to the committed snapshot (a histogram drift, a torch-version
    effect, is printed), and the kernel entries' outputs (B1, B2, the row
    scatter) bit-equal to their plain versions on the same inputs; the
    train step's entry launches the hi/lo split."""
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
          and row["launches"]["fused_window_step"] >= 1
          and row["launches"]["scatter_rows"] >= 1
          and row["launches"]["hi_lo"] >= 1,
          f"device tier launched {row['launches']}")
    row["cases"] = len(cuda_reports)
    row["kernel_cases_bit_equal"] = kernel_cases
    row["snapshot_drift_cases"] = sorted(drift)
    if drift:
        emit({"phase": "main_analysis_snapshot_drift",
              "torch": torch.__version__, "drift": drift})
    emit(row)
    return row


PHASES = ("kernels", "ratio", "mixed", "serial_mlp", "aggregator",
          "temporal", "train", "node", "sharded", "mesh", "chaos",
          "parallel", "dist", "analysis")


def parse_phases(argv: list[str]) -> list[str]:
    """``--phases a,b`` → the phases to run, in the script's order; no
    argument: all of them (what the chip check runs)."""
    import argparse

    parser = argparse.ArgumentParser(description="Chip smoke test of the "
                                     "PyTorch/CUDA port.")
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma list of phases to run, of: "
                        + ", ".join(PHASES) + " (default: all)")
    asked = [p for p in parser.parse_args(argv).phases.split(",") if p]
    unknown = sorted(set(asked) - set(PHASES))
    if unknown:
        parser.error(f"unknown phases {unknown}; known: {', '.join(PHASES)}")
    return [p for p in PHASES if p in asked]


def launches_of(rows: dict, name: str) -> dict:
    """``name``'s launches by path, from the rows of the phases that ran
    (each row's ``launches``, counted from 0 over its main path)."""
    return {path: row["launches"][name] for path, row in rows.items()
            if row.get("launches", {}).get(name)}


def kernel_line(row: dict | None, name: str, by_path: dict,
                **extra) -> dict:
    """One kernel's entry of the ``kernels`` line: its measured row (the
    ``kernels`` phase) with its launches on the paths that ran."""
    keys = ("name", "route", "kind", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_device_ms", "device_ms",
            "plain_device_ms", "shape", "by_db", "by_k", "by_shape",
            "launches_by_path", "launches_by_variant",
            "launches_by_kernel_path")
    out = dict(row or {"name": name}, **extra)
    out["launches_by_path"] = by_path
    out["launches"] = sum(by_path.values())
    return {k: out[k] for k in keys if k in out}


def main(argv: list[str] | None = None) -> int:
    phases = parse_phases(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if here not in sys.path:
        sys.path.insert(0, here)
    from kepler_tpu_torch.device import resolve_device
    from kepler_tpu_torch.ops import build
    from kepler_tpu_torch.ops import cuda_attention as cat

    dev = resolve_device("cuda")
    t_script = time.perf_counter()
    smi = provenance()
    emit({"phase": "phases", "run": phases})
    t0 = time.perf_counter()
    libs = build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {k: os.path.basename(str(v)) for k, v in libs.items()},
          "flags": list(build.NVCC_FLAGS)})

    on = set(phases)
    laps: dict = {}  # wall seconds of each phase that ran
    mark = [time.perf_counter()]

    def lap(name: str) -> None:
        """Charge the wall time since the last lap to phase ``name``."""
        now = time.perf_counter()
        if name in on:
            laps[name] = laps.get(name, 0.0) + now - mark[0]
        mark[0] = now

    r: dict = {}  # the rows of the phases that ran, by path
    b1 = b2_flush = None
    b2_rows: dict = {}
    b3_rows: list = []
    b3_wide: dict = {}
    b3_widepath: dict = {}
    scatter_rows: dict = {}
    hi_lo_row = None
    if "kernels" in on:
        b1 = kernel_b1(dev)
        b2_rows = {db: kernel_b2(dev, db) for db in (8, N_NODES)}
        b3_rows = [kernel_b3(dev, b, t) for b, t in B3_SHAPES]
        b3_wide = {str(cd)[6:]: kernel_b3_wide(dev, cd)
                   for cd in (torch.bfloat16, torch.float32)}
        b3_widepath = {(d, str(cd)[6:]): kernel_b3_wide_path(dev, cd, d)
                       for d in B3_WIDE_DS
                       for cd in (torch.bfloat16, torch.float32)}
        scatter_rows = {db: kernel_scatter_rows(dev, db)
                        for db in SCATTER_DBS}
        hi_lo_row = kernel_hi_lo(dev)
    lap("kernels")
    main_db = 512  # the ratio schedule's flush DB, when it does not run
    if "ratio" in on:
        r["main_ratio_fused"] = main_ratio(dev)
        main_db = r["main_ratio_fused"]["flushes"][-1]["db"]
    lap("ratio")
    if "kernels" in on:
        if main_db not in b2_rows:
            b2_rows[main_db] = kernel_b2(dev, main_db)
        b2_flush = kernel_b2_flush(dev, FUSED_K, main_db)
    lap("kernels")
    if "mixed" in on:
        r["main_mixed"] = main_mixed(dev)
    lap("mixed")
    if "serial_mlp" in on:
        main_serial_mlp(dev)
    lap("serial_mlp")
    if "aggregator" in on:
        r["main_aggregator_fused"] = main_aggregator_fused(dev)
        r["main_aggregator_mixed"] = main_aggregator_mixed(dev)
        main_aggregator_cmd()
        models = main_aggregator_models(dev)
        r["main_aggregator_models_moe"] = models["moe"]
        r["main_aggregator_models_deep"] = models["deep"]
    lap("aggregator")
    if "temporal" in on:
        fleet, saved, params, outs = main_temporal_fleet(dev)
        r["main_temporal_fleet"] = fleet
        r["main_temporal_trunk"] = main_temporal_trunk(dev, saved, params,
                                                       outs)
        r["main_temporal_trunk_f32"] = r["main_temporal_trunk"]["accuracy"]
        del saved, outs
        wide = main_trunk_wide(dev)
        r["main_trunk_wide_bf16"] = wide["bf16"]
        r["main_trunk_wide_f32"] = wide["f32"]
        widest = main_trunk_widest(dev)
        r["main_trunk_widest_bf16"] = widest["bf16"]
        r["main_trunk_widest_f32"] = widest["f32"]
    lap("temporal")
    if "train" in on:
        r["main_train"] = main_train(dev)
    lap("train")
    if "node" in on:
        main_node_agent(dev)
        r["main_node_fleet"] = main_node_fleet(dev)
        main_node_cmd()
    lap("node")
    multihost = None
    if "sharded" in on:
        sh_phases = sharded_phases()
        r["main_sharded"], sharded_planes = main_sharded(dev, sh_phases)
        multihost = main_multihost_virtual(dev, sh_phases, sharded_planes)
        del sh_phases, sharded_planes
    lap("sharded")
    if "mesh" in on:
        r["main_mesh"] = main_mesh(dev)
    lap("mesh")
    if "chaos" in on:
        r["main_chaos_pallas"] = main_chaos(dev)
    lap("chaos")
    rings: dict = {}
    if "parallel" in on:
        rings = main_parallel(dev)["rings"]
        for key, x in rings.items():
            r[f"main_parallel_ring_{key}"] = x
    lap("parallel")
    if "dist" in on:
        r["main_dist"] = main_dist(dev)
    lap("dist")
    if "analysis" in on:
        r["main_analysis"] = main_analysis(dev)
    lap("analysis")

    b1_paths = launches_of(r, "outer_product_attribution")
    if multihost is not None:
        b1_paths["main_multihost_virtual"] = multihost[
            "b1_two_hosts_window"] + sum(
            multihost["b1_per_window_after_demotion"])
    b2_extra: dict = {}
    if b2_flush is not None:
        b2_extra["by_db"] = {
            str(db): {"ms": x["ms"], "plain_ms": x["plain_ms"],
                      "device_ms": x["device_ms"],
                      "bound_ms": x["bound_ms"]}
            for db, x in sorted(b2_rows.items())}
        b2_extra["by_k"] = {str(x["shape"].get("K", 1)): {
            k: x[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms")}
            for x in (b2_rows[main_db], b2_flush)}
    tc_paths = launches_of(r, "flash_block_tc")
    tiled_paths = launches_of(r, "flash_block_tiled")
    ran_tiled_paths = {"temporal", "parallel"} & on
    check(not ran_tiled_paths or sum(tiled_paths.values()) > 0,
          f"B3's tiled variant launched no time on the main paths "
          f"{sorted(ran_tiled_paths)}: {tiled_paths}")
    by_kernel_path = {path: sum(launches_of(
        r, f"flash_block_tiled_{path}").values())
        for path in cat.TILED_PATH_LAUNCHES}
    check(sum(by_kernel_path.values()) == sum(tiled_paths.values()),
          f"B3's tiled launches {tiled_paths} do not add up by path: "
          f"{by_kernel_path}")
    tc_extra: dict = {}
    tiled_row = None
    tiled_extra: dict = {"launches_by_kernel_path": by_kernel_path}
    if b3_rows:
        tc_extra["by_shape"] = {f"B{x['shape']['B']}_T{x['shape']['Tq']}": {
            k: x[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms", "library_device_ms",
                              "max_abs_err")}
            for x in b3_rows}
        # the tiled variant's own row: accuracy mode at the serving shape
        x = b3_rows[0]
        tiled_row = {
            "name": "flash_block_tiled", "route": "cuda",
            "source": x["source"], "replaces": x["replaces"],
            "max_abs_err": x["f32_max_abs_err"], "ms": x["f32_ms"],
            "device_ms": x["f32_device_ms"], "plain_ms": x["f32_plain_ms"],
            "plain_device_ms": x["f32_plain_device_ms"],
            "bound_ms": x["f32_bound_ms"], "bound_by": x["f32_bound_by"],
            "library_ms": x["library_ms"],
            "library_device_ms": x["library_device_ms"],
            "shape": {**x["shape"], "compute": "f32"}}
        tiled_extra["by_shape"] = {
            f"B{x['shape']['B']}_T{x['shape']['Tq']}_f32": {
                "ms": x["f32_ms"], "device_ms": x["f32_device_ms"],
                "plain_ms": x["f32_plain_ms"], "bound_ms": x["f32_bound_ms"],
                "bound_by": x["f32_bound_by"],
                "library_ms": x["library_ms"],
                "library_device_ms": x["library_device_ms"],
                "max_abs_err": x["f32_max_abs_err"]}
            for x in b3_rows}
        tiled_extra["by_shape"].update({
            f"B{x['shape']['B']}_T{x['shape']['Tq']}_bf16_forced": {
                "ms": x["tiled_bf16_ms"],
                "device_ms": x["tiled_bf16_device_ms"],
                "bound_ms": x["bound_ms"], "bound_by": x["bound_by"],
                "max_abs_err": x["tiled_bf16_max_abs_err"]}
            for x in b3_rows})
    launch_keys = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                   "library_ms", "library_device_ms", "max_abs_err")
    for cd_name, x in [*b3_wide.items(),
                       *((cd, x) for (_, cd), x in b3_widepath.items())]:
        tiled_extra.setdefault("by_shape", {})[
            f"B{x['B']}_T{x['Tq']}_D{x['D']}_{cd_name}"] = {
            k: x[k] for k in launch_keys}
    for key, x in rings.items():
        y = x["per_launch"]
        extra = tc_extra if y["plan"]["variant"] == "tc" else tiled_extra
        extra.setdefault("by_shape", {})[
            f"B{y['B']}_T{y['Tq']}_ring_{key}_block"] = {
            **{k: y[k] for k in launch_keys},
            "ring_call_b3_device_ms": x["b3_ms_per_call"],
            "ring_b3_device_ms_per_launch": x["b3_device_ms_per_launch"],
            "ring_call_b3_bound_ms": x["b3_bound_ms_per_call"]}
    scatter_paths = launches_of(r, "scatter_rows")
    ran_scatter_paths = {"mixed", "aggregator", "sharded", "mesh",
                         "chaos"} & on
    check(not ran_scatter_paths or sum(scatter_paths.values()) > 0,
          f"the row scatter launched no time on the main paths "
          f"{sorted(ran_scatter_paths)}: {scatter_paths}")
    split_paths = launches_of(r, "hi_lo")
    check(not {"train", "analysis"} & on or sum(split_paths.values()) > 0,
          f"the hi/lo split launched no time in training: {split_paths}")
    scatter_extra: dict = {}
    if scatter_rows:
        scatter_extra["by_db"] = {
            str(db): {k: x[k] for k in (
                "ms", "device_ms", "plain_ms", "plain_device_ms",
                "library_ms", "library_device_ms", "bound_ms", "bound_by",
                "max_abs_err")} | {"lands": x["shape"]["lands"]}
            for db, x in sorted(scatter_rows.items())}
    lines = [
        kernel_line(b1, "outer_product_attribution", b1_paths),
        kernel_line(b2_flush, "fused_window_step",
                    launches_of(r, "fused_window_step"), **b2_extra),
        kernel_line(b3_rows[0] if b3_rows else None, "flash_block_tc",
                    tc_paths, **tc_extra),
        kernel_line(tiled_row, "flash_block_tiled", tiled_paths,
                    **tiled_extra),
        kernel_line(scatter_rows.get(512), "scatter_rows", scatter_paths,
                    **scatter_extra),
        kernel_line(hi_lo_row, "hi_lo", split_paths)]
    emit({"phase": "total", "phases": phases,
          "seconds": time.perf_counter() - t_script,
          "phase_seconds": laps})
    print(smi, flush=True)
    emit({"kernels": lines})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
