"""The fleet window's CUDA kernels B1 and B2, their plain versions, and
``attribute_fleet_pallas``.

The counterpart of ``kepler_tpu/ops/pallas_attribution.py``. The kernels
are written by hand in ``csrc/attribution.cu`` for Hopper (``sm_90a``) and
bound through a plain C interface (``ops/build.py`` compiles and loads the
library at first launch):

- **B1** :func:`outer_product_attribution` — ``energy = ratio ⊗ active``
  and ``power = ratio ⊗ active_power`` in one pass, written straight into
  ``[N, W, Z]``.
- **B2** :func:`fused_window_steps` — K whole fleet windows on the packed
  resident block in one launch: per step, scatter the interval's delta
  rows in place, unpack, ratio-attribute, emit the f16 watts plane
  ``[N, W+2, Z]``. :func:`fused_window_step` is its K = 1 call.

Each wrapper takes its plain PyTorch version (``*_ref``) only for tensors
that lie on the CPU. For a CUDA tensor it launches the kernel or raises;
nothing falls back. ``LAUNCHES`` counts kernel launches per kernel so a
run can show that its main path went through them (``fused_window_step``
counts every B2 launch, whatever its K).

The backend name ``pallas`` keeps its meaning from the JAX package's
config (``tpu.fleetBackend``): it selects these hand-written kernels.
"""

from __future__ import annotations

import ctypes
from typing import Any

import torch

from kepler_tpu_torch.ops import build, recorder
from kepler_tpu_torch.ops.attribution import (
    AttributionResult,
    WorkloadAttribution,
    _node_split,
    _workload_ratios,
    scatter_rows_,
)

# kernel launches since import (or since the caller last zeroed them)
LAUNCHES: dict[str, int] = {"outer_product_attribution": 0,
                            "fused_window_step": 0}

# NVIDIA H100 SXM data sheet: HBM3 rate and the f32 rate outside the
# tensor cores — the peaks a kernel's bound is taken against
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

_SOURCE = "attribution"
_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load(_SOURCE)
    if not getattr(lib, "_kt_bound", False):
        lib.kt_outer_product_attribution.argtypes = [
            _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
            _c_int, _c_int, _c_int, _c_void_p]
        lib.kt_outer_product_attribution.restype = _c_int
        lib.kt_fused_window_steps.argtypes = [
            _c_void_p, _c_void_p, _c_void_p, _c_void_p,
            _c_int, _c_int, _c_int, _c_int, _c_int, _c_void_p]
        lib.kt_fused_window_steps.restype = _c_int
        lib._kt_bound = True
    return lib


def _check(t: torch.Tensor, name: str, dtype: torch.dtype,
           shape: tuple[int, ...], device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"cudaError {rc}")


# -- cost model (what a kernel must move and compute) ----------------------

def outer_product_cost(n: int, w: int, z: int) -> tuple[int, int]:
    """B1 → (bytes, f32 operations): ratio and both zone planes read once,
    both [N, W, Z] planes written once; one multiply per output."""
    nbytes = 4 * (n * w + 2 * n * z + 2 * n * w * z)
    return nbytes, 2 * n * w * z


def fused_window_step_cost(n: int, db: int, w: int, z: int,
                           hits: int | None = None) -> tuple[int, int]:
    """B2 for one window → (bytes, f32 operations): resident and the
    ``db`` indices read once; each of the ``hits`` delta rows that lands
    (default: all ``db``) read once and written once into resident in
    place; the f16 plane written once. Rows no delta replaces are never
    written back."""
    return fused_window_steps_cost(n, db, w, z, 1, hits)


def fused_window_steps_cost(n: int, db: int, w: int, z: int, k: int,
                            hits: int | None = None,
                            dirty: int | None = None) -> tuple[int, int]:
    """B2 over a flush of ``k`` windows → (bytes, f32 operations): the
    resident block read once; each of the ``hits`` delta rows that lands
    over all steps (default: all ``k·db``) read once; the ``dirty`` rows
    (distinct rows hit; at most, and by default, ``hits``) written back
    once; the ``k·db`` indices; ``k`` f16 planes written."""
    width = w + 2 * z + 4
    hits = k * db if hits is None else hits
    dirty = hits if dirty is None else dirty
    nbytes = 4 * (n * width + hits * width + dirty * width + k * db) \
        + k * 2 * n * (w + 2) * z
    ops = k * (n * w * 2 + n * z * 4 + n * (w + 2) * z * 2)
    return nbytes, ops


def bound_ms(nbytes: int, ops: int,
             ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    """Least time an H100 SXM could take → (ms, "bytes" | "operations");
    ``ops_per_s`` is the peak rate for the operations' type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- B1: outer product -----------------------------------------------------

def outer_product_attribution_ref(
        ratio: torch.Tensor, active_uj: torch.Tensor,
        active_power_uw: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of B1: two broadcast multiplies."""
    return (ratio[:, :, None] * active_uj[:, None, :],
            ratio[:, :, None] * active_power_uw[:, None, :])


@recorder.records_kernel("outer_product_attribution")
def outer_product_attribution(
        ratio: torch.Tensor,  # f32 [N, W]
        active_uj: torch.Tensor,  # f32 [N, Z]
        active_power_uw: torch.Tensor,  # f32 [N, Z]
) -> tuple[torch.Tensor, torch.Tensor]:
    """→ (energy_uj [N,W,Z], power_uw [N,W,Z]) in one kernel pass (B1)."""
    if ratio.device.type == "cpu":
        return outer_product_attribution_ref(ratio, active_uj,
                                             active_power_uw)
    if ratio.device.type != "cuda":
        raise ValueError(f"unsupported device {ratio.device}")
    n, w = ratio.shape
    z = active_uj.shape[1]
    dev = ratio.device
    _check(ratio, "ratio", torch.float32, (n, w), dev)
    _check(active_uj, "active_uj", torch.float32, (n, z), dev)
    _check(active_power_uw, "active_power_uw", torch.float32, (n, z), dev)
    energy = torch.empty((n, w, z), dtype=torch.float32, device=dev)
    power = torch.empty((n, w, z), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.kt_outer_product_attribution(
            ratio.data_ptr(), active_uj.data_ptr(),
            active_power_uw.data_ptr(), energy.data_ptr(), power.data_ptr(),
            n, w, z, stream)
    _raise_on(rc, "outer_product_attribution")
    LAUNCHES["outer_product_attribution"] += 1
    return energy, power


# -- B2: fused window step -------------------------------------------------

def fused_window_step_ref(resident: torch.Tensor, delta_rows: torch.Tensor,
                          delta_idx: torch.Tensor, lay: Any,
                          *, out: torch.Tensor | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of one B2 step: the drop-mode scatter in place, then
    the packed ratio window in the f32 order of the JAX kernel."""
    scatter_rows_(resident, delta_rows, delta_idx)
    rows = resident
    cpu_nan = rows[:, lay.cpu]
    node = _node_split(rows[:, lay.zone], rows[:, lay.zone_valid] > 0.5,
                       rows[:, lay.col_ratio], rows[:, lay.col_dt])
    ratios = _workload_ratios(cpu_nan, ~torch.isnan(cpu_nan),
                              rows[:, lay.col_denom])
    col_a = node.active_power_uw[:, None, :]
    watts = torch.cat([ratios[:, :, None] * col_a, col_a,
                       node.power_uw[:, None, :]], dim=1)
    plane = (watts * 1e-6).to(torch.float16)
    if out is not None:
        out.copy_(plane)
        plane = out
    return resident, plane


def fused_window_steps_ref(resident: torch.Tensor, delta_rows: torch.Tensor,
                           delta_idx: torch.Tensor, lay: Any,
                           *, out: torch.Tensor | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of B2: the K steps one after the other."""
    k, n = delta_rows.shape[0], resident.shape[0]
    if out is None:
        out = torch.empty((k, n, lay.n_workloads + 2, lay.n_zones),
                          dtype=torch.float16, device=resident.device)
    for s in range(k):
        fused_window_step_ref(resident, delta_rows[s], delta_idx[s], lay,
                              out=out[s])
    return resident, out


@recorder.records_kernel("fused_window_step")
def fused_window_steps(
        resident: torch.Tensor,  # f32 [N, width], updated IN PLACE
        delta_rows: torch.Tensor,  # f32 [K, DB, width]
        delta_idx: torch.Tensor,  # i32 [K, DB] target rows (pad = N → dropped)
        lay: Any,  # PackedLayout (width + field offsets)
        *,
        out: torch.Tensor | None = None,  # f16 [K, N, W+2, Z] destination
) -> tuple[torch.Tensor, torch.Tensor]:
    """K fused window steps in one launch (B2) → ``(resident, watts f16
    [K, N, W+2, Z])``.

    ``resident`` is updated in place and returned — the port's form of
    the JAX program's donated resident block — and ends as K successive
    single steps leave it: a row hit in several steps takes them in
    order. Valid indices must be unique within a step.
    """
    if resident.device.type == "cpu":
        return fused_window_steps_ref(resident, delta_rows, delta_idx, lay,
                                      out=out)
    if resident.device.type != "cuda":
        raise ValueError(f"unsupported device {resident.device}")
    n = resident.shape[0]
    k, db = delta_rows.shape[0], delta_rows.shape[1]
    w, z = lay.n_workloads, lay.n_zones
    dev = resident.device
    if k < 1:
        raise ValueError("B2 needs at least one step")
    _check(resident, "resident", torch.float32, (n, lay.width), dev)
    _check(delta_rows, "delta_rows", torch.float32, (k, db, lay.width), dev)
    _check(delta_idx, "delta_idx", torch.int32, (k, db), dev)
    if out is None:
        out = torch.empty((k, n, w + 2, z), dtype=torch.float16, device=dev)
    else:
        _check(out, "out", torch.float16, (k, n, w + 2, z), dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.kt_fused_window_steps(
            resident.data_ptr(), delta_rows.data_ptr(), delta_idx.data_ptr(),
            out.data_ptr(), n, k, db, w, z, stream)
    _raise_on(rc, "fused_window_steps")
    # the kernel wrote through raw pointers: mark the in-place update
    torch.autograd.graph.increment_version(resident)
    LAUNCHES["fused_window_step"] += 1
    return resident, out


@recorder.records_kernel("fused_window_step")
def fused_window_step(
        resident: torch.Tensor,  # f32 [N, width], updated IN PLACE
        delta_rows: torch.Tensor,  # f32 [DB, width]
        delta_idx: torch.Tensor,  # i32 [DB] target rows (pad = N → dropped)
        lay: Any,  # PackedLayout (width + field offsets)
        *,
        out: torch.Tensor | None = None,  # f16 [N, W+2, Z] destination
) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused window step (B2) → ``(resident, watts f16 [N, W+2, Z])``:
    the K = 1 call of :func:`fused_window_steps`. ``resident`` is updated
    in place and returned."""
    if resident.device.type == "cpu":
        return fused_window_step_ref(resident, delta_rows, delta_idx, lay,
                                     out=out)
    _, outs = fused_window_steps(
        resident, delta_rows[None], delta_idx[None], lay,
        out=None if out is None else out[None])
    return resident, outs[0]


# -- the pallas-backend fleet attribution ----------------------------------

def attribute_fleet_pallas(
    zone_deltas_uj: torch.Tensor,  # f32 [N, Z]
    zone_valid: torch.Tensor,  # bool [N, Z]
    usage_ratio: torch.Tensor,  # f32 [N]
    cpu_deltas: torch.Tensor,  # f32 [N, W]
    workload_valid: torch.Tensor,  # bool [N, W]
    node_cpu_delta: torch.Tensor,  # f32 [N]
    dt_s: torch.Tensor,  # f32 [N]
) -> AttributionResult:
    """Drop-in for ``ops.attribution.attribute_fleet`` with the outer
    product running as kernel B1 (bit-identical results)."""
    node = _node_split(zone_deltas_uj, zone_valid, usage_ratio, dt_s)
    ratios = _workload_ratios(cpu_deltas, workload_valid, node_cpu_delta)
    energy, power = outer_product_attribution(
        ratios.contiguous(), node.active_uj.contiguous(),
        node.active_power_uw.contiguous())
    return AttributionResult(
        node=node,
        workloads=WorkloadAttribution(
            energy_uj=energy, power_uw=power, cpu_ratio=ratios
        ),
    )
