"""The temporal estimator's attention kernel B3, its plain version, and the
dense-serving wrappers around it.

The counterpart of ``kepler_tpu/ops/pallas_attention.py``. The kernel is
written by hand in ``csrc/attention.cu`` for Hopper (``sm_90a``) and bound
through a plain C interface (``ops/build.py`` compiles and loads the
library at first launch). It has two variants, chosen from the compute
type and the shape alone (:func:`flash_block_plan`): a tensor-core one
(bf16 compute, Tq == Tk a multiple of 16 up to 128, D in {16, 32, 64} —
the temporal trunk's default) and a SIMT one for f32 compute and every
other shape.

- **B3** :func:`flash_block_pallas` — one fused (q-block × kv-block)
  attention partial ``(pv [B,Tq,H,D], m [B,H,Tq], l [B,H,Tq])``, the
  ``ops.attention.block_attn`` contract: scores, the KV-validity mask and
  the causal mask from scalar block starts, the softmax statistics and the
  value contraction, without the ``[Tq, Tk]`` scores ever reaching device
  memory.
- :func:`full_attention_pallas` — dense attention through B3 (a drop-in
  for ``ops.attention.full_attention``), and :func:`pallas_attention_fn`,
  the ``attention_fn`` for ``models.temporal.temporal_trunk``'s seam.

The wrapper takes its plain PyTorch version (:func:`flash_block_ref`) only
for tensors that lie on the CPU. For a CUDA tensor it launches the kernel
or raises; nothing falls back, and no variant is tried and replaced on
error. ``LAUNCHES`` counts kernel launches, in all and per variant, so a
run can show that its main path went through the kernel it expects. The
names keep the JAX package's ``pallas``: the backend name selects the
hand-written kernels.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from kepler_tpu_torch.ops import build
from kepler_tpu_torch.ops.attention import block_attn, stats_to_out
from kepler_tpu_torch.ops.cuda_attribution import (F32_OPS_PER_S, _raise_on,
                                                   bound_ms)

# kernel launches since import (or since the caller last zeroed them):
# "flash_block" counts every B3 launch, the other two each variant's
LAUNCHES: dict[str, int] = {"flash_block": 0, "flash_block_tc": 0,
                            "flash_block_simt": 0}

# NVIDIA H100 SXM data sheet: the dense bf16 tensor-core rate, the peak a
# bf16-operand contraction's bound is taken against (f32 operands use
# cuda_attribution.F32_OPS_PER_S)
BF16_OPS_PER_S = 989e12

# what the kernels take (csrc/attention.cu). SIMT: head dims it is
# instantiated for, threads per block, and shared memory per block (all
# of it, and the size below which a second block shares the SM).
KERNEL_HEAD_DIMS = (8, 16, 32, 64)
MAX_THREADS = 256
MAX_SMEM = 227 * 1024
TARGET_SMEM = 96 * 1024
# Tensor cores: bf16 compute, Tq == Tk a multiple of 16 up to TC_MAX_T,
# these head dims; a two-stage ring of items of g sequences × hb heads,
# each stage ≤ TC_STAGE_BYTES of q, k, v where one unit allows it; rows
# staged by cp.async (hb = 1) padded by TC_PAD floats.
TC_HEAD_DIMS = (16, 32, 64)
TC_MAX_T = 128
TC_STAGES = 2
TC_STAGE_BYTES = 56 * 1024
TC_PAD = 4

_SOURCE = "attention"
_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int
_c_ll = ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = build.load(_SOURCE)
    if not getattr(lib, "_kt_bound", False):
        lib.kt_flash_block.argtypes = (
            [_c_void_p] * 7 + [_c_int] * 7 + [_c_ll] * 9
            + [_c_int] * 5 + [ctypes.c_float, _c_void_p])
        lib.kt_flash_block.restype = _c_int
        lib.kt_flash_block_tc.argtypes = (
            [_c_void_p] * 7 + [_c_int] * 6 + [_c_ll] * 9
            + [_c_int] * 5 + [ctypes.c_float, _c_void_p])
        lib.kt_flash_block_tc.restype = _c_int
        lib.kt_flash_block_info.argtypes = [_c_int, _c_int, _c_int,
                                            ctypes.POINTER(_c_int)]
        lib.kt_flash_block_info.restype = _c_int
        lib._kt_bound = True
    return lib


class FlashPlan(NamedTuple):
    """How B3 runs one call: ``variant`` "tc" (tensor cores) or "simt";
    items (tc) or blocks (simt) of ``g`` sequences × ``hb`` heads,
    ``threads`` per block, ``smem`` bytes of shared memory per block, and
    (tc) whether each item's rows arrive as bulk copies."""

    variant: str
    g: int
    hb: int
    threads: int
    smem: int
    bulk: bool


def takes_tensor_cores(tq: int, tk: int, d: int,
                       compute_dtype: torch.dtype) -> bool:
    """Whether the tensor-core variant takes this call: bf16 compute,
    Tq == Tk a multiple of 16 up to ``TC_MAX_T``, D in ``TC_HEAD_DIMS``."""
    return (compute_dtype == torch.bfloat16 and tq == tk and tq % 16 == 0
            and 16 <= tq <= TC_MAX_T and d in TC_HEAD_DIMS)


def smem_bytes(g: int, hb: int, tq: int, tk: int, d: int,
               variant: str = "simt", bulk: bool = False) -> int:
    """Shared memory of one B3 block of ``g`` sequences × ``hb`` heads, as
    ``csrc/attention.cu`` lays it out. simt: K and V tiles (each unit
    padded by 4 floats), the Q tile (rows padded to D+1) and the
    sequences' KV-validity bytes. tc: ``TC_STAGES`` stages of the q, k
    and v tiles (f32; rows of hb·D floats as ``bulk`` copies land them,
    else of D + ``TC_PAD``) and one mbarrier each."""
    if variant == "tc":
        row = hb * d if bulk else d + TC_PAD
        return TC_STAGES * (3 * 4 * g * tq * row + 8)
    units = g * hb
    floats = units * (2 * (tk * d + 4) + tq * (d + 1))
    return 4 * floats + (g * tk + 15) // 16 * 16


def _tc_plan(b: int, t: int, h: int, d: int, contiguous: bool) -> FlashPlan:
    """Items of all H heads (bulk copies) where q, k, v are contiguous and
    one sequence fits a stage, else of one head; then as many sequences
    as keep a stage within ``TC_STAGE_BYTES`` and the block within
    ``MAX_THREADS`` threads (T/16 warps a unit)."""
    warps = t // 16
    bulk = (contiguous and 3 * 4 * t * h * d <= TC_STAGE_BYTES
            and h * warps * 32 <= MAX_THREADS)
    hb = h if bulk else 1
    # q, k, v of one sequence's hb heads, as staged
    unit = 3 * 4 * t * (h * d if bulk else d + TC_PAD)
    g = 1
    while (g < b and (g + 1) * unit <= TC_STAGE_BYTES
           and (g + 1) * hb * warps * 32 <= MAX_THREADS):
        g += 1
    return FlashPlan("tc", g, hb, g * hb * warps * 32,
                     smem_bytes(g, hb, t, t, d, "tc", bulk), bulk)


def flash_block_plan(b: int, tq: int, tk: int, h: int, d: int,
                     compute_dtype: torch.dtype = torch.bfloat16,
                     contiguous: bool = True) -> FlashPlan:
    """→ the B3 variant and its blocking for this call, from the compute
    type and the shape alone (``contiguous``: q, k, v are contiguous
    ``[B, T, H, D]`` with 16-byte aligned data).

    Tensor cores where :func:`takes_tensor_cores`; else the SIMT kernel,
    with as many heads per block as fit (a timestep row of hb·D f32 values
    is then one contiguous read), then as many sequences as keep the block
    within ``MAX_THREADS`` threads (one per query row) and
    ``TARGET_SMEM``. Raises ValueError for a shape neither takes."""
    if takes_tensor_cores(tq, tk, d, compute_dtype):
        return _tc_plan(b, tq, h, d, contiguous)
    return simt_plan(b, tq, tk, h, d)


def simt_plan(b: int, tq: int, tk: int, h: int, d: int) -> FlashPlan:
    """The SIMT variant's blocking for this shape (see
    :func:`flash_block_plan`). Raises ValueError for a shape it does not
    take."""
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"B3 takes head dims {KERNEL_HEAD_DIMS}, got {d}")
    for hb in range(h, 0, -1):
        if (h % hb == 0 and hb * tq <= MAX_THREADS
                and smem_bytes(1, hb, tq, tk, d) <= MAX_SMEM):
            break
    else:
        raise ValueError(
            f"B3 does not take Tq={tq}, Tk={tk}, D={d}: one head of one "
            f"sequence needs {tq} threads (at most {MAX_THREADS}) and "
            f"{smem_bytes(1, 1, tq, tk, d)} B of shared memory (at most "
            f"{MAX_SMEM})")
    g = 1
    while (g < b and (g + 1) * hb * tq <= MAX_THREADS
           and smem_bytes(g + 1, hb, tq, tk, d) <= TARGET_SMEM):
        g += 1
    return FlashPlan("simt", g, hb, g * hb * tq, smem_bytes(g, hb, tq, tk, d),
                     False)


def flash_block_info(variant: str, t: int, d: int) -> dict[str, int]:
    """Compiled resources of one B3 instance on the card (variant "tc" at
    T = Tq = Tk, or "simt" with bf16 staging): registers per thread,
    static shared bytes, local (spill) bytes, max threads per block."""
    out = (_c_int * 4)()
    rc = _lib().kt_flash_block_info(int(variant == "tc"), t, d, out)
    _raise_on(rc, "flash_block_info")
    return dict(zip(("registers", "static_smem", "local_bytes",
                     "max_threads"), list(out)))


# -- cost model (what the kernel must move and compute) ---------------------

def attended_pairs(kv_valid: torch.Tensor, tq: int, q_start: int,
                   kv_start: int, causal: bool) -> int:
    """Unmasked (sequence, query, key) triples: the score and value work
    this call's data needs (per head)."""
    valid = (kv_valid > 0.5) if kv_valid.dtype != torch.bool else kv_valid
    tk = valid.shape[1]
    if causal:
        # queries at or after key j: q_start + i >= kv_start + j
        j = torch.arange(tk, device=valid.device)
        per_key = torch.clamp(tq - (kv_start - q_start + j), 0, tq)
    else:
        per_key = torch.full((tk,), tq, device=valid.device)
    return int((valid.to(torch.int64) * per_key).sum())


def flash_block_cost(b: int, tq: int, tk: int, h: int, d: int, pairs: int,
                     compute_dtype: torch.dtype = torch.bfloat16
                     ) -> tuple[int, int, float]:
    """B3 → (bytes, operations, peak rate for their type): q, k, v (f32)
    and the KV-validity bytes read once, pv, m and l (f32) written once;
    2·D operations for a score and 2·D for its share of p·v, for each of
    the ``pairs`` unmasked (sequence, query, key) triples of each head."""
    nbytes = 4 * (b * tq * h * d + 2 * b * tk * h * d) + b * tk \
        + 4 * (b * tq * h * d + 2 * b * h * tq)
    ops = 4 * d * h * pairs
    rate = BF16_OPS_PER_S if compute_dtype == torch.bfloat16 \
        else F32_OPS_PER_S
    return nbytes, ops, rate


def flash_block_bound_ms(q: torch.Tensor, k: torch.Tensor,
                         kv_valid: torch.Tensor, q_start: int, kv_start: int,
                         *, causal: bool = True,
                         compute_dtype: torch.dtype = torch.bfloat16
                         ) -> tuple[float, str]:
    """Least time an H100 SXM could take for this B3 call → (ms, by)."""
    b, tq, h, d = q.shape
    pairs = attended_pairs(kv_valid, tq, q_start, kv_start, causal)
    nbytes, ops, rate = flash_block_cost(b, tq, k.shape[1], h, d, pairs,
                                         compute_dtype)
    return bound_ms(nbytes, ops, rate)


# -- B3: one attention partial ----------------------------------------------

def _position_mask(kv_valid: torch.Tensor, tq: int, q_start: int,
                   kv_start: int, causal: bool) -> torch.Tensor:
    """bool [B, 1, Tq, Tk]: KV validity, and the causal order of global
    positions ``q_start + i >= kv_start + j``."""
    valid = kv_valid.to(torch.float32) > 0.5
    mask = valid[:, None, None, :]
    if causal:
        dev = kv_valid.device
        pos_q = q_start + torch.arange(tq, device=dev)
        pos_k = kv_start + torch.arange(valid.shape[1], device=dev)
        mask = mask & (pos_q[:, None] >= pos_k[None, :])
    return mask


def flash_block_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_valid: torch.Tensor, q_start: int, kv_start: int, *,
                    causal: bool = True,
                    compute_dtype: torch.dtype = torch.bfloat16
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of B3: ``block_attn`` under the position mask."""
    mask = _position_mask(kv_valid, q.shape[1], int(q_start), int(kv_start),
                          causal)
    scale = 1.0 / math.sqrt(q.shape[-1])
    return block_attn(q, k, v, mask, scale, compute_dtype)


def _check_qkv(name: str, t: torch.Tensor, shape: tuple[int, ...],
               device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} is {t.dtype}, expected torch.float32")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name} must have a unit stride on D")


def flash_block_pallas(
    q: torch.Tensor,  # f32 [B, Tq, H, D]
    k: torch.Tensor,  # f32 [B, Tk, H, D]
    v: torch.Tensor,  # f32 [B, Tk, H, D]
    kv_valid: torch.Tensor,  # bool/float [B, Tk]
    q_start: int,  # global position of q row 0
    kv_start: int,  # global position of k row 0
    *,
    causal: bool = True,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused (q-block × kv-block) partial → (pv [B,Tq,H,D],
    m [B,H,Tq], l [B,H,Tq]) — the ``block_attn`` contract, as kernel B3."""
    if q.device.type == "cpu":
        return flash_block_ref(q, k, v, kv_valid, q_start, kv_start,
                               causal=causal, compute_dtype=compute_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if compute_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"B3 computes in bf16 or f32, not {compute_dtype}")
    b, tq, h, d = q.shape
    tk = k.shape[1]
    dev = q.device
    _check_qkv("q", q, (b, tq, h, d), dev)
    _check_qkv("k", k, (b, tk, h, d), dev)
    _check_qkv("v", v, (b, tk, h, d), dev)
    if kv_valid.device != dev or tuple(kv_valid.shape) != (b, tk):
        raise ValueError(f"kv_valid must be [{b}, {tk}] on {dev}, got "
                         f"{tuple(kv_valid.shape)} on {kv_valid.device}")
    contiguous = all(t.is_contiguous() and t.data_ptr() % 16 == 0
                     for t in (q, k, v))
    plan = flash_block_plan(b, tq, tk, h, d, compute_dtype, contiguous)
    return flash_block_launch(plan, q, k, v, kv_valid, q_start, kv_start,
                              causal=causal, compute_dtype=compute_dtype)


def flash_block_launch(
    plan: FlashPlan,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_valid: torch.Tensor,
    q_start: int,
    kv_start: int,
    *,
    causal: bool = True,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch B3 on CUDA tensors as ``plan`` says (the checks of
    :func:`flash_block_pallas` done). :func:`flash_block_pallas` passes
    :func:`flash_block_plan`'s plan; a measurement may pass
    :func:`simt_plan`'s to time the SIMT variant at bf16. The kernel
    refuses a plan it does not take (the call raises)."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    dev = q.device
    if plan.variant == "tc" and compute_dtype != torch.bfloat16:
        raise ValueError("the tensor-core variant computes in bf16 only")
    if plan.bulk and not all(t.is_contiguous() and t.data_ptr() % 16 == 0
                             for t in (q, k, v)):
        raise ValueError("a bulk-copy plan needs contiguous, 16-byte "
                         "aligned q, k and v")
    valid = kv_valid if kv_valid.dtype == torch.bool else kv_valid > 0.5
    valid = valid.contiguous().view(torch.uint8)
    if valid.data_ptr() % 16:
        valid = valid.clone()  # the kernels read it 4 bytes at a time
    pv = torch.empty((b, tq, h, d), dtype=torch.float32, device=dev)
    m = torch.empty((b, h, tq), dtype=torch.float32, device=dev)
    l = torch.empty((b, h, tq), dtype=torch.float32, device=dev)
    if b == 0:
        return pv, m, l
    vec = all(t.data_ptr() % 16 == 0 and all(s % 4 == 0 for s in t.stride()[:3])
              for t in (q, k, v))
    scale = float(torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32))
    lib = _lib()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
            pv.data_ptr(), m.data_ptr(), l.data_ptr())
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if plan.variant == "tc":
            rc = lib.kt_flash_block_tc(
                *ptrs, b, tq, h, d, plan.hb, plan.g, *strides,
                int(q_start), int(kv_start), int(causal), int(plan.bulk),
                int(vec), scale, stream)
        else:
            rc = lib.kt_flash_block(
                *ptrs, b, tq, tk, h, d, plan.hb, plan.g, *strides,
                int(q_start), int(kv_start), int(causal),
                int(compute_dtype == torch.bfloat16), int(vec), scale,
                stream)
    _raise_on(rc, f"flash_block ({plan.variant})")
    LAUNCHES["flash_block"] += 1
    LAUNCHES[f"flash_block_{plan.variant}"] += 1
    return pv, m, l


def full_attention_pallas(
    q: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,
    v: torch.Tensor,
    t_valid: torch.Tensor | None = None,  # bool [B, T]
    *,
    causal: bool = True,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Dense attention through kernel B3 (drop-in for
    ``ops.attention.full_attention``)."""
    if t_valid is None:
        t_valid = torch.ones(q.shape[:2], dtype=torch.bool, device=q.device)
    pv, _, l = flash_block_pallas(q, k, v, t_valid, 0, 0, causal=causal,
                                  compute_dtype=compute_dtype)
    l_safe = torch.clamp(l, min=1e-30)
    return (pv / stats_to_out(l_safe)).to(q.dtype)


def pallas_attention_fn(causal: bool = True,
                        compute_dtype: torch.dtype = torch.bfloat16):
    """→ an ``attention_fn`` for ``temporal_trunk``'s plug-in seam."""

    def fn(q, k, v, t_valid):
        return full_attention_pallas(q, k, v, t_valid, causal=causal,
                                     compute_dtype=compute_dtype)

    return fn

