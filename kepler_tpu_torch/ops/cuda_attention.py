"""The temporal estimator's attention kernel B3, its plain version, and the
dense-serving wrappers around it.

The counterpart of ``kepler_tpu/ops/pallas_attention.py``. The kernel is
written by hand in ``csrc/attention.cu`` for Hopper (``sm_90a``) and bound
through a plain C interface (``ops/build.py`` compiles and loads the
library at first launch). It has two variants, chosen from the compute
type and the shape alone (:func:`flash_block_plan`): a tensor-core one
(bf16 compute, Tq == Tk a multiple of 16 up to 128, D in {16, 32, 64} —
the temporal trunk's default) and a KV-tiled one for f32 compute and
every other shape: any Tq, Tk and D, as the TPU kernel takes them. The
tiled variant has three paths (:func:`tiled_plan`): the ring (one score
pass where a warp's keys fit its registers, else two over a stream of KV
tiles), the resident path (bf16 K and V of a long block held whole in
shared memory) and the wide path (D above 256: one warp a block streaming
64-column chunks of q, K and V through a ring of asynchronous copies; one
score pass summed over all of D in the warp's registers where a row's
visible keys fit a 64-key tile; tensor cores at bf16).

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
error. ``LAUNCHES`` counts kernel launches, in all and per variant, and
``TILED_PATH_LAUNCHES`` the tiled variant's per path, so a run can show
that its main path went through the kernel it expects. The
names keep the JAX package's ``pallas``: the backend name selects the
hand-written kernels.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from kepler_tpu_torch.ops import build, recorder
from kepler_tpu_torch.ops.attention import block_attn, stats_to_out
from kepler_tpu_torch.ops.cuda_attribution import (F32_OPS_PER_S, _raise_on,
                                                   bound_ms)

# kernel launches since import (or since the caller last zeroed them):
# "flash_block" counts every B3 launch, the other two each variant's
LAUNCHES: dict[str, int] = {"flash_block": 0, "flash_block_tc": 0,
                            "flash_block_tiled": 0}
# the tiled variant's launches by the path its plan took (tiled_plan)
TILED_PATH_LAUNCHES: dict[str, int] = {"one-pass": 0, "two-pass": 0,
                                       "resident": 0, "wide": 0}

# NVIDIA H100 SXM data sheet: the dense bf16 tensor-core rate, the peak a
# bf16-operand contraction's bound is taken against (f32 operands use
# cuda_attribution.F32_OPS_PER_S)
BF16_OPS_PER_S = 989e12

# what the kernels take (csrc/attention.cu): threads and shared memory a
# block may have.
MAX_THREADS = 256
MAX_SMEM = 227 * 1024
# Tensor cores: bf16 compute, Tq == Tk a multiple of 16 up to TC_MAX_T,
# these head dims; a two-stage ring of items of g sequences × hb heads,
# each stage ≤ TC_STAGE_BYTES of q, k, v where one unit allows it; rows
# staged by cp.async (hb = 1) padded by TC_PAD floats.
TC_HEAD_DIMS = (16, 32, 64)
TC_MAX_T = 128
TC_STAGES = 2
TC_STAGE_BYTES = 56 * 1024
TC_PAD = 4
# KV-tiled, the ring path: D zero-padded to the first of the padded head
# dims (bf16: all; f32 from 32) that holds it; items of up to
# TILED_Q_ROWS query rows (16 a warp; fewer where a block would not fit
# MAX_SMEM), KV tiles in a two-stage ring: one tile of a whole row of up
# to TILED_KEYS[dp] keys (one score pass), else TILED_STREAM_KEYS[dp];
# rows padded by TILED_PAD floats, f32 p^T rows of TILED_P_ROW floats,
# each stage's KV-validity bytes beside its tiles. Where an item packs
# several sequences (dp <= 64) its block stays within TILED_BLOCK_SMEM,
# so that several small blocks share an SM and their barriers fall at
# different times (2 sequences an item at the f32 serving shape).
TILED_DIMS = {torch.bfloat16: (16, 32, 64, 128, 256),
              torch.float32: (32, 64, 128, 256)}
TILED_KEYS = {16: 128, 32: 128, 64: 128, 128: 32, 256: 16}
TILED_STREAM_KEYS = {16: 64, 32: 64, 64: 64, 128: 32, 256: 16}
TILED_Q_ROWS = 128
TILED_STAGES = 2
TILED_PAD = 4
TILED_P_ROW = 20
TILED_BLOCK_SMEM = 32 * 1024
# the resident path: bf16 at these padded head dims where a KV row is
# longer than one tile and K and V fit shared memory whole as bf16 rows
# of dp + RESIDENT_PAD elements; 8 warps walk the q rows
RESIDENT_DIMS = (16, 32, 64)
RESIDENT_PAD = 8
# the wide path: D above the widest padded head dim; one warp a block, an
# item of 16 query rows at a time, a ring of WIDE_STAGES stages each
# holding a WIDE_CHUNK-column chunk of 16 q rows and of a KV tile's tk K
# (or V) rows (f32 rows padded by TILED_PAD floats); one tile holds rows of
# up to WIDE_KEYS keys (one score pass), longer rows stream tiles of
# WIDE_KEYS (two passes); f32 adds a p^T tile of tk keys, each stage a
# header of WIDE_HEADER ints
WIDE_CHUNK = 64
WIDE_STAGES = 3
WIDE_KEYS = 64
WIDE_HEADER = 12
_PATHS = {"one-pass": 0, "two-pass": 0, "resident": 1, "wide": 2}

_SOURCE = "attention"
_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int
_c_ll = ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = build.load(_SOURCE)
    if not getattr(lib, "_kt_bound", False):
        lib.kt_flash_block_tiled.argtypes = (
            [_c_void_p] * 7 + [_c_int] * 9 + [_c_ll] * 9
            + [_c_int] * 6 + [ctypes.c_float, _c_void_p])
        lib.kt_flash_block_tiled.restype = _c_int
        lib.kt_flash_block_tc.argtypes = (
            [_c_void_p] * 7 + [_c_int] * 6 + [_c_ll] * 9
            + [_c_int] * 5 + [ctypes.c_float, _c_void_p])
        lib.kt_flash_block_tc.restype = _c_int
        lib.kt_flash_block_info.argtypes = [_c_int] * 5 + [
            ctypes.POINTER(_c_int)]
        lib.kt_flash_block_info.restype = _c_int
        lib._kt_bound = True
    return lib


class FlashPlan(NamedTuple):
    """How B3 runs one call: ``variant`` "tc" (tensor cores) or "tiled";
    items of ``g`` sequences × ``hb`` heads, ``threads`` per block,
    ``smem`` bytes of shared memory per block, (tc) whether each item's
    rows arrive as bulk copies, and (tiled) the padded head dim ``dp``,
    an item's query rows ``qr``, a KV tile's keys ``tk`` and the
    ``path``: "one-pass" or "two-pass" (the ring of KV tiles), "resident"
    or "wide"."""

    variant: str
    g: int
    hb: int
    threads: int
    smem: int
    bulk: bool
    dp: int = 0
    qr: int = 0
    tk: int = 0
    path: str = ""


def takes_tensor_cores(tq: int, tk: int, d: int,
                       compute_dtype: torch.dtype) -> bool:
    """Whether the tensor-core variant takes this call: bf16 compute,
    Tq == Tk a multiple of 16 up to ``TC_MAX_T``, D in ``TC_HEAD_DIMS``."""
    return (compute_dtype == torch.bfloat16 and tq == tk and tq % 16 == 0
            and 16 <= tq <= TC_MAX_T and d in TC_HEAD_DIMS)


def tc_smem_bytes(g: int, hb: int, t: int, d: int, bulk: bool) -> int:
    """Shared memory of one tensor-core block, as ``csrc/attention.cu``
    lays it out: ``TC_STAGES`` stages of the q, k and v tiles of ``g``
    sequences × ``hb`` heads (f32; rows of hb·D floats as ``bulk`` copies
    land them, else of D + ``TC_PAD``) and one mbarrier each."""
    row = hb * d if bulk else d + TC_PAD
    return TC_STAGES * (3 * 4 * g * t * row + 8)


def tiled_smem_bytes(g: int, qr: int, tk: int, dp: int,
                     compute_dtype: torch.dtype, multi: bool = False) -> int:
    """Shared memory of one KV-tiled ring block, as ``csrc/attention.cu``
    lays it out: ``TILED_STAGES`` q slots of ``g`` × ``qr`` rows and as many K
    and V stages of ``g`` × ``tk`` rows (f32 rows of dp + ``TILED_PAD``
    floats), at f32 compute where the item streams several KV tiles
    (``multi``) each warp's p^T tile (16 × ``TILED_P_ROW``; a single-tile
    item's warp keeps it in its own q rows), each stage's ``g`` × ``tk``
    validity bytes, and 2·``TILED_STAGES`` + 8 ints."""
    rows = TILED_STAGES * g * (qr + 2 * tk) * (dp + TILED_PAD)
    pt = (g * qr * TILED_P_ROW
          if compute_dtype == torch.float32 and multi else 0)
    return 4 * (rows + pt) + TILED_STAGES * g * tk + 4 * (2 * TILED_STAGES + 8)


def resident_smem_bytes(tkp: int, dp: int) -> int:
    """Shared memory of one resident block: K and V, ``tkp`` rows each of
    dp + ``RESIDENT_PAD`` bf16 values, the sequence's visibility bits, 8
    ints and the next item's ``tkp`` validity bytes."""
    return (2 * 2 * tkp * (dp + RESIDENT_PAD) + 4 * (-(-tkp // 32)) + 4 * 8
            + tkp)


def wide_smem_bytes(tk: int, compute_dtype: torch.dtype) -> int:
    """Shared memory of one wide block (one warp): ``WIDE_STAGES`` stages of
    16 q rows and ``tk`` K (or V) rows of ``WIDE_CHUNK`` + ``TILED_PAD``
    floats, at f32 compute a p^T tile of ``tk`` × ``TILED_P_ROW`` floats,
    and each stage's ``WIDE_HEADER`` ints."""
    pt = tk * TILED_P_ROW if compute_dtype == torch.float32 else 0
    return (4 * (WIDE_STAGES * (16 + tk) * (WIDE_CHUNK + TILED_PAD) + pt)
            + 4 * WIDE_STAGES * WIDE_HEADER)


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
                     tc_smem_bytes(g, hb, t, d, bulk), bulk, d, t, t)


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


def tiled_plan(b: int, tq: int, tk: int, d: int,
               compute_dtype: torch.dtype = torch.bfloat16) -> FlashPlan:
    """The KV-tiled variant's path and blocking for this call.

    - D above the widest padded head dim: the wide path, one warp a
      block, items of 16 query rows, D in chunks of ``WIDE_CHUNK``
      columns; one KV tile of Tk rounded up to 16 keys where Tk is at most
      ``WIDE_KEYS`` (one score pass), else tiles of ``WIDE_KEYS``.
    - bf16 where Tk is longer than a tile (``TILED_KEYS[dp]``), dp in
      ``RESIDENT_DIMS`` and K and V fit ``MAX_SMEM`` whole: the resident
      path, one (sequence, head) an item.
    - Else the ring: items of one head and query tiles of up to
      ``TILED_Q_ROWS`` rows (as many as fit ``MAX_SMEM``); "one-pass"
      where one KV tile holds Tk (up to ``TILED_KEYS[dp]``), "two-pass"
      over tiles of ``TILED_STREAM_KEYS[dp]`` keys where it does not.
      Where one query tile and one KV tile hold whole sequences, an item
      packs as many sequences as keep the block within ``MAX_THREADS``
      threads (one warp a 16 query rows) and its shared memory within
      ``TILED_BLOCK_SMEM`` (dp <= 64, and bf16 at any dp) or
      ``MAX_SMEM``.

    Every path copies rows whatever their layout, so the plan is the
    same for every layout and head count. Raises ValueError for D, Tq or
    Tk below 1."""
    if d < 1:
        raise ValueError(f"B3 needs D >= 1, got {d}")
    if tq < 1 or tk < 1:
        raise ValueError(f"B3 needs Tq, Tk >= 1, got Tq={tq}, Tk={tk}")
    if compute_dtype not in TILED_DIMS:
        raise TypeError(f"B3 computes in bf16 or f32, not {compute_dtype}")
    if d > TILED_DIMS[compute_dtype][-1]:
        kt = min(_round16(tk), WIDE_KEYS)
        return FlashPlan("tiled", 1, 1, 32, wide_smem_bytes(kt, compute_dtype),
                         False, -(-d // WIDE_CHUNK) * WIDE_CHUNK, 16, kt,
                         "wide")
    dp = next(x for x in TILED_DIMS[compute_dtype] if x >= d)
    kt = (_round16(tk) if tk <= TILED_KEYS[dp]
          else TILED_STREAM_KEYS[dp])
    if (compute_dtype == torch.bfloat16 and tk > kt and dp in RESIDENT_DIMS
            and resident_smem_bytes(_round16(tk), dp) <= MAX_SMEM):
        return FlashPlan("tiled", 1, 1, MAX_THREADS,
                         resident_smem_bytes(_round16(tk), dp), False, dp,
                         TILED_Q_ROWS, _round16(tk), "resident")
    multi = tk > kt
    qr = min(_round16(tq), TILED_Q_ROWS)
    while tiled_smem_bytes(1, qr, kt, dp, compute_dtype, multi) > MAX_SMEM:
        qr -= 16
    # bf16 above dp 64 takes one sequence an item: its math is a fraction
    # of its loads, and one-warp blocks overlap them best
    budget = (TILED_BLOCK_SMEM if dp <= 64 or compute_dtype == torch.bfloat16
              else MAX_SMEM)
    g = 1
    if tq <= qr and not multi:
        while (g < b and (g + 1) * qr // 16 * 32 <= MAX_THREADS
               and tiled_smem_bytes(g + 1, qr, kt, dp, compute_dtype)
               <= budget):
            g += 1
    return FlashPlan("tiled", g, 1, g * qr // 16 * 32,
                     tiled_smem_bytes(g, qr, kt, dp, compute_dtype, multi),
                     False, dp, qr, kt, "two-pass" if multi else "one-pass")


def flash_block_plan(b: int, tq: int, tk: int, h: int, d: int,
                     compute_dtype: torch.dtype = torch.bfloat16,
                     contiguous: bool = True) -> FlashPlan:
    """→ the B3 variant and its blocking for this call, from the compute
    type and the shape alone (``contiguous``: q, k, v are contiguous
    ``[B, T, H, D]`` with 16-byte aligned data).

    Tensor cores where :func:`takes_tensor_cores`, else the KV-tiled
    kernel (:func:`tiled_plan`). Raises ValueError for D, Tq or Tk below
    1."""
    if takes_tensor_cores(tq, tk, d, compute_dtype):
        return _tc_plan(b, tq, h, d, contiguous)
    return tiled_plan(b, tq, tk, d, compute_dtype)


def flash_block_info(variant: str, t: int, d: int,
                     compute_dtype: torch.dtype = torch.float32,
                     path: str = "") -> dict[str, int]:
    """Compiled resources of one B3 instance on the card (variant "tc" at
    T = Tq = Tk and D, bf16; or "tiled" on ``path`` — by default the one
    :func:`tiled_plan` takes at Tq = Tk = ``t`` — at the padded head dim of
    D for ``compute_dtype``, the ring's instance for a KV row of ``t``
    keys):
    registers per thread, static shared bytes, local (spill) bytes, max
    threads per block."""
    bf16 = int(compute_dtype == torch.bfloat16)
    if variant == "tc":
        key, bf16, code = d, 1, 0
    else:
        plan = tiled_plan(1, t, t, d, compute_dtype)
        key, code = plan.dp, _PATHS[path or plan.path]
    out = (_c_int * 4)()
    rc = _lib().kt_flash_block_info(int(variant == "tc"), t, key, bf16,
                                    code, out)
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


def needed_rows(kv_valid: torch.Tensor, tq: int, q_start: int,
                kv_start: int, causal: bool) -> tuple[int, int]:
    """(query rows, keys) that the call's scores and values need, over all
    sequences (per head): a query row that sees any valid key, and a
    valid key that any query row sees. The rest are masked whole and need
    no q, K or V byte."""
    valid = (kv_valid > 0.5) if kv_valid.dtype != torch.bool else kv_valid
    tk = valid.shape[1]
    any_valid = valid.any(dim=1)
    if not causal:
        return tq * int(any_valid.sum()), int(valid.sum())
    j = torch.arange(tk, device=valid.device)
    # the last query row sees key j when q_start + tq - 1 >= kv_start + j
    keys = int((valid & (j <= q_start + tq - 1 - kv_start)).sum())
    # row i sees the sequence's first valid key f when
    # q_start + i >= kv_start + f
    first = torch.where(valid, j, tk).min(dim=1).values
    rows = torch.clamp(tq - torch.clamp(kv_start + first - q_start, min=0),
                       0, tq)
    return int(torch.where(any_valid, rows, 0).sum()), keys


def flash_block_cost(b: int, tq: int, tk: int, h: int, d: int, pairs: int,
                     q_rows: int, keys: int,
                     compute_dtype: torch.dtype = torch.bfloat16
                     ) -> tuple[int, int, float]:
    """B3 → (bytes, operations, peak rate for their type): the ``q_rows``
    query rows and ``keys`` K and V rows the output needs (f32, summed
    over sequences, :func:`needed_rows`) and the KV-validity bytes read
    once, pv, m and l (f32) written once for every row; 2·D operations for
    a score and 2·D for its share of p·v, for each of the ``pairs``
    unmasked (sequence, query, key) triples of each head."""
    nbytes = 4 * h * d * (q_rows + 2 * keys) + b * tk \
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
    q_rows, keys = needed_rows(kv_valid, tq, q_start, kv_start, causal)
    nbytes, ops, rate = flash_block_cost(b, tq, k.shape[1], h, d, pairs,
                                         q_rows, keys, compute_dtype)
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


@recorder.records_kernel("flash_block")
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
    m [B,H,Tq], l [B,H,Tq]) — the ``block_attn`` contract, as kernel B3.

    B3 has no backward, as the TPU kernel has none (``jax.grad`` through
    it fails): under autograd, with q, k or v requiring grad, the call
    raises ValueError on every device, so the plain version never stands
    in for a gradient the card cannot give."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise ValueError(
            "flash_block_pallas (kernel B3) has no backward, like the TPU "
            "kernel it replaces: differentiate through the einsum backend "
            "(ops.attention.block_attn, ring backend='einsum') or call it "
            "under torch.no_grad() / torch.inference_mode()")
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
    :func:`tiled_plan`'s to time the tiled variant where the tensor-core
    one would run. The kernel refuses a plan it does not take (the call
    raises)."""
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
            rc = lib.kt_flash_block_tiled(
                *ptrs, b, tq, tk, h, d, plan.dp, plan.g, plan.qr, plan.tk,
                *strides, int(q_start), int(kv_start), int(causal),
                int(compute_dtype == torch.bfloat16), int(vec),
                _PATHS[plan.path], scale, stream)
    _raise_on(rc, f"flash_block ({plan.variant})")
    LAUNCHES["flash_block"] += 1
    LAUNCHES[f"flash_block_{plan.variant}"] += 1
    if plan.variant == "tiled":
        TILED_PATH_LAUNCHES[plan.path] += 1
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

