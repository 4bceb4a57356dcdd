// Attention partial kernel for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes by kepler_tpu_torch/ops/cuda_attention.py.
//
// B3  kt_flash_block_tc, kt_flash_block_tiled
//   Replaces kepler_tpu/ops/pallas_attention.py::flash_block_pallas (Pallas
//   body _flash_kernel). One fused (q-block x kv-block) attention partial,
//   the ops/attention.py block_attn contract:
//     s  = cd(q) . cd(k)^T * scale      f32 accumulation, scale = 1/sqrt(D)
//     mask = kv_valid[b, j] && (!causal || q_start + i >= kv_start + j)
//     m  = rowmax(mask ? s : -1e30),  p = mask ? exp(s - m) : 0,
//     l  = rowsum(p),  pv = cd(p) . cd(v)   f32 accumulation
//   cd is bf16 (round to nearest even, then multiply as f32: products of
//   two bf16 values are exact in f32) or f32. A fully masked row gives
//   m = -1e30, l = 0, pv = 0. The TPU kernel takes whole (Tq, D) and
//   (Tk, D) blocks, one grid step per (sequence, head), so any Tq, Tk and
//   D; so does the pair of variants here.
//   In: q [B, Tq, H, D], k and v [B, Tk, H, D] f32, each with its own
//   (b, t, h) strides and unit d stride; kv_valid u8 [B, Tk] contiguous.
//   Out (contiguous): pv f32 [B, Tq, H, D], m and l f32 [B, H, Tq].
//
//   Bound: bytes. At the temporal trunk's serving shape (B = 262,144
//   sequences of T = 16 ticks, H = 4, D = 32) q, k and v are read once and
//   pv written once: ~8.7 GB, ~2.6 ms at 3.35 TB/s, while the two
//   contractions are ~34 GFLOP (~18 under the causal mask).
//
//   Two variants, chosen by the wrapper (ops/cuda_attention.py) from the
//   compute type and the shape alone:
//
//   kt_flash_block_tc: bf16 compute with Tq == Tk = T a multiple of 16 up
//   to 128 and D in {16, 32, 64} (the trunk's default). What held the
//   first design at 2.5-4.8x its bound: runtime div/mod in the staging
//   loops, staging and compute serialised inside each block (2-3 blocks
//   an SM, so little memory traffic in flight while blocks computed), and
//   every score computed twice on the FMA pipe. This design:
//   - Persistent blocks (as many as fit on each SM) walk over work items
//     of g sequences x hb heads. Each item's q, k and v are staged in a
//     ring of two shared-memory stages, loaded asynchronously, so the
//     next item arrives while the current one computes (48 KB an item at
//     the trunk's shapes: ~96 KB in flight an SM). Where an item's rows
//     are contiguous in device memory (hb = H on a contiguous
//     [B, T, H, D]: one 8 KB run each at T = 16) one thread issues three
//     cp.async.bulk copies (1-D TMA) that complete on an mbarrier;
//     otherwise (hb = 1: strided views, T > 16) every thread issues
//     16-byte cp.async copies (4-byte ones where strides or pointers are
//     not 16-byte aligned) into rows padded by 4 floats. Instances whose
//     two stages fit twice in shared memory are compiled for two blocks
//     an SM (at most 128 registers: 64 at T = 16, 128 at T = 128 with
//     D = 32, no spills).
//   - Both contractions run on the tensor cores: mma.sync m16n8k16 with
//     bf16 operands and f32 accumulators. A warp owns 16 query rows of
//     one (sequence, head); operands are rounded f32 -> bf16 (RNE) as the
//     fragments are formed from shared memory. The contraction index is
//     permuted identically in both operands (free for a sum), so each
//     lane reads q and k as float4, and key columns are assigned so that
//     each lane's score registers are exactly its A fragment of P.V.
//   - The plain version's math is kept: the whole key row (Tk <= 128)
//     stays in registers, one pass, no online-softmax rescaling. The
//     scale is an explicit __fmul_rn, the mask is applied, the row max
//     taken with quad shuffles, p = expf(s - m), l sums the unrounded p
//     in f32, and p is rounded to bf16 in the registers as P.V's A
//     operand. Only summation order differs from block_attn.
//   - Key tiles wholly above the causal diagonal (from q_start and
//     kv_start) or past the sequence's last valid key are skipped, in
//     the products and in the softmax loops.
//   - T and D are template parameters, so no staging index divides at
//     run time; pv is staged back through shared memory for coalesced
//     16-byte stores; m and l are written from registers.
//
//   kt_flash_block_tiled: every other call -- f32 compute (accuracy
//   mode), Tq != Tk, T not a multiple of 16 or above 128 (the ring's
//   512-row blocks), and any D. Neither Tq, Tk nor D is bounded by
//   threads or shared memory. The plain version's math on every path:
//   the exact row max before any expf, no online rescaling (it would
//   change the bf16 rounding of p against block_attn and JAX, and f32 by
//   more than summation order), p = expf(s - m), l summed from the
//   unrounded p, p rounded to bf16 as P.V's operand at bf16, scores an
//   explicit fmaf chain (f32) or mma.sync (bf16) scaled by an explicit
//   __fmul_rn, so two passes over a key cannot round it differently. The
//   wrapper's plan (ops/cuda_attention.py tiled_plan) picks one of three
//   paths from the compute type and the shape:
//   - The ring (path 0). A work item is a tile of up to 128 query rows of
//     one (sequence, head), or, where a sequence's whole q and KV fit one
//     tile (T = 16), the query rows of g sequences of one head (one at
//     bf16 above DP = 64, where a warp's math is a fraction of its loads
//     and one-warp blocks overlap them best); a warp owns 16 query rows.
//     Persistent blocks walk the items; q, K and V
//     arrive by 16-byte cp.async copies (4-byte ones where strides or
//     pointers are not 16-byte aligned) that zero-fill padding columns
//     and rows past Tq or Tk, so a masked key meets a zero value row,
//     never a stale one; rows are padded by 4 floats, D to DP (16, 32,
//     64, 128 or 256; at least 32 for f32); the item's KV-validity bytes
//     ride with each K tile. One score pass where a warp's 16 rows x
//     its keys fit its registers: up to DP = 64 one tile holds a KV row
//     of up to 128 keys (64 scores a lane, as in the tc variant at T =
//     128), so the item loads q, K and V once and computes each score
//     once: the f32 ring's 128-row blocks, accuracy mode at T = 16 and
//     the D = 128 trunk. Longer rows stream through two stages in tiles
//     of 64, 32 or 16 keys (by DP): pass 1 takes the row max over every
//     needed tile from the scores alone, pass 2 recomputes them for p,
//     l and P.V. bf16 runs both products on the tensor cores with the
//     tc variant's fragment scheme (operands rounded f32 -> bf16 as the
//     fragments form); f32 runs them on the FMA pipe with 4x2 score and
//     4x4 pv micro-tiles a lane, p going through a per-warp p^T tile (a
//     one-pass warp's own q rows, read in full by then). The 128-key
//     instances take single-tile items only and are compiled for two
//     blocks an SM (at most 128 registers) up to DP = 32.
//   - Resident (path 1): bf16 where a KV row is longer than one tile and
//     K and V fit shared memory whole (D up to 64: the 2-shard ring's
//     512-row blocks). One (sequence, head) an item: the block converts
//     K and V to bf16 once, as they land (rows of DP + 8 values, 16 loads
//     in flight a thread), builds the sequence's visibility bits, and
//     its 8 warps walk their 16-row blocks of q (each loaded one block
//     ahead, straight into A fragments; not loaded where no row of the
//     block sees a key) against them with no further
//     barrier: pass 1 the row max, pass 2 p, l and P.V, K and V read as
//     B fragments by ldmatrix (.trans for V). The next item's validity
//     bytes arrive by cp.async while this one computes.
//   - Wide (path 2): D above 256 (the trunk at d_model above 1024). One
//     warp a block and eight blocks an SM (where a tile holds 16 keys),
//     each warp walking over items of (sequence, head, 16 query rows)
//     with a stream of loads of its own: a ring of three stages, each a
//     64-column chunk of q and of a KV tile's K rows (or of its V rows),
//     filled by 16-byte cp.async copies while the earlier stages compute,
//     so the next chunks and the next item's are in flight meanwhile; no
//     block barrier. (On an H100, four stages or 32-column chunks left
//     fewer warps an SM and were slower, most at f32; 128-column chunks
//     too.) The copies
//     zero-fill, without reading, the q rows that see no key and the K
//     and V rows past the last key a row sees; the item's validity bytes
//     are read one item ahead and ride in each stage's header as
//     visibility bits. Where the visible keys fit one tile of up to 64
//     (every block up to T = 64: the served windows) the warp sums each
//     score over all of D in its own registers, chunk after chunk, takes
//     the exact row max from them, forms p once and streams V's chunks
//     into pv: q, K and V are each staged once. Longer rows take two
//     passes over 64-key tiles (pv summed over tiles in device memory by
//     the lane that owns each element). bf16 runs both products on the
//     tensor cores with the tc variant's fragment scheme (operands rounded
//     f32 -> bf16 as the fragments form, each element once), f32 on the
//     FMA pipe (fmaf chains, no TF32). Neither shared memory nor
//     registers grow with D.
//   On every path: key tiles (16-key groups on the resident path) past
//   the sequence's last valid key or above the causal diagonal of the
//   rows that need them are neither loaded nor computed -- an item that
//   the causal mask hides whole loads nothing and writes m = -1e30, l =
//   0, pv = 0 -- and a warp tests validity bits in registers or shared
//   memory, built once per tile from the staged bytes by ballots, never
//   bytes in device memory per score; a 16-key group that is valid and
//   below the causal diagonal of every row of the warp skips the
//   per-score mask. Causal work is evened out across warps: in an
//   8-warp ring item warps w and w + 4 (which share one of the SM's four
//   schedulers) take row blocks w and 7 - w; on the resident path row
//   blocks go to warps in rounds, reversed every other round.
//
//   What bounds it: bytes, as above, where T = 16; at T = 128 f32 the
//   FMA pipe's share of the work (~0.9 ms at the f32 peak for B =
//   16,384, H = 4, D = 32) plus its shared-memory traffic (each lane
//   reads q, k, p and v as float4, whole quarter-warps on one address)
//   with only 16 warps an SM to hide the latency, since a 128-key row
//   takes 64 of a lane's 128 registers.

// Numerics: expf (no fast math); both variants differ from the plain
// PyTorch version only in summation order. Build without --use_fast_math
// or -ftz=true.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxSmem = 227 * 1024;
constexpr float kNegInf = -1e30f;

// -- tensor-core variant ------------------------------------------------------

constexpr int kTcStages = 2;
constexpr int kTcMaxThreads = 256;
// floats that pad each staged row on the cp.async path (hb == 1): rows
// of D + 4 floats put a lane quad's v reads two ways into the banks, not
// four (bulk copies land rows unpadded, as they lie in device memory)
constexpr int kTcPad = 4;

// smem row stride (floats) of a stage
__host__ __device__ constexpr int tc_row(int hb, int d, bool bulk) {
  return bulk ? hb * d : d + kTcPad;
}

// Blocks an SM is compiled for: two where two blocks of one padded
// (sequence, head) unit fit in shared memory (the compiler then keeps
// registers at or below 128), else one.
template <int T, int D>
constexpr int tc_min_blocks() {
  return 2 * (kTcStages * 3 * T * (D + kTcPad) * 4 + 1024) <= 228 * 1024
             ? 2 : 1;
}

struct TcArgs {
  const float* q;
  const float* k;
  const float* v;
  const unsigned char* kv_valid;
  float* pv;
  float* m;
  float* l;
  long long qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh;
  int B, H, hb, g, q_start, kv_start, causal, bulk, vec;
  int n_items, n_hgroups;
  float scale;
};

__host__ __device__ inline size_t tc_smem_bytes(int g, int hb, int t,
                                                int d, bool bulk) {
  return (size_t)kTcStages * 3 * g * t * tc_row(hb, d, bulk) *
             sizeof(float) +
         kTcStages * sizeof(uint64_t);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// two f32 values rounded to bf16 (RNE), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += A[16x16] . B[16x8], bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Spins until the phase of parity `parity` completes; traps (a launch
// error, not a hang) if it has not after ~10 s of SM clock.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done = 0;
  do {
    if (clock64() - t0 > 20000000000LL) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// 1-D TMA: bytes (a multiple of 16, both addresses 16-byte aligned) from
// device memory to shared memory, completing on bar
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// 16 (or 4) bytes into shared memory, the first n of them from src and
// the rest zero (n = 0 reads nothing from src)
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 uint32_t n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src,
                                                uint32_t n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every committed group but the newest N has landed
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_oldest() {
  cp_async_wait_group<kTcStages - 1>();
}

struct TcItem {
  int b0, h0, nb;
};

__device__ __forceinline__ TcItem tc_item(const TcArgs& a, int item) {
  const int bblk = item / a.n_hgroups;
  const int hg = item - bblk * a.n_hgroups;
  const int b0 = bblk * a.g;
  return {b0, hg * a.hb, min(a.g, a.B - b0)};
}

// Start the loads of one item into a stage: q, k, v tiles of
// [g][T][hb][D] f32. bulk: hb == H and the item's rows are one contiguous
// run each; else hb == 1 and every thread copies 16 (vec) or 4 bytes.
// The cp.async path commits one group per call, loads or not.
template <int T, int D>
__device__ __forceinline__ void tc_issue(const TcArgs& a, float* stage,
                                         uint64_t* bar, int tile,
                                         int item) {
  float* qs = stage;
  float* ks = qs + tile;
  float* vs = ks + tile;
  if (item >= a.n_items) {
    if (!a.bulk) cp_async_commit();
    return;
  }
  const TcItem it = tc_item(a, item);
  if (a.bulk) {
    if (threadIdx.x == 0) {
      // order earlier generic accesses of the stage before the async
      // proxy's writes
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      const uint32_t bytes = (uint32_t)it.nb * T * a.hb * D * sizeof(float);
      mbar_expect_tx(bar, 3 * bytes);
      bulk_g2s(qs, a.q + it.b0 * a.qsb, bytes, bar);
      bulk_g2s(ks, a.k + it.b0 * a.ksb, bytes, bar);
      bulk_g2s(vs, a.v + it.b0 * a.vsb, bytes, bar);
    }
    return;
  }
  const int rows = it.nb * T;  // head rows of D floats
  if (a.vec) {
    constexpr int C = D / 4;
    for (int e = threadIdx.x; e < rows * C; e += blockDim.x) {
      const int r = e / C;
      const int c = (e - r * C) * 4;
      const int gi = r / T;
      const int t = r - gi * T;
      const long long b = it.b0 + gi;
      const int at = r * (D + kTcPad) + c;
      cp_async16(qs + at, a.q + b * a.qsb + t * a.qst + it.h0 * a.qsh + c);
      cp_async16(ks + at, a.k + b * a.ksb + t * a.kst + it.h0 * a.ksh + c);
      cp_async16(vs + at, a.v + b * a.vsb + t * a.vst + it.h0 * a.vsh + c);
    }
  } else {
    for (int e = threadIdx.x; e < rows * D; e += blockDim.x) {
      const int r = e / D;
      const int c = e - r * D;
      const int gi = r / T;
      const int t = r - gi * T;
      const long long b = it.b0 + gi;
      const int at = r * (D + kTcPad) + c;
      cp_async4(qs + at, a.q + b * a.qsb + t * a.qst + it.h0 * a.qsh + c);
      cp_async4(ks + at, a.k + b * a.ksb + t * a.kst + it.h0 * a.ksh + c);
      cp_async4(vs + at, a.v + b * a.vsb + t * a.vst + it.h0 * a.vsh + c);
    }
  }
  cp_async_commit();
}

// One warp: 16 query rows (r0 = 16 * wq) of sequence b, head h, from the
// unit's staged tiles (row stride rs floats). Writes m and l, and leaves
// its pv rows in place of its q rows in shared memory.
template <int T, int D>
__device__ __forceinline__ void tc_warp(const TcArgs& a, float* qs,
                                        const float* ks, const float* vs,
                                        int rs, int wq, int b, int h) {
  constexpr int NKT = T / 16;  // key tiles of 16
  constexpr int DK = D / 16;   // k-steps of q.k
  constexpr int DN = D / 8;    // n-tiles of p.v
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int r0 = wq * 16;
  const unsigned char* valid = a.kv_valid + (size_t)b * T;

  // key tiles this warp needs: none past the sequence's last valid key,
  // none wholly above the causal diagonal of its last row
  int last = -1;
  if (lane * 4 < T) {
    const uchar4 v4 = *reinterpret_cast<const uchar4*>(valid + lane * 4);
    last = v4.w ? lane * 4 + 3
         : v4.z ? lane * 4 + 2
         : v4.y ? lane * 4 + 1
         : v4.x ? lane * 4 : -1;
  }
  last = __reduce_max_sync(0xffffffffu, last);
  int kt_end = (last + 16) / 16;
  if (a.causal) {
    const int span = a.q_start + r0 + 15 - a.kv_start;
    kt_end = min(kt_end, span < 0 ? 0 : span / 16 + 1);
  }

  // A fragments of q: lane (g, t4) holds d = 16c + 4t4 + {0,1} in a0/a1
  // and {2,3} in a2/a3 (rows g, g + 8); k's B fragments use the same
  // permutation of d, so the sum is unchanged
  uint32_t qa[DK][4];
#pragma unroll
  for (int c = 0; c < DK; ++c) {
    const float4 x = *reinterpret_cast<const float4*>(
        qs + (r0 + g) * rs + 16 * c + 4 * t4);
    const float4 y = *reinterpret_cast<const float4*>(
        qs + (r0 + g + 8) * rs + 16 * c + 4 * t4);
    qa[c][0] = pack_bf16(x.x, x.y);
    qa[c][1] = pack_bf16(y.x, y.y);
    qa[c][2] = pack_bf16(x.z, x.w);
    qa[c][3] = pack_bf16(y.z, y.w);
  }

  // scores: n-tile 2kt + half holds, in lane (g, t4), keys
  // 16kt + 4t4 + 2half + {0, 1} for rows g (s[..][0..1]) and g + 8
  // (s[..][2..3]); B column n reads key 16kt + 2n - (n & 1) + 2half
  float s[2 * NKT][4];
  uint32_t ok0 = 0, ok1 = 0;  // bit 4kt + e: key 16kt + 4t4 + e visible
  const int qpos = a.q_start + r0 + g;
#pragma unroll
  for (int kt = 0; kt < NKT; ++kt) {
    if (kt >= kt_end) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float(&c)[4] = s[2 * kt + half];
      c[0] = c[1] = c[2] = c[3] = 0.0f;
      const int key = 16 * kt + 2 * g - (g & 1) + 2 * half;
#pragma unroll
      for (int dc = 0; dc < DK; ++dc) {
        const float4 kk = *reinterpret_cast<const float4*>(
            ks + key * rs + 16 * dc + 4 * t4);
        mma_bf16(c, qa[dc][0], qa[dc][1], qa[dc][2], qa[dc][3],
                 pack_bf16(kk.x, kk.y), pack_bf16(kk.z, kk.w));
      }
    }
    const uchar4 v4 =
        *reinterpret_cast<const uchar4*>(valid + 16 * kt + 4 * t4);
    const unsigned char vb[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kpos = a.kv_start + 16 * kt + 4 * t4 + e;
      const bool o0 = vb[e] && (!a.causal || qpos >= kpos);
      const bool o1 = vb[e] && (!a.causal || qpos + 8 >= kpos);
      ok0 |= (uint32_t)o0 << (4 * kt + e);
      ok1 |= (uint32_t)o1 << (4 * kt + e);
    }
  }

  // scale, mask, row max (over the quad that shares a row)
  float m0 = kNegInf, m1 = kNegInf;
#pragma unroll
  for (int kt = 0; kt < NKT; ++kt) {
    if (kt >= kt_end) continue;  // all masked: -1e30, the max's floor
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int bit = 4 * kt + e;
      float& x0 = s[2 * kt + (e >> 1)][e & 1];
      float& x1 = s[2 * kt + (e >> 1)][2 + (e & 1)];
      x0 = (ok0 >> bit) & 1u ? __fmul_rn(x0, a.scale) : kNegInf;
      x1 = (ok1 >> bit) & 1u ? __fmul_rn(x1, a.scale) : kNegInf;
      m0 = fmaxf(m0, x0);
      m1 = fmaxf(m1, x1);
    }
  }
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));

  // p = exp(s - m) where visible, else 0; l sums the unrounded p
  float l0 = 0.0f, l1 = 0.0f;
#pragma unroll
  for (int kt = 0; kt < NKT; ++kt) {
    if (kt >= kt_end) continue;  // all masked: p = 0
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int bit = 4 * kt + e;
      float& x0 = s[2 * kt + (e >> 1)][e & 1];
      float& x1 = s[2 * kt + (e >> 1)][2 + (e & 1)];
      x0 = (ok0 >> bit) & 1u ? expf(x0 - m0) : 0.0f;
      x1 = (ok1 >> bit) & 1u ? expf(x1 - m1) : 0.0f;
      l0 += x0;
      l1 += x1;
    }
  }
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);

  // pv = bf16(p) . bf16(v): the score registers of key tile kt are the A
  // fragment (keys 16kt + 4t4 + {0,1} in a0/a1, {2,3} in a2/a3)
  float o[DN][4];
#pragma unroll
  for (int dt = 0; dt < DN; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.0f;
#pragma unroll
  for (int kt = 0; kt < NKT; ++kt) {
    if (kt >= kt_end) continue;
    const uint32_t p0 = pack_bf16(s[2 * kt][0], s[2 * kt][1]);
    const uint32_t p1 = pack_bf16(s[2 * kt][2], s[2 * kt][3]);
    const uint32_t p2 = pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]);
    const uint32_t p3 = pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3]);
    const float* vr = vs + (16 * kt + 4 * t4) * rs + g;
#pragma unroll
    for (int dt = 0; dt < DN; ++dt) {
      const float* vc = vr + 8 * dt;
      mma_bf16(o[dt], p0, p1, p2, p3, pack_bf16(vc[0], vc[rs]),
               pack_bf16(vc[2 * rs], vc[3 * rs]));
    }
  }

  if (t4 == 0) {
    const size_t stat = ((size_t)b * a.H + h) * T + r0 + g;
    a.m[stat] = m0;
    a.l[stat] = l0;
    a.m[stat + 8] = m1;
    a.l[stat + 8] = l1;
  }
  // pv in place of this warp's own q rows (no other warp reads them)
  __syncwarp();
#pragma unroll
  for (int dt = 0; dt < DN; ++dt) {
    *reinterpret_cast<float2*>(qs + (r0 + g) * rs + 8 * dt + 2 * t4) =
        make_float2(o[dt][0], o[dt][1]);
    *reinterpret_cast<float2*>(qs + (r0 + g + 8) * rs + 8 * dt + 2 * t4) =
        make_float2(o[dt][2], o[dt][3]);
  }
}

template <int T, int D>
__global__ void __launch_bounds__(kTcMaxThreads, tc_min_blocks<T, D>())
flash_block_tc_kernel(const TcArgs a) {
  extern __shared__ __align__(128) float smem[];
  constexpr int NKT = T / 16;
  const int rs = tc_row(a.hb, D, a.bulk);
  const int tile = a.g * T * rs;  // floats of q (or k, v) a stage
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kTcStages * 3 * tile);
  // this warp's unit (sequence gi, head hh of the item) and its rows
  const int warp = threadIdx.x >> 5;
  const int unit = warp / NKT;
  const int wq = warp - unit * NKT;
  const int gi = unit / a.hb;
  const int hh = unit - gi * a.hb;
  const int unit_off = gi * T * rs + hh * D;

  if (a.bulk && threadIdx.x == 0) {
    for (int st = 0; st < kTcStages; ++st) mbar_init(&bars[st], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  for (int st = 0; st < kTcStages; ++st) {
    tc_issue<T, D>(a, smem + st * 3 * tile, &bars[st], tile,
                   blockIdx.x + st * gridDim.x);
  }
  int n = 0;
  for (int item = blockIdx.x; item < a.n_items; item += gridDim.x, ++n) {
    const int st = n % kTcStages;
    float* qs = smem + st * 3 * tile;
    if (a.bulk) {
      mbar_wait(&bars[st], (uint32_t)(n / kTcStages) & 1u);
    } else {
      cp_async_wait_oldest();
    }
    __syncthreads();
    const TcItem it = tc_item(a, item);
    if (gi < it.nb) {
      tc_warp<T, D>(a, qs + unit_off, qs + tile + unit_off,
                    qs + 2 * tile + unit_off, rs, wq, it.b0 + gi,
                    it.h0 + hh);
    }
    __syncthreads();
    // coalesced pv store from the stage's q tile
    if (a.bulk) {  // the item is one contiguous run of pv
      const int n4 = it.nb * T * a.hb * (D / 4);
      float4* dst = reinterpret_cast<float4*>(a.pv + (size_t)it.b0 * T * a.H * D);
      const float4* src = reinterpret_cast<const float4*>(qs);
      for (int e = threadIdx.x; e < n4; e += blockDim.x) dst[e] = src[e];
    } else {  // hb == 1: head rows of D floats (padded in the stage)
      constexpr int C = D / 4;
      for (int e = threadIdx.x; e < it.nb * T * C; e += blockDim.x) {
        const int r = e / C;
        const int c = (e - r * C) * 4;
        *reinterpret_cast<float4*>(
            a.pv + ((size_t)it.b0 * T + r) * a.H * D + it.h0 * D + c) =
            *reinterpret_cast<const float4*>(qs + r * rs + c);
      }
    }
    __syncthreads();
    tc_issue<T, D>(a, qs, &bars[st], tile, item + kTcStages * gridDim.x);
  }
  if (!a.bulk) asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Launch a persistent kernel: as many blocks as fit on every SM, at most
// one per work item.
template <class Args>
int launch_persistent(void (*kern)(Args), const Args& a, int n_items,
                      int threads, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kern, threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long cap = (long long)per_sm * sms;
  const int grid = (int)(n_items < cap ? n_items : cap);
  kern<<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int T, int D>
int launch_tc(const TcArgs& a, int threads, size_t smem,
              cudaStream_t stream) {
  return launch_persistent(flash_block_tc_kernel<T, D>, a, a.n_items,
                           threads, smem, stream);
}

// -- KV-tiled variant -----------------------------------------------------------

constexpr int kTlStages = 2;
constexpr int kTlMaxThreads = 256;
constexpr int kTlPad = 4;      // floats padding each staged f32 row
constexpr int kTlQRows = 128;  // query rows of an item's tile at most
constexpr int kTlPRow = 20;    // f32: floats of one key's row of a warp's p^T
constexpr int kTlMaxDP = 256;  // widest padded head dim of the ring path
constexpr int kTlBPad = 8;     // bf16 elements padding each resident row

// the three paths of the variant, as the wrapper's plan names them
enum TlPath { kTlRing = 0, kTlResident = 1, kTlWide = 2 };

// keys a KV tile holds at most, by padded head dim: where one tile holds
// the whole KV row, up to DP = 64 a 128-key row (one score pass: the
// ring's 128-row blocks); where an item streams several tiles, tiles that
// keep a lane's scores and pv accumulators within its registers. Every DP
// also has an instance for tiles of 16 keys (T <= 16: the trunk's serving
// windows), which needs fewer registers.
__host__ __device__ constexpr int tl_keys(int dp) {
  return dp <= 64 ? 128 : dp == 128 ? 32 : 16;
}
__host__ __device__ constexpr int tl_stream_keys(int dp) {
  return dp <= 64 ? 64 : tl_keys(dp);
}

// blocks an SM each instance is compiled for (registers: 128 a thread at
// two, 255 at one, which 128-key rows at DP = 64 and DP >= 128 need)
template <int DP, int TK>
constexpr int tl_min_blocks() {
  return DP <= 32 || (DP == 64 && TK <= 64) ? 2 : 1;
}

__host__ __device__ inline bool tl_dp_ok(int dp, bool bf16) {
  return (bf16 && dp == 16) || dp == 32 || dp == 64 || dp == 128 ||
         dp == kTlMaxDP;
}

struct TlArgs {
  const float* q;
  const float* k;
  const float* v;
  const unsigned char* kv_valid;
  float* pv;
  float* m;
  float* l;
  long long qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh;
  int B, Tq, Tk, H, D;
  int g, qr, tk;  // sequences an item, its query rows, keys of a KV tile
  int nqt, nkt;   // query tiles of a (sequence, head), key tiles of Tk
  int nch;        // wide path: column chunks of D
  int n_items, warps;
  int q_start, kv_start, causal, vec, valid4;
  float scale;
};

// Keys [0, end) that query row i may see under the causal mask (all of
// Tk without it), at least 0.
__device__ __forceinline__ int tl_causal_end(const TlArgs& a, int i) {
  if (!a.causal) return a.Tk;
  return max(0, min(a.Tk, a.q_start + i - a.kv_start + 1));
}

// Shared memory of one ring block: kTlStages q slots [g][qr][DP + pad], as
// many K and V stages [g][tk][DP + pad], where an item streams several KV
// tiles (multi) the f32 variant's p^T tiles [warps][16][kTlPRow] (a
// single-tile item's warp keeps its p^T in its own q rows, which it has
// read in full by then), the stages' KV-validity bytes [g][tk], and per q
// slot the item's tile count and last valid key, then 8 ints of block
// reduction.
__host__ __device__ inline size_t tl_smem_bytes(int g, int qr, int tk,
                                                int dp, bool bf16,
                                                bool multi) {
  const size_t rs = (size_t)dp + kTlPad;
  const size_t warps = (size_t)g * qr / 16;
  return sizeof(float) *
             ((size_t)kTlStages * g * rs * (qr + 2 * (size_t)tk) +
              (bf16 || !multi ? 0 : warps * 16 * kTlPRow)) +
         (size_t)kTlStages * g * tk + sizeof(int) * (2 * kTlStages + 8);
}

struct TlItem {
  int b0, h, qt, nb;
};

// items: (sequence block, head, query tile), the query tile fastest, so
// the tiles of one (sequence, head) run side by side and share its K
// and V in L2
__device__ __forceinline__ TlItem tl_item(const TlArgs& a, int item) {
  const int qt = item % a.nqt;
  const int r = item / a.nqt;
  const int h = r % a.H;
  const int b0 = (r / a.H) * a.g;
  return {b0, h, qt, min(a.g, a.B - b0)};
}

// Start copies of `rows` rows t0 + r of head h of the item's nb
// sequences of x into dst ([nb][slot_rows][DP + pad], slot_rows >= rows):
// rows at or past t_end and columns at or past D are zero-filled.
template <int DP>
__device__ __forceinline__ void tl_rows(const TlArgs& a, float* dst,
                                        const float* x, long long sb,
                                        long long st, long long sh,
                                        const TlItem& it, int t0, int rows,
                                        int slot_rows, int t_end) {
  constexpr int rs = DP + kTlPad;
  if (rows <= 0) return;
  const float* base = x + it.b0 * sb + (long long)it.h * sh;
  // rows is 16, 32, 48, 64, ...: a shift where it is a power of two
  const bool pow2 = (rows & (rows - 1)) == 0;
  const int lg = __ffs(rows) - 1;
  if (a.vec) {
    constexpr int C = DP / 4;
    const int n = it.nb * rows * C;
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int ra = e / C;  // C is a power of two
      const int c = (e - ra * C) * 4;
      const int gi = pow2 ? ra >> lg : ra / rows;
      const int r = ra - gi * rows;
      const int t = t0 + r;
      const int bytes = t < t_end ? 4 * min(max(a.D - c, 0), 4) : 0;
      cp_async16_zfill(dst + (gi * slot_rows + r) * rs + c,
                       bytes ? base + gi * sb + (long long)t * st + c : x,
                       (uint32_t)bytes);
    }
  } else {
    const int n = it.nb * rows * DP;
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int ra = e / DP;
      const int c = e - ra * DP;
      const int gi = pow2 ? ra >> lg : ra / rows;
      const int r = ra - gi * rows;
      const int t = t0 + r;
      const int bytes = t < t_end && c < a.D ? 4 : 0;
      cp_async4_zfill(dst + (gi * slot_rows + r) * rs + c,
                      bytes ? base + gi * sb + (long long)t * st + c : x,
                      (uint32_t)bytes);
    }
  }
}

// The KV-validity bytes of keys t0 .. t0 + tk - 1 of the item's sequences
// into dst ([nb][tk]; zero past Tk): 4-byte cp.async copies where every
// row of kv_valid is 4-byte aligned (Tk % 4 == 0), else plain copies
// (visible to the consumer after the barrier that precedes it).
__device__ __forceinline__ void tl_bytes(const TlArgs& a, unsigned char* dst,
                                         const TlItem& it, int t0) {
  const unsigned char* src = a.kv_valid + (size_t)it.b0 * a.Tk + t0;
  if (a.valid4) {
    const int w = a.tk >> 2;
    for (int e = threadIdx.x; e < it.nb * w; e += blockDim.x) {
      const int gi = e / w;
      const int j = (e - gi * w) * 4;
      const int bytes = t0 + j < a.Tk ? 4 : 0;
      cp_async4_zfill(dst + gi * a.tk + j,
                      bytes ? src + (size_t)gi * a.Tk + j : a.kv_valid,
                      (uint32_t)bytes);
    }
  } else {
    for (int e = threadIdx.x; e < it.nb * a.tk; e += blockDim.x) {
      const int gi = e / a.tk;
      const int j = e - gi * a.tk;
      dst[gi * a.tk + j] = t0 + j < a.Tk ? src[(size_t)gi * a.Tk + j] : 0;
    }
  }
}

// The item's tile count n (key tiles up to the last one any of its rows
// can see: none past the sequence's last valid key, none wholly above the
// causal diagonal of its last row; at least one) and the sequence's last
// valid key, into the q slot's ints. Multi-tile items hold one sequence.
// All threads take part (two barriers).
__device__ int tl_tiles(const TlArgs& a, const TlItem& it, int* n_out,
                        int* last_out, int* red) {
  const unsigned char* valid = a.kv_valid + (size_t)it.b0 * a.Tk;
  int last = -1;
  for (int j = threadIdx.x; j < a.Tk; j += blockDim.x) {
    if (valid[j]) last = j;
  }
  last = __reduce_max_sync(0xffffffffu, last);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = last;
  __syncthreads();
  last = -1;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) last = max(last, red[w]);
  const int kend =
      min(last + 1, tl_causal_end(a, min((it.qt + 1) * a.qr, a.Tq) - 1));
  const int n = max(1, (kend + a.tk - 1) / a.tk);
  if (threadIdx.x == 0) {
    *n_out = n;
    *last_out = last;
  }
  __syncthreads();  // red is free again
  return n;
}

// The stream of loads of one block: item after item (blockIdx.x, then
// every gridDim.x-th), each one load where one KV tile serves both passes
// (n == 1), else n loads of K (pass 1: the row max) then n of K and V
// (pass 2); the q tile rides in the item's first load.
struct TlCursor {
  int item, j, n, load, count;  // count: items begun (their q slot)

  __device__ int loads() const { return n == 1 ? 1 : 2 * n; }
  __device__ void advance(int n_blocks) {
    ++load;
    if (++j == loads()) {
      j = 0;
      item += n_blocks;
      ++count;
    }
  }
};

// Issue the cursor's next load (one cp.async group; an empty one past
// the last item) and advance it. Neither q nor K and V rows that no row
// of the item can see under the causal mask are loaded: the warps never
// read them.
template <int DP>
__device__ void tl_produce(const TlArgs& a, TlCursor& p, float* qbuf,
                           float* kbuf, float* vbuf, unsigned char* bbuf,
                           int* ints) {
  if (p.item >= a.n_items) {
    cp_async_commit();
    return;
  }
  constexpr int rs = DP + kTlPad;
  const int q_tile = a.g * a.qr * rs;
  const int kv_tile = a.g * a.tk * rs;
  const TlItem it = tl_item(a, p.item);
  const int slot = p.count % kTlStages;
  const int cend = tl_causal_end(a, min((it.qt + 1) * a.qr, a.Tq) - 1);
  if (p.j == 0) {
    // the slot's previous item has been consumed in full by now
    p.n = a.nkt > 1 ? tl_tiles(a, it, ints + slot, ints + kTlStages + slot,
                               ints + 2 * kTlStages)
                    : 1;
    if (cend > 0) {
      tl_rows<DP>(a, qbuf + slot * q_tile, a.q, a.qsb, a.qst, a.qsh, it,
                  it.qt * a.qr, a.qr, a.qr, a.Tq);
    }
  }
  const int kt = p.n == 1 ? 0 : p.j % p.n;
  const int st = p.load % kTlStages;
  const int t0 = kt * a.tk;
  const int kr = min(a.tk, max(0, (cend - t0 + 15) & ~15));
  tl_rows<DP>(a, kbuf + st * kv_tile, a.k, a.ksb, a.kst, a.ksh, it, t0, kr,
              a.tk, a.Tk);
  tl_bytes(a, bbuf + st * a.g * a.tk, it, t0);
  if (p.n == 1 || p.j >= p.n) {
    tl_rows<DP>(a, vbuf + st * kv_tile, a.v, a.vsb, a.vst, a.vsh, it, t0,
                kr, a.tk, a.Tk);
  }
  cp_async_commit();
  p.advance(gridDim.x);
}

// The tile's visibility bits (bit j of word w: key 32w + j valid) from
// its staged validity bytes (zero past Tk), by ballots of the warp.
template <int NW>
__device__ __forceinline__ void tl_bits(const TlArgs& a,
                                        const unsigned char* bytes,
                                        uint32_t (&vw)[NW]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const int jl = 32 * w + lane;
    vw[w] = __ballot_sync(0xffffffffu, jl < a.tk && bytes[jl] != 0);
  }
}

// -- one warp's 16 query rows against one KV tile, bf16 (tensor cores)

template <int DP>
struct TlBf16 {
  float m0, m1, l0, l1;  // rows g, g + 8 of the lane
  float o[DP / 8][4];

  __device__ void init() {
    m0 = m1 = kNegInf;
    l0 = l1 = 0.0f;
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.0f;
  }
};

// Scores of the tile's first gend 16-key groups (keys t0 + ...) of the
// warp's rows (query i0 + r, r < 16; qs, ks, vs at its unit's row 0),
// then as asked: fold them into the row max; reduce the max over the
// lanes of a row; p, l and P.V against the reduced max. vw: the tile's
// visibility bits, which instances for tiles of more than 16 keys
// rebuild from the staged bytes after the scores instead (so they hold
// no registers meanwhile).
template <int DP, int TK>
__device__ __forceinline__ void tl_tile_bf16(
    const TlArgs& a, const float* qs, const float* ks, const float* vs,
    TlBf16<DP>& st, const unsigned char* bytes,
    const uint32_t (&vw_in)[TK > 32 ? TK / 32 : 1], int gend, int i0,
    int t0, bool do_max, bool reduce_max, bool do_pv) {
  constexpr int NG = TK / 16;
  constexpr int DK = DP / 16;
  constexpr int DN = DP / 8;
  constexpr int rs = DP + kTlPad;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  // s[2kk + half]: lane (g, t4) holds keys 16kk + 4t4 + 2half + {0, 1}
  // of rows g ([0..1]) and g + 8 ([2..3]), as in the tc variant
  float s[2 * NG][4];
  uint32_t ok0 = 0, ok1 = 0;  // bit 4kk + e: key 16kk + 4t4 + e visible
  if (gend > 0) {
#pragma unroll
    for (int n = 0; n < 2 * NG; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
    for (int dc = 0; dc < DK; ++dc) {
      const float4 x = *reinterpret_cast<const float4*>(
          qs + g * rs + 16 * dc + 4 * t4);
      const float4 y = *reinterpret_cast<const float4*>(
          qs + (g + 8) * rs + 16 * dc + 4 * t4);
      const uint32_t a0 = pack_bf16(x.x, x.y);
      const uint32_t a1 = pack_bf16(y.x, y.y);
      const uint32_t a2 = pack_bf16(x.z, x.w);
      const uint32_t a3 = pack_bf16(y.z, y.w);
#pragma unroll
      for (int kk = 0; kk < NG; ++kk) {
        if (kk >= gend) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int key = 16 * kk + 2 * g - (g & 1) + 2 * half;
          const float4 kv = *reinterpret_cast<const float4*>(
              ks + key * rs + 16 * dc + 4 * t4);
          mma_bf16(s[2 * kk + half], a0, a1, a2, a3, pack_bf16(kv.x, kv.y),
                   pack_bf16(kv.z, kv.w));
        }
      }
    }
    uint32_t vw[TK > 32 ? TK / 32 : 1];
#pragma unroll
    for (int w = 0; w < (TK > 32 ? TK / 32 : 1); ++w) vw[w] = vw_in[w];
    if constexpr (TK > 16) tl_bits(a, bytes, vw);
    const int qpos = a.q_start + i0 + g;
#pragma unroll
    for (int kk = 0; kk < NG; ++kk) {
      if (kk >= gend) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jl = 16 * kk + 4 * t4 + e;
        const bool vj = (vw[kk >> 1] >> (((kk & 1) << 4) + 4 * t4 + e)) & 1u;
        const int kpos = a.kv_start + t0 + jl;
        const bool o0 = vj && (!a.causal || qpos >= kpos);
        const bool o1 = vj && (!a.causal || qpos + 8 >= kpos);
        ok0 |= (uint32_t)o0 << (4 * kk + e);
        ok1 |= (uint32_t)o1 << (4 * kk + e);
        float& x0 = s[2 * kk + (e >> 1)][e & 1];
        float& x1 = s[2 * kk + (e >> 1)][2 + (e & 1)];
        x0 = o0 ? __fmul_rn(x0, a.scale) : kNegInf;
        x1 = o1 ? __fmul_rn(x1, a.scale) : kNegInf;
        if (do_max) {
          st.m0 = fmaxf(st.m0, x0);
          st.m1 = fmaxf(st.m1, x1);
        }
      }
    }
  }
  if (reduce_max) {
    st.m0 = fmaxf(st.m0, __shfl_xor_sync(0xffffffffu, st.m0, 1));
    st.m0 = fmaxf(st.m0, __shfl_xor_sync(0xffffffffu, st.m0, 2));
    st.m1 = fmaxf(st.m1, __shfl_xor_sync(0xffffffffu, st.m1, 1));
    st.m1 = fmaxf(st.m1, __shfl_xor_sync(0xffffffffu, st.m1, 2));
  }
  if (!do_pv || gend == 0) return;
#pragma unroll
  for (int kk = 0; kk < NG; ++kk) {
    if (kk >= gend) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float& x0 = s[2 * kk + (e >> 1)][e & 1];
      float& x1 = s[2 * kk + (e >> 1)][2 + (e & 1)];
      x0 = (ok0 >> (4 * kk + e)) & 1u ? expf(x0 - st.m0) : 0.0f;
      x1 = (ok1 >> (4 * kk + e)) & 1u ? expf(x1 - st.m1) : 0.0f;
      st.l0 += x0;
      st.l1 += x1;
    }
    // the group's score registers are P.V's A fragment; p rounds to bf16
    const uint32_t p0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    const uint32_t p1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    const uint32_t p2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    const uint32_t p3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    const float* vr = vs + (16 * kk + 4 * t4) * rs + g;
#pragma unroll
    for (int dt = 0; dt < DN; ++dt) {
      const float* vc = vr + 8 * dt;
      mma_bf16(st.o[dt], p0, p1, p2, p3, pack_bf16(vc[0], vc[rs]),
               pack_bf16(vc[2 * rs], vc[3 * rs]));
    }
  }
}

// l over the quad; m, l and pv to device memory from the registers (a
// warp's store of one column tile covers 16 rows of 32 bytes)
template <int DP>
__device__ __forceinline__ void tl_finish_bf16(const TlArgs& a,
                                               TlBf16<DP>& st, int b, int h,
                                               int i0) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  st.l0 += __shfl_xor_sync(0xffffffffu, st.l0, 1);
  st.l0 += __shfl_xor_sync(0xffffffffu, st.l0, 2);
  st.l1 += __shfl_xor_sync(0xffffffffu, st.l1, 1);
  st.l1 += __shfl_xor_sync(0xffffffffu, st.l1, 2);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = i0 + g + 8 * half;
    if (i >= a.Tq) continue;
    if (t4 == 0) {
      const size_t stat = ((size_t)b * a.H + h) * a.Tq + i;
      a.m[stat] = half ? st.m1 : st.m0;
      a.l[stat] = half ? st.l1 : st.l0;
    }
    float* out = a.pv + (((size_t)b * a.Tq + i) * a.H + h) * a.D;
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
      const int c = 8 * dt + 2 * t4;
      const float x = st.o[dt][2 * half], y = st.o[dt][2 * half + 1];
      if ((a.D & 1) == 0) {
        if (c < a.D) *reinterpret_cast<float2*>(out + c) = make_float2(x, y);
      } else {
        if (c < a.D) out[c] = x;
        if (c + 1 < a.D) out[c + 1] = y;
      }
    }
  }
}

// -- one warp's 16 query rows against one KV tile, f32 (FMA pipe)
//
// Lane (rg, kg) = (lane / 8, lane % 8) holds the scores of rows 4rg + r
// and keys 16kk + kg + 8c: each q and k float4 read from shared memory
// feeds 8 (or 16) fmaf.

template <int DP>
struct TlF32 {
  float m[4], l[4];            // rows 4rg + r of the lane
  // rows 4rg + r, columns 32c + 4kg + {0..3} (f32 takes DP >= 32)
  float acc[4][DP / 32 > 0 ? DP / 32 : 1][4];

  __device__ void init() {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      m[r] = kNegInf;
      l[r] = 0.0f;
#pragma unroll
      for (int c = 0; c < DP / 32; ++c) acc[r][c][0] = acc[r][c][1] = acc[r][c][2] = acc[r][c][3] = 0.0f;
    }
  }
};

// s += q . k over DP columns for the first gend 16-key groups (qs at the
// warp's row 0, ks at the tile's key 0, rows of DP + pad floats)
template <int DP, int NG>
__device__ __forceinline__ void f32_scores(const float* qs, const float* ks,
                                           float (&s)[NG][4][2], int gend) {
  constexpr int rs = DP + kTlPad;
  const int lane = threadIdx.x & 31;
  const int rg = lane >> 3;
  const int kg = lane & 7;
  // a 128-key row keeps 64 scores a lane: no unrolling over d, so the
  // loads the compiler hoists stay within two blocks' registers
#pragma unroll (NG > 4 ? 1 : 8)
  for (int d = 0; d < DP; d += 4) {
    float4 qv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      qv[r] = *reinterpret_cast<const float4*>(qs + (4 * rg + r) * rs + d);
    }
#pragma unroll
    for (int kk = 0; kk < NG; ++kk) {
      if (kk >= gend) continue;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float4 kv = *reinterpret_cast<const float4*>(
            ks + (16 * kk + kg + 8 * c) * rs + d);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float x = s[kk][r][c];
          x = fmaf(qv[r].x, kv.x, x);
          x = fmaf(qv[r].y, kv.y, x);
          x = fmaf(qv[r].z, kv.z, x);
          x = fmaf(qv[r].w, kv.w, x);
          s[kk][r][c] = x;
        }
      }
    }
  }
}

// Scale and mask the scores of the first gend groups (keys kpos0 + 16kk
// + kg + 8c; vw the tile's visibility bits; qpos the position of the
// lane's row 4rg), folding them into m where do_max → visibility bits
// (bit 8kk + 2r + c).
template <int NG>
__device__ __forceinline__ uint64_t f32_mask(
    const TlArgs& a, float (&s)[NG][4][2],
    const uint32_t (&vw)[NG > 2 ? NG / 2 : 1], int gend, int qpos, int kpos0,
    bool do_max, float (&m)[4]) {
  const int kg = threadIdx.x & 7;
  const int rg = (threadIdx.x & 31) >> 3;
  uint64_t ok = 0;
#pragma unroll
  for (int kk = 0; kk < NG; ++kk) {
    if (kk >= gend) continue;
    // every key of the group valid and at or below the causal diagonal of
    // the warp's first row (qpos - 4rg): no per-score test
    const uint32_t word = (vw[kk >> 1] >> ((kk & 1) << 4)) & 0xffffu;
    if (word == 0xffffu &&
        (!a.causal || qpos - 4 * rg >= kpos0 + 16 * kk + 15)) {
      ok |= (uint64_t)0xffu << (8 * kk);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float& x = s[kk][r][c];
          x = __fmul_rn(x, a.scale);
          if (do_max) m[r] = fmaxf(m[r], x);
        }
      }
      continue;
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int jl = 16 * kk + kg + 8 * c;
      const bool vj = (vw[kk >> 1] >> (((kk & 1) << 4) + kg + 8 * c)) & 1u;
      const int kpos = kpos0 + jl;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const bool o = vj && (!a.causal || qpos + r >= kpos);
        ok |= (uint64_t)o << (8 * kk + 2 * r + c);
        float& x = s[kk][r][c];
        x = o ? __fmul_rn(x, a.scale) : kNegInf;
        if (do_max) m[r] = fmaxf(m[r], x);
      }
    }
  }
  return ok;
}

// the row max over the 8 lanes that share a row
__device__ __forceinline__ void f32_rowmax(float (&m)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 4));
  }
}

// p = exp(s - m) where visible, l += p, and acc += p . v over DP columns
// (vs at the tile's key 0) for the first gend groups; p goes through the
// warp's transposed tile pt [16 keys][kTlPRow] so that lane (rg, kg) then
// accumulates rows 4rg + r, columns 32dc + 4kg + {0..3}.
template <int DP, int NG>
__device__ __forceinline__ void f32_pv(const float* vs, float* pt,
                                       const float (&s)[NG][4][2],
                                       uint64_t ok, int gend,
                                       const float (&m)[4], float (&l)[4],
                                       float (&acc)[4][DP / 32][4]) {
  constexpr int DC = DP / 32;
  constexpr int rs = DP + kTlPad;
  const int lane = threadIdx.x & 31;
  const int rg = lane >> 3;
  const int kg = lane & 7;
#pragma unroll
  for (int kk = 0; kk < NG; ++kk) {
    if (kk >= gend) continue;
    float p[2][4];
    const bool all = ((ok >> (8 * kk)) & 0xffu) == 0xffu;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        p[c][r] = all || ((ok >> (8 * kk + 2 * r + c)) & 1u)
                      ? expf(s[kk][r][c] - m[r]) : 0.0f;
        l[r] += p[c][r];
      }
      *reinterpret_cast<float4*>(pt + (kg + 8 * c) * kTlPRow + 4 * rg) =
          make_float4(p[c][0], p[c][1], p[c][2], p[c][3]);
    }
    __syncwarp();
    const float* vr = vs + 16 * kk * rs + 4 * kg;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const float4 pj = *reinterpret_cast<const float4*>(
          pt + jj * kTlPRow + 4 * rg);
      const float pr[4] = {pj.x, pj.y, pj.z, pj.w};
#pragma unroll
      for (int dc = 0; dc < DC; ++dc) {
        const float4 vv = *reinterpret_cast<const float4*>(
            vr + jj * rs + 32 * dc);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float(&o)[4] = acc[r][dc];
          o[0] = fmaf(pr[r], vv.x, o[0]);
          o[1] = fmaf(pr[r], vv.y, o[1]);
          o[2] = fmaf(pr[r], vv.z, o[2]);
          o[3] = fmaf(pr[r], vv.w, o[3]);
        }
      }
    }
    __syncwarp();  // pt is free for the next group
  }
}

// As tl_tile_bf16, in f32. pt: the warp's p^T tile.
template <int DP, int TK>
__device__ __forceinline__ void tl_tile_f32(
    const TlArgs& a, const float* qs, const float* ks, const float* vs,
    float* pt, TlF32<DP>& st, const unsigned char* bytes,
    const uint32_t (&vw_in)[TK > 32 ? TK / 32 : 1], int gend, int i0,
    int t0, bool do_max, bool reduce_max, bool do_pv) {
  constexpr int NG = TK / 16;
  float s[NG][4][2];
  uint64_t ok = 0;
  if (gend > 0) {
#pragma unroll
    for (int kk = 0; kk < NG; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) s[kk][r][0] = s[kk][r][1] = 0.0f;
    }
    f32_scores<DP, NG>(qs, ks, s, gend);
    uint32_t vw[NG > 2 ? NG / 2 : 1];
#pragma unroll
    for (int w = 0; w < (NG > 2 ? NG / 2 : 1); ++w) vw[w] = vw_in[w];
    if constexpr (TK > 16) tl_bits(a, bytes, vw);
    const int rg = (threadIdx.x & 31) >> 3;
    ok = f32_mask<NG>(a, s, vw, gend, a.q_start + i0 + 4 * rg,
                      a.kv_start + t0, do_max, st.m);
  }
  if (reduce_max) f32_rowmax(st.m);
  if (!do_pv || gend == 0) return;
  __syncwarp();  // pt may be the warp's q rows: every lane has read them
  f32_pv<DP, NG>(vs, pt, s, ok, gend, st.m, st.l, st.acc);
}

// as tl_finish_bf16, for the f32 lane layout (a warp's store of one
// column tile covers 4 rows of 128 bytes): pv columns c0 + ..., and m and
// l where `stats`
template <int DP>
__device__ __forceinline__ void tl_finish_f32(const TlArgs& a,
                                              TlF32<DP>& st, int b, int h,
                                              int i0, int c0 = 0,
                                              bool stats = true) {
  const int lane = threadIdx.x & 31;
  const int rg = lane >> 3;
  const int kg = lane & 7;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    st.l[r] += __shfl_xor_sync(0xffffffffu, st.l[r], 1);
    st.l[r] += __shfl_xor_sync(0xffffffffu, st.l[r], 2);
    st.l[r] += __shfl_xor_sync(0xffffffffu, st.l[r], 4);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + 4 * rg + r;
    if (i >= a.Tq) continue;
    if (kg == 0 && stats) {
      const size_t stat = ((size_t)b * a.H + h) * a.Tq + i;
      a.m[stat] = st.m[r];
      a.l[stat] = st.l[r];
    }
    float* out = a.pv + (((size_t)b * a.Tq + i) * a.H + h) * a.D;
#pragma unroll
    for (int dc = 0; dc < DP / 32; ++dc) {
      const int c = c0 + 32 * dc + 4 * kg;
      const float(&o)[4] = st.acc[r][dc];
      if ((a.D & 3) == 0) {
        if (c < a.D) {
          *reinterpret_cast<float4*>(out + c) =
              make_float4(o[0], o[1], o[2], o[3]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (c + e < a.D) out[c + e] = o[e];
        }
      }
    }
  }
}

// The ring path: one- or two-pass over a stream of KV tiles. Instances
// with TK above tl_stream_keys(DP) take single-tile items only (one
// pass), so a warp's pv accumulators start at zero after its scores and
// need no registers while they are computed.
template <int DP, int TK, bool kBf16>
__global__ void __launch_bounds__(kTlMaxThreads, tl_min_blocks<DP, TK>())
flash_block_tiled_kernel(const TlArgs a) {
  extern __shared__ __align__(128) float smem[];
  constexpr int rs = DP + kTlPad;
  constexpr int NW = TK > 32 ? TK / 32 : 1;
  constexpr bool kOne = TK > tl_stream_keys(DP);
  const int q_tile = a.g * a.qr * rs;
  const int kv_tile = a.g * a.tk * rs;
  float* qbuf = smem;                       // [stages][g][qr][rs]
  float* kbuf = qbuf + kTlStages * q_tile;  // [stages][g][tk][rs]
  float* vbuf = kbuf + kTlStages * kv_tile;
  const bool multi = a.nkt > 1;
  // f32, multi: [warps][16][kTlPRow]
  float* pbuf = vbuf + kTlStages * kv_tile;
  unsigned char* bbuf = reinterpret_cast<unsigned char*>(
      pbuf + (kBf16 || !multi ? 0 : a.warps * 16 * kTlPRow));
  int* ints = reinterpret_cast<int*>(bbuf + kTlStages * a.g * a.tk);
  // this warp's sequence of the item and its 16 rows of the query tile.
  // On a causal diagonal a later row block sees more keys; warps w and
  // w + 4 share one of the SM's four schedulers, so in an 8-warp tile they
  // take row blocks w and 7 - w and every scheduler gets the same work.
  const int warp = threadIdx.x >> 5;
  const int wpu = a.qr >> 4;
  const int gi = warp / wpu;
  const int wl = warp - gi * wpu;
  const int wq = wpu == 8 && wl >= 4 ? 11 - wl : wl;

  TlCursor p{(int)blockIdx.x, 0, 1, 0, 0};
  for (int s = 0; s < kTlStages; ++s) {
    tl_produce<DP>(a, p, qbuf, kbuf, vbuf, bbuf, ints);
  }
  TlCursor c{(int)blockIdx.x, 0, 1, 0, 0};
  std::conditional_t<kBf16, TlBf16<DP>, TlF32<DP>> st;
  int kend = 0;  // keys [0, kend) are all that the warp's rows can see
  while (c.item < a.n_items) {
    cp_async_wait_group<kTlStages - 1>();
    __syncthreads();
    const int slot = c.count % kTlStages;
    const int stage = c.load % kTlStages;
    const TlItem it = tl_item(a, c.item);
    if (c.j == 0) c.n = multi ? ints[slot] : 1;
    const int kt = c.n == 1 ? 0 : c.j % c.n;
    const bool single = c.n == 1;
    const bool last = c.j == c.loads() - 1;
    const int i0 = it.qt * a.qr + 16 * wq;
    const float* qs = qbuf + slot * q_tile + (gi * a.qr + 16 * wq) * rs;
    if (gi < it.nb && i0 < a.Tq) {
      const int b = it.b0 + gi;
      // the tile's staged validity bytes (zero past Tk)
      const unsigned char* bytes = bbuf + (stage * a.g + gi) * a.tk;
      uint32_t vw[NW];
      tl_bits(a, bytes, vw);
      if (kOne || c.j == 0) {
        st.init();
        int lastv = -1;
        if (multi) {
          lastv = ints[kTlStages + slot];
        } else {
#pragma unroll
          for (int w = 0; w < NW; ++w) {
            if (vw[w]) lastv = 32 * w + 31 - __clz((int)vw[w]);
          }
        }
        kend = min(lastv + 1, tl_causal_end(a, min(i0 + 15, a.Tq - 1)));
      }
      const int t0 = kt * a.tk;
      const int gend = kend <= t0 ? 0 : min((kend - t0 + 15) >> 4, a.tk >> 4);
      const float* ks = kbuf + stage * kv_tile + gi * a.tk * rs;
      const float* vs = vbuf + stage * kv_tile + gi * a.tk * rs;
      const bool do_max = single || c.j < c.n;
      const bool reduce_max = single || c.j == c.n - 1;
      const bool do_pv = single || c.j >= c.n;
      if constexpr (kBf16) {
        tl_tile_bf16<DP, TK>(a, qs, ks, vs, st, bytes, vw, gend, i0, t0,
                             do_max, reduce_max, do_pv);
        if (last) tl_finish_bf16<DP>(a, st, b, it.h, i0);
      } else {
        float* pt = multi ? pbuf + warp * 16 * kTlPRow
                          : const_cast<float*>(qs);
        tl_tile_f32<DP, TK>(a, qs, ks, vs, pt, st, bytes, vw, gend, i0, t0,
                            do_max, reduce_max, do_pv);
        if (last) tl_finish_f32<DP>(a, st, b, it.h, i0);
      }
    }
    __syncthreads();
    tl_produce<DP>(a, p, qbuf, kbuf, vbuf, bbuf, ints);
    c.advance(gridDim.x);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the instance for tiles of 16 keys where a.tk is 16, the streaming one
// where an item takes several tiles, else the one-pass one
template <int DP, bool kBf16>
int launch_tiled(const TlArgs& a, int threads, size_t smem,
                 cudaStream_t stream) {
  constexpr int TK = tl_keys(DP);
  constexpr int TS = tl_stream_keys(DP);
  if constexpr (TK > 16) {
    if (a.tk == 16) {
      return launch_persistent(flash_block_tiled_kernel<DP, 16, kBf16>, a,
                               a.n_items, threads, smem, stream);
    }
  }
  if constexpr (TS < TK) {
    if (a.nkt > 1) {
      return launch_persistent(flash_block_tiled_kernel<DP, TS, kBf16>, a,
                               a.n_items, threads, smem, stream);
    }
  }
  return launch_persistent(flash_block_tiled_kernel<DP, TK, kBf16>, a,
                           a.n_items, threads, smem, stream);
}

// -- resident path: bf16, KV rows longer than one tile ---------------------

// ldmatrix: four 8 x 8 bf16 matrices, lanes 8j .. 8j + 7 addressing the
// rows of matrix j; r[j] holds the lane's pair of matrix j (transposed:
// of its columns)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row)));
}

// Shared memory of one resident block: K and V rows [tkp][DP + kTlBPad]
// bf16, the sequence's visibility bits [tkp / 32], 8 ints and the next
// item's KV-validity bytes [tkp].
__host__ __device__ inline size_t rs_smem_bytes(int tkp, int dp) {
  return (size_t)2 * tkp * (dp + kTlBPad) * 2 + 4 * (size_t)((tkp + 31) / 32) +
         4 * 8 + tkp;
}

// Start copying the KV-validity bytes of item `item`'s sequence into dst
// ([tkp], zero past Tk): 4-byte cp.async copies where rows of kv_valid
// are 4-byte aligned, else plain copies (visible after the next barrier).
__device__ __forceinline__ void rs_fetch_valid(const TlArgs& a,
                                               unsigned char* dst, int item) {
  if (item >= a.n_items) return;
  const unsigned char* src = a.kv_valid + (size_t)(item / a.H) * a.Tk;
  for (int j = 4 * threadIdx.x; j < a.tk; j += 4 * blockDim.x) {
    if (a.valid4) {
      const int bytes = j < a.Tk ? 4 : 0;
      cp_async4_zfill(dst + j, bytes ? src + j : a.kv_valid, (uint32_t)bytes);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) dst[j + u] = j + u < a.Tk ? src[j + u] : 0;
    }
  }
  cp_async_commit();
}

// q's A fragments of rows i0 + g (+ 8), columns 16c + 2t4 (+ 8) + {0, 1},
// as f32 pairs (zero past Tq and D, and where no row of the block sees a
// key: the sequence's last valid key is `last`): loaded one row block
// ahead
template <int DP>
__device__ __forceinline__ void rs_load_q(const TlArgs& a, int b, int h,
                                          int i0, int last,
                                          float2 (&qf)[DP / 16][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const float* qb = a.q + b * a.qsb + (long long)h * a.qsh;
  const bool seen =
      min(last + 1, tl_causal_end(a, min(i0 + 15, a.Tq - 1))) > 0;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int i = i0 + g + 8 * hf;
    const float* qr = qb + (long long)i * a.qst;
#pragma unroll
    for (int c = 0; c < DP / 16; ++c) {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int col = 16 * c + 8 * h2 + 2 * t4;
        float2 x = make_float2(0.0f, 0.0f);
        if (seen && i < a.Tq) {
          if (a.vec && col + 2 <= a.D) {
            x = *reinterpret_cast<const float2*>(qr + col);
          } else {
            if (col < a.D) x.x = qr[col];
            if (col + 1 < a.D) x.y = qr[col + 1];
          }
        }
        qf[c][hf + 2 * h2] = x;
      }
    }
  }
}

// rows [0, rows) of head h of sequence b of x → dst as bf16 (RNE), rows
// of DP + kTlBPad elements; zero past Tk and past D. Each thread keeps
// sixteen 16-byte loads in flight (64 KB a block: a 512-key row of K at
// D = 32), in registers that the compute phase does not hold.
template <int DP>
__device__ __forceinline__ void rs_stage(const TlArgs& a, uint16_t* dst,
                                         const float* x, long long sb,
                                         long long st, long long sh, int b,
                                         int h, int rows) {
  constexpr int BR = DP + kTlBPad;
  constexpr int C = DP / 4;  // 4-column chunks of a row
  const float* base = x + b * sb + (long long)h * sh;
  const int n = rows * C;
  for (int e0 = threadIdx.x; e0 < n; e0 += 16 * blockDim.x) {
    float4 f[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int e = e0 + u * blockDim.x;
      f[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const int t = e / C;
      const int c = (e - t * C) * 4;
      if (e < n && t < a.Tk) {
        const float* src = base + (long long)t * st + c;
        if (a.vec && c + 4 <= a.D) {
          f[u] = *reinterpret_cast<const float4*>(src);
        } else {
          if (c < a.D) f[u].x = src[0];
          if (c + 1 < a.D) f[u].y = src[1];
          if (c + 2 < a.D) f[u].z = src[2];
          if (c + 3 < a.D) f[u].w = src[3];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < n) {
        const int t = e / C;
        const int c = (e - t * C) * 4;
        *reinterpret_cast<uint2*>(dst + t * BR + c) = make_uint2(
            pack_bf16(f[u].x, f[u].y), pack_bf16(f[u].z, f[u].w));
      }
    }
  }
}

// The scores of key group kk (keys 16kk .. 16kk + 15) against the warp's
// rows in the natural m16n8 layout: s[n][e] is row g + 8 (e >> 1), key
// 16kk + 8n + 2t4 + (e & 1). K's B fragments come from ldmatrix: lane l
// addresses key 16kk + 8 (l / 16) + l % 8 at column 8 ((l / 8) & 1).
template <int DP>
__device__ __forceinline__ void rs_scores(const uint16_t* kb,
                                          const uint32_t (&qa)[DP / 16][4],
                                          int kk, float (&s)[2][4]) {
  constexpr int BR = DP + kTlBPad;
  const int lane = threadIdx.x & 31;
  const uint16_t* row =
      kb + (16 * kk + 8 * (lane >> 4) + (lane & 7)) * BR +
      8 * ((lane >> 3) & 1);
#pragma unroll
  for (int n = 0; n < 2; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
  for (int dc = 0; dc < DP / 16; ++dc) {
    uint32_t r[4];
    ldsm_x4(r, row + 16 * dc);
    mma_bf16(s[0], qa[dc][0], qa[dc][1], qa[dc][2], qa[dc][3], r[0], r[1]);
    mma_bf16(s[1], qa[dc][0], qa[dc][1], qa[dc][2], qa[dc][3], r[2], r[3]);
  }
}

// One warp: query rows i0 .. i0 + 15 of sequence b, head h, against the
// resident K and V (two passes over them: the row max, then p, l and
// P.V), then m, l and pv out. last: the sequence's last valid key.
template <int DP>
__device__ __forceinline__ void rs_rows(const TlArgs& a, const uint16_t* kb,
                                        const uint16_t* vb,
                                        const uint32_t* bits, int b, int h,
                                        int i0, int last,
                                        const float2 (&qf)[DP / 16][4]) {
  constexpr int BR = DP + kTlBPad;
  constexpr int DK = DP / 16;
  constexpr int DN = DP / 8;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int kend = min(last + 1, tl_causal_end(a, min(i0 + 15, a.Tq - 1)));
  const int ng = kend > 0 ? (kend + 15) >> 4 : 0;
  TlBf16<DP> st;
  st.init();
  if (ng > 0) {
    uint32_t qa[DK][4];
#pragma unroll
    for (int c = 0; c < DK; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) qa[c][e] = pack_bf16(qf[c][e].x, qf[c][e].y);
    }
    const int qpos = a.q_start + i0 + g;
    // a group whose 16 keys are valid and at or below the causal diagonal
    // of the warp's first row is visible to every row: no mask, and its
    // row max is taken from the raw scores (scaling by a positive scale
    // rounds monotonically, so scale * max equals max of scale * s)
    auto full = [&](int kk, uint32_t word) {
      return word == 0xffffu &&
             (!a.causal || a.q_start + i0 >= a.kv_start + 16 * kk + 15);
    };
    // pass 1: the row max
    float r0 = -INFINITY, r1 = -INFINITY;  // raw maxima of full groups
#pragma unroll 4
    for (int kk = 0; kk < ng; ++kk) {
      float s[2][4];
      rs_scores<DP>(kb, qa, kk, s);
      const uint32_t word = (bits[kk >> 1] >> ((kk & 1) << 4)) & 0xffffu;
      if (full(kk, word)) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          r0 = fmaxf(r0, fmaxf(s[n][0], s[n][1]));
          r1 = fmaxf(r1, fmaxf(s[n][2], s[n][3]));
        }
        continue;
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jb = 8 * n + 2 * t4 + (e & 1);
          const bool o = ((word >> jb) & 1u) &&
                         (!a.causal || qpos + 8 * (e >> 1) >=
                                           a.kv_start + 16 * kk + jb);
          const float x = o ? __fmul_rn(s[n][e], a.scale) : kNegInf;
          if (e < 2) st.m0 = fmaxf(st.m0, x);
          else st.m1 = fmaxf(st.m1, x);
        }
      }
    }
    st.m0 = fmaxf(st.m0, __fmul_rn(r0, a.scale));
    st.m1 = fmaxf(st.m1, __fmul_rn(r1, a.scale));
    st.m0 = fmaxf(st.m0, __shfl_xor_sync(0xffffffffu, st.m0, 1));
    st.m0 = fmaxf(st.m0, __shfl_xor_sync(0xffffffffu, st.m0, 2));
    st.m1 = fmaxf(st.m1, __shfl_xor_sync(0xffffffffu, st.m1, 1));
    st.m1 = fmaxf(st.m1, __shfl_xor_sync(0xffffffffu, st.m1, 2));
    // pass 2: p, l and P.V (V's B fragments by ldmatrix.trans: lane l
    // addresses key 16kk + 8 ((l / 8) & 1) + l % 8 at column 8 (l / 16))
    const uint16_t* vrow =
        vb + (8 * ((lane >> 3) & 1) + (lane & 7)) * BR + 8 * (lane >> 4);
#pragma unroll 2
    for (int kk = 0; kk < ng; ++kk) {
      float s[2][4];
      rs_scores<DP>(kb, qa, kk, s);
      const uint32_t word = (bits[kk >> 1] >> ((kk & 1) << 4)) & 0xffffu;
      if (full(kk, word)) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[n][e] = expf(__fmul_rn(s[n][e], a.scale) -
                           (e < 2 ? st.m0 : st.m1));
          }
        }
      } else {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int jb = 8 * n + 2 * t4 + (e & 1);
            const bool o = ((word >> jb) & 1u) &&
                           (!a.causal || qpos + 8 * (e >> 1) >=
                                             a.kv_start + 16 * kk + jb);
            s[n][e] = o ? expf(__fmul_rn(s[n][e], a.scale) -
                               (e < 2 ? st.m0 : st.m1))
                        : 0.0f;
          }
        }
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        st.l0 += s[n][0] + s[n][1];
        st.l1 += s[n][2] + s[n][3];
      }
      // the group's scores are P.V's A fragment; p rounds to bf16
      const uint32_t p0 = pack_bf16(s[0][0], s[0][1]);
      const uint32_t p1 = pack_bf16(s[0][2], s[0][3]);
      const uint32_t p2 = pack_bf16(s[1][0], s[1][1]);
      const uint32_t p3 = pack_bf16(s[1][2], s[1][3]);
#pragma unroll
      for (int dt = 0; dt < DN; dt += 2) {
        uint32_t r[4];
        ldsm_x4_trans(r, vrow + 16 * kk * BR + 8 * dt);
        mma_bf16(st.o[dt], p0, p1, p2, p3, r[0], r[1]);
        mma_bf16(st.o[dt + 1], p0, p1, p2, p3, r[2], r[3]);
      }
    }
  }
  tl_finish_bf16<DP>(a, st, b, h, i0);
}

// Persistent blocks of 8 warps walk over (sequence, head) items. A block
// stages the item's K and V rows up to the last key any of its rows can
// see, as bf16, and its visibility bits, once; then every warp walks its
// 16-row blocks of q against them with no further barrier. Row blocks go
// to warps in rounds of 8, in reverse order every other round, so each
// warp's causal work comes out about even.
template <int DP>
__global__ void __launch_bounds__(kTlMaxThreads, 2)
flash_block_resident_kernel(const TlArgs a) {
  extern __shared__ __align__(128) float smem[];
  constexpr int BR = DP + kTlBPad;
  const int tkp = a.tk;  // rows the block can hold: Tk rounded up to 16
  const int nwords = (tkp + 31) / 32;
  uint16_t* kb = reinterpret_cast<uint16_t*>(smem);
  uint16_t* vb = kb + tkp * BR;
  uint32_t* bits = reinterpret_cast<uint32_t*>(vb + tkp * BR);
  int* red = reinterpret_cast<int*>(bits + nwords);
  unsigned char* vbytes = reinterpret_cast<unsigned char*>(red + 8);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const int nrb = (a.Tq + 15) >> 4;
  rs_fetch_valid(a, vbytes, blockIdx.x);
  for (int item = blockIdx.x; item < a.n_items; item += gridDim.x) {
    const int b = item / a.H;
    const int h = item - b * a.H;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();  // the item's validity bytes have landed
    int last = -1;
    for (int w = warp; w < nwords; w += nw) {
      const int j = 32 * w + lane;
      const uint32_t word = __ballot_sync(0xffffffffu, j < tkp && vbytes[j]);
      if (lane == 0) bits[w] = word;
      if (word) last = 32 * w + 31 - __clz((int)word);
    }
    if (lane == 0) red[warp] = last;
    __syncthreads();
    last = -1;
    for (int w = 0; w < nw; ++w) last = max(last, red[w]);
    // the next item's bytes land while this one computes
    rs_fetch_valid(a, vbytes, item + gridDim.x);
    const int kend = min(last + 1, tl_causal_end(a, a.Tq - 1));
    const int rows = (max(kend, 0) + 15) & ~15;
    rs_stage<DP>(a, kb, a.k, a.ksb, a.kst, a.ksh, b, h, rows);
    rs_stage<DP>(a, vb, a.v, a.vsb, a.vst, a.vsh, b, h, rows);
    __syncthreads();
    // row blocks in rounds of nw, reversed every other round; each warp
    // loads its next row block's q while it computes the current one
    float2 qf[DP / 16][4];
    if (warp < nrb) rs_load_q<DP>(a, b, h, 16 * warp, last, qf);
    for (int r = 0; nw * r < nrb; ++r) {
      const int rb = nw * r + (r & 1 ? nw - 1 - warp : warp);
      if (rb >= nrb) continue;
      float2 qc[DP / 16][4];
#pragma unroll
      for (int c = 0; c < DP / 16; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qc[c][e] = qf[c][e];
      }
      const int nxt = nw * (r + 1) + (r & 1 ? warp : nw - 1 - warp);
      if (nxt < nrb) rs_load_q<DP>(a, b, h, 16 * nxt, last, qf);
      rs_rows<DP>(a, kb, vb, bits, b, h, 16 * rb, last, qc);
    }
    __syncthreads();  // K, V, the bits and red are free for the next item
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// -- wide path: D above kTlMaxDP --------------------------------------------

constexpr int kWdChunk = 64;  // columns of a staged chunk of D
constexpr int kWdRow = kWdChunk + kTlPad;  // floats of a staged row
constexpr int kWdStages = 3;  // a warp's ring of stages
constexpr int kWdKeys = 64;   // keys of a KV tile at most: one pass up to it
constexpr int kWdGroups = kWdKeys / 16;
constexpr int kWdHdr = 12;  // ints of a stage's header

// Shared memory of one wide block (one warp): kWdStages stages of 16 q
// rows and tk K (or V) rows of kWdRow floats, at f32 the p^T tile [tk]
// [kTlPRow], and each stage's header.
__host__ __device__ inline size_t wd_smem_bytes(int tk, bool bf16) {
  return sizeof(float) * ((size_t)kWdStages * (16 + tk) * kWdRow +
                          (bf16 ? 0 : (size_t)tk * kTlPRow)) +
         sizeof(int) * kWdStages * kWdHdr;
}

// The producer's place in a warp's stream of loads. An item (sequence b,
// head h, query rows i0 .. i0 + 15) whose rows see keys [0, kend) in nt KV
// tiles takes one empty load where kend = 0; else, in one pass (nt = 1),
// nch loads of a q chunk and the K tile's chunk, then nch of the V tile's;
// in two passes, nt x nch q-and-K loads (pass 1: the row max), then per
// tile nch q-and-K and nch V loads (pass 2: p, l and P.V). The cursor
// holds the next load's chunk c, tile t, pass and kind (qk), the item's
// first q row that sees a key, and its KV-validity bits of keys below
// 128; item past the last: done.
struct WdCursor {
  int item, b, h, i0, kend, nt, qlo;
  int c, t, pass, qk, first, load;
  uint32_t vw[4];
};

// Start loading the KV-validity bytes of keys 32w + lane (w < 4) of the
// item's sequence (zero at or past Tk, and past the last item). A warp
// reads them one item ahead, so they have landed when the item begins.
__device__ __forceinline__ void wd_fetch(const TlArgs& a, int item,
                                         unsigned char (&pre)[4]) {
  const int lane = threadIdx.x & 31;
  const unsigned char* src =
      a.kv_valid + (size_t)(item / (a.nqt * a.H)) * a.Tk;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    pre[w] = 0;
    if (item < a.n_items && 32 * w + lane < a.Tk) pre[w] = src[32 * w + lane];
  }
}

// visibility bits of keys j0 .. j0 + 31 of sequence b, read now (keys past
// 128: blocks of long rows only)
__device__ __forceinline__ uint32_t wd_bits(const TlArgs& a, int b, int j0) {
  const int j = j0 + (threadIdx.x & 31);
  return __ballot_sync(0xffffffffu,
                       j < a.Tk && a.kv_valid[(size_t)b * a.Tk + j] != 0);
}

__device__ __forceinline__ uint32_t wd_word(const uint32_t (&vw)[4], int w) {
  return w == 0 ? vw[0] : w == 1 ? vw[1] : w == 2 ? vw[2] : vw[3];
}

// The cursor's item begins: its place, its validity bits from the
// prefetched bytes, the keys its rows see (none past the sequence's last
// valid key or above the causal diagonal of its last row; none at all
// where no row sees the first valid key), its tiles and first q row that
// sees a key; and the next item's bytes start to load.
__device__ void wd_begin(const TlArgs& a, WdCursor& p,
                         unsigned char (&pre)[4]) {
  const int r = p.item / a.nqt;
  p.i0 = 16 * (p.item - r * a.nqt);
  p.b = r / a.H;
  p.h = r - p.b * a.H;
  int first = -1, last = -1;
#pragma unroll
  for (int w = 3; w >= 0; --w) {
    p.vw[w] = __ballot_sync(0xffffffffu, pre[w] != 0);
    if (p.vw[w]) first = 32 * w + __ffs((int)p.vw[w]) - 1;
  }
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    if (p.vw[w]) last = 32 * w + 31 - __clz((int)p.vw[w]);
  }
  for (int j0 = 128; j0 < a.Tk; j0 += 32) {
    const uint32_t w = wd_bits(a, p.b, j0);
    if (w) {
      last = j0 + 31 - __clz((int)w);
      if (first < 0) first = j0 + __ffs((int)w) - 1;
    }
  }
  wd_fetch(a, p.item + gridDim.x, pre);
  const int cend = tl_causal_end(a, min(p.i0 + 15, a.Tq - 1));
  p.kend = first >= 0 && first < cend ? min(last + 1, cend) : 0;
  p.nt = p.kend <= a.tk ? 1 : (p.kend + a.tk - 1) / a.tk;
  p.qlo = a.causal
              ? min(max(p.i0, a.kv_start + first - a.q_start), p.i0 + 16)
              : p.i0;
  p.c = p.t = 0;
  p.pass = p.nt == 1 ? 0 : 1;
  p.qk = p.first = 1;
}

// the cursor past its load: the next load of its item, or the next item
__device__ __forceinline__ void wd_advance(const TlArgs& a, WdCursor& p) {
  p.first = 0;
  bool done = p.kend == 0;
  if (!done && ++p.c == a.nch) {
    p.c = 0;
    if (p.pass == 1) {
      if (++p.t == p.nt) {
        p.t = 0;
        p.pass = 2;
      }
    } else if (p.qk) {
      p.qk = 0;
    } else if (p.pass == 0 || ++p.t == p.nt) {
      done = true;
    } else {
      p.qk = 1;
    }
  }
  if (done) {
    p.item += gridDim.x;
    p.first = 1;
  }
}

// Start copies of rows t0 + r (r < rows) of head h of sequence b of x,
// columns c0 .. c0 + kWdChunk - 1, into dst (rows of kWdRow floats):
// 16-byte copies (4-byte ones where strides or pointers are not 16-byte
// aligned); rows outside [t_lo, t_hi) and columns at or past D are
// zero-filled and not read.
__device__ __forceinline__ void wd_rows(const TlArgs& a, float* dst,
                                        const float* x, long long sb,
                                        long long st, long long sh, int b,
                                        int h, int t0, int rows, int t_lo,
                                        int t_hi, int c0) {
  const int lane = threadIdx.x & 31;
  const float* base = x + b * sb + (long long)h * sh + c0;
  if (a.vec) {
    constexpr int C = kWdChunk / 4;  // 16-byte copies a row
    const int c = 4 * (lane % C);   // the lane's column, in every row
    const int cb = 4 * min(max(a.D - c0 - c, 0), 4);
    for (int r = lane / C; r < rows; r += 32 / C) {
      const int t = t0 + r;
      const int bytes = t >= t_lo && t < t_hi ? cb : 0;
      cp_async16_zfill(dst + r * kWdRow + c,
                       bytes ? base + (long long)t * st + c : x,
                       (uint32_t)bytes);
    }
  } else {
    for (int e = lane; e < rows * kWdChunk; e += 32) {
      const int r = e / kWdChunk;
      const int c = e - r * kWdChunk;
      const int t = t0 + r;
      const int bytes = t >= t_lo && t < t_hi && c0 + c < a.D ? 4 : 0;
      cp_async4_zfill(dst + r * kWdRow + c,
                      bytes ? base + (long long)t * st + c : x,
                      (uint32_t)bytes);
    }
  }
}

// Issue the cursor's next load into its stage (one cp.async group: a q
// chunk and the K tile's rows up to kend, or the V tile's; an empty one
// where the item's rows see no key) with its header {b (-1 past the last
// item), h, i0, kend, c, t, flags (qk, pass, first), nt, and with a tile's
// last q-and-K chunk its two visibility words}; then advance.
__device__ void wd_produce(const TlArgs& a, WdCursor& p,
                           unsigned char (&pre)[4], float* stages,
                           int* hdr) {
  const int st = p.load % kWdStages;
  ++p.load;
  int* hd = hdr + st * kWdHdr;
  const bool lead = (threadIdx.x & 31) == 0;
  if (p.item >= a.n_items) {
    if (lead) hd[0] = -1;
    cp_async_commit();
    return;
  }
  if (p.first) wd_begin(a, p, pre);
  uint32_t w0 = 0, w1 = 0;
  if (p.kend > 0) {
    const int t0 = p.t * a.tk;
    const int kr = min(a.tk, (p.kend - t0 + 15) & ~15);
    const int c0 = p.c * kWdChunk;
    float* dst = stages + st * (16 + a.tk) * kWdRow;
    float* kv = dst + 16 * kWdRow;
    if (p.qk) {
      wd_rows(a, dst, a.q, a.qsb, a.qst, a.qsh, p.b, p.h, p.i0, 16, p.qlo,
              min(p.i0 + 16, a.Tq), c0);
      wd_rows(a, kv, a.k, a.ksb, a.kst, a.ksh, p.b, p.h, t0, kr, 0, p.kend,
              c0);
      if (p.c == a.nch - 1) {
        // a tile of several starts at a multiple of 32 keys (tk 32 or 64)
        const int w = t0 >> 5;
        w0 = w < 4 ? wd_word(p.vw, w) : wd_bits(a, p.b, t0);
        w1 = w + 1 < 4 ? wd_word(p.vw, w + 1) : wd_bits(a, p.b, t0 + 32);
      }
    } else {
      wd_rows(a, kv, a.v, a.vsb, a.vst, a.vsh, p.b, p.h, t0, kr, 0, p.kend,
              c0);
    }
  }
  if (lead) {
    hd[0] = p.b;
    hd[1] = p.h;
    hd[2] = p.i0;
    hd[3] = p.kend;
    hd[4] = p.c;
    hd[5] = p.t;
    hd[6] = p.qk | p.pass << 1 | p.first << 3;
    hd[7] = p.nt;
    hd[8] = (int)w0;
    hd[9] = (int)w1;
  }
  cp_async_commit();
  wd_advance(a, p);
}

// a stage's load as its header gives it to the consumer
struct WdLoad {
  int b, h, i0, kend, c, t, qk, pass, first, nt;
  uint32_t vw[2];
};

// An item whose rows see no key: m = -1e30, l = 0, pv = 0.
__device__ void wd_empty(const TlArgs& a, const WdLoad& ld) {
  const int lane = threadIdx.x & 31;
  const int rows = min(16, a.Tq - ld.i0);
  if (lane < rows) {
    const size_t stat = ((size_t)ld.b * a.H + ld.h) * a.Tq + ld.i0 + lane;
    a.m[stat] = kNegInf;
    a.l[stat] = 0.0f;
  }
  for (int r = 0; r < rows; ++r) {
    float* out = a.pv + (((size_t)ld.b * a.Tq + ld.i0 + r) * a.H + ld.h) * a.D;
    if ((a.D & 3) == 0) {
      for (int c = 4 * lane; c < a.D; c += 128) {
        *reinterpret_cast<float4*>(out + c) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
      for (int c = lane; c < a.D; c += 32) out[c] = 0.0f;
    }
  }
}

// -- the wide path at bf16: both products on the tensor cores

struct WdBf16 {
  // the tile's scores in the tc variant's layout: s[2kk + half] holds keys
  // 16kk + 4t4 + 2half + {0, 1} of rows g ([0..1]) and g + 8 ([2..3])
  float s[2 * kWdGroups][4];
  float m0, m1, l0, l1;
  uint32_t pf[kWdGroups][4];  // p of group kk as P.V's A fragment

  __device__ void init() {
    m0 = m1 = kNegInf;
    l0 = l1 = 0.0f;
  }
  __device__ void zero() {
#pragma unroll
    for (int n = 0; n < 2 * kWdGroups; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
    }
  }
};

// s += q . K^T over one staged chunk (qs: 16 q rows, ks: the K tile's rows)
// for the first gend 16-key groups; operands rounded f32 -> bf16 as the
// fragments form, the contraction index permuted alike in both (so each
// lane reads float4s), as in the tc variant
__device__ __forceinline__ void wd_scores_bf16(const float* qs,
                                               const float* ks, WdBf16& st,
                                               int gend) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
#pragma unroll
  for (int dc = 0; dc < kWdChunk / 16; ++dc) {
    const float4 x = *reinterpret_cast<const float4*>(
        qs + g * kWdRow + 16 * dc + 4 * t4);
    const float4 y = *reinterpret_cast<const float4*>(
        qs + (g + 8) * kWdRow + 16 * dc + 4 * t4);
    const uint32_t a0 = pack_bf16(x.x, x.y);
    const uint32_t a1 = pack_bf16(y.x, y.y);
    const uint32_t a2 = pack_bf16(x.z, x.w);
    const uint32_t a3 = pack_bf16(y.z, y.w);
#pragma unroll
    for (int kk = 0; kk < kWdGroups; ++kk) {
      if (kk >= gend) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int key = 16 * kk + 2 * g - (g & 1) + 2 * half;
        const float4 kv = *reinterpret_cast<const float4*>(
            ks + key * kWdRow + 16 * dc + 4 * t4);
        mma_bf16(st.s[2 * kk + half], a0, a1, a2, a3, pack_bf16(kv.x, kv.y),
                 pack_bf16(kv.z, kv.w));
      }
    }
  }
}

// Scale and mask the tile's summed scores (keys kpos0 + ...; vw its
// visibility bits), folding them into the row max where do_max; then,
// where do_p, p = exp(s - m), l and p's A fragments (p rounded to bf16).
__device__ __forceinline__ void wd_softmax_bf16(const TlArgs& a, WdBf16& st,
                                                const uint32_t (&vw)[2],
                                                int gend, int i0, int kpos0,
                                                bool do_max, bool reduce_max,
                                                bool do_p) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int qpos = a.q_start + i0 + g;
  // bit 4kk + e: key 16kk + 4t4 + e visible to row g (ok0), g + 8 (ok1)
  uint32_t ok0 = 0, ok1 = 0;
#pragma unroll
  for (int kk = 0; kk < kWdGroups; ++kk) {
    if (kk >= gend) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int jl = 16 * kk + 4 * t4 + e;
      const bool vj = (vw[kk >> 1] >> (((kk & 1) << 4) + 4 * t4 + e)) & 1u;
      const int kpos = kpos0 + jl;
      const bool o0 = vj && (!a.causal || qpos >= kpos);
      const bool o1 = vj && (!a.causal || qpos + 8 >= kpos);
      ok0 |= (uint32_t)o0 << (4 * kk + e);
      ok1 |= (uint32_t)o1 << (4 * kk + e);
      float& x0 = st.s[2 * kk + (e >> 1)][e & 1];
      float& x1 = st.s[2 * kk + (e >> 1)][2 + (e & 1)];
      x0 = o0 ? __fmul_rn(x0, a.scale) : kNegInf;
      x1 = o1 ? __fmul_rn(x1, a.scale) : kNegInf;
      if (do_max) {
        st.m0 = fmaxf(st.m0, x0);
        st.m1 = fmaxf(st.m1, x1);
      }
    }
  }
  if (reduce_max) {
    st.m0 = fmaxf(st.m0, __shfl_xor_sync(0xffffffffu, st.m0, 1));
    st.m0 = fmaxf(st.m0, __shfl_xor_sync(0xffffffffu, st.m0, 2));
    st.m1 = fmaxf(st.m1, __shfl_xor_sync(0xffffffffu, st.m1, 1));
    st.m1 = fmaxf(st.m1, __shfl_xor_sync(0xffffffffu, st.m1, 2));
  }
  if (!do_p) return;
#pragma unroll
  for (int kk = 0; kk < kWdGroups; ++kk) {
    if (kk >= gend) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float& x0 = st.s[2 * kk + (e >> 1)][e & 1];
      float& x1 = st.s[2 * kk + (e >> 1)][2 + (e & 1)];
      x0 = (ok0 >> (4 * kk + e)) & 1u ? expf(x0 - st.m0) : 0.0f;
      x1 = (ok1 >> (4 * kk + e)) & 1u ? expf(x1 - st.m1) : 0.0f;
      st.l0 += x0;
      st.l1 += x1;
    }
    st.pf[kk][0] = pack_bf16(st.s[2 * kk][0], st.s[2 * kk][1]);
    st.pf[kk][1] = pack_bf16(st.s[2 * kk][2], st.s[2 * kk][3]);
    st.pf[kk][2] = pack_bf16(st.s[2 * kk + 1][0], st.s[2 * kk + 1][1]);
    st.pf[kk][3] = pack_bf16(st.s[2 * kk + 1][2], st.s[2 * kk + 1][3]);
  }
}

// pv's columns c0 .. c0 + kWdChunk - 1 of the warp's rows (g, g + 8) += P . V
// over one staged chunk of the V tile (vs), for the first gend groups;
// add: pv holds earlier tiles' sums (a tile of several), else it starts at
// zero. Each lane keeps its fragment's pv positions, so its own stores are
// what it reads back.
__device__ void wd_pv_bf16(const TlArgs& a, const float* vs,
                           const WdBf16& st, int gend, const WdLoad& ld,
                           bool add) {
  constexpr int DN = kWdChunk / 8;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int c0 = ld.c * kWdChunk;
  const bool even = (a.D & 1) == 0;
  float o[DN][4];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = ld.i0 + g + 8 * half;
    const float* out = a.pv + (((size_t)ld.b * a.Tq + i) * a.H + ld.h) * a.D;
#pragma unroll
    for (int dt = 0; dt < DN; ++dt) {
      const int c = c0 + 8 * dt + 2 * t4;
      float2 x = make_float2(0.0f, 0.0f);
      if (add && i < a.Tq) {
        if (even) {
          if (c < a.D) x = *reinterpret_cast<const float2*>(out + c);
        } else {
          if (c < a.D) x.x = out[c];
          if (c + 1 < a.D) x.y = out[c + 1];
        }
      }
      o[dt][2 * half] = x.x;
      o[dt][2 * half + 1] = x.y;
    }
  }
#pragma unroll
  for (int kk = 0; kk < kWdGroups; ++kk) {
    if (kk >= gend) continue;
    // B fragments: keys 16kk + 4t4 + {0..3} (the permuted contraction
    // index), column g of each 8-column tile
    const float* vr = vs + (16 * kk + 4 * t4) * kWdRow + g;
#pragma unroll
    for (int dt = 0; dt < DN; ++dt) {
      const float* vc = vr + 8 * dt;
      mma_bf16(o[dt], st.pf[kk][0], st.pf[kk][1], st.pf[kk][2],
               st.pf[kk][3], pack_bf16(vc[0], vc[kWdRow]),
               pack_bf16(vc[2 * kWdRow], vc[3 * kWdRow]));
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = ld.i0 + g + 8 * half;
    if (i >= a.Tq) continue;
    float* out = a.pv + (((size_t)ld.b * a.Tq + i) * a.H + ld.h) * a.D;
#pragma unroll
    for (int dt = 0; dt < DN; ++dt) {
      const int c = c0 + 8 * dt + 2 * t4;
      const float x = o[dt][2 * half], y = o[dt][2 * half + 1];
      if (even) {
        if (c < a.D) *reinterpret_cast<float2*>(out + c) = make_float2(x, y);
      } else {
        if (c < a.D) out[c] = x;
        if (c + 1 < a.D) out[c + 1] = y;
      }
    }
  }
}

// l over the quad; m and l of the warp's rows to device memory
__device__ __forceinline__ void wd_stats_bf16(const TlArgs& a, WdBf16& st,
                                              const WdLoad& ld) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  st.l0 += __shfl_xor_sync(0xffffffffu, st.l0, 1);
  st.l0 += __shfl_xor_sync(0xffffffffu, st.l0, 2);
  st.l1 += __shfl_xor_sync(0xffffffffu, st.l1, 1);
  st.l1 += __shfl_xor_sync(0xffffffffu, st.l1, 2);
  if ((lane & 3) != 0) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = ld.i0 + g + 8 * half;
    if (i >= a.Tq) continue;
    const size_t stat = ((size_t)ld.b * a.H + ld.h) * a.Tq + i;
    a.m[stat] = half ? st.m1 : st.m0;
    a.l[stat] = half ? st.l1 : st.l0;
  }
}

// -- the wide path at f32: both products on the FMA pipe (no TF32)

struct WdF32 {
  // lane (rg, kg) = (lane / 8, lane % 8): rows 4rg + r, keys 16kk + kg + 8c
  float s[kWdGroups][4][2];
  float m[4], l[4];

  __device__ void init() {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      m[r] = kNegInf;
      l[r] = 0.0f;
    }
  }
  __device__ void zero() {
#pragma unroll
    for (int kk = 0; kk < kWdGroups; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) s[kk][r][0] = s[kk][r][1] = 0.0f;
    }
  }
};

// p = exp(s - m) where visible, l += p, p into the warp's p^T tile pt
// [tk][kTlPRow] (key 16kk + kg + 8c, rows 4rg .. 4rg + 3)
__device__ __forceinline__ void wd_p_f32(float* pt, WdF32& st, uint64_t ok,
                                         int gend) {
  const int lane = threadIdx.x & 31;
  const int rg = lane >> 3;
  const int kg = lane & 7;
#pragma unroll
  for (int kk = 0; kk < kWdGroups; ++kk) {
    if (kk >= gend) continue;
    const bool all = ((ok >> (8 * kk)) & 0xffu) == 0xffu;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float p[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        p[r] = all || ((ok >> (8 * kk + 2 * r + c)) & 1u)
                   ? expf(st.s[kk][r][c] - st.m[r]) : 0.0f;
        st.l[r] += p[r];
      }
      *reinterpret_cast<float4*>(pt + (16 * kk + kg + 8 * c) * kTlPRow +
                                 4 * rg) = make_float4(p[0], p[1], p[2], p[3]);
    }
  }
}

// pv's columns c0 .. c0 + kWdChunk - 1 of the warp's rows += P . V over one
// staged chunk of the V tile (vs), p from the p^T tile: lane (rg, kg)
// accumulates rows 4rg + r, columns 32dc + 4kg + {0..3}; add as in
// wd_pv_bf16.
__device__ void wd_pv_f32(const TlArgs& a, const float* vs, const float* pt,
                          int gend, const WdLoad& ld, bool add) {
  constexpr int DC = kWdChunk / 32;
  const int lane = threadIdx.x & 31;
  const int rg = lane >> 3;
  const int kg = lane & 7;
  const int c0 = ld.c * kWdChunk;
  const bool quad = (a.D & 3) == 0;
  float acc[4][DC][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ld.i0 + 4 * rg + r;
    const float* out = a.pv + (((size_t)ld.b * a.Tq + i) * a.H + ld.h) * a.D;
#pragma unroll
    for (int dc = 0; dc < DC; ++dc) {
      const int c = c0 + 32 * dc + 4 * kg;
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (add && i < a.Tq) {
        if (quad) {
          if (c < a.D) x = *reinterpret_cast<const float4*>(out + c);
        } else {
          if (c < a.D) x.x = out[c];
          if (c + 1 < a.D) x.y = out[c + 1];
          if (c + 2 < a.D) x.z = out[c + 2];
          if (c + 3 < a.D) x.w = out[c + 3];
        }
      }
      acc[r][dc][0] = x.x;
      acc[r][dc][1] = x.y;
      acc[r][dc][2] = x.z;
      acc[r][dc][3] = x.w;
    }
  }
#pragma unroll
  for (int kk = 0; kk < kWdGroups; ++kk) {
    if (kk >= gend) continue;
#pragma unroll 4
    for (int jj = 0; jj < 16; ++jj) {
      const int key = 16 * kk + jj;
      const float4 pj =
          *reinterpret_cast<const float4*>(pt + key * kTlPRow + 4 * rg);
      const float pr[4] = {pj.x, pj.y, pj.z, pj.w};
#pragma unroll
      for (int dc = 0; dc < DC; ++dc) {
        const float4 vv = *reinterpret_cast<const float4*>(
            vs + key * kWdRow + 32 * dc + 4 * kg);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float(&o)[4] = acc[r][dc];
          o[0] = fmaf(pr[r], vv.x, o[0]);
          o[1] = fmaf(pr[r], vv.y, o[1]);
          o[2] = fmaf(pr[r], vv.z, o[2]);
          o[3] = fmaf(pr[r], vv.w, o[3]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ld.i0 + 4 * rg + r;
    if (i >= a.Tq) continue;
    float* out = a.pv + (((size_t)ld.b * a.Tq + i) * a.H + ld.h) * a.D;
#pragma unroll
    for (int dc = 0; dc < DC; ++dc) {
      const int c = c0 + 32 * dc + 4 * kg;
      const float(&o)[4] = acc[r][dc];
      if (quad) {
        if (c < a.D) {
          *reinterpret_cast<float4*>(out + c) =
              make_float4(o[0], o[1], o[2], o[3]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (c + e < a.D) out[c + e] = o[e];
        }
      }
    }
  }
}

// l over the 8 lanes of a row; m and l of the warp's rows to device memory
__device__ __forceinline__ void wd_stats_f32(const TlArgs& a, WdF32& st,
                                             const WdLoad& ld) {
  const int lane = threadIdx.x & 31;
  const int rg = lane >> 3;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    st.l[r] += __shfl_xor_sync(0xffffffffu, st.l[r], 1);
    st.l[r] += __shfl_xor_sync(0xffffffffu, st.l[r], 2);
    st.l[r] += __shfl_xor_sync(0xffffffffu, st.l[r], 4);
  }
  if ((lane & 7) != 0) return;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ld.i0 + 4 * rg + r;
    if (i >= a.Tq) continue;
    const size_t stat = ((size_t)ld.b * a.H + ld.h) * a.Tq + i;
    a.m[stat] = st.m[r];
    a.l[stat] = st.l[r];
  }
}

// One warp a block, as many blocks an SM as fit (eight where a tile holds
// 16 keys: 26-28 KB each), each warp walking over (sequence, head, 16
// query rows) items with a stream of loads of its own: a ring of
// kWdStages stages, each a chunk of kWdChunk columns of q and of a KV
// tile's K rows (or of its V rows), filled by cp.async copies while the
// earlier stages compute, so the next chunks -- and the next item's --
// are in flight meanwhile; no block barrier anywhere. Where the item's
// visible keys fit one tile (up to kWdKeys: every T <= 64 block) the warp
// sums each score over all of D in its own registers, chunk after chunk,
// takes the exact row max from them, forms p once, and then streams V's
// chunks into pv: q, K and V are each staged once. Longer rows take two
// passes over tiles of 64 keys (the row max; then p, l and P.V, pv summed
// over tiles in device memory by the lanes that own each element).
template <bool kBf16>
__global__ void __launch_bounds__(32, 1)
flash_block_wide_kernel(const TlArgs a) {
  extern __shared__ __align__(128) float smem[];
  const int stage_f = (16 + a.tk) * kWdRow;
  float* pt = smem + kWdStages * stage_f;  // f32: [tk][kTlPRow]
  int* hdr = reinterpret_cast<int*>(pt + (kBf16 ? 0 : a.tk * kTlPRow));
  WdCursor p;
  p.item = blockIdx.x;
  p.first = 1;
  p.load = 0;
  unsigned char pre[4];
  wd_fetch(a, p.item, pre);
  for (int s = 0; s < kWdStages; ++s) wd_produce(a, p, pre, smem, hdr);
  std::conditional_t<kBf16, WdBf16, WdF32> st;
  for (int load = 0;; ++load) {
    cp_async_wait_group<kWdStages - 1>();
    __syncwarp();
    const int* hd = hdr + (load % kWdStages) * kWdHdr;
    WdLoad ld;
    ld.b = hd[0];
    if (ld.b < 0) break;
    ld.h = hd[1];
    ld.i0 = hd[2];
    ld.kend = hd[3];
    ld.c = hd[4];
    ld.t = hd[5];
    ld.qk = hd[6] & 1;
    ld.pass = (hd[6] >> 1) & 3;
    ld.first = hd[6] >> 3;
    ld.nt = hd[7];
    ld.vw[0] = (uint32_t)hd[8];
    ld.vw[1] = (uint32_t)hd[9];
    const float* qs = smem + (load % kWdStages) * stage_f;
    const float* ks = qs + 16 * kWdRow;  // the K (or V) tile's rows
    if (ld.kend == 0) {
      wd_empty(a, ld);
    } else {
      const int t0 = ld.t * a.tk;
      const int gend = min((ld.kend - t0 + 15) >> 4, a.tk >> 4);
      if (ld.first) st.init();
      if (ld.qk) {
        if (ld.c == 0) st.zero();
        const bool last = ld.c == a.nch - 1;
        const bool do_max = ld.pass != 2;
        const bool reduce_max =
            ld.pass == 0 || (ld.pass == 1 && ld.t == ld.nt - 1);
        if constexpr (kBf16) {
          wd_scores_bf16(qs, ks, st, gend);
          if (last) {
            wd_softmax_bf16(a, st, ld.vw, gend, ld.i0, a.kv_start + t0,
                            do_max, reduce_max, ld.pass != 1);
          }
        } else {
          f32_scores<kWdChunk, kWdGroups>(qs, ks, st.s, gend);
          if (last) {
            const int rg = (threadIdx.x & 31) >> 3;
            const uint64_t ok = f32_mask<kWdGroups>(
                a, st.s, ld.vw, gend, a.q_start + ld.i0 + 4 * rg,
                a.kv_start + t0, do_max, st.m);
            if (reduce_max) f32_rowmax(st.m);
            if (ld.pass != 1) wd_p_f32(pt, st, ok, gend);
          }
        }
      } else {
        if constexpr (kBf16) {
          wd_pv_bf16(a, ks, st, gend, ld, ld.t > 0);
        } else {
          wd_pv_f32(a, ks, pt, gend, ld, ld.t > 0);
        }
        if (ld.c == a.nch - 1 && ld.t == ld.nt - 1) {
          if constexpr (kBf16) {
            wd_stats_bf16(a, st, ld);
          } else {
            wd_stats_f32(a, st, ld);
          }
        }
      }
    }
    __syncwarp();  // the stage (and pt's readers) are done
    wd_produce(a, p, pre, smem, hdr);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// cudaFuncAttributes of one instance → {registers, static shared bytes,
// local (spill) bytes, max threads}
int func_info(const void* fn, int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = (int)attr.localSizeBytes;
  out[3] = attr.maxThreadsPerBlock;
  return 0;
}

}  // namespace

extern "C" {

// → cudaGetLastError() after the launch (0 = launched). The tensor-core
// variant: bf16 compute, Tq == Tk == T with T % 16 == 0 and T <= 128,
// D in {16, 32, 64}; items of g sequences x hb heads, hb == H with
// bulk = 1 (contiguous [B, T, H, D] q, k, v, 16-byte aligned), else
// hb == 1 (vec = 16-byte aligned pointers and strides); at most 256
// threads (g * hb * T / 16 warps). Persistent grid: as many blocks as fit
// on every SM.
int kt_flash_block_tc(const float* q, const float* k, const float* v,
                      const unsigned char* kv_valid, float* pv, float* m,
                      float* l, int B, int T, int H, int D, int hb, int g,
                      long long qsb, long long qst, long long qsh,
                      long long ksb, long long kst, long long ksh,
                      long long vsb, long long vst, long long vsh,
                      int q_start, int kv_start, int causal, int bulk,
                      int vec, float scale, void* stream) {
  const int warps = g * hb * (T / 16);
  const bool ok_shape = B > 0 && H > 0 && g > 0 && T >= 16 && T <= 128 &&
                        T % 16 == 0 && (D == 16 || D == 32 || D == 64) &&
                        (bulk ? hb == H : hb == 1) && warps * 32 <= kTcMaxThreads &&
                        tc_smem_bytes(g, hb, T, D, bulk) <= (size_t)kMaxSmem;
  if (!ok_shape) return (int)cudaErrorInvalidValue;
  TcArgs a;
  a.q = q; a.k = k; a.v = v; a.kv_valid = kv_valid;
  a.pv = pv; a.m = m; a.l = l;
  a.qsb = qsb; a.qst = qst; a.qsh = qsh;
  a.ksb = ksb; a.kst = kst; a.ksh = ksh;
  a.vsb = vsb; a.vst = vst; a.vsh = vsh;
  a.B = B; a.H = H; a.hb = hb; a.g = g;
  a.q_start = q_start; a.kv_start = kv_start; a.causal = causal;
  a.bulk = bulk; a.vec = vec;
  a.n_hgroups = H / hb;
  a.n_items = ((B + g - 1) / g) * a.n_hgroups;
  a.scale = scale;
  const size_t smem = tc_smem_bytes(g, hb, T, D, bulk);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define KT_TC_CASE(TT, DD)                                        \
  if (T == TT && D == DD) return launch_tc<TT, DD>(a, warps * 32, smem, s);
#define KT_TC_T(TT) KT_TC_CASE(TT, 16) KT_TC_CASE(TT, 32) KT_TC_CASE(TT, 64)
  KT_TC_T(16) KT_TC_T(32) KT_TC_T(48) KT_TC_T(64)
  KT_TC_T(80) KT_TC_T(96) KT_TC_T(112) KT_TC_T(128)
#undef KT_TC_T
#undef KT_TC_CASE
  return (int)cudaErrorInvalidValue;
}

// → cudaGetLastError() after the launch (0 = launched). The KV-tiled
// variant: bf16 (bf16 = 1) or f32 compute, any B, Tq, Tk, H, D >= 1, on
// one of three paths (vec = every q/k/v pointer 16-byte aligned and every
// stride a multiple of 4 floats; persistent grids):
// - ring (path 0): dp the padded head dim (16 (bf16 only), 32, 64, 128
//   or 256) with D <= dp; items of g sequences x one head x qr query rows
//   (qr a multiple of 16 up to 128), KV tiles of tk keys (a multiple of
//   16 up to 128, 32 or 16 for dp <= 64, 128, 256 where one tile holds
//   Tk, else up to 64, 32 or 16); g > 1 only where one
//   query tile and one KV tile hold whole sequences; g * qr / 16 warps,
//   at most 8;
// - resident (path 1): bf16, dp 16, 32 or 64, g = 1, tk = Tk rounded up
//   to 16, qr = 128 (8 warps);
// - wide (path 2): D > 256, dp = D rounded up to 64, g = 1, qr = 16, tk
//   up to 64 (Tk rounded up to 16 where one tile holds it, else 32 or 64);
//   one warp a block.
int kt_flash_block_tiled(const float* q, const float* k, const float* v,
                         const unsigned char* kv_valid, float* pv, float* m,
                         float* l, int B, int Tq, int Tk, int H, int D,
                         int dp, int g, int qr, int tk, long long qsb,
                         long long qst, long long qsh, long long ksb,
                         long long kst, long long ksh, long long vsb,
                         long long vst, long long vsh, int q_start,
                         int kv_start, int causal, int bf16, int vec,
                         int path, float scale, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || g <= 0 || qr < 16 ||
      tk < 16 || D < 1 || qr % 16 != 0 || tk % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int nqt = (Tq + qr - 1) / qr;
  const int nkt = (Tk + tk - 1) / tk;
  int warps = g * (qr / 16);
  const int nch = (D + kWdChunk - 1) / kWdChunk;
  size_t smem = 0;
  long long items = 0;
  bool ok_shape = warps * 32 <= kTlMaxThreads;
  if (path == kTlRing) {
    smem = tl_smem_bytes(g, qr, tk, dp, bf16 != 0, nkt > 1);
    ok_shape = ok_shape && D <= dp && tl_dp_ok(dp, bf16 != 0) &&
               qr <= kTlQRows &&
               tk <= (nkt > 1 ? tl_stream_keys(dp) : tl_keys(dp)) &&
               (g == 1 || (nqt == 1 && nkt == 1));
    items = (long long)((B + g - 1) / g) * H * nqt;
  } else if (path == kTlResident) {
    smem = rs_smem_bytes(tk, dp);
    ok_shape = ok_shape && bf16 && (dp == 16 || dp == 32 || dp == 64) &&
               D <= dp && g == 1 && nkt == 1 && tk - Tk < 16 &&
               qr == kTlQRows;
    items = (long long)B * H;
  } else if (path == kTlWide) {
    warps = 1;
    smem = wd_smem_bytes(tk, bf16 != 0);
    ok_shape = ok_shape && D > kTlMaxDP && dp == nch * kWdChunk && g == 1 &&
               qr == 16 && tk <= kWdKeys && (nkt == 1 || tk % 32 == 0);
    items = (long long)B * H * nqt;
  } else {
    ok_shape = false;
  }
  if (!ok_shape || smem > (size_t)kMaxSmem || items > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  TlArgs a;
  a.q = q; a.k = k; a.v = v; a.kv_valid = kv_valid;
  a.pv = pv; a.m = m; a.l = l;
  a.qsb = qsb; a.qst = qst; a.qsh = qsh;
  a.ksb = ksb; a.kst = kst; a.ksh = ksh;
  a.vsb = vsb; a.vst = vst; a.vsh = vsh;
  a.B = B; a.Tq = Tq; a.Tk = Tk; a.H = H; a.D = D;
  a.g = g; a.qr = qr; a.tk = tk; a.nqt = nqt; a.nkt = nkt; a.nch = nch;
  a.n_items = (int)items;
  a.warps = warps;
  a.q_start = q_start; a.kv_start = kv_start; a.causal = causal;
  a.vec = vec;
  a.valid4 = Tk % 4 == 0 && ((uintptr_t)kv_valid & 3) == 0;
  a.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = warps * 32;
  if (path == kTlWide) {
    return bf16 ? launch_persistent(flash_block_wide_kernel<true>, a,
                                    a.n_items, threads, smem, s)
                : launch_persistent(flash_block_wide_kernel<false>, a,
                                    a.n_items, threads, smem, s);
  }
  if (path == kTlResident) {
#define KT_RS_CASE(DD)                                                     \
  if (dp == DD)                                                            \
    return launch_persistent(flash_block_resident_kernel<DD>, a, a.n_items, \
                             threads, smem, s);
    KT_RS_CASE(16) KT_RS_CASE(32) KT_RS_CASE(64)
#undef KT_RS_CASE
    return (int)cudaErrorInvalidValue;
  }
  if (bf16) {
    switch (dp) {
      case 16: return launch_tiled<16, true>(a, threads, smem, s);
      case 32: return launch_tiled<32, true>(a, threads, smem, s);
      case 64: return launch_tiled<64, true>(a, threads, smem, s);
      case 128: return launch_tiled<128, true>(a, threads, smem, s);
      case 256: return launch_tiled<256, true>(a, threads, smem, s);
    }
  } else {
    switch (dp) {
      case 32: return launch_tiled<32, false>(a, threads, smem, s);
      case 64: return launch_tiled<64, false>(a, threads, smem, s);
      case 128: return launch_tiled<128, false>(a, threads, smem, s);
      case 256: return launch_tiled<256, false>(a, threads, smem, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// Compiled resources of one instance: tc = 1 the tensor-core variant at
// (T, D); tc = 0 the tiled one for bf16 or f32 compute on `path`: the
// ring at padded head dim D, its instance for a KV row of T keys (16 or
// fewer, one tile, or a stream of tiles); the resident one at padded D;
// the wide one → out =
// {registers, static shared bytes, local (spill) bytes, max threads per
// block}.
int kt_flash_block_info(int tc, int T, int D, int bf16, int path, int* out) {
  if (!tc && path == kTlWide) {
    return func_info(bf16 ? (const void*)flash_block_wide_kernel<true>
                          : (const void*)flash_block_wide_kernel<false>,
                     out);
  }
  if (!tc && path == kTlResident) {
#define KT_RS_INFO(DD)                                                     \
  if (D == DD)                                                             \
    return func_info((const void*)flash_block_resident_kernel<DD>, out);
    KT_RS_INFO(16) KT_RS_INFO(32) KT_RS_INFO(64)
#undef KT_RS_INFO
    return (int)cudaErrorInvalidValue;
  }
  if (!tc) {
    // T: keys of the KV row; the instance the launch would take
    const bool short_tile = T <= 16 && tl_keys(D) > 16;
    const bool stream = T > tl_keys(D);
#define KT_TL_INFO(DD, BF)                                                   \
  if (D == DD && bf16 == BF)                                                 \
    return func_info(                                                        \
        short_tile ? (const void*)flash_block_tiled_kernel<DD, 16, BF != 0>  \
        : stream                                                             \
            ? (const void*)flash_block_tiled_kernel<DD, tl_stream_keys(DD),  \
                                                    BF != 0>                 \
            : (const void*)flash_block_tiled_kernel<DD, tl_keys(DD), BF != 0>, \
        out);
    KT_TL_INFO(16, 1) KT_TL_INFO(32, 1) KT_TL_INFO(64, 1)
    KT_TL_INFO(128, 1) KT_TL_INFO(256, 1)
    KT_TL_INFO(32, 0) KT_TL_INFO(64, 0) KT_TL_INFO(128, 0) KT_TL_INFO(256, 0)
#undef KT_TL_INFO
    return (int)cudaErrorInvalidValue;
  }
#define KT_TC_INFO(TT, DD)                                                   \
  if (T == TT && D == DD)                                                    \
    return func_info((const void*)flash_block_tc_kernel<TT, DD>, out);
#define KT_TC_T(TT) KT_TC_INFO(TT, 16) KT_TC_INFO(TT, 32) KT_TC_INFO(TT, 64)
  KT_TC_T(16) KT_TC_T(32) KT_TC_T(48) KT_TC_T(64)
  KT_TC_T(80) KT_TC_T(96) KT_TC_T(112) KT_TC_T(128)
#undef KT_TC_T
#undef KT_TC_INFO
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
