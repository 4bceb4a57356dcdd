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
//   D; so does the pair of variants here (D up to 256).
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
//   512-row blocks), and any D from 1 to 256 (zero-padded in shared
//   memory to DP: 16, 32, 64, 128 or 256; at least 32 for f32). Neither
//   Tq nor Tk is bounded by threads or shared memory: a block holds one
//   tile of each at a time. This design:
//   - A work item is a tile of up to 128 query rows of one (sequence,
//     head) (fewer where DP = 256), or, where a sequence's whole q and
//     KV fit one tile (T = 16), the query rows of g sequences of one
//     head. A warp owns 16 query rows of one sequence. Persistent blocks
//     walk over the items; the tiles of one (sequence, head) run side by
//     side and share its K and V in L2.
//   - K and V stream through a ring of two shared-memory stages in tiles
//     of TK keys (64 for DP <= 64, 32 for 128, 16 for 256), filled by
//     16-byte cp.async copies (4-byte ones where strides or pointers are
//     not 16-byte aligned) that zero-fill the padding columns and the
//     rows past Tq or Tk, so a masked key meets a zero value row, never a
//     stale one. The item's q tile rides in the group of its first load,
//     in a slot of its own that lasts the item. Rows are padded by 4
//     floats. m, l and pv are stored from the registers.
//   - The plain version's math, in two passes over the key tiles: the
//     first takes the row max over every tile from the scores alone, the
//     second recomputes the scores, p = expf(s - m), l and P.V. No online
//     rescaling: it would change the bf16 rounding of p against
//     block_attn and JAX. Where one tile holds every key the item needs,
//     the two passes share one load and the scores stay in registers.
//     Tiles wholly past the sequence's last valid key or above the
//     causal diagonal of the item's last row are neither loaded nor
//     computed; within a tile, a warp skips 16-key groups past its own
//     rows' last visible key, in both passes.
//   - bf16: both products on the tensor cores with the tc variant's
//     fragment scheme (mma.sync m16n8k16, operands rounded f32 -> bf16
//     as fragments are formed, f32 accumulators, p rounded to bf16 as
//     P.V's A operand), per 16-key group of a tile.
//   - f32: products on the FMA pipe in f32 (no TF32) with register
//     tiling: a lane holds a 4-row x 2-key micro-tile of scores of each
//     16-key group and reads each q and k float4 from shared memory once
//     per micro-tile; p goes through a per-warp transposed tile in shared
//     memory so that a lane then accumulates a 4-row x 4-column micro-tile
//     of pv per 32 columns.
//   - Scores are an explicit fmaf chain (f32) or the same mma sequence
//     (bf16) and the scale an explicit __fmul_rn in both passes, so the
//     two passes cannot round a score differently.
//
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
constexpr int kTlPad = 4;     // floats padding each staged row
constexpr int kTlQRows = 128;  // query rows of an item's tile at most
constexpr int kTlPRow = 20;   // f32: floats of one key's row of a warp's p^T
constexpr int kTlMaxD = 256;

// keys a KV tile holds at most, by padded head dim: a lane's scores of a
// tile stay at TK / 2 registers and its pv accumulators at DP / 2. Every
// DP also has an instance for tiles of 16 keys (T <= 16: the trunk's
// serving windows), which needs fewer registers.
__host__ __device__ constexpr int tl_keys(int dp) {
  return dp <= 64 ? 64 : dp == 128 ? 32 : 16;
}

// blocks an SM each instance is compiled for (registers: 128 a thread at
// two, 255 at one, which the pv accumulators of DP >= 128 need)
template <int DP>
constexpr int tl_min_blocks() {
  return DP <= 64 ? 2 : 1;
}

__host__ __device__ inline bool tl_dp_ok(int dp, bool bf16) {
  return (bf16 && dp == 16) || dp == 32 || dp == 64 || dp == 128 ||
         dp == kTlMaxD;
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
  int n_items, warps;
  int q_start, kv_start, causal, vec;
  float scale;
};

// Shared memory of one block: kTlStages q slots [g][qr][DP + pad], as many
// K and V stages [g][tk][DP + pad], the f32 variant's p^T tiles
// [warps][16][kTlPRow], and per q slot the item's tile count and last
// valid key, then 8 ints of block reduction.
__host__ __device__ inline size_t tl_smem_bytes(int g, int qr, int tk,
                                                int dp, bool bf16) {
  const size_t rs = (size_t)dp + kTlPad;
  const size_t warps = (size_t)g * qr / 16;
  return sizeof(float) *
             ((size_t)kTlStages * g * rs * (qr + 2 * (size_t)tk) +
              (bf16 ? 0 : warps * 16 * kTlPRow)) +
         sizeof(int) * (2 * kTlStages + 8);
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
// sequences of x into dst ([nb][rows][DP + pad]): rows at or past t_end
// and columns at or past D are zero-filled.
template <int DP>
__device__ __forceinline__ void tl_rows(const TlArgs& a, float* dst,
                                        const float* x, long long sb,
                                        long long st, long long sh,
                                        const TlItem& it, int t0, int rows,
                                        int t_end) {
  constexpr int rs = DP + kTlPad;
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
      const int t = t0 + ra - gi * rows;
      const int bytes = t < t_end ? 4 * min(max(a.D - c, 0), 4) : 0;
      cp_async16_zfill(dst + ra * rs + c,
                       bytes ? base + gi * sb + (long long)t * st + c : x,
                       (uint32_t)bytes);
    }
  } else {
    const int n = it.nb * rows * DP;
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int ra = e / DP;
      const int c = e - ra * DP;
      const int gi = pow2 ? ra >> lg : ra / rows;
      const int t = t0 + ra - gi * rows;
      const int bytes = t < t_end && c < a.D ? 4 : 0;
      cp_async4_zfill(dst + ra * rs + c,
                      bytes ? base + gi * sb + (long long)t * st + c : x,
                      (uint32_t)bytes);
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
  int kend = min(a.Tk, last + 1);
  if (a.causal) {
    const int i_last = min((it.qt + 1) * a.qr, a.Tq) - 1;
    kend = min(kend, max(0, a.q_start + i_last - a.kv_start + 1));
  }
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
// the last item) and advance it.
template <int DP>
__device__ void tl_produce(const TlArgs& a, TlCursor& p, float* qbuf,
                           float* kbuf, float* vbuf, int* ints) {
  if (p.item >= a.n_items) {
    cp_async_commit();
    return;
  }
  constexpr int rs = DP + kTlPad;
  const int q_tile = a.g * a.qr * rs;
  const int kv_tile = a.g * a.tk * rs;
  const TlItem it = tl_item(a, p.item);
  const int slot = p.count % kTlStages;
  if (p.j == 0) {
    // the slot's previous item has been consumed in full by now
    p.n = a.nkt > 1 ? tl_tiles(a, it, ints + slot, ints + kTlStages + slot,
                               ints + 2 * kTlStages)
                    : 1;
    tl_rows<DP>(a, qbuf + slot * q_tile, a.q, a.qsb, a.qst, a.qsh, it,
                it.qt * a.qr, a.qr, a.Tq);
  }
  const int kt = p.n == 1 ? 0 : p.j % p.n;
  const int st = p.load % kTlStages;
  tl_rows<DP>(a, kbuf + st * kv_tile, a.k, a.ksb, a.kst, a.ksh, it,
              kt * a.tk, a.tk, a.Tk);
  if (p.n == 1 || p.j >= p.n) {
    tl_rows<DP>(a, vbuf + st * kv_tile, a.v, a.vsb, a.vst, a.vsh, it,
                kt * a.tk, a.tk, a.Tk);
  }
  cp_async_commit();
  p.advance(gridDim.x);
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
// lanes of a row; p, l and P.V against the reduced max.
template <int DP, int TK>
__device__ __forceinline__ void tl_tile_bf16(
    const TlArgs& a, const float* qs, const float* ks, const float* vs,
    TlBf16<DP>& st, int gend, int b, int i0, int t0, bool do_max,
    bool reduce_max, bool do_pv) {
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
    const unsigned char* valid = a.kv_valid + (size_t)b * a.Tk;
    const int qpos = a.q_start + i0 + g;
#pragma unroll
    for (int kk = 0; kk < NG; ++kk) {
      if (kk >= gend) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = t0 + 16 * kk + 4 * t4 + e;
        const bool vj = j < a.Tk && valid[j];
        const int kpos = a.kv_start + j;
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

// As tl_tile_bf16, in f32. Lane (rg, kg) = (lane / 8, lane % 8) holds the
// scores of rows 4rg + r and keys 16kk + kg + 8c: each q and k float4
// read from shared memory feeds 8 (or 16) fmaf. pt: the warp's p^T tile
// [16 keys][kTlPRow].
template <int DP, int TK>
__device__ __forceinline__ void tl_tile_f32(
    const TlArgs& a, const float* qs, const float* ks, const float* vs,
    float* pt, TlF32<DP>& st, int gend, int b, int i0, int t0, bool do_max,
    bool reduce_max, bool do_pv) {
  constexpr int NG = TK / 16;
  constexpr int DC = DP / 32;
  constexpr int rs = DP + kTlPad;
  const int lane = threadIdx.x & 31;
  const int rg = lane >> 3;
  const int kg = lane & 7;
  float s[NG][4][2];
  uint32_t ok = 0;  // bit 8kk + 2r + c: key 16kk + kg + 8c of row 4rg + r
  if (gend > 0) {
#pragma unroll
    for (int kk = 0; kk < NG; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) s[kk][r][0] = s[kk][r][1] = 0.0f;
    }
#pragma unroll 8
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
    const unsigned char* valid = a.kv_valid + (size_t)b * a.Tk;
    const int qpos = a.q_start + i0 + 4 * rg;
#pragma unroll
    for (int kk = 0; kk < NG; ++kk) {
      if (kk >= gend) continue;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = t0 + 16 * kk + kg + 8 * c;
        const bool vj = j < a.Tk && valid[j];
        const int kpos = a.kv_start + j;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const bool o = vj && (!a.causal || qpos + r >= kpos);
          ok |= (uint32_t)o << (8 * kk + 2 * r + c);
          float& x = s[kk][r][c];
          x = o ? __fmul_rn(x, a.scale) : kNegInf;
          if (do_max) st.m[r] = fmaxf(st.m[r], x);
        }
      }
    }
  }
  if (reduce_max) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      st.m[r] = fmaxf(st.m[r], __shfl_xor_sync(0xffffffffu, st.m[r], 1));
      st.m[r] = fmaxf(st.m[r], __shfl_xor_sync(0xffffffffu, st.m[r], 2));
      st.m[r] = fmaxf(st.m[r], __shfl_xor_sync(0xffffffffu, st.m[r], 4));
    }
  }
  if (!do_pv || gend == 0) return;
#pragma unroll
  for (int kk = 0; kk < NG; ++kk) {
    if (kk >= gend) continue;
    float p[2][4];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        p[c][r] = (ok >> (8 * kk + 2 * r + c)) & 1u
                      ? expf(s[kk][r][c] - st.m[r]) : 0.0f;
        st.l[r] += p[c][r];
      }
      *reinterpret_cast<float4*>(pt + (kg + 8 * c) * kTlPRow + 4 * rg) =
          make_float4(p[c][0], p[c][1], p[c][2], p[c][3]);
    }
    __syncwarp();
    // lane (rg, kg): pv rows 4rg + r, columns 32dc + 4kg + {0..3}
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
          float(&o)[4] = st.acc[r][dc];
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

// as tl_finish_bf16, for the f32 lane layout (a warp's store of one
// column tile covers 4 rows of 128 bytes)
template <int DP>
__device__ __forceinline__ void tl_finish_f32(const TlArgs& a,
                                              TlF32<DP>& st, int b, int h,
                                              int i0) {
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
    if (kg == 0) {
      const size_t stat = ((size_t)b * a.H + h) * a.Tq + i;
      a.m[stat] = st.m[r];
      a.l[stat] = st.l[r];
    }
    float* out = a.pv + (((size_t)b * a.Tq + i) * a.H + h) * a.D;
#pragma unroll
    for (int dc = 0; dc < DP / 32; ++dc) {
      const int c = 32 * dc + 4 * kg;
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

// last valid key of sequence b, by one warp (a single-tile item: Tk <= 64)
__device__ __forceinline__ int tl_warp_last(const TlArgs& a, int b) {
  const unsigned char* valid = a.kv_valid + (size_t)b * a.Tk;
  int last = -1;
  for (int j = threadIdx.x & 31; j < a.Tk; j += 32) {
    if (valid[j]) last = j;
  }
  return __reduce_max_sync(0xffffffffu, last);
}

template <int DP, int TK, bool kBf16>
__global__ void __launch_bounds__(kTlMaxThreads, tl_min_blocks<DP>())
flash_block_tiled_kernel(const TlArgs a) {
  extern __shared__ __align__(128) float smem[];
  constexpr int rs = DP + kTlPad;
  const int q_tile = a.g * a.qr * rs;
  const int kv_tile = a.g * a.tk * rs;
  float* qbuf = smem;                       // [stages][g][qr][rs]
  float* kbuf = qbuf + kTlStages * q_tile;  // [stages][g][tk][rs]
  float* vbuf = kbuf + kTlStages * kv_tile;
  float* pbuf = vbuf + kTlStages * kv_tile;  // f32: [warps][16][kTlPRow]
  int* ints = reinterpret_cast<int*>(pbuf + (kBf16 ? 0 : a.warps * 16 * kTlPRow));
  // this warp's sequence of the item and its 16 rows of the query tile
  const int warp = threadIdx.x >> 5;
  const int wpu = a.qr >> 4;
  const int gi = warp / wpu;
  const int wq = warp - gi * wpu;
  const bool multi = a.nkt > 1;

  TlCursor p{(int)blockIdx.x, 0, 1, 0, 0};
  for (int s = 0; s < kTlStages; ++s) {
    tl_produce<DP>(a, p, qbuf, kbuf, vbuf, ints);
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
      if (c.j == 0) {
        st.init();
        const int lastv = multi ? ints[kTlStages + slot] : tl_warp_last(a, b);
        kend = min(a.Tk, lastv + 1);
        if (a.causal) {
          const int i_last = min(i0 + 15, a.Tq - 1);
          kend = min(kend, max(0, a.q_start + i_last - a.kv_start + 1));
        }
      }
      const int t0 = kt * a.tk;
      const int gend = kend <= t0 ? 0 : min((kend - t0 + 15) >> 4, a.tk >> 4);
      const float* ks = kbuf + stage * kv_tile + gi * a.tk * rs;
      const float* vs = vbuf + stage * kv_tile + gi * a.tk * rs;
      const bool do_max = single || c.j < c.n;
      const bool reduce_max = single || c.j == c.n - 1;
      const bool do_pv = single || c.j >= c.n;
      if constexpr (kBf16) {
        tl_tile_bf16<DP, TK>(a, qs, ks, vs, st, gend, b, i0, t0, do_max,
                             reduce_max, do_pv);
        if (last) tl_finish_bf16<DP>(a, st, b, it.h, i0);
      } else {
        tl_tile_f32<DP, TK>(a, qs, ks, vs, pbuf + warp * 16 * kTlPRow, st,
                            gend, b, i0, t0, do_max, reduce_max, do_pv);
        if (last) tl_finish_f32<DP>(a, st, b, it.h, i0);
      }
    }
    __syncthreads();
    tl_produce<DP>(a, p, qbuf, kbuf, vbuf, ints);
    c.advance(gridDim.x);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the instance for tiles of up to 16 keys where a.tk is 16, else the one
// for tl_keys(DP)
template <int DP, bool kBf16>
int launch_tiled(const TlArgs& a, int threads, size_t smem,
                 cudaStream_t stream) {
  constexpr int TK = tl_keys(DP);
  if constexpr (TK > 16) {
    if (a.tk == 16) {
      return launch_persistent(flash_block_tiled_kernel<DP, 16, kBf16>, a,
                               a.n_items, threads, smem, stream);
    }
  }
  return launch_persistent(flash_block_tiled_kernel<DP, TK, kBf16>, a,
                           a.n_items, threads, smem, stream);
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
// variant: bf16 (bf16 = 1) or f32 compute, any B, Tq, Tk, H >= 1 and
// 1 <= D <= dp, dp the padded head dim (16 (bf16 only), 32, 64, 128 or
// 256); items of g sequences x one head x qr query rows (qr a multiple of
// 16 up to 64), KV tiles of tk keys (a multiple of 16 up to 64, 32 or 16
// for dp <= 64, 128, 256); g > 1 only where one query tile and one KV tile
// hold whole sequences; g * qr / 16 warps, at most 8; vec = every q/k/v
// pointer 16-byte aligned and every stride a multiple of 4 floats.
// Persistent grid: as many blocks as fit on every SM.
int kt_flash_block_tiled(const float* q, const float* k, const float* v,
                         const unsigned char* kv_valid, float* pv, float* m,
                         float* l, int B, int Tq, int Tk, int H, int D,
                         int dp, int g, int qr, int tk, long long qsb,
                         long long qst, long long qsh, long long ksb,
                         long long kst, long long ksh, long long vsb,
                         long long vst, long long vsh, int q_start,
                         int kv_start, int causal, int bf16, int vec,
                         float scale, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || g <= 0 || qr < 16 ||
      tk < 16) {
    return (int)cudaErrorInvalidValue;
  }
  const int nqt = (Tq + qr - 1) / qr;
  const int nkt = (Tk + tk - 1) / tk;
  const int warps = g * (qr / 16);
  const bool ok_shape =
      D >= 1 && D <= dp && tl_dp_ok(dp, bf16 != 0) && qr <= kTlQRows &&
      qr % 16 == 0 && tk % 16 == 0 && tk <= tl_keys(dp) &&
      (g == 1 || (nqt == 1 && nkt == 1)) && warps * 32 <= kTlMaxThreads &&
      tl_smem_bytes(g, qr, tk, dp, bf16 != 0) <= (size_t)kMaxSmem;
  if (!ok_shape) return (int)cudaErrorInvalidValue;
  TlArgs a;
  a.q = q; a.k = k; a.v = v; a.kv_valid = kv_valid;
  a.pv = pv; a.m = m; a.l = l;
  a.qsb = qsb; a.qst = qst; a.qsh = qsh;
  a.ksb = ksb; a.kst = kst; a.ksh = ksh;
  a.vsb = vsb; a.vst = vst; a.vsh = vsh;
  a.B = B; a.Tq = Tq; a.Tk = Tk; a.H = H; a.D = D;
  a.g = g; a.qr = qr; a.tk = tk; a.nqt = nqt; a.nkt = nkt;
  const long long items = (long long)((B + g - 1) / g) * H * nqt;
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  a.n_items = (int)items;
  a.warps = warps;
  a.q_start = q_start; a.kv_start = kv_start; a.causal = causal;
  a.vec = vec;
  a.scale = scale;
  const size_t smem = tl_smem_bytes(g, qr, tk, dp, bf16 != 0);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = warps * 32;
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
// (T, D), tc = 0 the tiled one at padded head dim D for bf16 or f32
// compute, its instance for T (the keys of a tile: 16 or fewer, or more)
// → out = {registers, static shared bytes, local (spill) bytes, max
// threads per block}.
int kt_flash_block_info(int tc, int T, int D, int bf16, int* out) {
  if (!tc) {
    const bool short_tile = T <= 16 && tl_keys(D) > 16;
#define KT_TL_INFO(DD, BF)                                                   \
  if (D == DD && bf16 == BF)                                                 \
    return func_info(                                                        \
        short_tile                                                           \
            ? (const void*)flash_block_tiled_kernel<DD, 16, BF != 0>         \
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
