// Attention partial kernel for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes by kepler_tpu_torch/ops/cuda_attention.py.
//
// B3  kt_flash_block
//   Replaces kepler_tpu/ops/pallas_attention.py::flash_block_pallas (Pallas
//   body _flash_kernel). One fused (q-block x kv-block) attention partial,
//   the ops/attention.py block_attn contract:
//     s  = cd(q) . cd(k)^T * scale      f32 accumulation, scale = 1/sqrt(D)
//     mask = kv_valid[b, j] && (!causal || q_start + i >= kv_start + j)
//     m  = rowmax(mask ? s : -1e30),  p = mask ? exp(s - m) : 0,
//     l  = rowsum(p),  pv = cd(p) . cd(v)   f32 accumulation
//   cd is bf16 (round to nearest even, then multiply as f32: products of
//   two bf16 values are exact in f32) or f32. A fully masked row gives
//   m = -1e30, l = 0, pv = 0.
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
//   first design (below) at 2.5-4.8x its bound: runtime div/mod in the
//   staging loops, staging and compute serialised inside each block (2-3
//   blocks an SM, so little memory traffic in flight while blocks
//   computed), and every score computed twice on the FMA pipe, which made
//   T = 128 bound by that pipe. This design:
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
//   kt_flash_block (SIMT): f32 compute (accuracy mode) and the shapes the
//   tensor-core variant does not take (D = 8, Tq != Tk, T not a multiple
//   of 16, T > 128). A block stages the K and V tiles (rounded to cd) and
//   the Q tile of g sequences x hb heads in shared memory, so each
//   timestep row of hb*D f32 values is read once, coalesced, as float4
//   where the strides allow. One thread owns one query row: it keeps q
//   and its pv accumulator in registers, computes the row's scores twice
//   (once for the max, once for exp and p.v) from shared memory, and
//   never writes the [Tq, Tk] scores to device memory. pv is staged back
//   through shared memory so its stores coalesce too. The TPU kernel's
//   fold to [B*H, T, D] was a Mosaic tiling rule and has no counterpart
//   here.
//
// Numerics: expf (no fast math); the SIMT variant's score is an explicit
// fmaf chain and its scale an explicit __fmul_rn, so nvcc cannot contract
// them differently in the two passes over a row. Both variants differ
// from the plain PyTorch version only in summation order. Build without
// --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxSmem = 227 * 1024;
constexpr float kNegInf = -1e30f;

template <bool kBf16>
__device__ __forceinline__ float round_cd(float x) {
  if constexpr (kBf16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

// floats of one (sequence, head) unit's K (or V) tile in shared memory:
// the +4 staggers neighbouring units by four banks and keeps float4
// alignment
__host__ __device__ inline int kv_unit_stride(int tk, int d) {
  return tk * d + 4;
}

__host__ __device__ inline size_t smem_bytes(int g, int hb, int tq, int tk,
                                             int d) {
  const size_t units = (size_t)g * hb;
  const size_t floats = units * (2 * (size_t)kv_unit_stride(tk, d) +
                                 (size_t)tq * (d + 1));
  return floats * sizeof(float) + (((size_t)g * tk + 15) / 16) * 16;
}

template <int D>
__device__ __forceinline__ float row_score(const float* __restrict__ qr,
                                           const float* __restrict__ kr,
                                           float scale) {
  float s = 0.0f;
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    const float4 k4 = *reinterpret_cast<const float4*>(kr + d);
    s = fmaf(qr[d], k4.x, s);
    s = fmaf(qr[d + 1], k4.y, s);
    s = fmaf(qr[d + 2], k4.z, s);
    s = fmaf(qr[d + 3], k4.w, s);
  }
  return __fmul_rn(s, scale);
}

template <int D, bool kBf16>
__global__ void __launch_bounds__(kMaxThreads)
flash_block_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const unsigned char* __restrict__ kv_valid,
                   float* __restrict__ pv, float* __restrict__ m_out,
                   float* __restrict__ l_out, int B, int Tq, int Tk, int H,
                   int hb, int g, long long qsb, long long qst,
                   long long qsh, long long ksb, long long kst,
                   long long ksh, long long vsb, long long vst,
                   long long vsh, int q_start, int kv_start, int causal,
                   int vec, float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int D4 = D / 4;
  const int units = g * hb;
  const int kvs = kv_unit_stride(Tk, D);
  const int q_row = D + 1;  // odd row stride: one bank per query row
  float* ks = smem;                    // [units][Tk][D] (+4)
  float* vs = ks + units * kvs;        // [units][Tk][D] (+4)
  float* qs = vs + units * kvs;        // [units][Tq][D + 1]
  unsigned char* valid =
      reinterpret_cast<unsigned char*>(qs + units * Tq * q_row);  // [g][Tk]

  const int b0 = blockIdx.x * g;
  const int h0 = blockIdx.y * hb;
  const int nb = min(g, B - b0);

  // -- stage K, V and Q: d fastest, then head, then time, then sequence,
  //    so consecutive threads read consecutive addresses
  const int kv_chunks = nb * Tk * hb * D4;
  for (int e = threadIdx.x; e < kv_chunks; e += blockDim.x) {
    const int d = (e % D4) * 4;
    int r = e / D4;
    const int hh = r % hb;
    r /= hb;
    const int j = r % Tk;
    const int gi = r / Tk;
    const long long b = b0 + gi;
    const long long h = h0 + hh;
    const float* ksrc = k + b * ksb + j * kst + h * ksh + d;
    const float* vsrc = v + b * vsb + j * vst + h * vsh + d;
    float4 k4, v4;
    if (vec) {
      k4 = *reinterpret_cast<const float4*>(ksrc);
      v4 = *reinterpret_cast<const float4*>(vsrc);
    } else {
      k4 = make_float4(ksrc[0], ksrc[1], ksrc[2], ksrc[3]);
      v4 = make_float4(vsrc[0], vsrc[1], vsrc[2], vsrc[3]);
    }
    const int at = (gi * hb + hh) * kvs + j * D + d;
    *reinterpret_cast<float4*>(ks + at) =
        make_float4(round_cd<kBf16>(k4.x), round_cd<kBf16>(k4.y),
                    round_cd<kBf16>(k4.z), round_cd<kBf16>(k4.w));
    *reinterpret_cast<float4*>(vs + at) =
        make_float4(round_cd<kBf16>(v4.x), round_cd<kBf16>(v4.y),
                    round_cd<kBf16>(v4.z), round_cd<kBf16>(v4.w));
  }
  const int q_chunks = nb * Tq * hb * D4;
  for (int e = threadIdx.x; e < q_chunks; e += blockDim.x) {
    const int d = (e % D4) * 4;
    int r = e / D4;
    const int hh = r % hb;
    r /= hb;
    const int i = r % Tq;
    const int gi = r / Tq;
    const float* src = q + (long long)(b0 + gi) * qsb + i * qst +
                       (long long)(h0 + hh) * qsh + d;
    float4 q4;
    if (vec) {
      q4 = *reinterpret_cast<const float4*>(src);
    } else {
      q4 = make_float4(src[0], src[1], src[2], src[3]);
    }
    float* dst = qs + ((gi * hb + hh) * Tq + i) * q_row + d;
    dst[0] = round_cd<kBf16>(q4.x);
    dst[1] = round_cd<kBf16>(q4.y);
    dst[2] = round_cd<kBf16>(q4.z);
    dst[3] = round_cd<kBf16>(q4.w);
  }
  for (int e = threadIdx.x; e < nb * Tk; e += blockDim.x) {
    valid[e] = kv_valid[(size_t)b0 * Tk + e];
  }
  __syncthreads();

  // -- one query row per thread
  const int unit = threadIdx.x / Tq;
  const int i = threadIdx.x - unit * Tq;
  const int gi = unit / hb;
  const int hh = unit - gi * hb;
  float* qrow = qs + (unit * Tq + i) * q_row;
  if (gi < nb) {
    float qr[D];
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = qrow[d];
    const float* kb = ks + unit * kvs;
    const float* vb = vs + unit * kvs;
    const unsigned char* ok_kv = valid + gi * Tk;
    const int qpos = q_start + i;

    float m = -INFINITY;
    for (int j = 0; j < Tk; ++j) {
      const bool ok = ok_kv[j] && (!causal || qpos >= kv_start + j);
      const float s = ok ? row_score<D>(qr, kb + j * D, scale)
                         : kNegInf;
      m = fmaxf(m, s);
    }

    float acc[D];
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = 0.0f;
    float l = 0.0f;
    for (int j = 0; j < Tk; ++j) {
      const bool ok = ok_kv[j] && (!causal || qpos >= kv_start + j);
      if (!ok) continue;
      const float p =
          expf(row_score<D>(qr, kb + j * D, scale) - m);
      l += p;
      const float pc = round_cd<kBf16>(p);
      const float* vr = vb + j * D;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 v4 = *reinterpret_cast<const float4*>(vr + d);
        acc[d] = fmaf(pc, v4.x, acc[d]);
        acc[d + 1] = fmaf(pc, v4.y, acc[d + 1]);
        acc[d + 2] = fmaf(pc, v4.z, acc[d + 2]);
        acc[d + 3] = fmaf(pc, v4.w, acc[d + 3]);
      }
    }
    const size_t stat = ((size_t)(b0 + gi) * H + h0 + hh) * Tq + i;
    m_out[stat] = m;
    l_out[stat] = l;
    // stage the pv row in this thread's own Q row (read only by it)
#pragma unroll
    for (int d = 0; d < D; ++d) qrow[d] = acc[d];
  }
  __syncthreads();

  // -- coalesced pv store: [B, Tq, H, D], d fastest then head
  for (int e = threadIdx.x; e < q_chunks; e += blockDim.x) {
    const int d = (e % D4) * 4;
    int r = e / D4;
    const int hh2 = r % hb;
    r /= hb;
    const int i2 = r % Tq;
    const int gi2 = r / Tq;
    const float* src = qs + ((gi2 * hb + hh2) * Tq + i2) * q_row + d;
    const size_t at =
        (((size_t)(b0 + gi2) * Tq + i2) * H + h0 + hh2) * D + d;
    *reinterpret_cast<float4*>(pv + at) =
        make_float4(src[0], src[1], src[2], src[3]);
  }
}

template <int D, bool kBf16>
int launch(const float* q, const float* k, const float* v,
           const unsigned char* kv_valid, float* pv, float* m, float* l,
           int B, int Tq, int Tk, int H, int hb, int g, long long qsb,
           long long qst, long long qsh, long long ksb, long long kst,
           long long ksh, long long vsb, long long vst, long long vsh,
           int q_start, int kv_start, int causal, int vec, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(g, hb, Tq, Tk, D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_block_kernel<D, kBf16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((B + g - 1) / g, H / hb);
  flash_block_kernel<D, kBf16><<<grid, g * hb * Tq, smem, stream>>>(
      q, k, v, kv_valid, pv, m, l, B, Tq, Tk, H, hb, g, qsb, qst, qsh, ksb,
      kst, ksh, vsb, vst, vsh, q_start, kv_start, causal, vec, scale);
  return (int)cudaGetLastError();
}

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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every committed group but the newest kTcStages - 1 has landed
__device__ __forceinline__ void cp_async_wait_oldest() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kTcStages - 1) : "memory");
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

template <int T, int D>
int launch_tc(const TcArgs& a, int threads, size_t smem,
              cudaStream_t stream) {
  auto kern = flash_block_tc_kernel<T, D>;
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
  const int grid = (int)(a.n_items < cap ? a.n_items : cap);
  kern<<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
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

// → cudaGetLastError() after the launch (0 = launched). g sequences and hb
// heads per block (hb divides H, g * hb * Tq <= 256 threads); D in
// {8, 16, 32, 64}; vec = every q/k/v pointer 16-byte aligned and every
// stride a multiple of 4 floats.
int kt_flash_block(const float* q, const float* k, const float* v,
                   const unsigned char* kv_valid, float* pv, float* m,
                   float* l, int B, int Tq, int Tk, int H, int D, int hb,
                   int g, long long qsb, long long qst, long long qsh,
                   long long ksb, long long kst, long long ksh,
                   long long vsb, long long vst, long long vsh, int q_start,
                   int kv_start, int causal, int bf16, int vec, float scale,
                   void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || hb <= 0 || g <= 0 ||
      H % hb != 0 || g * hb * Tq > kMaxThreads ||
      smem_bytes(g, hb, Tq, Tk, D) > (size_t)kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define KT_FLASH_CASE(DIM)                                                   \
  case DIM:                                                                  \
    return bf16 ? launch<DIM, true>(q, k, v, kv_valid, pv, m, l, B, Tq, Tk,  \
                                    H, hb, g, qsb, qst, qsh, ksb, kst, ksh,  \
                                    vsb, vst, vsh, q_start, kv_start,        \
                                    causal, vec, scale, s)                   \
                : launch<DIM, false>(q, k, v, kv_valid, pv, m, l, B, Tq, Tk, \
                                     H, hb, g, qsb, qst, qsh, ksb, kst, ksh, \
                                     vsb, vst, vsh, q_start, kv_start,       \
                                     causal, vec, scale, s);
  switch (D) {
    KT_FLASH_CASE(8)
    KT_FLASH_CASE(16)
    KT_FLASH_CASE(32)
    KT_FLASH_CASE(64)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef KT_FLASH_CASE
}

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

// Compiled resources of one instance: tc = 1 the tensor-core variant at
// (T, D), tc = 0 the SIMT one at D (bf16 staging) → out = {registers,
// static shared bytes, local (spill) bytes, max threads per block}.
int kt_flash_block_info(int tc, int T, int D, int* out) {
  if (!tc) {
    switch (D) {
      case 8: return func_info((const void*)flash_block_kernel<8, true>, out);
      case 16: return func_info((const void*)flash_block_kernel<16, true>, out);
      case 32: return func_info((const void*)flash_block_kernel<32, true>, out);
      case 64: return func_info((const void*)flash_block_kernel<64, true>, out);
      default: return (int)cudaErrorInvalidValue;
    }
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
