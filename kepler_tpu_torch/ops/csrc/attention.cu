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
//   contractions are ~34 GFLOP (~18 under the causal mask). Design: a block stages the K and V tiles
//   (rounded to cd) and the Q tile of g sequences x hb heads in shared
//   memory, so each timestep row of hb*D f32 values (512 contiguous bytes
//   at H = hb = 4, D = 32) is read once, coalesced, as float4 where the
//   strides allow. One thread owns one query row: it keeps q and its pv
//   accumulator in registers, computes the row's scores twice (once for
//   the max, once for exp and p.v) from shared memory, and never writes
//   the [Tq, Tk] scores to device memory. pv is staged back through
//   shared memory so its stores coalesce too. The TPU kernel's fold to
//   [B*H, T, D] was a Mosaic tiling rule and has no counterpart here.
//   Tensor cores (mma.sync / wgmma) and TMA are not used yet.
//
// Numerics: expf (no fast math); the score is an explicit fmaf chain and
// its scale an explicit __fmul_rn, so nvcc cannot contract them
// differently in the two passes over a row. The kernel differs from the
// plain PyTorch version only in summation order. Build without
// --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

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

}  // extern "C"
