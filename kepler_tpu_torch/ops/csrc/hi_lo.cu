// The hi/lo split of an f32 gradient into a bf16 pair, for Hopper
// (sm_90a), bound through a plain C interface and loaded with ctypes by
// kepler_tpu_torch/ops/hi_lo.py.
//
// kt_hi_lo (replaces no TPU kernel: there the transpose of a dot with an
// f32 result takes the f32 cotangent as it is, and the card's tensor
// cores take no f32 operand)
//   g [rows, n] f32 → pair [rows, 2n] bf16, row r:
//     pair[r, c]     = hi = bf16(g[r, c])            (round to nearest even)
//     pair[r, n + c] = lo = bf16(g[r, c] - float(hi))
//   g - hi is exact in f32, so hi + lo is g to 2^-17 relative.
//   Bound: bytes. Each element is read once (4 bytes) and its two halves
//   written once (4 bytes); ~10.7 GB, 3.2 ms at 3.35 TB/s, for the
//   [10,485,760, 128] gradients of the temporal refit's K and V.
//   Design: one thread a group of V neighbouring elements of one row, V = 8
//   where n % 8 == 0 (two 16-byte loads, one 16-byte store to each half),
//   V = 4 where n % 4 == 0 (8-byte stores), else one element, so
//   neighbouring threads touch neighbouring addresses in g and in both
//   halves of the pair. Index arithmetic is 32-bit where the element count
//   allows it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

// V bf16 values as one store: 8 or 16 bytes
template <int V> struct Store;
template <> struct Store<4> {
  using T = uint2;
  __device__ static T make(const uint32_t* w) { return make_uint2(w[0], w[1]); }
};
template <> struct Store<8> {
  using T = uint4;
  __device__ static T make(const uint32_t* w) {
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// One thread: V neighbouring elements of one row (n % V == 0), V / 4
// 16-byte loads and one store to each half of the pair.
template <int V, typename Index>
__global__ void hi_lo_vec(const float4* __restrict__ g,
                          typename Store<V>::T* __restrict__ pair,
                          Index groups, Index row_groups) {
  const Index i = blockIdx.x * (Index)blockDim.x + threadIdx.x;
  if (i >= groups) return;
  uint32_t hi[V / 2], lo[V / 2];
#pragma unroll
  for (int q = 0; q < V / 4; ++q) {
    const float4 x = g[i * (V / 4) + q];
    const __nv_bfloat162 h01 = __floats2bfloat162_rn(x.x, x.y);
    const __nv_bfloat162 h23 = __floats2bfloat162_rn(x.z, x.w);
    const float2 f01 = __bfloat1622float2(h01);
    const float2 f23 = __bfloat1622float2(h23);
    hi[2 * q] = bits(h01);
    hi[2 * q + 1] = bits(h23);
    lo[2 * q] = bits(__floats2bfloat162_rn(x.x - f01.x, x.y - f01.y));
    lo[2 * q + 1] = bits(__floats2bfloat162_rn(x.z - f23.x, x.w - f23.y));
  }
  const Index at = i + (i / row_groups) * row_groups;  // row r → r·2n/V
  pair[at] = Store<V>::make(hi);
  pair[at + row_groups] = Store<V>::make(lo);
}

// One thread: one element (n % 4 != 0).
template <typename Index>
__global__ void hi_lo_one(const float* __restrict__ g,
                          __nv_bfloat16* __restrict__ pair, Index total,
                          Index n) {
  const Index i = blockIdx.x * (Index)blockDim.x + threadIdx.x;
  if (i >= total) return;
  const float x = g[i];
  const __nv_bfloat16 hi = __float2bfloat16_rn(x);
  const Index at = i + (i / n) * n;
  pair[at] = hi;
  pair[at + n] = __float2bfloat16_rn(x - __bfloat162float(hi));
}

template <int V, typename Index>
void launch_vec(const float* g, __nv_bfloat16* pair, int64_t total,
                int64_t n, cudaStream_t s) {
  const int64_t groups = total / V;
  const int64_t blocks = (groups + kThreads - 1) / kThreads;
  hi_lo_vec<V, Index><<<(unsigned)blocks, kThreads, 0, s>>>(
      reinterpret_cast<const float4*>(g),
      reinterpret_cast<typename Store<V>::T*>(pair), (Index)groups,
      (Index)(n / V));
}

template <typename Index>
void launch(const float* g, __nv_bfloat16* pair, int64_t total, int64_t n,
            cudaStream_t s) {
  if (n % 8 == 0) {
    launch_vec<8, Index>(g, pair, total, n, s);
  } else if (n % 4 == 0) {
    launch_vec<4, Index>(g, pair, total, n, s);
  } else {
    const int64_t blocks = (total + kThreads - 1) / kThreads;
    hi_lo_one<Index><<<(unsigned)blocks, kThreads, 0, s>>>(
        g, pair, (Index)total, (Index)n);
  }
}

}  // namespace

extern "C" {

// → cudaGetLastError() after the launch (0 = launched). g [total / n, n]
// f32 and pair [total / n, 2n] bf16, both contiguous and 16-byte aligned.
int kt_hi_lo(const float* g, __nv_bfloat16* pair, int64_t total, int64_t n,
             void* stream) {
  if (total <= 0 || n <= 0 || total % n != 0 ||
      (total + kThreads - 1) / kThreads > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (total < (int64_t{1} << 31)) {
    launch<uint32_t>(g, pair, total, n, s);
  } else {
    launch<int64_t>(g, pair, total, n, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
