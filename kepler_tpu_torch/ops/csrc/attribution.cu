// Fleet-window attribution kernels for Hopper (sm_90a), bound through a
// plain C interface and loaded with ctypes by
// kepler_tpu_torch/ops/cuda_attribution.py.
//
// B1  kt_outer_product_attribution
//   Replaces kepler_tpu/ops/pallas_attribution.py::outer_product_attribution
//   (Pallas body _outer_kernel). Computes, in one pass over the inputs,
//     energy[n,w,z] = ratio[n,w] * active_uj[n,z]
//     power[n,w,z]  = ratio[n,w] * active_power_uw[n,z]
//   Bound: bytes. Two f32 [N,W,Z] outputs are written for one f32 [N,W]
//   input, at one multiply per output element; at N=1024, W=256, Z=4 the
//   kernel must move ~9.4 MB. Design: a grid over (w-tile, n); each thread
//   reads one ratio, keeps its node's Z zone values (broadcast through L1)
//   and writes its Z contiguous outputs of both planes straight into the
//   public [N, W, Z] layout, as one 16-byte store per plane when Z == 4.
//   The TPU kernel's [Z, N, W] layout plus transpose existed only to give
//   VMEM tiles a 128-wide lane axis and has no counterpart here.
//
// B2  kt_fused_window_step
//   Replaces kepler_tpu/ops/pallas_attribution.py::fused_window_step
//   (Pallas body _fused_window_kernel). One fleet window on the packed
//   resident block [N, W+2Z+4] (PackedLayout: cpu[W] | zone[Z] |
//   zone_valid[Z] | ratio, denom, dt, mode): scatter the interval's delta
//   rows into it IN PLACE (delta_idx unique; entries outside [0, N) are
//   dropped), unpack the fields, run the ratio attribution, and emit the
//   f16 watts plane [N, W+2, Z] (workload rows, node ACTIVE, node TOTAL).
//   Bound: bytes (resident read once, each landing delta row read and
//   written once, the f16 plane written once: ~5.4 MB at N=1024, W=256,
//   Z=4, DB=N; ~3.5 MB at DB=128) and, at fleet shapes, launch latency. Design: one block per tile of node rows. The
//   block scans delta_idx for the delta row that targets each of its rows
//   (no hit-matrix matmul: that was Mosaic's stand-in for an in-kernel
//   gather), copies that row or keeps the resident one in shared memory,
//   writes back only the rows a delta replaced (each block touches only
//   its own rows, so the in-place update is race-free), then computes the
//   plane from shared memory with coalesced f16 stores in [N, W+2, Z].
//   A plain copy keeps NaN (the invalid-slot encoding) as NaN, so the
//   0 * NaN hazard of the matmul gather does not arise.
//
// Numerics: every multiply and divide is an explicit IEEE round-to-nearest
// intrinsic (__fmul_rn, __fdiv_rn), never contracted into an FMA, in the
// f32 operation order of kepler_tpu/ops/attribution.py, and the f16 cast
// is __float2half_rn: the plane matches the plain PyTorch version bit for
// bit. Build without --use_fast_math or -ftz=true.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kOuterThreads = 256;
constexpr int kWindowThreads = 256;
// shared-memory floats a B2 block aims to hold for its row tile
constexpr int kWindowTileFloats = 8192;
constexpr int kWindowMaxRows = 8;

__global__ void outer_product_kernel(const float* __restrict__ ratio,
                                     const float* __restrict__ active,
                                     const float* __restrict__ power,
                                     float* __restrict__ energy_out,
                                     float* __restrict__ power_out,
                                     int n, int w, int z) {
  const int wi = blockIdx.x * blockDim.x + threadIdx.x;
  if (wi >= w) return;
  for (int node = blockIdx.y; node < n; node += gridDim.y) {
    const size_t cell = (size_t)node * w + wi;
    const float r = ratio[cell];
    const float* a = active + (size_t)node * z;
    const float* p = power + (size_t)node * z;
    if (z == 4) {
      const float4 e4 = make_float4(__fmul_rn(r, a[0]), __fmul_rn(r, a[1]),
                                    __fmul_rn(r, a[2]), __fmul_rn(r, a[3]));
      const float4 p4 = make_float4(__fmul_rn(r, p[0]), __fmul_rn(r, p[1]),
                                    __fmul_rn(r, p[2]), __fmul_rn(r, p[3]));
      reinterpret_cast<float4*>(energy_out)[cell] = e4;
      reinterpret_cast<float4*>(power_out)[cell] = p4;
    } else {
      for (int zi = 0; zi < z; ++zi) {
        energy_out[cell * z + zi] = __fmul_rn(r, a[zi]);
        power_out[cell * z + zi] = __fmul_rn(r, p[zi]);
      }
    }
  }
}

__global__ void fused_window_kernel(float* __restrict__ resident,
                                    const float* __restrict__ delta_rows,
                                    const int* __restrict__ delta_idx,
                                    __half* __restrict__ watts,
                                    int n, int db, int w, int z,
                                    int tile_rows) {
  extern __shared__ float smem[];
  const int width = w + 2 * z + 4;
  float* rows = smem;                            // [tile_rows, width]
  float* col_a = rows + tile_rows * width;       // [tile_rows, z] active µW
  float* col_t = col_a + tile_rows * z;          // [tile_rows, z] total µW
  int* src = reinterpret_cast<int*>(col_t + tile_rows * z);  // [tile_rows]

  const int row0 = blockIdx.x * tile_rows;
  const int nrows = min(tile_rows, n - row0);
  for (int r = threadIdx.x; r < tile_rows; r += blockDim.x) src[r] = -1;
  __syncthreads();
  // find, for each row of the tile, the delta row that targets it
  for (int j = threadIdx.x; j < db; j += blockDim.x) {
    const int t = delta_idx[j];
    if (t >= row0 && t < row0 + nrows) src[t - row0] = j;
  }
  __syncthreads();

  // scatter: the delta row if one targets this row, else the resident row;
  // only replaced rows are written back
  for (int e = threadIdx.x; e < nrows * width; e += blockDim.x) {
    const int r = e / width;
    const int c = e - r * width;
    const int s = src[r];
    const size_t at = (size_t)(row0 + r) * width + c;
    float v;
    if (s >= 0) {
      v = delta_rows[(size_t)s * width + c];
      resident[at] = v;
    } else {
      v = resident[at];
    }
    rows[e] = v;
  }
  __syncthreads();

  // node split per (row, zone): active = deltas * clip(ratio, 0, 1), then
  // the dt > 0 guarded divisions
  const int c_zone = w;
  const int c_valid = w + z;
  const int c_ratio = w + 2 * z;
  const int c_denom = c_ratio + 1;
  const int c_dt = c_ratio + 2;
  for (int e = threadIdx.x; e < nrows * z; e += blockDim.x) {
    const int r = e / z;
    const int zi = e - r * z;
    const float* row = rows + r * width;
    const float delta = row[c_valid + zi] > 0.5f ? row[c_zone + zi] : 0.0f;
    float ratio = row[c_ratio];
    // clip that lets NaN through, as jnp.clip and torch.clamp do
    ratio = ratio < 0.0f ? 0.0f : ratio;
    ratio = ratio > 1.0f ? 1.0f : ratio;
    const float active = __fmul_rn(delta, ratio);
    const float dt = row[c_dt];
    const bool pos = dt > 0.0f;
    col_a[e] = pos ? __fdiv_rn(active, dt) : 0.0f;
    col_t[e] = pos ? __fdiv_rn(delta, dt) : 0.0f;
  }
  __syncthreads();

  // the f16 watts plane [W+2, Z] of each row: workload rows, node ACTIVE,
  // node TOTAL — contiguous across the tile, so stores coalesce
  const int plane = (w + 2) * z;
  __half* out = watts + (size_t)row0 * plane;
  for (int e = threadIdx.x; e < nrows * plane; e += blockDim.x) {
    const int r = e / plane;
    const int rem = e - r * plane;
    const int wi = rem / z;
    const int zi = rem - wi * z;
    const float a = col_a[r * z + zi];
    float v;
    if (wi < w) {
      const float* row = rows + r * width;
      float cpu = row[wi];
      cpu = (cpu != cpu) ? 0.0f : cpu;  // NaN = invalid slot
      const float d = row[c_denom];
      const float share = d > 0.0f ? __fdiv_rn(cpu, fmaxf(d, 1e-30f)) : 0.0f;
      v = __fmul_rn(share, a);
    } else if (wi == w) {
      v = a;
    } else {
      v = col_t[r * z + zi];
    }
    out[e] = __float2half_rn(__fmul_rn(v, 1e-6f));
  }
}

// Rows per B2 block for a row width (one shared-memory tile).
int fused_window_tile_rows(int w, int z) {
  const int width = w + 2 * z + 4;
  int rows = kWindowTileFloats / width;
  if (rows < 1) rows = 1;
  if (rows > kWindowMaxRows) rows = kWindowMaxRows;
  return rows;
}

}  // namespace

extern "C" {

// → cudaGetLastError() after the launch (0 = launched).
int kt_outer_product_attribution(const float* ratio, const float* active,
                                 const float* power, float* energy_out,
                                 float* power_out, int n, int w, int z,
                                 void* stream) {
  if (n <= 0 || w <= 0 || z <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((w + kOuterThreads - 1) / kOuterThreads,
                  n < 65535 ? n : 65535);
  outer_product_kernel<<<grid, kOuterThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      ratio, active, power, energy_out, power_out, n, w, z);
  return (int)cudaGetLastError();
}

// → cudaGetLastError() after the launch (0 = launched).
int kt_fused_window_step(float* resident, const float* delta_rows,
                         const int* delta_idx, __half* watts, int n, int db,
                         int w, int z, void* stream) {
  if (n <= 0 || db < 0 || w <= 0 || z <= 0) return (int)cudaErrorInvalidValue;
  const int width = w + 2 * z + 4;
  const int tile_rows = fused_window_tile_rows(w, z);
  const size_t smem = (size_t)tile_rows * (width + 2 * z) * sizeof(float)
                      + (size_t)tile_rows * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (n + tile_rows - 1) / tile_rows;
  fused_window_kernel<<<blocks, kWindowThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      resident, delta_rows, delta_idx, watts, n, db, w, z, tile_rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
