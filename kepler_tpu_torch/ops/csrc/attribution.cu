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
// B2  kt_fused_window_steps
//   Replaces kepler_tpu/ops/pallas_attribution.py::fused_window_step
//   (Pallas body _fused_window_kernel), and the K launches per flush of
//   the fused window loop with one. K fleet windows on the packed
//   resident block [N, W+2Z+4] (PackedLayout: cpu[W] | zone[Z] |
//   zone_valid[Z] | ratio, denom, dt, mode), in order: step k scatters
//   delta_rows[k] into the block (delta_idx[k] unique within a step;
//   entries outside [0, N) are dropped), unpacks the fields, runs the
//   ratio attribution and emits the f16 watts plane out[k] [N, W+2, Z]
//   (workload rows, node ACTIVE, node TOTAL). resident is left as K
//   successive single steps leave it.
//   Bound: bytes. The resident block read once, each landing delta row
//   read once, each dirty row written back once, the indices, and K f16
//   planes: ~10.6 MB at N=1024, W=256, Z=4, DB=128, K=4 (~3.2 us).
//   What held the single-step design (PR 1) at ~15x that bound: 128
//   blocks of 8 rows (about one per SM), four barrier-separated phases
//   with runtime division by width, z and plane, and one launch (plus
//   the host wrapper) per window. Design: one block of 512 threads per
//   2 rows for the whole flush, all blocks of a 1024-node flush resident
//   at once (4 an SM). The block loads
//   its rows into shared memory once, finds for every step the delta
//   row that targets each of its rows (a scan of delta_idx; no hit
//   matrix), and from that the row's state at every step: its latest
//   delta row so far, read in place, or the resident copy. With the
//   node split of every (step, row) computed first, each thread writes
//   its (row, slot) of all K planes with no barrier between steps,
//   recomputing only where the row's state changed (most rows of a flush
//   are hit in no step or one), and each row a delta replaced
//   goes back to resident once, from its last delta row. Loops run over
//   steps, rows and columns, so no index divides at run time by width or
//   plane; Z is a template parameter (4 for the fleet, with a generic
//   instance), and at Z = 4 each workload's four halves leave as one
//   8-byte store. Each block touches only its own rows, so the
//   in-place update is race-free. A plain copy keeps NaN (the
//   invalid-slot encoding) as NaN, so the 0 * NaN hazard of the TPU
//   kernel's matmul gather does not arise.
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
// threads of a B2 block: one per (row, slot) pair of its planes at the
// fleet's W = 256 (2 x 258 pairs), and registers capped so four blocks
// (every block of a 1024-node flush) are resident on each SM at once
constexpr int kWindowThreads = 512;
constexpr int kWindowBlocksPerSm = 4;
// node rows a B2 block owns for the whole flush
constexpr int kWindowRows = 2;

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

// Shared memory of one B2 block: its rows as resident holds them, the
// node split per (step, row, zone), and per (step, row) the delta row
// that holds the row's state at that step.
size_t fused_window_smem(int k, int w, int z) {
  const int width = w + 2 * z + 4;
  return (size_t)kWindowRows * width * sizeof(float) +
         (size_t)k * kWindowRows * (2 * z * sizeof(float) + sizeof(int));
}

// kZ > 0: zones known at compile time; kZ == 0: z at run time.
template <int kZ>
__global__ void __launch_bounds__(kWindowThreads, kWindowBlocksPerSm)
fused_window_steps_kernel(float* __restrict__ resident,
                          const float* __restrict__ delta_rows,
                          const int* __restrict__ delta_idx,
                          __half* __restrict__ watts, int n, int k, int db,
                          int w, int z_rt) {
  const int z = kZ > 0 ? kZ : z_rt;
  extern __shared__ float smem[];
  const int width = w + 2 * z + 4;
  float* rows = smem;                             // [kWindowRows, width]
  float* col_a = rows + kWindowRows * width;      // [k, kWindowRows, z]
  float* col_t = col_a + k * kWindowRows * z;     // [k, kWindowRows, z]
  int* cur = reinterpret_cast<int*>(col_t + k * kWindowRows * z);  // [k, R]

  const int row0 = blockIdx.x * kWindowRows;
  const int nrows = min(kWindowRows, n - row0);
  const int tid = threadIdx.x;

  for (int r = 0; r < nrows; ++r) {
    const float* from = resident + (size_t)(row0 + r) * width;
    for (int c = tid; c < width; c += blockDim.x) rows[r * width + c] = from[c];
  }
  for (int e = tid; e < k * kWindowRows; e += blockDim.x) cur[e] = -1;
  __syncthreads();
  // the delta row that targets each row at each step (flat index s*db+j)
  for (int s = 0; s < k; ++s) {
    const int* idx = delta_idx + (size_t)s * db;
    for (int j = tid; j < db; j += blockDim.x) {
      const int t = idx[j];
      if (t >= row0 && t < row0 + nrows) {
        cur[s * kWindowRows + t - row0] = s * db + j;
      }
    }
  }
  __syncthreads();
  // the state of each row at each step: its latest hit so far, or resident
  if (tid < kWindowRows) {
    int last = -1;
    for (int s = 0; s < k; ++s) {
      const int hit = cur[s * kWindowRows + tid];
      last = hit >= 0 ? hit : last;
      cur[s * kWindowRows + tid] = last;
    }
  }
  __syncthreads();

  const int c_zone = w;
  const int c_valid = w + z;
  const int c_ratio = w + 2 * z;
  const int c_denom = c_ratio + 1;
  const int c_dt = c_ratio + 2;
  const int plane_rows = w + 2;
  auto row_at = [&](int s, int r) -> const float* {
    const int j = cur[s * kWindowRows + r];
    return j >= 0 ? delta_rows + (size_t)j * width : rows + r * width;
  };

  // node split per (step, row, zone): active = deltas * clip(ratio, 0, 1),
  // then the dt > 0 guarded divisions
  for (int e = tid; e < k * kWindowRows * z; e += blockDim.x) {
    const int sr = e / z;  // kZ = 4: a shift
    const int zi = e - sr * z;
    const int s = sr / kWindowRows;
    const int r = sr - s * kWindowRows;
    if (r >= nrows) continue;
    const float* row = row_at(s, r);
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

  // every plane, no barrier between steps: a thread owns (row, slot)
  // pairs of the plane — workload rows, node ACTIVE, node TOTAL — across
  // all K steps, and a row whose state did not change since the step
  // before stores the values it already holds
  for (int e = tid; e < nrows * plane_rows; e += blockDim.x) {
    const int r = e / plane_rows;
    const int wi = e - r * plane_rows;
    int held = -2;  // the state (cur entry) the held values belong to
    uint2 packed = make_uint2(0u, 0u);  // kZ == 4: the held halves
    for (int s = 0; s < k; ++s) {
      const int state = cur[s * kWindowRows + r];
      __half* out =
          watts + (((size_t)s * n + row0 + r) * plane_rows + wi) * z;
      if (kZ == 4 && state == held) {
        *reinterpret_cast<uint2*>(out) = packed;
        continue;
      }
      held = state;
      const float* row = row_at(s, r);
      const float* a = col_a + (s * kWindowRows + r) * z;
      const float* t = col_t + (s * kWindowRows + r) * z;
      float share = 0.0f;
      if (wi < w) {
        float cpu = row[wi];
        cpu = (cpu != cpu) ? 0.0f : cpu;  // NaN = invalid slot
        const float d = row[c_denom];
        share = d > 0.0f ? __fdiv_rn(cpu, fmaxf(d, 1e-30f)) : 0.0f;
      }
      if constexpr (kZ == 4) {
        float v[4];
#pragma unroll
        for (int zi = 0; zi < 4; ++zi) {
          const float x = wi < w ? __fmul_rn(share, a[zi])
                                 : (wi == w ? a[zi] : t[zi]);
          v[zi] = __fmul_rn(x, 1e-6f);
        }
        const __half2 lo = __halves2half2(__float2half_rn(v[0]),
                                          __float2half_rn(v[1]));
        const __half2 hi = __halves2half2(__float2half_rn(v[2]),
                                          __float2half_rn(v[3]));
        packed.x = *reinterpret_cast<const unsigned int*>(&lo);
        packed.y = *reinterpret_cast<const unsigned int*>(&hi);
        *reinterpret_cast<uint2*>(out) = packed;
      } else {
        for (int zi = 0; zi < z; ++zi) {
          const float x = wi < w ? __fmul_rn(share, a[zi])
                                 : (wi == w ? a[zi] : t[zi]);
          out[zi] = __float2half_rn(__fmul_rn(x, 1e-6f));
        }
      }
    }
  }

  // each row a delta replaced goes back to resident once, as its last
  // step left it (only this block reads or writes these rows)
  for (int r = 0; r < nrows; ++r) {
    const int j = cur[(k - 1) * kWindowRows + r];
    if (j < 0) continue;
    const float* from = delta_rows + (size_t)j * width;
    float* to = resident + (size_t)(row0 + r) * width;
    for (int c = tid; c < width; c += blockDim.x) to[c] = from[c];
  }
}

template <int kZ>
int launch_window_steps(float* resident, const float* delta_rows,
                        const int* delta_idx, __half* watts, int n, int k,
                        int db, int w, int z, cudaStream_t stream) {
  const size_t smem = fused_window_smem(k, w, z);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_window_steps_kernel<kZ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (n + kWindowRows - 1) / kWindowRows;
  fused_window_steps_kernel<kZ><<<blocks, kWindowThreads, smem, stream>>>(
      resident, delta_rows, delta_idx, watts, n, k, db, w, z);
  return (int)cudaGetLastError();
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

// → cudaGetLastError() after the launch (0 = launched). delta_rows
// [k, db, width], delta_idx [k, db], watts [k, n, w+2, z], all
// contiguous; k = 1 is one window.
int kt_fused_window_steps(float* resident, const float* delta_rows,
                          const int* delta_idx, __half* watts, int n, int k,
                          int db, int w, int z, void* stream) {
  if (n <= 0 || k <= 0 || db < 0 || w <= 0 || z <= 0 ||
      fused_window_smem(k, w, z) > 227 * 1024) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return z == 4 ? launch_window_steps<4>(resident, delta_rows, delta_idx,
                                         watts, n, k, db, w, z, s)
                : launch_window_steps<0>(resident, delta_rows, delta_idx,
                                         watts, n, k, db, w, z, s);
}

}  // extern "C"
