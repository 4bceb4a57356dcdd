// The boundary between a hidden layer's product and the next product, in
// one pass each way, for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes by kepler_tpu_torch/ops/gelu_operand.py.
//
// Replaces no TPU kernel: XLA fuses the bias add, the tanh GELU and the
// bf16 cast of the next dot's operand on the TPU; eager PyTorch runs them
// as separate passes over the f32 activations.
//
// kt_gelu_operand
//   z [E, M, H] f32, bias [E, H] f32 → h [E, M, H] bf16:
//     h = bf16(gelu_tanh(z + bias[e]))      (round to nearest even)
//   gelu_tanh is PyTorch's f32 formula in its order,
//     0.5·x·(1 + tanh(β·(x + κ·x³))), β = √2·(2/√π)·0.5, κ = 0.044715,
//   so h is F.gelu(z + b, approximate="tanh").to(bf16) bit for bit where
//   nvcc contracts the expression as it does PyTorch's own kernel.
//   Bound: bytes, 6 an element (z read once, h written once); 30.2 GB,
//   9.0 ms at 3.35 TB/s, at the mixture's [8, 4,915,200, 128].
//   Design: one thread a group of 8 neighbouring elements of one row
//   (H % 8 == 0): two 16-byte loads of z, two of the bias (L1-resident),
//   one 16-byte store of h; one grid row (blockIdx.y) an expert, so the
//   index arithmetic within an expert is 32-bit.
//
// kt_gelu_operand_backward
//   g [E, M, H] bf16 (the next product's operand gradient), z, bias →
//     dz [E, M, H] f32 = f32(g) · gelu_tanh'(z + bias[e])
//     dbias [E, H] f32 = Σ_rows dz
//   gelu_tanh' is PyTorch's tanh-GELU backward, factor for factor. The
//   bias gradient takes no atomics, so it repeats bit for bit: each block
//   sums its tile of rows per column in a fixed order into partial
//   [E, tiles, H] (the scratch the caller sizes with
//   kt_gelu_operand_tiles), and a second, small kernel sums the tiles of
//   each column in order.
//   Bound: bytes, 10 an element (g 2, z 4 read once; dz 4 written once)
//   plus the partial sums, 1/256 of z; 50.3 GB, 15.0 ms at 3.35 TB/s at
//   the mixture's shape.
//   Design: a block of 256 threads takes a tile of 256 rows of one
//   expert and up to 64 column groups of 8; each thread walks the tile's
//   rows with a stride of the block's row count, 16-byte loads and
//   stores, the loop unrolled 4 deep (7% less time than rolled on an
//   H100 at the refits' shapes), and keeps 8 running column sums in
//   registers; the block then sums its threads' column sums through
//   shared memory in thread order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#ifndef M_SQRT2
#define M_SQRT2 1.41421356237309504880
#endif
#ifndef M_2_SQRTPI
#define M_2_SQRTPI 1.12837916709551257390
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 256;    // rows of one backward tile (at least)
constexpr int kMaxGroupsX = 64;   // column groups of 8 in one backward block

// The constants and the order of PyTorch's CUDA tanh-GELU and its
// backward (ActivationGeluKernel.cu): double constants rounded to float.
__device__ __forceinline__ float gelu_tanh(float x) {
  constexpr float kBeta = M_SQRT2 * M_2_SQRTPI * 0.5f;
  constexpr float kKappa = 0.044715;
  const float x_cube = x * x * x;
  const float inner = kBeta * (x + kKappa * x_cube);
  return 0.5f * x * (1.0f + tanhf(inner));
}

__device__ __forceinline__ float gelu_tanh_backward(float dy, float x) {
  constexpr float kBeta = M_SQRT2 * M_2_SQRTPI * 0.5f;
  constexpr float kKappa = 0.044715;
  const float x_sq = x * x;
  const float x_cube = x_sq * x;
  const float inner = kBeta * (x + kKappa * x_cube);
  const float tanh_inner = tanhf(inner);
  const float left = 0.5f * x;
  const float right = 1.0f + tanh_inner;
  const float left_derivative = 0.5f * right;
  const float tanh_derivative = 1.0f - tanh_inner * tanh_inner;
  const float inner_derivative = kBeta * (1.0f + 3.0f * kKappa * x_sq);
  const float right_derivative = left * tanh_derivative * inner_derivative;
  return dy * (left_derivative + right_derivative);
}

__device__ __forceinline__ uint32_t pack(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
}

// One thread: 8 neighbouring elements of one row of expert blockIdx.y;
// groups = M · H / 8, the groups of one expert.
__global__ void gelu_operand_fwd(const float4* __restrict__ z,
                                 const float4* __restrict__ bias,
                                 uint4* __restrict__ h, uint32_t groups,
                                 uint32_t row_groups) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= groups) return;
  const int64_t e = blockIdx.y;
  const int64_t at = e * groups + i;
  const float4* b = bias + 2 * (e * row_groups + i % row_groups);
  const float4 z0 = z[2 * at], z1 = z[2 * at + 1];
  const float4 b0 = __ldg(b), b1 = __ldg(b + 1);
  h[at] = make_uint4(pack(gelu_tanh(z0.x + b0.x), gelu_tanh(z0.y + b0.y)),
                     pack(gelu_tanh(z0.z + b0.z), gelu_tanh(z0.w + b0.w)),
                     pack(gelu_tanh(z1.x + b1.x), gelu_tanh(z1.y + b1.y)),
                     pack(gelu_tanh(z1.z + b1.z), gelu_tanh(z1.w + b1.w)));
}

// Block (blockIdx.x, blockIdx.y, blockIdx.z): a tile of tile_rows rows of
// expert blockIdx.z, column groups blockIdx.y · blockDim.x + threadIdx.x.
// Writes dz and the tile's column sums to partial[e, blockIdx.x, :].
__global__ void gelu_operand_bwd(const uint4* __restrict__ g,
                                 const float4* __restrict__ z,
                                 const float4* __restrict__ bias,
                                 float4* __restrict__ dz,
                                 float* __restrict__ partial, int64_t rows,
                                 int64_t row_groups, int64_t tile_rows) {
  __shared__ float sums[kThreads * 8];
  const int64_t e = blockIdx.z;
  const int64_t col = int64_t(blockIdx.y) * blockDim.x + threadIdx.x;
  const bool live = col < row_groups;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (live) {
    const float4 b0 = __ldg(bias + 2 * (e * row_groups + col));
    const float4 b1 = __ldg(bias + 2 * (e * row_groups + col) + 1);
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    const int64_t first = int64_t(blockIdx.x) * tile_rows;
    const int64_t last = first + tile_rows < rows ? first + tile_rows : rows;
    // unrolled so that a thread keeps several rows' loads in flight
#pragma unroll 4
    for (int64_t r = first + threadIdx.y; r < last; r += blockDim.y) {
      const int64_t at = (e * rows + r) * row_groups + col;
      const uint4 gv = g[at];
      const float4 z0 = z[2 * at], z1 = z[2 * at + 1];
      const float2 g01 = unpack(gv.x), g23 = unpack(gv.y);
      const float2 g45 = unpack(gv.z), g67 = unpack(gv.w);
      const float d[8] = {
          gelu_tanh_backward(g01.x, z0.x + b[0]),
          gelu_tanh_backward(g01.y, z0.y + b[1]),
          gelu_tanh_backward(g23.x, z0.z + b[2]),
          gelu_tanh_backward(g23.y, z0.w + b[3]),
          gelu_tanh_backward(g45.x, z1.x + b[4]),
          gelu_tanh_backward(g45.y, z1.y + b[5]),
          gelu_tanh_backward(g67.x, z1.z + b[6]),
          gelu_tanh_backward(g67.y, z1.w + b[7])};
      dz[2 * at] = make_float4(d[0], d[1], d[2], d[3]);
      dz[2 * at + 1] = make_float4(d[4], d[5], d[6], d[7]);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] += d[j];
    }
  }
  // the block's column sums, over its rows of threads in order
  const int width = blockDim.x * 8;  // columns of this block
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    sums[threadIdx.y * width + threadIdx.x * 8 + j] = acc[j];
  }
  __syncthreads();
  const int64_t first_col = int64_t(blockIdx.y) * width;
  const int64_t cols = row_groups * 8;
  float* out = partial + (e * gridDim.x + blockIdx.x) * cols + first_col;
  for (int c = tid; c < width && first_col + c < cols;
       c += blockDim.x * blockDim.y) {
    float s = 0.f;
    for (int y = 0; y < (int)blockDim.y; ++y) s += sums[y * width + c];
    out[c] = s;
  }
}

// Block (blockIdx.x, blockIdx.y): 32 columns of expert blockIdx.y; thread
// (x, y) sums the tiles y, y + 32, … of column x, then row y = 0 sums the
// 32 threads' sums in order.
__global__ void gelu_operand_bias_sum(const float* __restrict__ partial,
                                      float* __restrict__ dbias,
                                      int64_t tiles, int64_t cols) {
  __shared__ float sums[32][33];
  const int64_t e = blockIdx.y;
  const int64_t c = int64_t(blockIdx.x) * 32 + threadIdx.x;
  float s = 0.f;
  if (c < cols) {
    const float* p = partial + e * tiles * cols + c;
    for (int64_t t = threadIdx.y; t < tiles; t += 32) s += p[t * cols];
  }
  sums[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < cols) {
    float total = 0.f;
    for (int y = 0; y < 32; ++y) total += sums[y][threadIdx.x];
    dbias[e * cols + c] = total;
  }
}

struct BackwardPlan {
  dim3 block;
  int64_t tile_rows;
  int64_t col_blocks;
};

BackwardPlan backward_plan(int64_t width) {
  const int64_t row_groups = width / 8;
  const int64_t x = row_groups < kMaxGroupsX ? row_groups : kMaxGroupsX;
  const int64_t y = kThreads / x;
  const int64_t steps = (kTileRows + y - 1) / y;
  return {dim3((unsigned)x, (unsigned)y), y * steps,
          (row_groups + x - 1) / x};
}

bool shape_ok(int64_t experts, int64_t rows, int64_t width) {
  return experts > 0 && experts <= 65535 && rows > 0 && width > 0 &&
         width % 8 == 0 && rows * (width / 8) <= 0xffffffffLL - kThreads;
}

}  // namespace

extern "C" {

// The number of row tiles of one expert in the backward: the partial sums
// are [experts, tiles, width] f32. 0 for a shape the kernels do not take.
int64_t kt_gelu_operand_tiles(int64_t rows, int64_t width) {
  if (!shape_ok(1, rows, width)) return 0;
  const int64_t tile = backward_plan(width).tile_rows;
  return (rows + tile - 1) / tile;
}

// → cudaGetLastError() after the launch (0 = launched). z [E, M, H] f32,
// bias [E, H] f32 and h [E, M, H] bf16, contiguous, 16-byte aligned.
int kt_gelu_operand(const float* z, const float* bias, __nv_bfloat16* h,
                    int64_t experts, int64_t rows, int64_t width,
                    void* stream) {
  if (!shape_ok(experts, rows, width)) return (int)cudaErrorInvalidValue;
  const uint32_t groups = (uint32_t)(rows * (width / 8));
  const dim3 grid((groups + kThreads - 1) / kThreads, (unsigned)experts);
  gelu_operand_fwd<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(z),
      reinterpret_cast<const float4*>(bias), reinterpret_cast<uint4*>(h),
      groups, (uint32_t)(width / 8));
  return (int)cudaGetLastError();
}

// → cudaGetLastError() after the two launches (0 = launched). g [E, M, H]
// bf16, z [E, M, H] f32, bias [E, H] f32, dz [E, M, H] f32, partial
// [E, kt_gelu_operand_tiles(M, H), H] f32 (scratch) and dbias [E, H] f32,
// contiguous, 16-byte aligned.
int kt_gelu_operand_backward(const __nv_bfloat16* g, const float* z,
                             const float* bias, float* dz, float* partial,
                             float* dbias, int64_t experts, int64_t rows,
                             int64_t width, void* stream) {
  if (!shape_ok(experts, rows, width)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BackwardPlan plan = backward_plan(width);
  const int64_t tiles = (rows + plan.tile_rows - 1) / plan.tile_rows;
  if (tiles > 0x7fffffff || plan.col_blocks > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)tiles, (unsigned)plan.col_blocks,
                  (unsigned)experts);
  gelu_operand_bwd<<<grid, plan.block, 0, s>>>(
      reinterpret_cast<const uint4*>(g), reinterpret_cast<const float4*>(z),
      reinterpret_cast<const float4*>(bias), reinterpret_cast<float4*>(dz),
      partial, rows, width / 8, plan.tile_rows);
  const cudaError_t first = cudaGetLastError();
  if (first != cudaSuccess) return (int)first;
  const dim3 sum_grid((unsigned)((width + 31) / 32), (unsigned)experts);
  gelu_operand_bias_sum<<<sum_grid, dim3(32, 32), 0, s>>>(partial, dbias,
                                                          tiles, width);
  return (int)cudaGetLastError();
}

}  // extern "C"
