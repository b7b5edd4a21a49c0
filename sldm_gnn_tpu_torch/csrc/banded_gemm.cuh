// The f32 block-level product of the one banded kernel that still runs on
// the CUDA cores (sage_fused_fwd.cu), the `cmap` slot tiles, and the helpers
// every graph kernel includes (element loads and stores, the ordered
// reduction of per-block partials, shape checks, the shared-memory opt-in).
// spmm_banded.cu, spmm_dense.cu and the reverse kernel of sage_fused_bwd.cu
// run their products on the tensor cores instead (banded_mma.cuh).
//
// One block of 256 threads computes an output tile of at most 128 x 128
// f32 sums, acc = A @ B, walking the depth K in chunks of 32: every thread
// loads its share of the chunk through the caller's element loaders
// la(m, k) and lb(k, n) (which read device memory or shared memory and
// apply the roundings and scales of the TPU kernel being replaced) into
// shared memory as f32, then each thread accumulates an 8 x 8 register
// block by f32 FMAs: rows ty + 16 i, columns 4 tx + 64 (j / 4) + j % 4
// (ty = tid / 16, tx = tid % 16). Rows past M, columns past N and depths
// past K load as zeros. The A chunk is stored m-major with an odd stride
// (33), so both of its store patterns (consecutive threads along k, or
// along m with kAMFast, for operands whose m is the contiguous dimension in
// memory) and the row reads are free of bank conflicts; the B chunk is read
// as two float4 per thread and k.
//
// block_gemm runs on the f32 FMA units (67 TFLOP/s on the H100), not on the
// tensor cores: the fused forward that uses it is still to be redesigned.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileMax = 128;  // rows and columns of one output tile
constexpr int kKc = 32;        // depth of one staged chunk
constexpr int kLdA = kKc + 1;

struct Stage {
  float a[kTileMax * kLdA];  // [m][k]
  float b[kKc * kTileMax];   // [k][n]
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// element i of a bf16 (is_bf16) or f32 array, as f32
__device__ __forceinline__ float load_f(const void* p, size_t i, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_f(void* p, size_t i, float v, int is_bf16) {
  if (is_bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

// element i of the int8 count (or f32 weight, a_f32) tiles
__device__ __forceinline__ float load_a(const void* a, size_t i, int a_f32) {
  return a_f32 ? static_cast<const float*>(a)[i]
               : static_cast<float>(static_cast<const int8_t*>(a)[i]);
}

// column of accumulator j of thread tx
__device__ __forceinline__ int acc_col(int tx, int j) { return 4 * tx + 64 * (j >> 2) + (j & 3); }

template <bool kAMFast, class LA, class LB>
__device__ __forceinline__ void block_gemm(float (&acc)[8][8], int M, int N, int K, LA la, LB lb,
                                           Stage& st) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  for (int k0 = 0; k0 < K; k0 += kKc) {
#pragma unroll 4
    for (int q = 0; q < kTileMax * kKc / kThreads; ++q) {
      const int idx = tid + q * kThreads;
      const int m = kAMFast ? idx & (kTileMax - 1) : idx >> 5;
      const int k = kAMFast ? idx >> 7 : idx & (kKc - 1);
      st.a[m * kLdA + k] = (m < M && k0 + k < K) ? la(m, k0 + k) : 0.0f;
    }
#pragma unroll 4
    for (int q = 0; q < kTileMax * kKc / kThreads; ++q) {
      const int idx = tid + q * kThreads;
      const int n = idx & (kTileMax - 1), k = idx >> 7;
      st.b[k * kTileMax + n] = (n < N && k0 + k < K) ? lb(k0 + k, n) : 0.0f;
    }
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < kKc; ++kk) {
      float av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = st.a[(ty + 16 * i) * kLdA + kk];
      const float4 b0 = *reinterpret_cast<const float4*>(&st.b[kk * kTileMax + 4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&st.b[kk * kTileMax + 64 + 4 * tx]);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
}

// out[e] = sum over p, in order, of partial[p * n + e]: the ordered second
// pass of a reduction across blocks (no atomics, so launches repeat bits)
__global__ void reduce_partials_kernel(const float* __restrict__ partial, int parts, int n,
                                       float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.0f;
  for (int p = 0; p < parts; ++p) s += partial[static_cast<size_t>(p) * n + e];
  out[e] = s;
}

inline int launch_reduce(const float* partial, int parts, int n, float* out, cudaStream_t s) {
  reduce_partials_kernel<<<(n + 255) / 256, 256, 0, s>>>(partial, parts, n, out);
  return cudaGetLastError();
}

// Source tiles of a `cmap` layout (ops/spmm_cmap.py): slot s of
// destination block b reads the window tile woff[b / k] + cmap[b * s_span +
// s] (clamped to [0, nb), as the XLA twin clamps) instead of bo[b] + s.
// The block stages its s_span tiles in shared memory once; the caller
// synchronises before reading them.
constexpr int kMaxCmapSlots = 64;

__device__ __forceinline__ void load_cmap_tiles(int* stile, const int* __restrict__ cmap,
                                                const int* __restrict__ woff, int b, int k,
                                                int s_span, int nb) {
  for (int s = threadIdx.x; s < s_span; s += blockDim.x)
    stile[s] = min(max(woff[b / k] + cmap[static_cast<size_t>(b) * s_span + s], 0), nb - 1);
}

// Shapes every banded kernel takes: tiles of 32..128 rows in steps of 32
// (whole depth chunks), feature widths 1..128 (one output tile).
// With a cmap, at most kMaxCmapSlots slots and woff given.
inline bool banded_shape_ok(int nb, int s_span, int tile, int width) {
  return nb > 0 && s_span > 0 && tile >= 32 && tile <= kTileMax && tile % kKc == 0 &&
         width > 0 && width <= kTileMax;
}

inline bool cmap_ok(const void* cmap, const void* woff, int s_span, int k, int nb) {
  return cmap == nullptr ||
         (woff != nullptr && s_span <= kMaxCmapSlots && k > 0 && nb % k == 0);
}

// Opt in to `bytes` of dynamic shared memory for `kernel`.
template <class Kernel>
int smem_opt_in(Kernel kernel, size_t bytes) {
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (bytes > static_cast<size_t>(smem_max)) return SLDM_ERR_SMEM;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace
