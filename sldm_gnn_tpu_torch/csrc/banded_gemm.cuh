// The helpers every graph kernel includes: element loads and stores, the
// ordered reduction of per-block partials, the shapes the banded kernels
// take and the shared-memory opt-in. The banded products themselves run on
// the tensor cores (banded_mma.cuh: spmm_banded.cu, spmm_dense.cu,
// sage_fused_fwd.cu, sage_fused_bwd.cu and spmm_banded_int8.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileMax = 128;  // rows and columns of one output tile
constexpr int kKc = 32;        // depth of one staged chunk (tiles are whole chunks)

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

// Slots of a `cmap` layout (ops/spmm_cmap.py) a block may have: the slot
// loop stages them in a table in shared memory.
constexpr int kMaxCmapSlots = 64;

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
