// Per-row symmetric int8 quantization: scale[i] = max(max_j |x[i, j]| / 127,
// 1e-12), q[i, j] = clamp(rint(x[i, j] / scale[i]), -127, 127) (ties to
// even), or with stochastic rounding clamp(floor(x[i, j] / scale[i] + u),
// -127, 127), u uniform in [0, 1).
//
// Replaces the TPU kernel `_quant_kernel` (sldm_gnn_tpu/ops/quant.py:32,
// launched by `quantize_rows_pallas` :59, pallas_call :85). The TPU kernel
// quantizes a block of 256 rows a grid step and draws u from the TPU's own
// generator. Here one warp quantizes one row: each lane takes columns
// lane, lane + 32, ..., the row's absmax is reduced by shuffles, and a
// second pass over the row (served from L1) writes q. Divisions are IEEE
// (__fdiv_rn; the build has no fast math), so the ties round as XLA's.
// u is a counter-based hash of (seed, row, column), murmur3's 32-bit
// finalizer applied three times; its top 23 bits are the mantissa of a
// float in [1, 2), minus 1, as in `_quant_kernel`. The plain version
// (ops/quant.py) computes the same bits with int64 tensor ops, so the two
// are bit-equal; the TPU's bits are not matched.
//
// Bound at bench.py's shape (x [200192, 128] f32): bytes, x read once (103
// MB), q and the scales written once (26 MB): about 129 MB, 0.039 ms at
// 3.35 TB/s.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowsPerBlock = 8;  // one warp a row

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

__global__ void __launch_bounds__(32 * kRowsPerBlock)
    quant_rows_kernel(const float* __restrict__ x, int n_rows, int D, int stochastic,
                      uint32_t seed, int8_t* __restrict__ q, float* __restrict__ scale) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const float* xr = x + static_cast<size_t>(row) * D;
  float m = 0.0f;
  for (int c = lane; c < D; c += 32) m = fmaxf(m, fabsf(xr[c]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  const float s = fmaxf(__fdiv_rn(m, 127.0f), 1e-12f);
  if (lane == 0) scale[row] = s;
  const uint32_t hr = fmix32(fmix32(static_cast<uint32_t>(row)) ^ seed);
  int8_t* qr = q + static_cast<size_t>(row) * D;
  for (int c = lane; c < D; c += 32) {
    float v = __fdiv_rn(xr[c], s);
    if (stochastic) {
      const uint32_t h = fmix32(hr + static_cast<uint32_t>(c) * 0x9e3779b9u);
      const float u = __fsub_rn(__uint_as_float((h >> 9) | 0x3f800000u), 1.0f);
      v = floorf(__fadd_rn(v, u));
    } else {
      v = rintf(v);
    }
    qr[c] = static_cast<int8_t>(fminf(fmaxf(v, -127.0f), 127.0f));
  }
}

}  // namespace

// x [n_rows, D] f32 -> q [n_rows, D] int8, scale [n_rows] f32.
extern "C" int quant_rows_launch(const void* x, int n_rows, int D, int stochastic,
                                 uint32_t seed, void* q, void* scale, void* stream) {
  if (n_rows <= 0 || D <= 0) return SLDM_ERR_SHAPE;
  const int blocks = (n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  quant_rows_kernel<<<blocks, 32 * kRowsPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n_rows, D, stochastic, seed, static_cast<int8_t*>(q),
      static_cast<float*>(scale));
  return cudaGetLastError();
}
