// SDDMM over the blocked layout: score[w, j] = <x[dst], y[src]> for slot j
// of chunk w (dst = dst_block * tile + dst_local, src = src_block * tile +
// src_local), in f32; 0 where the slot's weight is 0 (padding).
//
// Replaces the TPU kernel `_sddmm_kernel` (sldm_gnn_tpu/ops/sddmm.py:47,
// launched by `sddmm_pallas` :63, pallas_call :92). The TPU kernel
// multiplies the whole destination tile by the whole source tile on the
// MXU (tile x tile dot products, of which a chunk uses at most EC) and
// picks the slots' entries out with one-hot products. On this card that
// work is wasted: one block takes one chunk and each of its 8 warps one
// slot at a time; lane l multiplies and sums columns l, l + 32, ... of the
// two rows in turn, and the warp adds the lanes' sums by a fixed shuffle
// tree (xor 16, 8, 4, 2, 1), so every launch repeats its bits and the
// plain version (ops/sddmm.py) sums in the same order. __fmul_rn /
// __fadd_rn keep the compiler from contracting into FMAs.
//
// Bound at bench.py's graph under prepare_sddmm (200 192 rows, tile 128,
// 256-slot chunks, D = 128, f32 x and y): bytes, x and y once (205 MB),
// the layout's 12 bytes a slot and the f32 scores once. The gathered rows
// (512 bytes each, two a slot) are served mostly from the 50 MB L2.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;

__global__ void __launch_bounds__(32 * kWarps)
    sddmm_kernel(const int* __restrict__ block_meta, const int* __restrict__ src_local,
                 const int* __restrict__ dst_local, const float* __restrict__ weight, int ec,
                 int tile, const float* __restrict__ x, const float* __restrict__ y, int D,
                 float* __restrict__ out) {
  const int w = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t dst0 = static_cast<size_t>(block_meta[2 * w]) * tile;
  const size_t src0 = static_cast<size_t>(block_meta[2 * w + 1]) * tile;
  for (int j = warp; j < ec; j += kWarps) {
    const size_t s = static_cast<size_t>(w) * ec + j;
    float acc = 0.0f;
    if (weight[s] != 0.0f) {  // the same for the whole warp
      const float* xr = x + (dst0 + dst_local[s]) * D;
      const float* yr = y + (src0 + src_local[s]) * D;
      for (int c = lane; c < D; c += 32) acc = __fadd_rn(acc, __fmul_rn(xr[c], yr[c]));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, off));
    }
    if (lane == 0) out[s] = acc;
  }
}

}  // namespace

// block_meta [W, 2], src_local and dst_local [W, ec] int32, weight [W, ec]
// f32, x and y [n_rows, D] f32 -> out [W, ec] f32.
extern "C" int sddmm_launch(const void* block_meta, const void* src_local, const void* dst_local,
                            const void* weight, int num_chunks, int ec, int tile, const void* x,
                            const void* y, int D, void* out, void* stream) {
  if (num_chunks <= 0 || ec <= 0 || tile <= 0 || D <= 0) return SLDM_ERR_SHAPE;
  sddmm_kernel<<<num_chunks, 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(block_meta), static_cast<const int*>(src_local),
      static_cast<const int*>(dst_local), static_cast<const float*>(weight), ec, tile,
      static_cast<const float*>(x), static_cast<const float*>(y), D,
      static_cast<float*>(out));
  return cudaGetLastError();
}
