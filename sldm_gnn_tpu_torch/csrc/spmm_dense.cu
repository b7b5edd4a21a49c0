// Dense-tile SpMM: out[b] = rs[b] * sum_s bf16(A[b, s]) @ bf16(x[src_blk[b, s]]).
//
// Replaces the TPU kernel `_dense_kernel` (sldm_gnn_tpu/ops/spmm_dense.py:165,
// launched by `spmm_dense_pallas` :183, pallas_call :241): the aggregation
// of the dense-tile layout, both directions, and the dense half of the
// hybrid layout. The reverse layout's column scale is applied to x by the
// wrapper before the launch, as the JAX wrapper does (:220-227).
//
// This is csrc/spmm_banded.cu with an explicit source block per slot
// (src_blk) in place of bo[b] + s: one block of 256 threads a destination
// block, the slots' products walked 32 deep by the shared block product of
// banded_gemm.cuh (f32 FMAs on bf16-rounded operands), the row scale in
// f32, the result at x's dtype. Padding slots hold zero tiles and source
// block 0, and add zeros. The TPU kernel's step_blocks (destination blocks
// per grid step) sets only how the layout is padded; the grid here is one
// block a destination block either way.
//
// Bound at bench.py's dense shape (200 000 nodes, tile 128, padded to 4
// blocks: nb = 1564, s_max = 5, int8 tiles, D = 128, bf16 x): bytes, 128 MB
// of A plus x and out once (about 232 MB, 0.069 ms at 3.35 TB/s); the
// count-tile products are 33 GFLOP (0.033 ms at the bf16 tensor-core rate,
// 0.49 ms at the 67 TFLOP/s f32 rate that this kernel's FMAs run at).
#include "banded_gemm.cuh"

namespace {

// element i of the tiles: int8 (kind 0), f32 (1) or bf16 (2), as f32
__device__ __forceinline__ float load_tile(const void* a, size_t i, int kind) {
  if (kind == 1) return static_cast<const float*>(a)[i];
  if (kind == 2) return __bfloat162float(static_cast<const __nv_bfloat16*>(a)[i]);
  return static_cast<float>(static_cast<const int8_t*>(a)[i]);
}

__global__ void __launch_bounds__(kThreads, 2)
    spmm_dense_kernel(const void* __restrict__ a, int a_kind, const int* __restrict__ src_blk,
                      int s_max, int tile, const void* __restrict__ x, int x_bf16, int D,
                      const float* __restrict__ rs, void* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  Stage& st = *reinterpret_cast<Stage*>(smem);
  const int b = blockIdx.x;
  const int* sblk = src_blk + static_cast<size_t>(b) * s_max;
  const size_t tt = static_cast<size_t>(tile) * tile;
  const size_t a0 = static_cast<size_t>(b) * s_max * tt;
  auto la = [&](int m, int k) {
    const int s = k / tile, j = k - s * tile;
    return bf16_round(load_tile(a, a0 + s * tt + static_cast<size_t>(m) * tile + j, a_kind));
  };
  auto lb = [&](int k, int n) {
    const int s = k / tile, j = k - s * tile;
    const size_t row = static_cast<size_t>(sblk[s]) * tile + j;
    return bf16_round(load_f(x, row * D + n, x_bf16));
  };
  float acc[8][8];
  zero_acc(acc);
  block_gemm<false>(acc, tile, D, s_max * tile, la, lb, st);

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 16 * i;
    if (r >= tile) continue;
    const size_t row = static_cast<size_t>(b) * tile + r;
    const float sc = rs != nullptr ? rs[row] : 1.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = acc_col(tx, j);
      if (c < D) store_f(out, row * D + c, acc[i][j] * sc, x_bf16);
    }
  }
}

}  // namespace

// a [nb, s_max, tile, tile] int8 / f32 / bf16 (a_kind 0 / 1 / 2),
// src_blk [nb, s_max] int32 (every entry < nb), x and out [nb * tile, D]
// bf16 (x_bf16) or f32, rs [nb * tile] f32 or NULL.
extern "C" int spmm_dense_launch(const void* a, int a_kind, const void* src_blk, int nb,
                                 int s_max, int tile, const void* x, int x_bf16, int D,
                                 const void* rs, void* out, void* stream) {
  if (!banded_shape_ok(nb, s_max, tile, D) || a_kind < 0 || a_kind > 2) return SLDM_ERR_SHAPE;
  spmm_dense_kernel<<<nb, kThreads, sizeof(Stage), static_cast<cudaStream_t>(stream)>>>(
      a, a_kind, static_cast<const int*>(src_blk), s_max, tile, x, x_bf16, D,
      static_cast<const float*>(rs), out);
  return cudaGetLastError();
}
