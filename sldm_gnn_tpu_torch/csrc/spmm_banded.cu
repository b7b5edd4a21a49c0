// Banded mean aggregation: out[b] = rs[b] * sum_s A[b, s] @ (cs * x)[bo[b] + s].
//
// Replaces the TPU kernel `_banded_kernel` (sldm_gnn_tpu/ops/spmm_banded.py:388,
// launched by `spmm_banded_pallas` :434, pallas_call :478). It is the unfused
// SAGE layer's aggregation and, on the reverse layout, the backward of
// `spmm_banded_apply` (the 1/deg column scale cs then multiplies x's rows).
//
// Semantics, not the TPU's schedule: the TPU kernel streams one x window
// per group of K destination blocks, double-buffered in VMEM; here block b
// reads its own bo[b] and its s_span source tiles straight from device
// memory, and the 50 MB L2 holds the neighbouring blocks' shared tiles.
// With a `cmap` layout (ops/spmm_cmap.py) slot s of block b reads the window
// tile woff[b / k] + cmap[b * s_span + s] instead of bo[b] + s (the TPU
// kernel's scalar-prefetched `cmap_ref`, spmm_banded.py:419-423); the block
// stages its slots' tiles in shared memory first. Numerics of the TPU kernel: the int8 counts (exact in bf16 up to 127) or
// f32 weights and cs * x are rounded to bf16, products summed in f32, the
// row scale applied in f32, the result stored at x's dtype.
//
// Bound at bench.py's shape (nb = 1572 blocks of 128 rows, s_span = 5,
// D = 128, bf16 x): bytes, 128.8 MB of A + 51.5 MB of x + 51.5 MB of out
// (0.069 ms at 3.35 TB/s), over 33 GFLOP (0.033 ms at the bf16 tensor-core
// rate). This kernel does the products with f32 FMAs (banded_gemm.cuh), so
// the FMA rate bounds it in practice; one block of 256 threads per
// destination block.
#include "banded_gemm.cuh"

namespace {

__global__ void __launch_bounds__(kThreads, 2)
    spmm_banded_kernel(const void* __restrict__ a, int a_f32, const int* __restrict__ bo,
                       const int* __restrict__ cmap, const int* __restrict__ woff, int k,
                       int s_span, int tile, const void* __restrict__ x, int x_bf16, int D,
                       const float* __restrict__ cs, const float* __restrict__ rs,
                       void* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int stile[kMaxCmapSlots];
  Stage& st = *reinterpret_cast<Stage*>(smem);
  const int b = blockIdx.x;
  const int base = bo[b];
  if (cmap != nullptr) {
    load_cmap_tiles(stile, cmap, woff, b, k, s_span, gridDim.x);
    __syncthreads();
  }
  const size_t tt = static_cast<size_t>(tile) * tile;
  const size_t a0 = static_cast<size_t>(b) * s_span * tt;
  auto la = [&](int m, int k) {
    const int s = k / tile, j = k - s * tile;
    return bf16_round(load_a(a, a0 + s * tt + static_cast<size_t>(m) * tile + j, a_f32));
  };
  auto lb = [&](int k, int n) {
    const int s = k / tile, j = k - s * tile;
    const size_t row = static_cast<size_t>(cmap != nullptr ? stile[s] : base + s) * tile + j;
    float v = load_f(x, row * D + n, x_bf16);
    if (cs != nullptr) v *= cs[row];
    return bf16_round(v);
  };
  float acc[8][8];
  zero_acc(acc);
  block_gemm<false>(acc, tile, D, s_span * tile, la, lb, st);

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

// a [nb, s_span, tile, tile] int8 (or f32 with a_f32), bo [nb] int32;
// cmap [nb * s_span] and woff [nb / k] int32, or NULL (contiguous slots);
// x and out [nb * tile, D] bf16 (x_bf16) or f32, cs/rs [nb * tile] f32 or
// NULL.
extern "C" int spmm_banded_launch(const void* a, int a_f32, const void* bo, const void* cmap,
                                  const void* woff, int k, int nb, int s_span, int tile,
                                  const void* x, int x_bf16, int D, const void* cs,
                                  const void* rs, void* out, void* stream) {
  if (!banded_shape_ok(nb, s_span, tile, D) || !cmap_ok(cmap, woff, s_span, k, nb))
    return SLDM_ERR_SHAPE;
  spmm_banded_kernel<<<nb, kThreads, sizeof(Stage), static_cast<cudaStream_t>(stream)>>>(
      a, a_f32, static_cast<const int*>(bo), static_cast<const int*>(cmap),
      static_cast<const int*>(woff), k, s_span, tile, x, x_bf16, D,
      static_cast<const float*>(cs), static_cast<const float*>(rs), out);
  return cudaGetLastError();
}
