// Banded row-gather SpMM: out[b*T + t] = rs * sum_{r < R} mult[b, r*T + t] *
// x[woff[b / k] * T + codes[b, r*T + t]], in f32, at x's dtype.
//
// Replaces the TPU kernel `_gather_kernel` (sldm_gnn_tpu/ops/spmm_gather.py:404,
// launched by `spmm_gather_pallas` :445, pallas_call :483), the low-degree
// tier's aggregation in both directions (the wrapper folds the reverse
// layout's column scale into x first). On the TPU that kernel never
// compiled (Mosaic gathers rows only within one vreg) and the JAX package
// runs its XLA form there; a row gather is native on this card.
//
// One warp per destination row: lanes r < R load slot r's code and
// multiplicity, the warp shares them by shuffles, and lane l adds columns
// l, l + 32, l + 64, l + 96 of each slot's source row, r = 0 .. R-1 in
// order, each step one f32 multiply and one f32 add (__fmul_rn /
// __fadd_rn: no FMA contraction), so the plain version that adds in the
// same order agrees bit for bit. Padding slots have multiplicity 0.
//
// Bound at bench.py's gather shape (200 000 nodes, tile 128, K = 12, R
// slots of int32 code and f32 multiplicity a row, D = 128, bf16 x): bytes,
// 8 R bytes a row of layout plus x and out once (about 0.04 ms at 3.35
// TB/s for R = 12). The row gathers (R rows of 256 bytes a destination
// row) are served mostly from the 50 MB L2, which holds x.
#include "banded_gemm.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowsPerBlock = 8;

__global__ void __launch_bounds__(32 * kRowsPerBlock)
    spmm_gather_kernel(const int* __restrict__ codes, int code_rows,
                       const float* __restrict__ mult, const int* __restrict__ woff, int n_rows,
                       int tile, int k, int R, const void* __restrict__ x, int x_bf16, int D,
                       const float* __restrict__ rs, void* __restrict__ out) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const int b = row / tile, t = row - b * tile;
  const size_t base = static_cast<size_t>(woff[b / k]) * tile;
  const int* cb = codes + static_cast<size_t>(b) * code_rows + t;
  const float* mb = mult + static_cast<size_t>(b) * R * tile + t;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int r0 = 0; r0 < R; r0 += 32) {
    int code = 0;
    float m = 0.0f;
    if (r0 + lane < R) {
      code = cb[static_cast<size_t>(r0 + lane) * tile];
      m = mb[static_cast<size_t>(r0 + lane) * tile];
    }
    const int n = min(32, R - r0);
    for (int j = 0; j < n; ++j) {
      const size_t off = (base + __shfl_sync(kFull, code, j)) * D;
      const float mj = __shfl_sync(kFull, m, j);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = lane + 32 * q;
        if (c < D) acc[q] = __fadd_rn(acc[q], __fmul_rn(mj, load_f(x, off + c, x_bf16)));
      }
    }
  }
  const float sc = rs != nullptr ? rs[row] : 1.0f;
  const size_t o = static_cast<size_t>(row) * D;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = lane + 32 * q;
    if (c < D) store_f(out, o + c, rs != nullptr ? __fmul_rn(acc[q], sc) : acc[q], x_bf16);
  }
}

}  // namespace

// codes [nb, code_rows] int32 (code_rows >= R * tile), mult [nb, R * tile]
// f32, woff [nb / k] int32, x and out [nb * tile, D] bf16 (x_bf16) or f32,
// rs [nb * tile] f32 or NULL; D <= 128.
extern "C" int spmm_gather_launch(const void* codes, int code_rows, const void* mult,
                                  const void* woff, int nb, int tile, int k, int R,
                                  const void* x, int x_bf16, int D, const void* rs, void* out,
                                  void* stream) {
  if (nb <= 0 || tile <= 0 || k <= 0 || nb % k || R <= 0 || code_rows < R * tile || D <= 0 ||
      D > 128)
    return SLDM_ERR_SHAPE;
  const int n_rows = nb * tile;
  const int blocks = (n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  spmm_gather_kernel<<<blocks, 32 * kRowsPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(codes), code_rows, static_cast<const float*>(mult),
      static_cast<const int*>(woff), n_rows, tile, k, R, x, x_bf16, D,
      static_cast<const float*>(rs), out);
  return cudaGetLastError();
}
