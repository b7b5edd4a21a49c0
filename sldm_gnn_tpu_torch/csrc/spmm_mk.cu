// Megakernel SpMM: for every destination block b, over its edge chunks c in
// order, acc += A_c @ X[sblk[c] * tile : + tile], where A_c[d, s] is the sum
// of the weights of chunk c's edges with local destination d and local
// source s. Blocks with no chunk write zeros; the output has x's dtype.
//
// Replaces the TPU kernel `_mk_kernel` (sldm_gnn_tpu/ops/spmm_mk.py:97,
// launched by `spmm_pallas_mk` :167, pallas_call :205) in both of its
// modes, two instances of one template:
//   * fast (kFast): every weight is rounded to bf16, A_c is summed in f32
//     and rounded to bf16 (the TPU's one-hot product of bf16 operands), x
//     is rounded to bf16, and the exact products are summed in f32;
//   * otherwise everything is f32 (the TPU's Precision.HIGHEST).
// Duplicate (d, s) pairs of one chunk are merged before A_c is rounded, as
// the TPU's one-hot product merges them.
//
// Design. The TPU kernel builds the dense 128 x 128 A_c of every chunk
// with two one-hot products and DMAs the whole 128-row source tile, double
// buffered. Here only the source rows that the edges name are read. The
// wrapper derives once per layout, on the device, a plan (ops/spmm_mk.py
// `mk_plan`): the live slots (weight != 0) sorted by (destination row,
// chunk, local source), grouped by equal key. One warp per destination row
// walks its groups in that order, 32 at a time: lane l sums its group's
// weights in slot order into A (the merge), then the warp shares each
// group's (source row, A) by shuffles and lane l adds columns l, l + 32, ...
// of A * x[source row]. __fmul_rn / __fadd_rn keep the compiler from
// contracting products and sums into FMAs, so the plain version repeats
// them. No atomics: every launch repeats its bits.
//
// Bound at bench.py's graph (200 064 rows, 3.2M edges, tile 128, chunks of
// 256: 16 380 chunks; D = 128, f32 x): bytes, x read once and out written
// once (205 MB) plus the layout's 12 bytes a slot (50 MB), 0.076 ms at
// 3.35 TB/s. The gathered x rows (512 bytes each) come mostly from L2.
#include "banded_gemm.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowsPerBlock = 8;  // one warp a destination row

template <bool kFast>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
    spmm_mk_kernel(const int* __restrict__ row_ptr, const int* __restrict__ grp_src,
                   const int* __restrict__ grp_ptr, const int* __restrict__ perm,
                   const float* __restrict__ weight, int n_rows, const void* __restrict__ x,
                   int x_bf16, int D, void* __restrict__ out) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const int g0 = row_ptr[row], g1 = row_ptr[row + 1];
  const size_t o = static_cast<size_t>(row) * D;
  for (int c0 = 0; c0 < D; c0 += 128) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int base = g0; base < g1; base += 32) {
      int src = 0;
      float a = 0.0f;
      if (base + lane < g1) {
        const int g = base + lane;
        src = grp_src[g];
        for (int s = grp_ptr[g]; s < grp_ptr[g + 1]; ++s) {
          const float w = weight[perm[s]];
          a = __fadd_rn(a, kFast ? bf16_round(w) : w);
        }
        if (kFast) a = bf16_round(a);
      }
      const int n = min(32, g1 - base);
      for (int j = 0; j < n; ++j) {
        const size_t off = static_cast<size_t>(__shfl_sync(kFull, src, j)) * D;
        const float aj = __shfl_sync(kFull, a, j);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = c0 + lane + 32 * q;
          if (c < D) {
            float v = load_f(x, off + c, x_bf16);
            if (kFast) v = bf16_round(v);
            acc[q] = __fadd_rn(acc[q], __fmul_rn(aj, v));
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c0 + lane + 32 * q;
      if (c < D) store_f(out, o + c, acc[q], x_bf16);
    }
  }
}

}  // namespace

// row_ptr [rows + 1], grp_src [G], grp_ptr [G + 1] and perm [live slots]
// int32 (the plan), weight [chunks * edge_chunk] f32 (the layout's), x and
// out [rows, D] bf16 (x_bf16) or f32.
extern "C" int spmm_mk_launch(const void* row_ptr, const void* grp_src, const void* grp_ptr,
                              const void* perm, const void* weight, int rows, const void* x,
                              int x_bf16, int D, int fast, void* out, void* stream) {
  if (rows <= 0 || D <= 0) return SLDM_ERR_SHAPE;
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  auto kernel = fast ? spmm_mk_kernel<true> : spmm_mk_kernel<false>;
  kernel<<<blocks, 32 * kRowsPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(row_ptr), static_cast<const int*>(grp_src),
      static_cast<const int*>(grp_ptr), static_cast<const int*>(perm),
      static_cast<const float*>(weight), rows, x, x_bf16, D, out);
  return cudaGetLastError();
}
