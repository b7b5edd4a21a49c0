// One-hot blocked SpMM over int8 features: out[i] = sum over the slots e
// with destination row i of w'_e * xq[src_e], summed in f32, where
//   per row:    w'_e = bf16(w_e * xs[src_e])   (xs [n_rows] f32 row scales)
//   per tensor: w'_e = bf16(w_e), and out = scale * sum at the write.
//
// Replaces the TPU kernels `_spmm_int8_kernel` (sldm_gnn_tpu/ops/spmm.py:220,
// launched by `spmm_pallas_int8` :272, pallas_call :329) and
// `_spmm_int8_pt_kernel` (:344, `spmm_pallas_int8_pt` :387, pallas_call
// :443). The TPU kernels gather the int8 rows with a one-hot product at the
// MXU's int8 rate, fold the per-row scale into the scatter weights and
// scatter with a bf16 one-hot product; the int8 values are exact in bf16,
// so each term is the exact product of the rounded weight and the int8
// value. That rounding is kept; the one-hot products are not. As in
// spmm_onehot.cu, the wrapper's per-layout plan (`row_ptr`, `perm`: the
// live slots of every destination row in slot order) lets one warp a
// destination row walk its slots with no atomics, so every launch repeats
// its bits: each lane loads one slot's source row and weight of a batch of
// 32 (the per-row variant also that row's scale), the warp shares them by
// shuffles, and lane l adds columns l, l + 32, l + 64, l + 96. __fmul_rn /
// __fadd_rn keep the compiler from contracting into FMAs. The two variants
// are two instances of one template.
//
// Bound at bench.py's one-hot shape (200 192 rows, tile 512, 7030 chunks
// of 512 slots, D = 128): bytes, the layout's 12 bytes a slot (43 MB), the
// int8 x (26 MB), the row scales (0.8 MB) and the f32 out (103 MB) once:
// about 172 MB, 0.051 ms at 3.35 TB/s. The x rows (128 bytes each) are
// gathered mostly from the 50 MB L2.
#include "banded_gemm.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowsPerBlock = 8;  // one warp a destination row

template <bool kPerRow>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
    spmm_onehot_int8_kernel(const int* __restrict__ row_ptr, const int* __restrict__ perm,
                            const int* __restrict__ block_meta,
                            const int* __restrict__ src_local, const float* __restrict__ weight,
                            int ec, int tile, int n_rows, const int8_t* __restrict__ xq, int D,
                            const float* __restrict__ scales, int out_bf16,
                            void* __restrict__ out) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const int e0 = row_ptr[row], e1 = row_ptr[row + 1];
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int base = e0; base < e1; base += 32) {
    int src = 0;
    float w = 0.0f;
    if (base + lane < e1) {
      const int s = perm[base + lane];
      src = block_meta[2 * (s / ec) + 1] * tile + src_local[s];
      w = kPerRow ? bf16_round(__fmul_rn(weight[s], scales[src])) : bf16_round(weight[s]);
    }
    const int n = min(32, e1 - base);
    for (int j = 0; j < n; ++j) {
      const size_t off = static_cast<size_t>(__shfl_sync(kFull, src, j)) * D;
      const float wj = __shfl_sync(kFull, w, j);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = lane + 32 * q;
        if (c < D) acc[q] = __fadd_rn(acc[q], __fmul_rn(wj, static_cast<float>(xq[off + c])));
      }
    }
  }
  const float s = kPerRow ? 1.0f : scales[0];
  const size_t o = static_cast<size_t>(row) * D;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = lane + 32 * q;
    if (c < D) store_f(out, o + c, kPerRow ? acc[q] : __fmul_rn(acc[q], s), out_bf16);
  }
}

}  // namespace

// row_ptr [n_rows + 1] and perm [live slots] int32 (the wrapper's plan),
// block_meta [W, 2], src_local [W, ec] int32, weight [W, ec] f32, xq
// [n_rows, D] int8 with D <= 128, scales [n_rows] (per_row) or [1] f32,
// out [n_rows, D] bf16 (out_bf16) or f32.
extern "C" int spmm_onehot_int8_launch(const void* row_ptr, const void* perm,
                                       const void* block_meta, const void* src_local,
                                       const void* weight, int ec, int tile, int n_rows,
                                       const void* xq, int D, const void* scales, int per_row,
                                       int out_bf16, void* out, void* stream) {
  if (n_rows <= 0 || ec <= 0 || tile <= 0 || D <= 0 || D > 128) return SLDM_ERR_SHAPE;
  const int blocks = (n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  auto kernel = per_row ? spmm_onehot_int8_kernel<true> : spmm_onehot_int8_kernel<false>;
  kernel<<<blocks, 32 * kRowsPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(row_ptr), static_cast<const int*>(perm),
      static_cast<const int*>(block_meta), static_cast<const int*>(src_local),
      static_cast<const float*>(weight), ec, tile, n_rows, static_cast<const int8_t*>(xq), D,
      static_cast<const float*>(scales), out_bf16, out);
  return cudaGetLastError();
}
