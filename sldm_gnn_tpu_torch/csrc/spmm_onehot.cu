// One-hot blocked SpMM: out[i] = sum over the slots e with destination row i
// of w_e * x[src_e], in f32, over the blocked layout (graph/csr.py).
//
// Replaces the TPU kernel `_spmm_kernel` (sldm_gnn_tpu/ops/spmm.py:64,
// launched by `spmm_pallas` :118, pallas_call :202): the aggregation of the
// one-hot layout, forward and (on the reverse layout) backward, and the
// straggler half of the hybrid layout.
//
// The TPU kernel gathers and scatters with two one-hot products per chunk
// on the MXU and carries a destination tile's sum across grid steps. On
// this card that is a gather and a scatter, so the products are not
// carried over: the wrapper derives once per layout (on the device, with
// torch ops) the live slots (weight != 0) of every destination row in slot
// order (`row_ptr`, `perm`), and one warp per destination row walks them in
// that order. No atomics: every launch repeats its bits. Each lane loads
// one slot's source row and weight of a batch of 32 and the warp shares
// them by shuffles; lane l then adds columns l, l + 32, l + 64, l + 96.
// Numerics of the TPU kernel: at DEFAULT (round = 1) the weight and x are
// rounded to bf16 and their exact product summed in f32; at HIGHEST
// (round = 0) f32 products. __fmul_rn / __fadd_rn keep the compiler from
// contracting them into FMAs.
//
// Bound at bench.py's one-hot shape (200 000 nodes, 3.2M edges, tile 512,
// 512-slot chunks, D = 128, bf16 x): bytes, the layout's 12 bytes a slot
// (src_local, dst_local, weight) plus x and out once (about 145 MB, 0.044
// ms at 3.35 TB/s). The gathers of x rows (256 bytes each) are served
// mostly from the 50 MB L2.
#include "banded_gemm.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowsPerBlock = 8;  // one warp a destination row

__global__ void __launch_bounds__(32 * kRowsPerBlock)
    spmm_onehot_kernel(const int* __restrict__ row_ptr, const int* __restrict__ perm,
                       const int* __restrict__ block_meta, const int* __restrict__ src_local,
                       const float* __restrict__ weight, int ec, int tile, int n_rows,
                       const void* __restrict__ x, int x_bf16, int D, int round,
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
      w = round ? bf16_round(weight[s]) : weight[s];
    }
    const int n = min(32, e1 - base);
    for (int j = 0; j < n; ++j) {
      const size_t off = static_cast<size_t>(__shfl_sync(kFull, src, j)) * D;
      const float wj = __shfl_sync(kFull, w, j);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = lane + 32 * q;
        if (c < D) {
          float v = load_f(x, off + c, x_bf16);
          if (round) v = bf16_round(v);
          acc[q] = __fadd_rn(acc[q], __fmul_rn(wj, v));
        }
      }
    }
  }
  const size_t o = static_cast<size_t>(row) * D;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = lane + 32 * q;
    if (c < D) store_f(out, o + c, acc[q], x_bf16);
  }
}

}  // namespace

// row_ptr [n_rows + 1] and perm [live slots] int32 (the wrapper's plan),
// block_meta [W, 2], src_local [W, ec] int32, weight [W, ec] f32, x and
// out [n_rows, D] bf16 (x_bf16) or f32, D <= 128.
extern "C" int spmm_onehot_launch(const void* row_ptr, const void* perm, const void* block_meta,
                                  const void* src_local, const void* weight, int ec, int tile,
                                  int n_rows, const void* x, int x_bf16, int D, int round,
                                  void* out, void* stream) {
  if (n_rows <= 0 || ec <= 0 || tile <= 0 || D <= 0 || D > 128) return SLDM_ERR_SHAPE;
  const int blocks = (n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  spmm_onehot_kernel<<<blocks, 32 * kRowsPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(row_ptr), static_cast<const int*>(perm),
      static_cast<const int*>(block_meta), static_cast<const int*>(src_local),
      static_cast<const float*>(weight), ec, tile, n_rows, x, x_bf16, D, round, out);
  return cudaGetLastError();
}
