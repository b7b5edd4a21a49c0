// GRU backward (v2): reverse BPTT that recomputes the gates from hs.
//
// Replaces the TPU kernel `_bwd2_kernel` (sldm_gnn_tpu/ops/gru_pallas.py:277,
// launched by `_run_bwd2` :425 from the custom VJPs of `gru_last_pallas`
// :477 and `gru_seq_pallas` :544). Its only residual is the forward's bf16
// hs; the gates of every step are recomputed from hs[t-1] with the forward's
// own arithmetic (gru_fwd.cu). Design, numerics and bound: gru_bwd.cuh.
// Bound at the flagship shape: operations (340 GFLOP, 0.34 ms at the tensor
// cores' 989 TFLOP/s); this kernel runs them on the f32 FMA units.
#include "gru_bwd.cuh"

extern "C" int gru_bwd_grid(int N, int D, int H, int* dw_smem, int* blocks) {
  return bwd_grid<false>(N, D, H, dw_smem, blocks);
}

extern "C" int gru_bwd_launch(const void* x, int64_t xsn, int64_t xst, const void* hs,
                              const void* g, int64_t gsn, int64_t gst, int seq_cot, int N, int T,
                              int D, int H, const void* w_ih, const void* b_ih, const void* w_hh,
                              const void* b_hh, void* dx, void* partial, int dw_smem, int blocks,
                              void* out, void* stream) {
  return bwd_launch<false>(x, xsn, xst, hs, nullptr, g, gsn, gst, seq_cot, N, T, D, H, w_ih, b_ih,
                           w_hh, b_hh, dx, partial, dw_smem, blocks, out, stream);
}
