// GRU backward (v2): reverse BPTT that recomputes the gates from hs.
//
// Replaces the TPU kernel `_bwd2_kernel` (sldm_gnn_tpu/ops/gru_pallas.py:277,
// launched by `_run_bwd2` :425 from the custom VJPs of `gru_last_pallas`
// :477 and `gru_seq_pallas` :544). Its only residual is the forward's bf16
// hs; the gates of every step are recomputed from hs[t-1] with the
// forward's own products and gate functions (gru_tc.cuh), as `_bwd2_kernel`
// recomputes them with the forward's arithmetic. Design, numerics and
// bound: gru_bwd.cuh. Bound at the flagship shape: operations (340 GFLOP,
// 0.34 ms at the tensor cores' 989 TFLOP/s).
#include "gru_bwd.cuh"

// The workspace bytes a launch at this shape needs (0 or an error code).
extern "C" int gru_bwd_grid(int N, int T, int D, int H, int64_t* ws_bytes) {
  BwdPlan pl;
  const int code = bwd_plan<false>(N, T, D, H, &pl);
  *ws_bytes = static_cast<int64_t>(pl.bytes);
  return code;
}

extern "C" int gru_bwd_launch(const void* x, int64_t xsn, int64_t xst, const void* hs,
                              const void* g, int64_t gsn, int64_t gst, int seq_cot, int N, int T,
                              int D, int H, const void* w_ih, const void* b_ih, const void* w_hh,
                              const void* b_hh, void* dx, void* ws, int64_t ws_bytes, void* out,
                              void* stream) {
  return bwd_launch<false>(x, xsn, xst, hs, nullptr, g, gsn, gst, seq_cot, N, T, D, H, w_ih, b_ih,
                           w_hh, b_hh, dx, ws, ws_bytes, out, stream);
}

// The kernels gru_bwd_launch takes for (D, H) on the current device: 1 the
// tensor-core route, 0 the FMA kernel, -1 none (shared memory); *out is
// set, the return is 0 or a cudaError_t.
extern "C" int gru_bwd_route(int D, int H, int* out) { return bwd_route_query<false>(D, H, out); }
