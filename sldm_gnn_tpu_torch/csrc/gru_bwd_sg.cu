// GRU backward (v3, store-gates): reverse BPTT that reads the gates back.
//
// Replaces the TPU kernel `_bwd3_kernel` (sldm_gnn_tpu/ops/gru_pallas.py:674,
// launched by `_run_bwd3` :790 from the custom VJPs of `gru_last_sg_pallas`
// :840 and `gru_seq_sg_pallas` :888). It reads the packed bf16 r|z|n|hn
// [T, N, 4H] that the store-gates forward (gru_fwd.cu, kStoreGates) wrote, so
// it runs no hidden-projection product and no transcendental; the biases are
// not needed. Design and numerics: gru_bwd.cuh. Bound at the flagship shape:
// bytes (1.9 GB of gates, hs and x, 0.58 ms at 3.35 TB/s).
#include "gru_bwd.cuh"

extern "C" int gru_bwd_sg_grid(int N, int T, int D, int H, int64_t* ws_bytes) {
  BwdPlan pl;
  const int code = bwd_plan<true>(N, T, D, H, &pl);
  *ws_bytes = static_cast<int64_t>(pl.bytes);
  return code;
}

extern "C" int gru_bwd_sg_launch(const void* x, int64_t xsn, int64_t xst, const void* hs,
                                 const void* gates, const void* g, int64_t gsn, int64_t gst,
                                 int seq_cot, int N, int T, int D, int H, const void* w_ih,
                                 const void* w_hh, void* dx, void* ws, int64_t ws_bytes,
                                 void* out, void* stream) {
  if (gates == nullptr) return SLDM_ERR_SHAPE;
  return bwd_launch<true>(x, xsn, xst, hs, gates, g, gsn, gst, seq_cot, N, T, D, H, w_ih, nullptr,
                          w_hh, nullptr, dx, ws, ws_bytes, out, stream);
}

extern "C" int gru_bwd_sg_route(int D, int H, int* out) {
  return bwd_route_query<true>(D, H, out);
}
