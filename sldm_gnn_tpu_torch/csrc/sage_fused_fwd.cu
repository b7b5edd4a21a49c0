// One fused SAGE layer over the banded layout:
//   out[b] = act(LN?(agg[b] @ Wl + x[b] @ Wr + bias)),
//   agg[b] = rs[b] * sum_s A[b, s] @ x[bo[b] + s]  (+ the compact residual)
//
// Replaces the TPU kernel `_fused_kernel` (sldm_gnn_tpu/ops/sage_fused.py:49,
// launched by `banded_sage_fwd_pallas` :147, pallas_call :283), with its
// `resid`, `ln` and `cmap` options; `ypre` (the halo overlap's
// pre-activation output) is not ported. With `cmap`, slot s of block b
// reads the window tile woff[b / k] + cmap[b * s_span + s] instead of
// bo[b] + s (sage_fused.py:95-101), staged in shared memory first.
//
// Design. One block of 256 threads per destination block of `tile` rows:
// the aggregation runs as one block product over the s_span source tiles
// (bo[b] + s, read from device memory; the TPU kernel's double-buffered x
// window is its way to stream them), then scales by rs, adds the group's
// compact residual slot where rg[group] > 0 (the slot is not read at all
// otherwise, which is NaN-safe), rounds to bf16 and stays in shared memory;
// a second block product [agg | x_own] @ [Wl; Wr] (depth 2D) forms the
// pre-activation, whose epilogue adds the bias, takes the LayerNorm over
// the feature axis (f32 mean and variance across the 16 threads of a row by
// warp shuffles; xhat and rstd stored for the backward) and the activation.
// The aggregate never leaves the SM. Roundings are the TPU kernel's: tiles,
// x, agg and the weights in bf16, f32 sums, f32 statistics.
//
// Bound at bench.py's shape (nb = 1572, tile 128, s_span 5, D = H = 128,
// bf16): bytes, 128.8 MB of A + 51.5 MB of x + 51.5 MB of out (0.069 ms at
// 3.35 TB/s), over 46 GFLOP (0.047 ms at the bf16 tensor-core rate). The
// products run on f32 FMAs (banded_gemm.cuh): >= 0.7 ms at 67 TFLOP/s.
#include "banded_gemm.cuh"

namespace {

struct FwdSmem {
  Stage st;
  __nv_bfloat16 agg[kTileMax * kTileMax];
};

__global__ void __launch_bounds__(kThreads, 2)
    sage_fwd_kernel(const void* __restrict__ a, int a_f32, const int* __restrict__ bo,
                    const int* __restrict__ cmap, const int* __restrict__ woff, int nb,
                    const float* __restrict__ rs, int s_span, int tile, int k_grp,
                    const void* __restrict__ x, int x_bf16, int D, int H,
                    const __nv_bfloat16* __restrict__ wl, const __nv_bfloat16* __restrict__ wr,
                    const float* __restrict__ bias, const float* __restrict__ gamma,
                    const float* __restrict__ beta, float eps, int has_act, float slope,
                    const void* __restrict__ r_c, int r_bf16, const int* __restrict__ rg,
                    void* __restrict__ out, void* __restrict__ xhat, float* __restrict__ rstd) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int stile[kMaxCmapSlots];
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(smem);
  const int b = blockIdx.x;
  const int base = bo[b];
  if (cmap != nullptr) {
    load_cmap_tiles(stile, cmap, woff, b, k_grp, s_span, nb);
    __syncthreads();
  }
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t tt = static_cast<size_t>(tile) * tile;
  const size_t a0 = static_cast<size_t>(b) * s_span * tt;
  const size_t row0 = static_cast<size_t>(b) * tile;

  // 1. agg = A-slots @ x-slots
  auto la = [&](int m, int k) {
    const int s = k / tile, j = k - s * tile;
    return bf16_round(load_a(a, a0 + s * tt + static_cast<size_t>(m) * tile + j, a_f32));
  };
  auto lb = [&](int k, int n) {
    const int s = k / tile, j = k - s * tile;
    const int src_tile = cmap != nullptr ? stile[s] : base + s;
    return bf16_round(load_f(x, (static_cast<size_t>(src_tile) * tile + j) * D + n, x_bf16));
  };
  float acc[8][8];
  zero_acc(acc);
  block_gemm<false>(acc, tile, D, s_span * tile, la, lb, sm.st);

  const int slot = rg != nullptr ? rg[b / k_grp] : 0;
  const size_t r0 =
      (static_cast<size_t>(slot) * k_grp + (b % k_grp)) * tile;  // first row of b in the slot
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 16 * i;
    if (r >= tile) continue;
    const float sc = rs != nullptr ? rs[row0 + r] : 1.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = acc_col(tx, j);
      if (c >= D) continue;
      float v = acc[i][j] * sc;
      if (slot > 0) v += load_f(r_c, (r0 + r) * D + c, r_bf16);
      sm.agg[r * kTileMax + c] = __float2bfloat16_rn(v);
    }
  }
  __syncthreads();

  // 2. y = [agg | x_own] @ [Wl; Wr]
  auto la2 = [&](int m, int k) {
    return k < D ? __bfloat162float(sm.agg[m * kTileMax + k])
                 : bf16_round(load_f(x, (row0 + m) * D + (k - D), x_bf16));
  };
  auto lb2 = [&](int k, int n) {
    return __bfloat162float(k < D ? wl[static_cast<size_t>(k) * H + n]
                                  : wr[static_cast<size_t>(k - D) * H + n]);
  };
  zero_acc(acc);
  block_gemm<false>(acc, tile, H, 2 * D, la2, lb2, sm.st);

  // 3. bias, LayerNorm, activation; row r's H values sit on the 16 lanes
  // of one half-warp
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 16 * i;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = acc_col(tx, j);
      v[j] = (c < H && bias != nullptr) ? acc[i][j] + bias[c] : acc[i][j];
    }
    if (gamma != nullptr) {
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) s += acc_col(tx, j) < H ? v[j] : 0.0f;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      const float mu = s / H;
      float q = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[j] -= mu;
        q += acc_col(tx, j) < H ? v[j] * v[j] : 0.0f;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
      const float rsd = 1.0f / sqrtf(q / H + eps);
      if (r < tile && tx == 0) rstd[row0 + r] = rsd;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = acc_col(tx, j);
        if (c >= H) continue;
        const float xh = v[j] * rsd;
        if (r < tile) store_f(xhat, (row0 + r) * H + c, xh, x_bf16);
        v[j] = xh * gamma[c] + beta[c];
      }
    }
    if (r >= tile) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = acc_col(tx, j);
      if (c >= H) continue;
      float o = v[j];
      if (has_act && !(o > 0.0f)) o *= slope;
      store_f(out, (row0 + r) * H + c, o, x_bf16);
    }
  }
}

}  // namespace

// a [nb, s_span, tile, tile] int8 (or f32), bo [nb] int32, cmap [nb *
// s_span] and woff [nb/k_grp] int32 or NULL, rs [nb*tile] f32 or NULL; x [nb*tile, D] bf16 or f32; wl, wr [D, H] bf16; bias, gamma, beta
// [H] f32 or NULL (gamma: LayerNorm on, and xhat [nb*tile, H] at x's dtype
// and rstd [nb*tile] f32 are written); r_c [m, k_grp*tile, D] and rg
// [nb/k_grp] int32 or NULL; out [nb*tile, H] at x's dtype.
extern "C" int sage_fwd_launch(const void* a, int a_f32, const void* bo, const void* cmap,
                               const void* woff, const void* rs, int nb,
                               int s_span, int tile, int k_grp, const void* x, int x_bf16, int D,
                               int H, const void* wl, const void* wr, const void* bias,
                               const void* gamma, const void* beta, float eps, int has_act,
                               float slope, const void* r_c, int r_bf16, const void* rg,
                               void* out, void* xhat, void* rstd, void* stream) {
  if (!banded_shape_ok(nb, s_span, tile, D) || H <= 0 || H > kTileMax || k_grp <= 0 ||
      nb % k_grp != 0 || (gamma != nullptr && (beta == nullptr || xhat == nullptr ||
                                               rstd == nullptr)) ||
      (rg != nullptr && r_c == nullptr) || !cmap_ok(cmap, woff, s_span, k_grp, nb))
    return SLDM_ERR_SHAPE;
  const int code = smem_opt_in(sage_fwd_kernel, sizeof(FwdSmem));
  if (code != 0) return code;
  sage_fwd_kernel<<<nb, kThreads, sizeof(FwdSmem), static_cast<cudaStream_t>(stream)>>>(
      a, a_f32, static_cast<const int*>(bo), static_cast<const int*>(cmap),
      static_cast<const int*>(woff), nb, static_cast<const float*>(rs), s_span, tile, k_grp,
      x, x_bf16, D, H, static_cast<const __nv_bfloat16*>(wl),
      static_cast<const __nv_bfloat16*>(wr), static_cast<const float*>(bias),
      static_cast<const float*>(gamma), static_cast<const float*>(beta), eps, has_act, slope,
      r_c, r_bf16, static_cast<const int*>(rg), out, xhat, static_cast<float*>(rstd));
  return cudaGetLastError();
}
