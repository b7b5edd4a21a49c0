// Backward of the fused banded SAGE layer, without and with LayerNorm.
//
// Replaces the TPU kernels `_bwd_kernel` (sldm_gnn_tpu/ops/sage_fused.py:302,
// launched by `banded_sage_bwd_pallas` :439, pallas_call :554) and
// `_bwd_ln_kernel` (:652, `banded_sage_ln_bwd_pallas` :800, pallas_call
// :905), with their `resid` and `cmap` options (with `cmap`, slot s of
// block b reads the window tile woff[b / k] + cmap[b * s_span + s] instead
// of bo[b] + s, as sage_fused.py:403 and :759 do; the block stages its
// slots' tiles in shared memory). Both share one reverse kernel, per
// destination block b of the reverse layout:
//   t[b]  = sum_s (A_rev[b, s] scaled by column) @ R[bo[b] + s]  (+ residual)
//   dx[b] = t[b] @ Wl^T + O[b] @ Wr^T
//   dWl  += x[b]^T t[b],   dWr += x[b]^T O[b]      (when x is given)
// Without LN, R = O = g~ (the activation-masked gradient) and the column
// scale is the forward's 1/deg, folded into the tile's columns as the TPU
// kernel folds it: bf16(bf16(A) * bf16(1/deg)). With LN, a row-wise
// prologue kernel first derives, from the raw gradient g and the forward's
// xhat and rstd, dy/rstd = g~ gamma - mean(g~ gamma) - xhat mean(g~ gamma
// xhat) (g~ = g act'(gamma xhat + beta)) and dy itself, both rounded to
// bf16 and written to device memory, with each tile's column sums of
// g~ xhat, g~ and dy (dgamma, dbeta, db); then R = dy/rstd, O = dy and the
// column scale rstd * 1/deg: bf16(A * rstd * 1/deg), as the TPU kernel.
// The TPU kernel recomputes dy for every window row in-kernel to keep it
// out of HBM; writing it once (2 x 51.5 MB at bench.py's shape) is this
// first version's cost, the in-kernel recompute later work.
//
// Reductions across blocks. The TPU grid runs in order and sums dWl, dWr and
// the LN statistics into one VMEM accumulator. Here the reverse kernel is a
// persistent grid: block p owns the destination blocks p, p + P, ... and
// keeps its own partial dWl, dWr [D, H] in shared memory; a second kernel
// adds the P partials in block order (and the prologue's per-tile
// statistics in tile order). No atomics: two launches give the same bits.
// t is rounded to bf16 into shared memory and never leaves the SM.
//
// Bound at bench.py's shape (nb = 1572, tile 128, s_span 5, D = H = 128,
// bf16, no LN): bytes, 128.8 MB of A + 51.5 MB of g~ + 51.5 MB of x + 51.5
// MB of dx (0.085 ms at 3.35 TB/s), over 59 GFLOP (0.060 ms at the bf16
// tensor-core rate). The products run on f32 FMAs (banded_gemm.cuh), one
// block of 256 threads per SM (193 KB of shared memory at D = H = 128).
#include <stddef.h>

#include "banded_gemm.cuh"

namespace {

struct BwdSmem {
  Stage st;
  __nv_bfloat16 t[kTileMax * kTileMax];
  float dw[1];  // [2, D, H] when x is given
};

size_t bwd_smem_bytes(int D, int H, bool with_dw) {
  return offsetof(BwdSmem, dw) + (with_dw ? sizeof(float) * 2 * D * H : 0);
}

__global__ void __launch_bounds__(kThreads, 1)
    sage_bwd_kernel(const void* __restrict__ a, int a_f32, const int* __restrict__ bo,
                    const int* __restrict__ cmap, const int* __restrict__ woff,
                    const float* __restrict__ cs, const float* __restrict__ rstd, int nb,
                    int s_span, int tile, int k_grp, const void* __restrict__ R, int r_bf16,
                    const void* __restrict__ O, int o_bf16, int H,
                    const __nv_bfloat16* __restrict__ wlt, const __nv_bfloat16* __restrict__ wrt,
                    int D, const void* __restrict__ t_c, int tc_bf16, const int* __restrict__ rg,
                    const void* __restrict__ x, int x_bf16, void* __restrict__ dx, int dx_bf16,
                    void* __restrict__ t_out, int t_bf16, float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int stile[kMaxCmapSlots];
  BwdSmem& sm = *reinterpret_cast<BwdSmem*>(smem);
  float* dwl = sm.dw;
  float* dwr = sm.dw + D * H;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t tt = static_cast<size_t>(tile) * tile;
  if (x != nullptr)
    for (int e = tid; e < 2 * D * H; e += kThreads) sm.dw[e] = 0.0f;
  float acc[8][8];

  for (int b = blockIdx.x; b < nb; b += gridDim.x) {
    const int base = bo[b];
    const size_t a0 = static_cast<size_t>(b) * s_span * tt;
    const size_t row0 = static_cast<size_t>(b) * tile;
    if (cmap != nullptr) {  // the previous block's reads of stile are behind a barrier
      load_cmap_tiles(stile, cmap, woff, b, k_grp, s_span, nb);
      __syncthreads();
    }
    auto src_tile = [&](int s) { return cmap != nullptr ? stile[s] : base + s; };

    // 1. t = (A with scaled columns) @ R-slots
    auto la = [&](int m, int k) {
      const int s = k / tile, j = k - s * tile;
      const size_t src = static_cast<size_t>(src_tile(s)) * tile + j;
      const float av = load_a(a, a0 + s * tt + static_cast<size_t>(m) * tile + j, a_f32);
      if (rstd != nullptr)
        return bf16_round(av * (cs != nullptr ? rstd[src] * cs[src] : rstd[src]));
      const float ab = bf16_round(av);
      return cs != nullptr ? bf16_round(ab * bf16_round(cs[src])) : ab;
    };
    auto lb = [&](int k, int n) {
      const int s = k / tile, j = k - s * tile;
      return bf16_round(load_f(R, (static_cast<size_t>(src_tile(s)) * tile + j) * H + n, r_bf16));
    };
    zero_acc(acc);
    block_gemm<false>(acc, tile, H, s_span * tile, la, lb, sm.st);

    const int slot = rg != nullptr ? rg[b / k_grp] : 0;
    const size_t r0 = (static_cast<size_t>(slot) * k_grp + (b % k_grp)) * tile;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty + 16 * i;
      if (r >= tile) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = acc_col(tx, j);
        if (c >= H) continue;
        float v = acc[i][j];
        if (slot > 0) v += load_f(t_c, (r0 + r) * H + c, tc_bf16);
        if (t_out != nullptr) store_f(t_out, (row0 + r) * H + c, v, t_bf16);
        sm.t[r * kTileMax + c] = __float2bfloat16_rn(v);
      }
    }
    __syncthreads();

    // 2. dx = [t | O_own] @ [Wl^T; Wr^T]
    auto la2 = [&](int m, int k) {
      return k < H ? __bfloat162float(sm.t[m * kTileMax + k])
                   : bf16_round(load_f(O, (row0 + m) * H + (k - H), o_bf16));
    };
    auto lb2 = [&](int k, int n) {
      return __bfloat162float(k < H ? wlt[static_cast<size_t>(k) * D + n]
                                    : wrt[static_cast<size_t>(k - H) * D + n]);
    };
    zero_acc(acc);
    block_gemm<false>(acc, tile, D, 2 * H, la2, lb2, sm.st);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty + 16 * i;
      if (r >= tile) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = acc_col(tx, j);
        if (c < D) store_f(dx, (row0 + r) * D + c, acc[i][j], dx_bf16);
      }
    }
    if (x == nullptr) continue;

    // 3. this block's partials: dWl += x_own^T t, dWr += x_own^T O_own
    auto lx = [&](int m, int k) {
      return bf16_round(load_f(x, (row0 + k) * D + m, x_bf16));
    };
    auto lt = [&](int k, int n) { return __bfloat162float(sm.t[k * kTileMax + n]); };
    auto lo = [&](int k, int n) { return bf16_round(load_f(O, (row0 + k) * H + n, o_bf16)); };
    for (int w = 0; w < 2; ++w) {
      float* dw = w == 0 ? dwl : dwr;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int d = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = acc_col(tx, j);
          acc[i][j] = (d < D && c < H) ? dw[d * H + c] : 0.0f;
        }
      }
      if (w == 0)
        block_gemm<true>(acc, D, H, tile, lx, lt, sm.st);
      else
        block_gemm<true>(acc, D, H, tile, lx, lo, sm.st);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int d = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = acc_col(tx, j);
          if (d < D && c < H) dw[d * H + c] = acc[i][j];
        }
      }
    }
  }
  if (x != nullptr) {
    __syncthreads();
    float* out = partial + static_cast<size_t>(blockIdx.x) * 2 * D * H;
    for (int e = tid; e < 2 * D * H; e += kThreads) out[e] = sm.dw[e];
  }
}

// One block per tile of rows; warp w takes rows w, w + 8, ...; lane l the
// columns l + 32 q. Writes dy/rstd and dy in bf16 and the tile's column sums
// stats[tile] = [sum g~ xhat; sum g~; sum dy] (f32, warps added in order).
__global__ void __launch_bounds__(kThreads)
    ln_bwd_prologue_kernel(int tile, const void* __restrict__ g, int g_bf16,
                           const void* __restrict__ xhat, int xh_bf16,
                           const float* __restrict__ rstd, const float* __restrict__ gamma,
                           const float* __restrict__ beta, int H, int has_act, float slope,
                           __nv_bfloat16* __restrict__ dyu, __nv_bfloat16* __restrict__ dyo,
                           float* __restrict__ stats) {
  __shared__ float red[kThreads / 32][3][kTileMax];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float sg[4] = {0, 0, 0, 0}, sb[4] = {0, 0, 0, 0}, sd[4] = {0, 0, 0, 0};
  for (int r = warp; r < tile; r += kThreads / 32) {
    const size_t row = static_cast<size_t>(blockIdx.x) * tile + r;
    float gt[4], xh[4], gz[4], s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = lane + 32 * q;
      gt[q] = xh[q] = gz[q] = 0.0f;
      if (c >= H) continue;
      xh[q] = load_f(xhat, row * H + c, xh_bf16);
      float gv = load_f(g, row * H + c, g_bf16);
      if (has_act && !(xh[q] * gamma[c] + beta[c] > 0.0f)) gv *= slope;
      gt[q] = gv;
      gz[q] = gv * gamma[c];
      s1 += gz[q];
      s2 += gz[q] * xh[q];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    const float m1 = s1 / H, m2 = s2 / H, rs = rstd[row];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = lane + 32 * q;
      if (c >= H) continue;
      const float du = gz[q] - m1 - xh[q] * m2;
      const float dv = du * rs;
      dyu[row * H + c] = __float2bfloat16_rn(du);
      dyo[row * H + c] = __float2bfloat16_rn(dv);
      sg[q] += gt[q] * xh[q];
      sb[q] += gt[q];
      sd[q] += dv;
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = lane + 32 * q;
    if (c >= H) continue;
    red[warp][0][c] = sg[q];
    red[warp][1][c] = sb[q];
    red[warp][2][c] = sd[q];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 3 * H; e += kThreads) {
    const int k = e / H, c = e - k * H;
    float s = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w) s += red[w][k][c];
    stats[static_cast<size_t>(blockIdx.x) * 3 * H + e] = s;
  }
}

int bwd_smem_opt_in(int D, int H, bool with_dw, int* occ, int* sms) {
  const size_t bytes = bwd_smem_bytes(D, H, with_dw);
  int code = smem_opt_in(sage_bwd_kernel, bytes);
  if (code != 0) return code;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, sage_bwd_kernel, kThreads, bytes);
  if (err != cudaSuccess) return err;
  return *occ > 0 ? 0 : SLDM_ERR_SMEM;
}

}  // namespace

// Blocks of the reverse kernel's persistent grid: one per free SM slot, at
// most one per destination block.
extern "C" int sage_bwd_grid(int nb, int D, int H, int with_dw, int* blocks) {
  if (nb <= 0 || D <= 0 || D > kTileMax || H <= 0 || H > kTileMax) return SLDM_ERR_SHAPE;
  int occ = 0, sms = 0;
  const int code = bwd_smem_opt_in(D, H, with_dw != 0, &occ, &sms);
  if (code != 0) return code;
  *blocks = nb < occ * sms ? nb : occ * sms;
  return 0;
}

// The reverse kernel: a [nb, s_span, tile, tile] int8 (or f32), bo [nb]
// int32; cmap [nb * s_span] and woff [nb/k_grp] int32 or NULL; cs [nb*tile] f32 or NULL (1/deg); rstd [nb*tile] f32 or NULL (LN
// mode); R, O [nb*tile, H] bf16 or f32; wlt, wrt [H, D] bf16; t_c
// [m, k_grp*tile, H] and rg [nb/k_grp] or NULL; x [nb*tile, D] or NULL;
// dx [nb*tile, D]; t_out [nb*tile, H] or NULL; with x, partial [blocks, 2,
// D, H] f32 scratch and dw [2, D, H] f32 = dWl | dWr.
extern "C" int sage_bwd_launch(const void* a, int a_f32, const void* bo, const void* cmap,
                               const void* woff, const void* cs,
                               const void* rstd, int nb, int s_span, int tile, int k_grp,
                               const void* R, int r_bf16, const void* O, int o_bf16, int H,
                               const void* wlt, const void* wrt, int D, const void* t_c,
                               int tc_bf16, const void* rg, const void* x, int x_bf16, void* dx,
                               int dx_bf16, void* t_out, int t_bf16, void* partial, int blocks,
                               void* dw, void* stream) {
  if (!banded_shape_ok(nb, s_span, tile, H) || D <= 0 || D > kTileMax || k_grp <= 0 ||
      nb % k_grp != 0 || (rg != nullptr && t_c == nullptr) ||
      (x != nullptr && (partial == nullptr || dw == nullptr)) ||
      !cmap_ok(cmap, woff, s_span, k_grp, nb))
    return SLDM_ERR_SHAPE;
  int want = 0;
  int code = sage_bwd_grid(nb, D, H, x != nullptr, &want);
  if (code != 0) return code;
  if (blocks != want) return SLDM_ERR_SHAPE;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  sage_bwd_kernel<<<blocks, kThreads, bwd_smem_bytes(D, H, x != nullptr), s>>>(
      a, a_f32, static_cast<const int*>(bo), static_cast<const int*>(cmap),
      static_cast<const int*>(woff), static_cast<const float*>(cs),
      static_cast<const float*>(rstd), nb, s_span, tile, k_grp, R, r_bf16, O, o_bf16, H,
      static_cast<const __nv_bfloat16*>(wlt), static_cast<const __nv_bfloat16*>(wrt), D, t_c,
      tc_bf16, static_cast<const int*>(rg), x, x_bf16, dx, dx_bf16, t_out, t_bf16,
      static_cast<float*>(partial));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (x == nullptr) return 0;
  return launch_reduce(static_cast<const float*>(partial), blocks, 2 * D * H,
                       static_cast<float*>(dw), s);
}

// The LN prologue: g, xhat [nb*tile, H] bf16 or f32, rstd [nb*tile] f32,
// gamma, beta [H] f32 -> dyu = dy/rstd and dyo = dy [nb*tile, H] bf16;
// stats [nb, 3, H] f32 scratch; dstats [3, H] f32 = dgamma | dbeta | db.
extern "C" int ln_bwd_prologue_launch(int nb, int tile, const void* g, int g_bf16,
                                      const void* xhat, int xh_bf16, const void* rstd,
                                      const void* gamma, const void* beta, int H, int has_act,
                                      float slope, void* dyu, void* dyo, void* stats,
                                      void* dstats, void* stream) {
  if (nb <= 0 || tile <= 0 || H <= 0 || H > kTileMax) return SLDM_ERR_SHAPE;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  ln_bwd_prologue_kernel<<<nb, kThreads, 0, s>>>(
      tile, g, g_bf16, xhat, xh_bf16, static_cast<const float*>(rstd),
      static_cast<const float*>(gamma), static_cast<const float*>(beta), H, has_act, slope,
      static_cast<__nv_bfloat16*>(dyu), static_cast<__nv_bfloat16*>(dyo),
      static_cast<float*>(stats));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(static_cast<const float*>(stats), nb, 3 * H, static_cast<float*>(dstats),
                       s);
}
