// Backward of the fused banded SAGE layer, without and with LayerNorm.
//
// Replaces the TPU kernels `_bwd_kernel` (sldm_gnn_tpu/ops/sage_fused.py:302,
// launched by `banded_sage_bwd_pallas` :439, pallas_call :554) and
// `_bwd_ln_kernel` (:652, `banded_sage_ln_bwd_pallas` :800, pallas_call
// :905), with their `resid` and `cmap` options (with `cmap`, slot s of
// block b reads the clamped window tile woff[b / k] + cmap[b * s_span + s]
// instead of bo[b] + s, as sage_fused.py:403 and :759 do). Both share one
// reverse kernel, per destination block b of the reverse layout:
//   t[b]  = sum_s (A_rev[b, s] scaled by column) @ R[src(b, s)]  (+ residual)
//   dx[b] = t[b] @ Wl^T + O[b] @ Wr^T
// and, when x is given, a second kernel
//   dWl = x^T t,   dWr = x^T O
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
// port's cost, the in-kernel recompute later work.
//
// Bound at bench.py's shape (nb = 1572, tile 128, s_span 5, D = H = 128,
// bf16, no LN): bytes, 128.8 MB of A + 51.5 MB of g~ + 51.5 MB of x + 51.5
// MB of dx (0.085 ms at 3.35 TB/s), over 59 GFLOP (0.060 ms at the bf16
// tensor-core rate). The first version ran every product on the f32 FMA
// units (a block product since removed: >= 0.88 ms at 67 TFLOP/s), staged
// each element through the caller's loaders (an integer division and a
// rounding each, stored as f32), did not overlap loads with products,
// re-read Wl^T and Wr^T element by element for every block and kept an
// f32 dW partial of 128 KB in shared memory (one block of 256 threads an
// SM, 193 KB).
//
// This version. The reverse kernel is a persistent grid of two blocks of
// two warpgroups an SM over the destination blocks in ascending order, one
// stream of 32-row chunks through a ring of three TMA stages (banded_mma.cuh):
//   step 1, the slot chunks: t = A~ @ R by wgmma with A's fragments built in
//     registers, the column scale folded in per element from the chunk's
//     staged cs and rstd; t (+ residual) is written out where asked (always
//     when x is given) and, rounded to bf16, into shared memory;
//   step 2, the tail: [Wl^T; Wr^T] in 32-row chunks through the same ring
//     (in flight during step 1), dx = [t | O] @ [Wl^T; Wr^T] by wgmma from
//     shared memory, O's own rows copied in by TMA during step 1.
// Nothing stays resident, so two blocks fit an SM (104 KB each at
// D = H = 128); with both weights resident (178 KB) one block an SM left
// the loop's latency unhidden. The
// weight gradients are the second kernel's: a split-K wgmma product over
// 32-row chunks, one block for dWl and one for dWr per range of rows, x and
// t or O arriving by TMA through four stages, one f32 partial [D, H] per
// block, added in range order by reduce_partials_kernel (no atomics: two
// launches give the same bits). It costs t's round trip (2 x 51.5 MB) and
// re-reads x (from L2: the two blocks of a range run side by side) and O.
#include <stddef.h>

#include "banded_mma.cuh"

namespace {

struct RevArgs {
  CUtensorMap map_o;  // O as [nb * tile, H], boxes [tile, 64] (bf16 O)
  int tma_o;
  const void* O;  // [nb * tile, H]: the own rows multiplied by Wr^T
  int o_bf16, H;
  int D;
  const void* t_c;  // [m, k_grp * tile, H] or NULL
  int tc_bf16;
  const int* rg;  // [nb / k_grp] or NULL
  int k_grp;
  void* dx;  // [nb * tile, D]
  int dx_bf16;
  void* t_out;  // [nb * tile, H] or NULL
  int t_bf16;
};

constexpr int kRevStages = 3;

inline size_t rev_smem_bytes(const SlotArgs& p) {
  return 1024 + slot_ring_bytes(kRevStages, p) +
         static_cast<size_t>(2 * tile_rows64(p.tile)) * kRow * 2;
}

// v0 at element i and v1 at i + 1 of a bf16 or f32 array; `pair` when both
// are wanted and i is even in an array of even rows (aligned as a pair)
__device__ __forceinline__ void store2(void* p, size_t i, float v0, float v1, int is_bf16,
                                       bool pair, bool second) {
  if (pair) {
    if (is_bf16)
      *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(p) + i) = pack_bf16(v0, v1);
    else
      *reinterpret_cast<float2*>(static_cast<float*>(p) + i) = make_float2(v0, v1);
    return;
  }
  store_f(p, i, v0, is_bf16);
  if (second) store_f(p, i + 1, v1, is_bf16);
}

// The reverse kernel: two warpgroups, each with 64 rows of t (step 1, the
// slot chunks) and then of dx (step 2, the tail: [Wl^T; Wr^T] in 32-row
// chunks through the same ring), in the same 64 accumulators.
using RevLoop = SlotLoop<kRevStages, true>;
constexpr int kRevThreads = RevLoop::kThreads;

__global__ void __launch_bounds__(kRevThreads, 2)
    sage_bwd_kernel(const __grid_constant__ SlotArgs p, const __grid_constant__ TailArgs w,
                    const __grid_constant__ RevArgs r) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ int table[kTableInts];
  __shared__ uint64_t bars[kRevStages + 1];  // the ring's, then O's
  unsigned char* smem = align1024(smem_raw);
  RevLoop loop(p, smem, table, &w);
  const int tile = p.tile, H = r.H, D = r.D, kt = depth32(H), tr = tile_rows64(tile);
  __nv_bfloat16* t_s = reinterpret_cast<__nv_bfloat16*>(smem + slot_ring_bytes(kRevStages, p));
  __nv_bfloat16* o_s = t_s + tr * kRow;
  const int tid = threadIdx.x, t = tid & 3;
  const int rw = RevLoop::thread_row(), m0 = rw & ~63;  // this thread's rows rw, rw + 8
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);

  // t's and O's columns H .. kt stay zero: step 2's depth padding
  for (int idx = tid; idx < tile * (kt - H); idx += kRevThreads) {
    const int rr = idx / (kt - H), c = H + idx % (kt - H);
    t_s[swz_h(tr, rr, c)] = zero;
    o_s[swz_h(tr, rr, c)] = zero;
  }

  // O's own rows of block b, in flight during its step 1 (by TMA, or by the
  // element path with f32 O rounded to bf16)
  uint64_t* obar = &bars[kRevStages];
  if (tid == 0) mbar_init(obar, 1);  // loop.run's barrier publishes it
  auto first = [&](int, int b) {
    if (!r.tma_o) {
      load_rows(o_s, tr, r.O, r.o_bf16, static_cast<size_t>(b) * tile, tile, H, true);
    } else if (tid == 0) {
      const int halves = H > 64 ? 2 : 1;
      mbar_expect(obar, halves * tile * 128);
      for (int h = 0; h < halves; ++h)
        tma_load(o_s + h * tr * 64, &r.map_o, 64 * h, b * tile, obar);
    }
  };

  // after step 1: t (+ residual) to t_out and, rounded to bf16, to t_s
  auto mid = [&](int i, int b, float (&acc)[16][4]) {
    const int slot = r.rg != nullptr ? r.rg[b / r.k_grp] : 0;
    const size_t rr0 = (static_cast<size_t>(slot) * r.k_grp + (b % r.k_grp)) * tile;
    const size_t row0 = static_cast<size_t>(b) * tile;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int rr = rw + 8 * h2;
      if (rr >= tile) continue;
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        const int c = nt * 8 + 2 * t;
        if (c >= H) continue;
        float v[2] = {acc[nt][2 * h2], acc[nt][2 * h2 + 1]};
        const bool second = c + 1 < H;
        if (slot > 0) {
          v[0] += load_f(r.t_c, (rr0 + rr) * H + c, r.tc_bf16);
          if (second) v[1] += load_f(r.t_c, (rr0 + rr) * H + c + 1, r.tc_bf16);
        }
        if (r.t_out != nullptr)
          store2(r.t_out, (row0 + rr) * H + c, v[0], v[1], r.t_bf16, second && H % 2 == 0,
                 second);
        t_s[swz_h(tr, rr, c)] = __float2bfloat16_rn(v[0]);
        if (second) t_s[swz_h(tr, rr, c + 1)] = __float2bfloat16_rn(v[1]);
      }
    }
    if (r.tma_o) mbar_wait(obar, i & 1);
    fence_proxy_async();
    __syncthreads();
  };

  // step 2, chunk j: dx += [t | O][:, 32 j' ..] @ [Wl^T; Wr^T] rows (wgmma
  // from shared memory, t or O K-contiguous)
  auto tail = [&](int j, const __nv_bfloat16* bs, float (&acc)[16][4]) {
    if (m0 >= tile) return;
    const __nv_bfloat16* as = j < kt / kChunk ? t_s : o_s;
    const int k0 = (j % (kt / kChunk)) * kChunk;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      wgmma_ss_n128<0>(acc, desc_h(as + swz_h(tr, m0, k0 + 16 * kk), tr),
                       desc_h(bs + swz_h(kChunk, 16 * kk, 0), kChunk));
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc);
  };

  auto epi = [&](int, int b, float (&acc)[16][4]) {
    const size_t row0 = static_cast<size_t>(b) * tile;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int rr = rw + 8 * h2;
      if (rr >= tile) continue;
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        const int c = nt * 8 + 2 * t;
        if (c >= D) continue;
        const bool second = c + 1 < D;
        store2(r.dx, (row0 + rr) * D + c, acc[nt][2 * h2], acc[nt][2 * h2 + 1], r.dx_bf16,
               second && D % 2 == 0, second);
      }
    }
  };

  float acc[16][4] = {};
  loop.run(acc, bars, first, mid, tail, epi);
}

// dWl or dWr partials: block (w, p) sums x^T t (w = 0) or x^T O (w = 1)
// over range p of the 32-row chunks into partial[p][w] = [D, H] f32, with
// wgmma from shared memory (x^T as an M-contiguous A, t or O as B): two
// warpgroups, 64 rows of x^T (columns of x) each, all of H.
constexpr int kDwStages = 4;
constexpr int kDwThreads = 256;

__host__ __device__ inline int dw_stage_bytes(int x_bf16, int b_bf16) {
  return kChunk * kRow * ((x_bf16 ? 2 : 4) + (b_bf16 ? 2 : 4));
}

inline size_t dw_smem_bytes(int x_bf16, int b_bf16) {
  return 1024 + static_cast<size_t>(kDwStages) * dw_stage_bytes(x_bf16, b_bf16) +
         ((x_bf16 ? 0 : 1) + (b_bf16 ? 0 : 1)) * kChunk * kRow * 2;
}

struct DwArgs {
  CUtensorMap map_x, map_t, map_o;  // 32-row boxes: swizzled halves (bf16) or raw rows (f32)
  int tma_x, tma_t, tma_o;
  const void* x;
  int x_bf16, D;
  const __nv_bfloat16* t;
  const void* O;
  int o_bf16, H, chunks;
  float* partial;
};

// bytes a TMA chunk of 32 rows of width W brings: two (or one) swizzled
// 64-column halves, or raw rows of kRow elements
__device__ __forceinline__ uint32_t rows_tx(int bf16, int W) {
  return bf16 ? (W > 64 ? 2 : 1) * kChunk * 128 : kChunk * kRow * 4;
}

__global__ void __launch_bounds__(kDwThreads, 2)
    sage_dw_kernel(const __grid_constant__ DwArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ uint64_t full[kDwStages];
  unsigned char* smem = align1024(smem_raw);
  const int w = blockIdx.x, tid = threadIdx.x, D = a.D, H = a.H, x_bf16 = a.x_bf16;
  const void* bsrc = w == 0 ? static_cast<const void*>(a.t) : a.O;
  const CUtensorMap* bmap = w == 0 ? &a.map_t : &a.map_o;
  const int b_bf16 = w == 0 ? 1 : a.o_bf16, b_tma = w == 0 ? a.tma_t : a.tma_o;
  const int xbytes = kChunk * kRow * (x_bf16 ? 2 : 4);
  const int stage = dw_stage_bytes(x_bf16, b_bf16);
  __nv_bfloat16* xb = reinterpret_cast<__nv_bfloat16*>(smem + kDwStages * stage);
  __nv_bfloat16* bb = xb + (x_bf16 ? 0 : kChunk * kRow);
  const int c0 = static_cast<int>(static_cast<long>(blockIdx.y) * a.chunks / gridDim.y);
  const int n = static_cast<int>(static_cast<long>(blockIdx.y + 1) * a.chunks / gridDim.y) - c0;
  if (tid == 0) {
    for (int i = 0; i < kDwStages; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto copy_next = [&](int q) {
    if (q >= n) return;
    unsigned char* st = smem + (q % kDwStages) * stage;
    uint64_t* bar = &full[q % kDwStages];
    const int r0 = (c0 + q) * kChunk;
    if (tid == 0) {
      mbar_expect(bar, (a.tma_x ? rows_tx(x_bf16, D) : 0) + (b_tma ? rows_tx(b_bf16, H) : 0));
      if (a.tma_x)
        for (int h = 0; h < (x_bf16 && D > 64 ? 2 : 1); ++h)
          tma_load(st + h * kChunk * 128, &a.map_x, 64 * h, r0, bar);
      if (b_tma)
        for (int h = 0; h < (b_bf16 && H > 64 ? 2 : 1); ++h)
          tma_load(st + xbytes + h * kChunk * 128, bmap, 64 * h, r0, bar);
    }
    if (!a.tma_x) load_rows(st, x_bf16 ? kChunk : 0, a.x, x_bf16, r0, kChunk, D);
    if (!b_tma) load_rows(st + xbytes, b_bf16 ? kChunk : 0, bsrc, b_bf16, r0, kChunk, H);
  };
  for (int q = 0; q < kDwStages - 1; ++q) copy_next(q);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = (warp >> 2) * 64, g = lane >> 2, tq = lane & 3;
  float acc[16][4] = {};
  for (int q = 0; q < n; ++q) {
    mbar_wait(&full[q % kDwStages], (q / kDwStages) & 1);
    fence_proxy_async();  // element-path writes, for wgmma's reads
    __syncthreads();
    copy_next(q + kDwStages - 1);
    const unsigned char* st = smem + (q % kDwStages) * stage;
    const __nv_bfloat16* xs = x_bf16 ? reinterpret_cast<const __nv_bfloat16*>(st) : xb;
    const __nv_bfloat16* bs = b_bf16 ? reinterpret_cast<const __nv_bfloat16*>(st + xbytes) : bb;
    if (!x_bf16 || !b_bf16) {
      if (!x_bf16) transform_rows(xb, st, 0, nullptr, D);
      if (!b_bf16) transform_rows(bb, st + xbytes, 0, nullptr, H);
      fence_proxy_async();
      __syncthreads();
    }
    if (m0 >= D) continue;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      wgmma_ss_n128<1>(acc, desc_h(xs + swz_h(kChunk, 16 * kk, m0), kChunk),
                       desc_h(bs + swz_h(kChunk, 16 * kk, 0), kChunk));
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc);
  }
  if (m0 >= D) return;
  float* out = a.partial + (static_cast<size_t>(blockIdx.y) * 2 + w) * D * H;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int d = m0 + (warp & 3) * 16 + g + 8 * h2;
    if (d >= D) continue;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      const int c = nt * 8 + 2 * tq;
      if (c < H) out[d * H + c] = acc[nt][2 * h2];
      if (c + 1 < H) out[d * H + c + 1] = acc[nt][2 * h2 + 1];
    }
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

int rev_launch(const SlotArgs& p, const TailArgs& w, const RevArgs& r, cudaStream_t s) {
  const size_t smem = rev_smem_bytes(p);
  int code = smem_opt_in(sage_bwd_kernel, smem);
  if (code != 0) return code;
  int grid = 0;
  code = persistent_grid(sage_bwd_kernel, kRevThreads, smem, p.nb, &grid);
  if (code != 0) return code;
  sage_bwd_kernel<<<grid, kRevThreads, smem, s>>>(p, w, r);
  return cudaGetLastError();
}

}  // namespace

// Blocks (f32 partials [2, D, H]) of the weight-gradient kernel for `rows`
// rows: one per SM, at most one per 32-row chunk.
extern "C" int sage_dw_parts(int rows, int* parts) {
  if (rows <= 0 || rows % kChunk != 0) return SLDM_ERR_SHAPE;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *parts = rows / kChunk < sms ? rows / kChunk : sms;
  return 0;
}

// The reverse kernel: a [nb, s_span, tile, tile] int8 (or f32), bo [nb]
// int32; cmap [nb * s_span] and woff [nb/k_grp] int32 or NULL; cs [nb*tile]
// f32 or NULL (1/deg); rstd [nb*tile] f32 or NULL (LN mode); R, O
// [nb*tile, H] bf16 or f32; wlt, wrt [H, D] bf16; t_c [m, k_grp*tile, H]
// and rg [nb/k_grp] or NULL; x [nb*tile, D] or NULL; dx [nb*tile, D];
// t_out [nb*tile, H] or NULL (with x: bf16, the weight kernel's t); with
// x, partial [parts, 2, D, H] f32 scratch (parts from sage_dw_parts) and
// dw [2, D, H] f32 = dWl | dWr.
extern "C" int sage_bwd_launch(const void* a, int a_f32, const void* bo, const void* cmap,
                               const void* woff, const void* cs, const void* rstd, int nb,
                               int s_span, int tile, int k_grp, const void* R, int r_bf16,
                               const void* O, int o_bf16, int H, const void* wlt, const void* wrt,
                               int D, const void* t_c, int tc_bf16, const void* rg,
                               const void* x, int x_bf16, void* dx, int dx_bf16, void* t_out,
                               int t_bf16, void* partial, int parts, void* dw, void* stream) {
  if (!banded_shape_ok(nb, s_span, tile, H) || D <= 0 || D > kTileMax || k_grp <= 0 ||
      nb % k_grp != 0 || (rg != nullptr && t_c == nullptr) ||
      (x != nullptr && (partial == nullptr || dw == nullptr || t_out == nullptr || !t_bf16)) ||
      !cmap_ok(cmap, woff, s_span, k_grp, nb))
    return SLDM_ERR_SHAPE;
  SlotArgs p{};
  p.a = a;
  p.a_kind = a_f32 ? kAF32 : kAInt8;
  p.amode = rstd != nullptr ? (cs != nullptr ? kScaleRstdCs : kScaleRstd)
                            : (cs != nullptr ? kScaleCs : kScaleNone);
  p.bo = static_cast<const int*>(bo);
  p.cmap = static_cast<const int*>(cmap);
  p.woff = static_cast<const int*>(woff);
  p.k = k_grp;
  p.nb = nb;
  p.s_span = s_span;
  p.tile = tile;
  p.x = R;
  p.x_bf16 = r_bf16;
  p.width = H;
  p.cs = static_cast<const float*>(cs);
  p.rstd = static_cast<const float*>(rstd);
  p.transform = 0;  // f32 R rows are rounded by the element path
  p.bscale = 0;
  RevArgs r{};
  r.O = O;
  r.o_bf16 = o_bf16;
  r.H = H;
  r.D = D;
  r.t_c = t_c;
  r.tc_bf16 = tc_bf16;
  r.rg = static_cast<const int*>(rg);
  r.k_grp = k_grp;
  r.dx = dx;
  r.dx_bf16 = dx_bf16;
  r.t_out = t_out;
  r.t_bf16 = t_bf16;
  make_slot_maps(p);
  TailArgs w{};
  w.w[0] = static_cast<const __nv_bfloat16*>(wlt);
  w.w[1] = static_cast<const __nv_bfloat16*>(wrt);
  w.wrows = H;
  w.wcols = D;
  w.tail = 2 * depth32(H) / kChunk;
  w.tma_w = make_map(&w.map_w[0], wlt, 2, H, D, kChunk, 64, CU_TENSOR_MAP_SWIZZLE_128B) &&
            make_map(&w.map_w[1], wrt, 2, H, D, kChunk, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  r.tma_o = o_bf16 && make_map(&r.map_o, O, 2, static_cast<size_t>(nb) * tile, H, tile, 64,
                               CU_TENSOR_MAP_SWIZZLE_128B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int code = rev_launch(p, w, r, s);
  if (code != 0 || x == nullptr) return code;
  int want = 0;
  code = sage_dw_parts(nb * tile, &want);
  if (code != 0) return code;
  if (parts != want) return SLDM_ERR_SHAPE;
  // dWr's block needs the more shared memory where O is f32; dWl's t is bf16
  const size_t smem = dw_smem_bytes(x_bf16, o_bf16);
  code = smem_opt_in(sage_dw_kernel, smem);
  if (code != 0) return code;
  DwArgs d{};
  const size_t rows = static_cast<size_t>(nb) * tile;
  d.tma_x = make_rows_map(&d.map_x, x, x_bf16, rows, D, kChunk, !x_bf16);
  d.tma_t = make_rows_map(&d.map_t, t_out, 1, rows, H, kChunk, false);
  d.tma_o = make_rows_map(&d.map_o, O, o_bf16, rows, H, kChunk, !o_bf16);
  d.x = x;
  d.x_bf16 = x_bf16;
  d.D = D;
  d.t = static_cast<const __nv_bfloat16*>(t_out);
  d.O = O;
  d.o_bf16 = o_bf16;
  d.H = H;
  d.chunks = nb * tile / kChunk;
  d.partial = static_cast<float*>(partial);
  sage_dw_kernel<<<dim3(2, parts), kDwThreads, smem, s>>>(d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(static_cast<const float*>(partial), parts, 2 * D * H,
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
