// One fused SAGE layer over the banded layout:
//   out[b] = act(LN?(agg[b] @ Wl + x[b] @ Wr + bias)),
//   agg[b] = rs[b] * sum_s A[b, s] @ x[src(b, s)]  (+ the compact residual)
//
// Replaces the TPU kernel `_fused_kernel` (sldm_gnn_tpu/ops/sage_fused.py:49,
// launched by `banded_sage_fwd_pallas` :147, pallas_call :283), with its
// `resid`, `ln`, `cmap` and `ypre` options. Slot s of block b reads source tile
// bo[b] + s or, with `cmap`, the clamped window tile woff[b / k] + cmap[b *
// s_span + s] (sage_fused.py:95-101). Roundings are the TPU kernel's: tiles,
// x, agg and the weights in bf16, f32 sums, f32 LayerNorm statistics, the
// output at x's dtype.
//
// Bound at bench.py's shape (nb = 1572, tile 128, s_span 5, D = H = 128,
// bf16): bytes, 128.8 MB of A + 51.5 MB of x + 51.5 MB of out (0.069 ms at
// 3.35 TB/s), over 46 GFLOP (0.047 ms at the bf16 tensor-core rate);
// `ypre` adds its m_b * k_grp * tile * H * 4 bytes written. The
// first version ran both products on the f32 FMA units (a block product
// staged element by element through loaders with an integer division and a
// rounding each: >= 0.7 ms at 67 TFLOP/s, 2.83 ms measured), one block of
// 256 threads per destination block, nothing overlapping loads and products.
//
// This version is the third client of banded_mma.cuh's slot loop, the
// reverse kernel of sage_fused_bwd.cu with the roles swapped: a persistent
// grid of two blocks of two warpgroups an SM over the destination blocks in
// ascending order, one stream of 32-row chunks through a ring of three TMA
// stages:
//   step 1, the slot chunks: acc = A @ x by wgmma m64n128k16, A's int8 counts
//     or f32 weights made bf16 fragments in registers; then, per row, acc *
//     rs in f32, the group's compact residual slot added where rg > 0 (not
//     read otherwise, which is NaN-safe), rounded to bf16 into a swizzled
//     tile in shared memory; the block's own x rows arrive by TMA meanwhile;
//   step 2, the tail: [Wl; Wr] in 32-row chunks through the same ring (in
//     flight during step 1), y = [agg | x_own] @ [Wl; Wr] by wgmma from
//     shared memory, D padded to whole chunks with zero rows and columns, H
//     to the wgmma width by columns that no statistic or store reads;
//   the epilogue: bias in f32; with `ypre` (the halo overlap's handshake,
//     sage_fused.py:124-129) each row of a group g = b / k_grp with a
//     boundary slot rg_b[g] > 0 stored as it stands, in f32, into y_pre_c
//     [m_b, k_grp * tile, H] at slot rg_b[g] (the TPU kernel's dummy slot 0
//     collects the unmapped groups' rows; here they write nothing, so no two
//     blocks race on it); LayerNorm in f32 (a row's values sit on the
//     four threads of a quad: mean, then the centred variance, by quad
//     shuffles; xhat and rstd stored for the backward), the activation, and
//     the rows out through shared memory (the agg and x_own tiles, no longer
//     read) in 16-byte stores. x in f32, and operands TMA cannot take, load
//     by the loop's element paths.
#include "banded_mma.cuh"

namespace {

struct FwdArgs {
  CUtensorMap map_own;  // x as [nb * tile, D], boxes [tile, 64] (bf16 x)
  int tma_own;
  int D, H;
  const float* rs;  // [nb * tile] or NULL
  const void* r_c;  // [m, k_grp * tile, D] or NULL
  int r_bf16;
  const int* rg;  // [nb / k_grp] or NULL
  int k_grp;
  const float* bias;   // [H] or NULL
  const float* gamma;  // [H] or NULL (no LayerNorm)
  const float* beta;
  float eps;
  int has_act;
  float slope;
  void* out;    // [nb * tile, H] at x's dtype
  void* xhat;   // [nb * tile, H] at x's dtype, with gamma
  float* rstd;  // [nb * tile], with gamma
  float* ypre;       // [m_b, k_grp * tile, H] f32 or NULL
  const int* rg_b;   // [nb / k_grp] boundary slot of each group, with ypre
};

constexpr int kFwdStages = 3;
using FwdLoop = SlotLoop<kFwdStages, true>;
constexpr int kFwdThreads = FwdLoop::kThreads;

inline size_t fwd_smem_bytes(const SlotArgs& p) {
  return 1024 + slot_ring_bytes(kFwdStages, p) +
         static_cast<size_t>(2 * tile_rows64(p.tile)) * kRow * 2;
}

__global__ void __launch_bounds__(kFwdThreads, 2)
    sage_fwd_kernel(const __grid_constant__ SlotArgs p, const __grid_constant__ TailArgs w,
                    const __grid_constant__ FwdArgs f) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ int table[kTableInts];
  __shared__ uint64_t bars[kFwdStages + 1];  // the ring's, then x_own's
  unsigned char* smem = align1024(smem_raw);
  FwdLoop loop(p, smem, table, &w);
  const int tile = p.tile, D = f.D, H = f.H, kd = depth32(D), tr = tile_rows64(tile);
  __nv_bfloat16* agg_s = reinterpret_cast<__nv_bfloat16*>(smem + slot_ring_bytes(kFwdStages, p));
  __nv_bfloat16* own_s = agg_s + tr * kRow;
  // the epilogue's output tile over both: rows of kRow elements at x's
  // dtype, each row's 16-byte pieces XOR-swizzled by row % 8 (the quads'
  // stores and the row reads are free of bank conflicts)
  unsigned char* out_s = reinterpret_cast<unsigned char*>(agg_s);
  const int esz = p.x_bf16 ? 2 : 4, ldb = kRow * esz;
  const int tid = threadIdx.x, t = tid & 3;
  const int rw = FwdLoop::thread_row(), m0 = rw & ~63;  // this thread's rows rw, rw + 8
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);

  // x_own of block b, in flight during its step 1 (by TMA, or by the element
  // path with f32 x rounded to bf16 and its columns D .. kd zeroed: the
  // previous block's output passed through this tile)
  uint64_t* obar = &bars[kFwdStages];
  if (tid == 0) mbar_init(obar, 1);  // loop.run's barrier publishes it
  auto first = [&](int, int b) {
    if (!f.tma_own) {
      load_rows(own_s, tr, p.x, p.x_bf16, static_cast<size_t>(b) * tile, tile, D, true);
      for (int idx = tid; idx < tile * (kd - D); idx += kFwdThreads)
        own_s[swz_h(tr, idx / (kd - D), D + idx % (kd - D))] = zero;
    } else if (tid == 0) {  // (the box's columns past D arrive as zeros)
      const int halves = D > 64 ? 2 : 1;
      mbar_expect(obar, halves * tile * 128);
      for (int h = 0; h < halves; ++h)
        tma_load(own_s + h * tr * 64, &f.map_own, 64 * h, b * tile, obar);
    }
  };

  // after step 1: agg = bf16(acc * rs (+ residual)) into agg_s, columns D ..
  // kd zeroed (step 2's depth padding)
  auto mid = [&](int i, int b, float (&acc)[16][4]) {
    const int slot = f.rg != nullptr ? f.rg[b / f.k_grp] : 0;
    const size_t rr0 = (static_cast<size_t>(slot) * f.k_grp + (b % f.k_grp)) * tile;
    const size_t row0 = static_cast<size_t>(b) * tile;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int rr = rw + 8 * h2;
      if (rr >= tile) continue;
      const float sc = f.rs != nullptr ? f.rs[row0 + rr] : 1.0f;
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        const int c = nt * 8 + 2 * t;
        if (c >= kd) continue;
        float v[2] = {0.0f, 0.0f};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (c + e >= D) continue;
          v[e] = acc[nt][2 * h2 + e] * sc;
          if (slot > 0) v[e] += load_f(f.r_c, (rr0 + rr) * D + c + e, f.r_bf16);
        }
        *reinterpret_cast<uint32_t*>(agg_s + swz_h(tr, rr, c)) = pack_bf16(v[0], v[1]);
      }
    }
    if (f.tma_own) mbar_wait(obar, i & 1);
    fence_proxy_async();
    __syncthreads();
  };

  // step 2, chunk j: y += [agg | x_own][:, 32 j' ..] @ [Wl; Wr] rows (wgmma
  // from shared memory, agg and x_own K-contiguous)
  auto tail = [&](int j, const __nv_bfloat16* bs, float (&acc)[16][4]) {
    if (m0 >= tile) return;
    const __nv_bfloat16* as = j < kd / kChunk ? agg_s : own_s;
    const int k0 = (j % (kd / kChunk)) * kChunk;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      wgmma_ss_n128<0>(acc, desc_h(as + swz_h(tr, m0, k0 + 16 * kk), tr),
                       desc_h(bs + swz_h(kChunk, 16 * kk, 0), kChunk));
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc);
  };

  auto out_at = [&](int r, int c) {  // element c of row r of out_s
    const int byte = c * esz;
    return out_s + r * ldb + (((byte >> 4) ^ (r & 7)) << 4) + (byte & 15);
  };
  // this thread's rows at columns (c, c + 1) into out_s
  auto put = [&](float (&acc)[16][4], int nt) {
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int rr = rw + 8 * h2;
      if (rr >= tile) continue;
      unsigned char* at = out_at(rr, nt * 8 + 2 * t);
      if (p.x_bf16)
        *reinterpret_cast<uint32_t*>(at) = pack_bf16(acc[nt][2 * h2], acc[nt][2 * h2 + 1]);
      else
        *reinterpret_cast<float2*>(at) = make_float2(acc[nt][2 * h2], acc[nt][2 * h2 + 1]);
    }
  };
  // out_s's rows to dst's rows row0 ..: 16-byte pieces where the row bytes
  // allow it, else element by element
  auto copy_out = [&](void* dst, size_t row0) {
    __syncthreads();
    char* g = static_cast<char*>(dst) + row0 * H * esz;
    if ((H * esz) % 16 == 0 && aligned16(dst)) {
      const int cpr = H * esz / 16;
      for (int idx = tid; idx < tile * 32; idx += kFwdThreads) {
        const int r = idx >> 5, j = idx & 31;
        if (j < cpr)
          *reinterpret_cast<uint4*>(g + static_cast<size_t>(r) * H * esz + j * 16) =
              *reinterpret_cast<const uint4*>(out_at(r, j * 16 / esz));
      }
    } else {
      for (int idx = tid; idx < tile * kRow; idx += kFwdThreads) {
        const int r = idx >> 7, c = idx & (kRow - 1);
        if (c >= H) continue;
        const size_t gi = static_cast<size_t>(r) * H + c;
        if (p.x_bf16)
          reinterpret_cast<__nv_bfloat16*>(g)[gi] =
              *reinterpret_cast<const __nv_bfloat16*>(out_at(r, c));
        else
          reinterpret_cast<float*>(g)[gi] = *reinterpret_cast<const float*>(out_at(r, c));
      }
    }
  };

  // bias, LayerNorm, activation; acc[nt][2 h2 + e] is row rw + 8 h2, column
  // 8 nt + 2 t + e, and a row's H values sit on the four threads of a quad
  auto epi = [&](int, int b, float (&acc)[16][4]) {
    const size_t row0 = static_cast<size_t>(b) * tile;
    float s[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = nt * 8 + 2 * t + e;
        const float bc = (f.bias != nullptr && c < H) ? __ldg(f.bias + c) : 0.0f;
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          acc[nt][2 * h2 + e] += bc;
          s[h2] += c < H ? acc[nt][2 * h2 + e] : 0.0f;
        }
      }
    if (f.ypre != nullptr) {  // y before LN and the activation, f32
      const int slot = f.rg_b[b / f.k_grp];
      if (slot > 0) {
        float* yp = f.ypre + (static_cast<size_t>(slot) * f.k_grp + b % f.k_grp) * tile * H;
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int rr = rw + 8 * h2;
          if (rr >= tile) continue;
#pragma unroll
          for (int nt = 0; nt < 16; ++nt) {
            const int c = nt * 8 + 2 * t;
            float* at = yp + static_cast<size_t>(rr) * H + c;
            if (c + 1 < H && H % 2 == 0) {
              *reinterpret_cast<float2*>(at) = make_float2(acc[nt][2 * h2], acc[nt][2 * h2 + 1]);
            } else {
              if (c < H) at[0] = acc[nt][2 * h2];
              if (c + 1 < H) at[1] = acc[nt][2 * h2 + 1];
            }
          }
        }
      }
    }
    __syncthreads();  // both warpgroups' products have read agg_s and own_s
    if (f.gamma != nullptr) {
      float q[2] = {0.0f, 0.0f}, rsd[2];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        s[h2] += __shfl_xor_sync(0xffffffffu, s[h2], 1);
        s[h2] += __shfl_xor_sync(0xffffffffu, s[h2], 2);
        const float mu = s[h2] / H;
#pragma unroll
        for (int nt = 0; nt < 16; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = acc[nt][2 * h2 + e] - mu;
            acc[nt][2 * h2 + e] = v;
            q[h2] += nt * 8 + 2 * t + e < H ? v * v : 0.0f;
          }
        q[h2] += __shfl_xor_sync(0xffffffffu, q[h2], 1);
        q[h2] += __shfl_xor_sync(0xffffffffu, q[h2], 2);
        rsd[h2] = 1.0f / sqrtf(q[h2] / H + f.eps);
        if (t == 0 && rw + 8 * h2 < tile) f.rstd[row0 + rw + 8 * h2] = rsd[h2];
      }
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
          for (int e = 0; e < 2; ++e) acc[nt][2 * h2 + e] *= rsd[h2];
        put(acc, nt);  // xhat
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = nt * 8 + 2 * t + e;
          const float gc = c < H ? __ldg(f.gamma + c) : 0.0f;
          const float bc = c < H ? __ldg(f.beta + c) : 0.0f;
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) acc[nt][2 * h2 + e] = acc[nt][2 * h2 + e] * gc + bc;
        }
      }
      copy_out(f.xhat, row0);
      __syncthreads();  // out_s has been read
    }
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      if (f.has_act)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!(acc[nt][e] > 0.0f)) acc[nt][e] *= f.slope;
      put(acc, nt);
    }
    copy_out(f.out, row0);
    // the next block's first copy into own_s comes after the loop's next
    // barrier, when every thread has read out_s
  };

  float acc[16][4] = {};
  loop.run(acc, bars, first, mid, tail, epi);
}

}  // namespace

// a [nb, s_span, tile, tile] int8 (or f32), bo [nb] int32, cmap [nb *
// s_span] and woff [nb/k_grp] int32 or NULL, rs [nb*tile] f32 or NULL; x
// [nb*tile, D] bf16 or f32; wl, wr [D, H] bf16; bias, gamma, beta [H] f32
// or NULL (gamma: LayerNorm on, and xhat [nb*tile, H] at x's dtype and rstd
// [nb*tile] f32 are written); r_c [m, k_grp*tile, D] and rg [nb/k_grp]
// int32 or NULL; out [nb*tile, H] at x's dtype; ypre [m_b, k_grp*tile, H]
// f32 and rg_b [nb/k_grp] int32, or NULL.
extern "C" int sage_fwd_launch(const void* a, int a_f32, const void* bo, const void* cmap,
                               const void* woff, const void* rs, int nb,
                               int s_span, int tile, int k_grp, const void* x, int x_bf16, int D,
                               int H, const void* wl, const void* wr, const void* bias,
                               const void* gamma, const void* beta, float eps, int has_act,
                               float slope, const void* r_c, int r_bf16, const void* rg,
                               void* out, void* xhat, void* rstd, void* ypre, const void* rg_b,
                               void* stream) {
  if (!banded_shape_ok(nb, s_span, tile, D) || H <= 0 || H > kTileMax || k_grp <= 0 ||
      nb % k_grp != 0 || (gamma != nullptr && (beta == nullptr || xhat == nullptr ||
                                               rstd == nullptr)) ||
      (rg != nullptr && r_c == nullptr) || (ypre != nullptr && rg_b == nullptr) ||
      !cmap_ok(cmap, woff, s_span, k_grp, nb))
    return SLDM_ERR_SHAPE;
  SlotArgs p{};
  p.a = a;
  p.a_kind = a_f32 ? kAF32 : kAInt8;
  p.amode = kScaleNone;
  p.bo = static_cast<const int*>(bo);
  p.cmap = static_cast<const int*>(cmap);
  p.woff = static_cast<const int*>(woff);
  p.k = k_grp;
  p.nb = nb;
  p.s_span = s_span;
  p.tile = tile;
  p.x = x;
  p.x_bf16 = x_bf16;
  p.width = D;
  p.transform = 0;  // f32 x rows are rounded by the element path
  make_slot_maps(p);
  TailArgs w{};
  w.w[0] = static_cast<const __nv_bfloat16*>(wl);
  w.w[1] = static_cast<const __nv_bfloat16*>(wr);
  w.wrows = D;
  w.wcols = H;
  w.tail = 2 * depth32(D) / kChunk;
  w.tma_w = make_map(&w.map_w[0], wl, 2, D, H, kChunk, 64, CU_TENSOR_MAP_SWIZZLE_128B) &&
            make_map(&w.map_w[1], wr, 2, D, H, kChunk, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  FwdArgs f{};
  f.tma_own = x_bf16 && make_map(&f.map_own, x, 2, static_cast<size_t>(nb) * tile, D, tile, 64,
                                 CU_TENSOR_MAP_SWIZZLE_128B);
  f.D = D;
  f.H = H;
  f.rs = static_cast<const float*>(rs);
  f.r_c = r_c;
  f.r_bf16 = r_bf16;
  f.rg = static_cast<const int*>(rg);
  f.k_grp = k_grp;
  f.bias = static_cast<const float*>(bias);
  f.gamma = static_cast<const float*>(gamma);
  f.beta = static_cast<const float*>(beta);
  f.eps = eps;
  f.has_act = has_act;
  f.slope = slope;
  f.out = out;
  f.xhat = xhat;
  f.rstd = static_cast<float*>(rstd);
  f.ypre = static_cast<float*>(ypre);
  f.rg_b = static_cast<const int*>(rg_b);
  const size_t smem = fwd_smem_bytes(p);
  int code = smem_opt_in(sage_fwd_kernel, smem);
  if (code != 0) return code;
  int grid = 0;
  code = persistent_grid(sage_fwd_kernel, kFwdThreads, smem, nb, &grid);
  if (code != 0) return code;
  sage_fwd_kernel<<<grid, kFwdThreads, smem, static_cast<cudaStream_t>(stream)>>>(p, w, f);
  return cudaGetLastError();
}
