// GRU forward over a whole sequence, one layer, bf16 operands.
//
// Replaces the TPU kernel `_fwd2_kernel` (sldm_gnn_tpu/ops/gru_pallas.py:246,
// launched by `_run_fwd2` :400 for `gru_last_pallas` :477 and
// `gru_seq_pallas` :544). Same numerics: x, W_ih and W_hh rounded to bf16,
// products summed in f32 (a bf16*bf16 product is exact in f32, so only the
// order of the sums differs), biases and gate math in f32 with expf/tanhf,
// h = bf16(fma(1 - z, n, z * h_old)) after every step. Gate order r, z, n
// (torch's nn.GRU).
//
// The same kernels, instantiated with kStoreGates, also replace
// `_fwd3_kernel` (gru_pallas.py:641, launched by `_run_fwd3` :759 for the
// store-gates `gru_last_sg_pallas` :840 and `gru_seq_sg_pallas` :888): they
// write the packed bf16 gates r|z|n|hn [T, N, 4H] beside hs (hn is the
// hidden projection of the n gate, bias included), which the store-gates
// backward (gru_bwd_sg.cu) reads instead of recomputing. Its hs is bit-equal
// to the plain instance's: the arithmetic is the same code. That instance
// moves T*N*(4H+H)*2 bytes of output (1.9 GB at the flagship shape), so it
// is bound by bytes (0.57 ms at 3.35 TB/s), not by operations.
//
// What bounds it on the H100: the recurrence. Each of the T steps needs the
// previous step's carry, so a row's T steps run in order; the work per step
// is a [rows, H] x [H, 3H] product plus a [rows, D] x [D, 3H] one. At the
// flagship shape (N=20k rows, T=100, D=6, H=96) that is 118 GFLOP of bf16
// products over 48 MB of input (0.12 ms at the tensor cores' 989 TFLOP/s),
// and 188M elements of exact gate math (about 100 instructions each: two
// expf, two IEEE reciprocals, a tanhf); at one served window (N=32) it is
// the length of the 100-step chain.
//
// Design (H <= 128, D <= 128: the tensor-core kernel). One block of four
// warpgroups owns a tile of 64 rows for all T steps (the TPU kernel's
// sequential T grid axis becomes a loop in the block). H is padded to Hp, a
// multiple of 32, with zero weights and zero biases: a padded unit stays
// exactly 0 (r = z = 1/2, n = tanh(0) = 0). Warpgroup w owns the Hw = Hp / 4
// units w Hw ...: each step it runs, on the tensor cores (wgmma m64nNk16,
// both operands from shared memory),
//   [r z xn] = x_t @ W_ih[:, its r, z, n columns]   (N = 3 Hw, D padded to 16)
//   [r z]   += h @ W_hh[:, its r, z columns]        (N = 2 Hw)
//   hn       = h @ W_hh[:, its n columns]           (N = Hw)
// so r and z sum both projections in one accumulator, while the n gate's
// input and hidden sums stay apart (n = tanh(xn + b_in + r (hn + b_hn))).
// The last two are issued k-step by k-step in turn: each chain waits only
// on its own accumulators (one chain of N = 3 Hw ran slower on the card).
// W_hh and W_ih sit in shared memory for the whole sequence,
// transposed (K-major, wgmma's 128-byte swizzle) with each warpgroup's r, z
// and n rows side by side. The accumulators leave the tensor cores in the
// layout of the thread's own units, so the gate math, the bf16 carry and
// the outputs are per thread; the carry goes back to shared memory (its A
// operand, bf16, 12 KB at 64 x 96) and one barrier a step publishes it to
// the other warpgroups with the next step's x tile, which is loaded into
// registers while the products run (two frames ahead for D <= 16). Carry
// and x tile are double-buffered where shared memory allows, else single
// (a second barrier a step). hs and the store-gates instance's gates leave
// through shared memory: one step's [64, H] and [64, 4H] tiles, stored by
// TMA (rows past N clipped) while the next step runs, where they fit and H
// is a multiple of 8 (else each thread stores its own pairs). With one tile
// of 32 rows or fewer, tile row m holds row 4 (m % 16) + m / 16, so that
// every warp owns live rows and the four schedulers share the gate math;
// rows past N are skipped.
//
// Measured on the H100 (PERF.md): the gate math is the largest part of a
// step, then the wgmma chain. A thread's share of the math is a long chain
// (tanhf and the IEEE reciprocal branch, so its elements interleave
// poorly); spreading a tile's warpgroups over the SMs of a cluster (the
// carry sent to every block's shared memory, a cluster barrier a step)
// left that chain as long, added the barrier, and ran slower.
//
// Wider H, or D > 128, take the first kernel of this file (gru_fwd_fma_kernel
// below: f32 FMAs, 16 rows a block; widths in PERF.md), chosen by shape in
// route(). It refuses what does not fit its shared memory.
#include "gru_tc.cuh"

namespace {

// Shared memory of the tensor-core kernel: the transposed weights, nbuf
// carry and x tiles, the biases, and with `stage` the output tiles of one
// step (hs, and gates with kStoreGates); 1024 more to align the tiles.
inline size_t tc_smem_bytes(int D, int H, int nbuf, bool stage, bool gates) {
  const int hp = tc_hp(H), dp = tc_dp(D);
  size_t n = 1024 + tc_tile_bytes(3 * hp, hp) + tc_tile_bytes(3 * hp, dp) +
             nbuf * (tc_tile_bytes(kTcRows, hp) + tc_tile_bytes(kTcRows, dp)) +
             sizeof(float) * 4 * hp;
  if (stage) n += tc_tile_bytes(kTcRows, H) + (gates ? tc_tile_bytes(kTcRows, 4 * H) : 0);
  return (n + 1023) / 1024 * 1024;
}

struct TcArgs {
  CUtensorMap map_hs, map_gates;  // with stage
  const float* x;
  int64_t sn, st;
  int N, T, D, H;
  const __nv_bfloat16* w_ih;
  const float* b_ih;
  const __nv_bfloat16* w_hh;
  const float* b_hh;
  float* h_last;        // [N, H] or NULL
  __nv_bfloat16* hs;    // [T, N, H] or NULL
  __nv_bfloat16* gates; // [T, N, 4H] with kStoreGates
  int nbuf;             // carry and x tiles: 2 (one barrier a step) or 1 (two)
  int stage;            // hs and gates leave through shared memory by TMA
};

// x elements a thread keeps in registers for a frame: its share of a
// [64, 16] tile (kSmallX: D <= 16, loaded two frames ahead) or of a [64,
// 128] one (one frame ahead)
template <bool kSmallX>
constexpr int kXSlots = kTcRows * (kSmallX ? 16 : 128) / kTcThreads;

template <int HW, bool kStoreGates, bool kSmallX>
__global__ void __launch_bounds__(kTcThreads, 1)
    gru_fwd_tc_kernel(const __grid_constant__ TcArgs p) {
  constexpr int NT = HW / 8;  // n-tiles of 8 units a gate
  constexpr int HP = kTcWarpgroups * HW;
  constexpr int R = 3 * HP;  // rows of the transposed weights
  constexpr int KH = HP / 16;
  const int N = p.N, T = p.T, D = p.D, H = p.H, nbuf = p.nbuf;
  const int dp = tc_dp(D), kx = dp / 16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  __nv_bfloat16* whh = reinterpret_cast<__nv_bfloat16*>(sm);  // swz_h(R, n, k)
  __nv_bfloat16* wih = whh + tc_tile_bytes(R, HP) / 2;        // swz_h(R, n, d)
  __nv_bfloat16* hbuf = wih + tc_tile_bytes(R, dp) / 2;       // nbuf x swz_h(64, m, k)
  const int hsz = tc_tile_bytes(kTcRows, HP) / 2, xsz = tc_tile_bytes(kTcRows, dp) / 2;
  __nv_bfloat16* xbuf = hbuf + nbuf * hsz;  // nbuf x swz_h(64, m, d)
  __nv_bfloat16* hs_s = xbuf + nbuf * xsz;  // with stage: swz_h(64, row, j)
  __nv_bfloat16* gt_s = hs_s + tc_tile_bytes(kTcRows, H) / 2;  // swz_h(64, row, 4H cols)
  // b_ir + b_hr | b_iz + b_hz | b_in | b_hn, Hp each
  float* bias = reinterpret_cast<float*>(
      p.stage ? gt_s + (kStoreGates ? tc_tile_bytes(kTcRows, 4 * H) / 2 : 0) : hs_s);

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kTcRows;
  const int H3 = 3 * H;
  // With one tile of 32 rows or fewer, tile row m holds row 4 (m % 16) +
  // m / 16: every warp then owns live rows (rows 0-31 are otherwise warps
  // 0 and 1 of each warpgroup, which share two of the four schedulers).
  const bool spread = N <= kTcRows / 2;
  auto tile_row = [&](int m) { return spread ? 4 * (m & 15) + (m >> 4) : m; };

  // zero the weights, the carry and x buffers, then fill (reads in the
  // source's order: consecutive threads, consecutive columns)
  {
    const size_t words = (tc_tile_bytes(R, HP) + tc_tile_bytes(R, dp) +
                          nbuf * (tc_tile_bytes(kTcRows, HP) + tc_tile_bytes(kTcRows, dp))) / 16;
    for (size_t e = tid; e < words; e += kTcThreads)
      reinterpret_cast<uint4*>(sm)[e] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  // W [K, 3H] into the transposed tile: column c = g H + j (gate g, unit j)
  // becomes row (j / Hw) 3 Hw + g Hw + j % Hw (warpgroup-major, r | z | n)
  auto fill = [&](__nv_bfloat16* dst, const __nv_bfloat16* src, int K) {
    int k = tid / H3, c = tid - k * H3;
#pragma unroll 4
    for (int e = tid; e < K * H3; e += kTcThreads) {
      const int gate = (c >= H) + (c >= 2 * H), j = c - gate * H;
      dst[swz_h(R, (j / HW) * 3 * HW + gate * HW + j % HW, k)] = src[e];
      for (c += kTcThreads; c >= H3; c -= H3) ++k;
    }
  };
  fill(whh, p.w_hh, H);
  fill(wih, p.w_ih, D);
  for (int j = tid; j < HP; j += kTcThreads) {
    const bool u = j < H;
    bias[j] = u ? p.b_ih[j] + p.b_hh[j] : 0.0f;
    bias[HP + j] = u ? p.b_ih[H + j] + p.b_hh[H + j] : 0.0f;
    bias[2 * HP + j] = u ? p.b_ih[2 * H + j] : 0.0f;
    bias[3 * HP + j] = u ? p.b_hh[2 * H + j] : 0.0f;
  }
  // x: this thread loads column xd of tile rows xm0 + q * xrows (q <
  // xpass), rounds it to bf16 and stores it into the next x tile
  const int xd = tid % dp, xrows = kTcThreads / dp, xm0 = tid / dp;
  const int xpass = xm0 < xrows ? (kTcRows - xm0 + xrows - 1) / xrows : 0;
  auto x_load = [&](auto& v, int t) {
#pragma unroll
    for (int q = 0; q < static_cast<int>(sizeof(v) / sizeof(float)); ++q) {
      const int row = row0 + tile_row(xm0 + q * xrows);
      v[q] = (t < T && q < xpass && xd < D && row < N) ? p.x[row * p.sn + t * p.st + xd] : 0.0f;
    }
  };
  auto x_put = [&](__nv_bfloat16* xb, const auto& v) {
#pragma unroll
    for (int q = 0; q < static_cast<int>(sizeof(v) / sizeof(float)); ++q)
      if (q < xpass) xb[swz_h(kTcRows, xm0 + q * xrows, xd)] = __float2bfloat16_rn(v[q]);
  };
  constexpr int XS = kXSlots<kSmallX>;
  float x1[XS], x2[kSmallX ? XS : 1];  // the next frame; with kSmallX the one after
  x_load(x1, 0);
  x_put(xbuf, x1);
  if (kSmallX) x_load(x1, 1);
  fence_proxy_async();
  __syncthreads();

  const int warp = tid >> 5, wg = warp >> 2, v = warp & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int n0 = wg * 3 * HW;  // this warpgroup's first transposed weight row
  int rows[2], prow[2];        // this thread's two rows (-1 past N), their tile rows
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    prow[h2] = tile_row(16 * v + g + 8 * h2);
    rows[h2] = row0 + prow[h2] < N ? row0 + prow[h2] : -1;
  }
  uint32_t hprev[NT][2];  // the carry of this thread's units, bf16 pairs
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) hprev[nt][0] = hprev[nt][1] = 0u;
  // [r z | xn] in one accumulator (the x product's N = 3 Hw), r z and xn
  // views of it; hn apart
  float rzx[3 * HW / 2] = {}, hn[HW / 2] = {};
  float (&rz)[HW] = *reinterpret_cast<float (*)[HW]>(rzx);
  float (&xn)[HW / 2] = *reinterpret_cast<float (*)[HW / 2]>(rzx + HW);

  int cur = 0;
  for (int t = 0; t < T; ++t) {
    const __nv_bfloat16* hb = hbuf + cur * hsz;
    const __nv_bfloat16* xb = xbuf + cur * xsz;
    // [r z xn] = x_t W_ih (one wgmma of the warpgroup's 3 Hw columns a
    // k-step), then [r z] += h W_hh and hn = h W_hh, the two chains
    // interleaved k-step by k-step (each waits on its own accumulators only)
    wgmma_fence();
    for (int kk = 0; kk < kx; ++kk)
      mma_n<3 * HW>(rzx, desc_h(xb + swz_h(kTcRows, 0, 16 * kk), kTcRows),
                    desc_h(wih + swz_h(R, n0, 16 * kk), R), kk);
#pragma unroll
    for (int kk = 0; kk < KH; ++kk) {
      const uint64_t da = desc_h(hb + swz_h(kTcRows, 0, 16 * kk), kTcRows);
      mma_n<2 * HW>(rz, da, desc_h(whh + swz_h(R, n0, 16 * kk), R), 1);
      mma_n<HW>(hn, da, desc_h(whh + swz_h(R, n0 + 2 * HW, 16 * kk), R), kk);
    }
    wgmma_commit();
    // later frames of x, while the products run
    if (kSmallX)
      x_load(x2, t + 2);
    else
      x_load(x1, t + 1);
    wgmma_wait<0>();
    pin_n(rzx);
    pin_n(hn);

    const int nxt = nbuf == 2 ? cur ^ 1 : cur;
    if (nbuf == 1 || p.stage) {
      // every warpgroup's products have read the buffers; the last step's
      // output tiles have left shared memory
      if (p.stage && tid == 0) bulk_wait_read();
      __syncthreads();
    }
    __nv_bfloat16* hw_next = hbuf + nxt * hsz;
    // the gate math of each live row: one branch a row, so the NT x 2
    // elements of a row are independent chains the compiler interleaves
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      if (rows[h2] < 0) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int j = wg * HW + 8 * nt + 2 * t4;  // this thread's units j, j + 1
        const float2 br = *reinterpret_cast<const float2*>(bias + j);
        const float2 bz = *reinterpret_cast<const float2*>(bias + HP + j);
        const float2 bi = *reinterpret_cast<const float2*>(bias + 2 * HP + j);
        const float2 bh = *reinterpret_cast<const float2*>(bias + 3 * HP + j);
        float o[2], gr[2], gz[2], gn[2], ghn[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * h2 + e;
          const float r = sigmoid(rz[nt * 4 + i] + (e ? br.y : br.x));
          const float z = sigmoid(rz[(NT + nt) * 4 + i] + (e ? bz.y : bz.x));
          const float hv = hn[nt * 4 + i] + (e ? bh.y : bh.x);
          const float n = tanhf(xn[nt * 4 + i] + (e ? bi.y : bi.x) + r * hv);
          const uint32_t hp2 = hprev[nt][h2];
          const float hold = __uint_as_float(e ? hp2 & 0xFFFF0000u : hp2 << 16);
          o[e] = fmaf(1.0f - z, n, z * hold);  // XLA's contraction of the update
          gr[e] = r, gz[e] = z, gn[e] = n, ghn[e] = hv;
        }
        const uint32_t hnew = pack_bf16(o[0], o[1]);
        hprev[nt][h2] = hnew;
        *reinterpret_cast<uint32_t*>(hw_next + swz_h(kTcRows, 16 * v + g + 8 * h2, j)) = hnew;
        if (p.stage) {
          if (j < H) {
            const int pr = prow[h2];
            if (p.hs != nullptr) *reinterpret_cast<uint32_t*>(hs_s + swz_h(kTcRows, pr, j)) = hnew;
            if (kStoreGates) {
              *reinterpret_cast<uint32_t*>(gt_s + swz_h(kTcRows, pr, j)) = pack_bf16(gr[0], gr[1]);
              *reinterpret_cast<uint32_t*>(gt_s + swz_h(kTcRows, pr, H + j)) =
                  pack_bf16(gz[0], gz[1]);
              *reinterpret_cast<uint32_t*>(gt_s + swz_h(kTcRows, pr, 2 * H + j)) =
                  pack_bf16(gn[0], gn[1]);
              *reinterpret_cast<uint32_t*>(gt_s + swz_h(kTcRows, pr, 3 * H + j)) =
                  pack_bf16(ghn[0], ghn[1]);
            }
          }
        } else {
          const size_t at = static_cast<size_t>(t) * N + rows[h2];
          if (p.hs != nullptr) store_bf16_pair(p.hs, at * H + j, hnew, j, H);
          if (kStoreGates) {
            __nv_bfloat16* gt = p.gates + at * (4 * H);
            store_bf16_pair(gt, j, pack_bf16(gr[0], gr[1]), j, H);
            store_bf16_pair(gt + H, j, pack_bf16(gz[0], gz[1]), j, H);
            store_bf16_pair(gt + 2 * H, j, pack_bf16(gn[0], gn[1]), j, H);
            store_bf16_pair(gt + 3 * H, j, pack_bf16(ghn[0], ghn[1]), j, H);
          }
        }
      }
    }
    if (t + 1 < T) {
      x_put(xbuf + nxt * xsz, x1);
      if (kSmallX)
#pragma unroll
        for (int q = 0; q < XS; ++q) x1[q] = x2[q];
    }
    fence_proxy_async();
    __syncthreads();  // the new carry, x tile and output tiles are visible
    if (p.stage && tid == 0) {
      if (p.hs != nullptr)
        for (int c = 0; c < H; c += 64)
          tma_store_3d(&p.map_hs, hs_s + swz_h(kTcRows, 0, c), c, row0, t);
      if (kStoreGates)
        for (int c = 0; c < 4 * H; c += 64)
          tma_store_3d(&p.map_gates, gt_s + swz_h(kTcRows, 0, c), c, row0, t);
      bulk_commit();
    }
    cur = nxt;
  }
  if (p.stage && tid == 0) bulk_wait();

  if (p.h_last != nullptr) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int j = wg * HW + 8 * nt + 2 * t4;
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        if (rows[h2] < 0) continue;
        float* hl = p.h_last + static_cast<size_t>(rows[h2]) * H;
        if (j < H) hl[j] = __uint_as_float(hprev[nt][h2] << 16);
        if (j + 1 < H) hl[j + 1] = __uint_as_float(hprev[nt][h2] & 0xFFFF0000u);
      }
    }
  }
}

// ------------------------------------------------------------ the FMA kernel (wide H)

constexpr int kRowsPerThread = 8;
constexpr int kRowGroups = 2;
constexpr int kRowsPerBlock = kRowsPerThread * kRowGroups;

size_t fma_smem_bytes(int D, int H) {
  const size_t h3 = 3 * static_cast<size_t>(H);
  const size_t hh = (H + 1) / 2;
  return sizeof(float) * kRowsPerBlock * 2 * hh  // carry [rows, 2*hh] f32
         + sizeof(__nv_bfloat162) * hh * h3      // W_hh as k-pairs [hh, 3H]
         + sizeof(__nv_bfloat162) * ((D * h3 + 1) / 2)  // W_ih bf16 [D, 3H], even length
         + sizeof(float) * 2 * h3                // b_ih, b_hh
         + sizeof(float) * kRowsPerBlock * D;    // x tile of one step
}

// The first kernel of this port, kept for the widths the tensor-core
// kernel does not take: the TPU kernel's sequential T grid axis becomes a
// loop inside the block. One block owns kRowsPerBlock rows for all T
// steps: W_hh (as bf16 pairs along k), W_ih (bf16), both biases and the
// [rows, H] carry stay in shared memory for the whole sequence. Thread
// (j, g) owns hidden unit j for kRowsPerThread rows and keeps their three
// gate sums in registers (f32 FMAs); two barriers per step separate reading
// the old carry from writing the new one. Shared memory holds W_hh and W_ih
// whole, which caps H (227 KB a block; the widths are in PERF.md); a wider
// H is refused at launch.
//
// x [N, T, D] f32 with element strides sn (rows) and st (frames), the last
// dimension contiguous; w_ih [D, 3H], w_hh [H, 3H] bf16 (JAX layout);
// b_ih, b_hh [3H] f32. Writes h_last [N, H] f32 and/or hs [T, N, H] bf16.
// With kStoreGates also writes gates [T, N, 4H] bf16 = r | z | n | hn.
template <bool kStoreGates>
__global__ void gru_fwd_fma_kernel(const float* __restrict__ x, int64_t sn, int64_t st,
                               int N, int T, int D, int H,
                               const __nv_bfloat16* __restrict__ w_ih,
                               const float* __restrict__ b_ih,
                               const __nv_bfloat16* __restrict__ w_hh,
                               const float* __restrict__ b_hh,
                               float* __restrict__ h_last,
                               __nv_bfloat16* __restrict__ hs,
                               __nv_bfloat16* __restrict__ gates) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H3 = 3 * H;
  const int Hh = (H + 1) / 2;
  const int Hp = 2 * Hh;
  float* hc = reinterpret_cast<float*>(smem);  // [rows, Hp], 16-byte aligned
  __nv_bfloat162* whh2 = reinterpret_cast<__nv_bfloat162*>(hc + kRowsPerBlock * Hp);
  __nv_bfloat16* wih = reinterpret_cast<__nv_bfloat16*>(whh2 + static_cast<size_t>(Hh) * H3);
  float* bih = reinterpret_cast<float*>(whh2 + static_cast<size_t>(Hh) * H3 +
                                        (static_cast<size_t>(D) * H3 + 1) / 2);
  float* bhh = bih + H3;
  float* xs = bhh + H3;  // [rows, D]

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;
  const int j = threadIdx.x;
  const int r0 = threadIdx.y * kRowsPerThread;
  const int row0 = blockIdx.x * kRowsPerBlock;

  for (int e = tid; e < Hh * H3; e += nthr) {
    const int kk = e / H3, c = e - kk * H3;
    const __nv_bfloat16 lo = w_hh[static_cast<size_t>(2 * kk) * H3 + c];
    const __nv_bfloat16 hi = (2 * kk + 1 < H) ? w_hh[static_cast<size_t>(2 * kk + 1) * H3 + c]
                                              : __float2bfloat16_rn(0.0f);
    whh2[e] = __halves2bfloat162(lo, hi);
  }
  for (int e = tid; e < D * H3; e += nthr) wih[e] = w_ih[e];
  for (int e = tid; e < H3; e += nthr) {
    bih[e] = b_ih[e];
    bhh[e] = b_hh[e];
  }
  for (int e = tid; e < kRowsPerBlock * Hp; e += nthr) hc[e] = 0.0f;
  for (int e = tid; e < kRowsPerBlock * D; e += nthr) {
    const int r = e / D, d = e - r * D, row = row0 + r;
    xs[e] = row < N ? bf16_round(x[row * sn + d]) : 0.0f;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    float ar[kRowsPerThread], az[kRowsPerThread], an[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) ar[i] = az[i] = an[i] = 0.0f;

    // hproj = h @ W_hh for this thread's rows and unit j, two k at a time
#pragma unroll 4
    for (int kk = 0; kk < Hh; ++kk) {
      const __nv_bfloat162* wrow = whh2 + static_cast<size_t>(kk) * H3;
      const float2 wr = __bfloat1622float2(wrow[j]);
      const float2 wz = __bfloat1622float2(wrow[H + j]);
      const float2 wn = __bfloat1622float2(wrow[2 * H + j]);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float2 hv = *reinterpret_cast<const float2*>(hc + (r0 + i) * Hp + 2 * kk);
        ar[i] = fmaf(hv.x, wr.x, ar[i]);
        ar[i] = fmaf(hv.y, wr.y, ar[i]);
        az[i] = fmaf(hv.x, wz.x, az[i]);
        az[i] = fmaf(hv.y, wz.y, az[i]);
        an[i] = fmaf(hv.x, wn.x, an[i]);
        an[i] = fmaf(hv.y, wn.y, an[i]);
      }
    }

    float hnew[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const float* xrow = xs + (r0 + i) * D;
      float xr = 0.0f, xz = 0.0f, xn = 0.0f;
      for (int d = 0; d < D; ++d) {
        const float xv = xrow[d];
        const __nv_bfloat16* w = wih + static_cast<size_t>(d) * H3;
        xr = fmaf(xv, __bfloat162float(w[j]), xr);
        xz = fmaf(xv, __bfloat162float(w[H + j]), xz);
        xn = fmaf(xv, __bfloat162float(w[2 * H + j]), xn);
      }
      xr += bih[j];
      xz += bih[H + j];
      xn += bih[2 * H + j];
      const float hr = ar[i] + bhh[j];
      const float hz = az[i] + bhh[H + j];
      const float hn = an[i] + bhh[2 * H + j];
      const float r = sigmoid(xr + hr);
      const float z = sigmoid(xz + hz);
      const float n = tanhf(xn + r * hn);
      const float hold = hc[(r0 + i) * Hp + j];
      hnew[i] = bf16_round(fmaf(1.0f - z, n, z * hold));  // XLA's contraction of the update
      if (kStoreGates) {
        const int row = row0 + r0 + i;
        if (row < N) {
          __nv_bfloat16* gt = gates + (static_cast<size_t>(t) * N + row) * (4 * H);
          gt[j] = __float2bfloat16_rn(r);
          gt[H + j] = __float2bfloat16_rn(z);
          gt[2 * H + j] = __float2bfloat16_rn(n);
          gt[3 * H + j] = __float2bfloat16_rn(hn);
        }
      }
    }
    __syncthreads();  // every thread has read the old carry

#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      hc[(r0 + i) * Hp + j] = hnew[i];
      const int row = row0 + r0 + i;
      if (hs != nullptr && row < N)
        hs[(static_cast<size_t>(t) * N + row) * H + j] = __float2bfloat16_rn(hnew[i]);
    }
    if (t + 1 < T) {
      for (int e = tid; e < kRowsPerBlock * D; e += nthr) {
        const int r = e / D, d = e - r * D, row = row0 + r;
        xs[e] = row < N ? bf16_round(x[row * sn + (t + 1) * st + d]) : 0.0f;
      }
    }
    __syncthreads();  // new carry and next x tile visible
  }

  if (h_last != nullptr) {
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int row = row0 + r0 + i;
      if (row < N) h_last[static_cast<size_t>(row) * H + j] = hc[(r0 + i) * Hp + j];
    }
  }
}


// Which kernel takes (D, H): 1 the tensor-core kernel, 0 the FMA kernel, -1
// neither (shared memory); smem_max is the device's opt-in limit a block.
int route(int D, int H, int smem_max) {
  if (H <= 128 && D <= 128 && tc_smem_bytes(D, H, 1, false, false) <= static_cast<size_t>(smem_max))
    return 1;
  if (H * kRowGroups <= 1024 && fma_smem_bytes(D, H) <= static_cast<size_t>(smem_max)) return 0;
  return -1;
}

int smem_limit(int* smem_max) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// The tensor-core kernel's launch: outputs staged through shared memory
// where it holds them and TMA takes them (H a multiple of 8), carry and x
// tiles double-buffered where they still fit.
template <int HW, bool kStoreGates, bool kSmallX>
int launch_tc(TcArgs& a, int smem_max, cudaStream_t stream) {
  const auto fits = [&](size_t bytes) { return bytes <= static_cast<size_t>(smem_max); };
  a.stage = a.hs != nullptr && a.H % 8 == 0 &&
            fits(tc_smem_bytes(a.D, a.H, 1, true, kStoreGates)) &&
            make_out_map(&a.map_hs, a.hs, a.H, a.N, a.T) &&
            (!kStoreGates || make_out_map(&a.map_gates, a.gates, 4 * a.H, a.N, a.T));
  a.nbuf = fits(tc_smem_bytes(a.D, a.H, 2, a.stage, kStoreGates)) ? 2 : 1;
  const size_t smem = tc_smem_bytes(a.D, a.H, a.nbuf, a.stage, kStoreGates);
  const auto kernel = gru_fwd_tc_kernel<HW, kStoreGates, kSmallX>;
  const int code = smem_opt_in(kernel, smem);
  if (code != 0) return code;
  kernel<<<(a.N + kTcRows - 1) / kTcRows, kTcThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool kStoreGates>
int launch(const void* x, int64_t stride_n, int64_t stride_t, int N, int T, int D, int H,
           const void* w_ih, const void* b_ih, const void* w_hh, const void* b_hh, void* h_last,
           void* hs, void* gates, void* stream_) {
  if (N <= 0 || T <= 0 || D <= 0 || H <= 0) return SLDM_ERR_SHAPE;
  const auto stream = static_cast<cudaStream_t>(stream_);
  int smem_max = 0;
  int code = smem_limit(&smem_max);
  if (code != 0) return code;
  const int path = route(D, H, smem_max);
  if (path == 1) {
    TcArgs a{};
    a.x = static_cast<const float*>(x);
    a.sn = stride_n;
    a.st = stride_t;
    a.N = N, a.T = T, a.D = D, a.H = H;
    a.w_ih = static_cast<const __nv_bfloat16*>(w_ih);
    a.b_ih = static_cast<const float*>(b_ih);
    a.w_hh = static_cast<const __nv_bfloat16*>(w_hh);
    a.b_hh = static_cast<const float*>(b_hh);
    a.h_last = static_cast<float*>(h_last);
    a.hs = static_cast<__nv_bfloat16*>(hs);
    a.gates = static_cast<__nv_bfloat16*>(gates);
    const bool small_x = D <= 16;
    switch (tc_hp(H) / kTcWarpgroups) {
#define SLDM_GRU_TC(HW_)                                                     \
  case HW_:                                                                  \
    return small_x ? launch_tc<HW_, kStoreGates, true>(a, smem_max, stream) \
                   : launch_tc<HW_, kStoreGates, false>(a, smem_max, stream);
      SLDM_GRU_TC(8)
      SLDM_GRU_TC(16)
      SLDM_GRU_TC(24)
      SLDM_GRU_TC(32)
#undef SLDM_GRU_TC
      default:
        return SLDM_ERR_SHAPE;
    }
  }
  if (H * kRowGroups > 1024) return SLDM_ERR_SHAPE;
  if (path < 0) return SLDM_ERR_SMEM;
  const size_t smem = fma_smem_bytes(D, H);
  code = smem_opt_in(gru_fwd_fma_kernel<kStoreGates>, smem);
  if (code != 0) return code;
  const dim3 block(H, kRowGroups);
  const dim3 grid((N + kRowsPerBlock - 1) / kRowsPerBlock);
  gru_fwd_fma_kernel<kStoreGates><<<grid, block, smem, stream>>>(
      static_cast<const float*>(x), stride_n, stride_t, N, T, D, H,
      static_cast<const __nv_bfloat16*>(w_ih), static_cast<const float*>(b_ih),
      static_cast<const __nv_bfloat16*>(w_hh), static_cast<const float*>(b_hh),
      static_cast<float*>(h_last), static_cast<__nv_bfloat16*>(hs),
      static_cast<__nv_bfloat16*>(gates));
  return cudaGetLastError();
}

}  // namespace

extern "C" int gru_fwd_launch(const void* x, int64_t stride_n, int64_t stride_t, int N, int T,
                              int D, int H, const void* w_ih, const void* b_ih, const void* w_hh,
                              const void* b_hh, void* h_last, void* hs, void* stream) {
  return launch<false>(x, stride_n, stride_t, N, T, D, H, w_ih, b_ih, w_hh, b_hh, h_last, hs,
                       nullptr, stream);
}

// The store-gates forward: hs [T, N, H] and gates [T, N, 4H], both bf16.
extern "C" int gru_fwd_sg_launch(const void* x, int64_t stride_n, int64_t stride_t, int N,
                                 int T, int D, int H, const void* w_ih, const void* b_ih,
                                 const void* w_hh, const void* b_hh, void* hs, void* gates,
                                 void* stream) {
  if (hs == nullptr || gates == nullptr) return SLDM_ERR_SHAPE;
  return launch<true>(x, stride_n, stride_t, N, T, D, H, w_ih, b_ih, w_hh, b_hh, nullptr, hs,
                      gates, stream);
}

// The kernel both entry points launch for (D, H) on the current device: 1
// the tensor-core kernel, 0 the FMA kernel, -1 none (too wide for shared
// memory); *out is set, the return is 0 or a cudaError_t.
extern "C" int gru_fwd_route(int D, int H, int* out) {
  int smem_max = 0;
  const int code = smem_limit(&smem_max);
  if (code != 0) return code;
  *out = route(D, H, smem_max);
  return 0;
}
