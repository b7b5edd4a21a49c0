// v1 GRU scan, forward and backward, in f32: one layer's recurrence over
// precomputed input projections.
//
// Replaces the TPU kernels `_fwd_kernel` (sldm_gnn_tpu/ops/gru_pallas.py:32,
// launched by `_run_fwd` :112, pallas_call :125) and `_bwd_kernel` (:59,
// `_run_bwd` :138, pallas_call :147), the custom VJP pair of
// `gru_scan_pallas` :176 that `gru_forward_pallas` :196 chains into a stack.
//
//   forward:  xproj [T, B, 3H] f32 (x @ W_ih + b_ih, one GEMM outside the
//             kernel), W_hh [H, 3H] f32, b_hh [3H] f32 -> hs [T, B, H] f32,
//             h_0 = 0, gates r, z, n (torch's nn.GRU), all in f32 (the TPU
//             kernel's Precision.HIGHEST products);
//   backward: + the cotangent g [T, B, H] -> dxproj [T, B, 3H], dW_hh
//             [H, 3H], db_hh [3H]; the gates of step t are recomputed from
//             hs[t-1] (products in 3xTF32, so not the forward's bits, but
//             within the f32 contract), and the dh carry runs in reverse.
//
// Rows of a GRU are independent, so the TPU kernel's sequential T grid axis
// becomes a loop inside the block and a block owns a tile of rows for all T
// steps, with W_hh in shared memory in f32 for the whole sequence. Both
// kernels run their products h @ W_hh (and the backward's others) on the
// tensor cores as 3xTF32 (below).
//
// Forward: a block of 12 warps, one an SM, owns mt m-tiles of 16 rows for
// the whole sequence: the fewest waves of blocks at the most m-tiles a
// block holds (5 tasks a warp, and shared memory), then the fewest m-tiles
// that fill them (N = 19 558, H = 96: 10 m-tiles, 123 blocks on 132 SMs,
// one wave). A warp takes (m-tile, unit-group pair) tasks, each with the
// pair's r, z and n columns (6 n-tiles of 8), so the gate math runs on the
// product's own fragments; its tasks are fixed for the whole sequence, so
// their carries stay in registers. A step: each task loads its xproj ahead
// of its product (consumed after it), multiplies the carry tile (A) by
// W_hh (B) as 3xTF32, applies the gates (the backward's gate functions)
// and stores hs[t]; then, after a barrier, every warp writes its new
// carries into the tile, the next step's A; a second barrier. Its products
// and splits are the backward's recompute, but summed in another order
// (one accumulator, not two), so the two do not share bits. Its widest H
// is 128: W_hh, each gate padded to H rounded up to 16, and one 16-row
// carry tile fill the 227 KB of shared memory.
//
// Backward: a persistent grid of 8-warp blocks, one a SM, walks tiles of M
// rows (32 at H <= 112, 16 at H <= 128, by shared memory).
// Each step has three products, all on the tensor cores as 3xTF32
// (mma.sync m16n8k8: every f32 operand is split in registers into a TF32
// high part and a TF32 residual, and a product is hi*lo + lo*hi + hi*hi with
// f32 sums, as the TPU kernel's Precision.HIGHEST is a multi-pass product;
// about 2^-20 relative, well within the f32 contract's 2e-4; in products 1
// and 3 the cross terms go to a second accumulator, so that a k-step's
// chain is two dependent products, not three):
//   1. the recompute hproj = hprev @ W_hh, a warp a (16-row m-tile, 8-unit
//      group) with the group's r, z and n columns, so the gate math runs on
//      the product's own fragments (exp and division by the hardware's
//      approximations): dxproj out, dhp = [dr, dz, dn r] into a shared
//      tile, and d z kept as the next product's start;
//   2. the weight product dW_hh += hprev^T @ dhp, each warp's part of dW_hh
//      kept in registers for the tile's whole walk (db_hh from the same
//      fragments); it leaves the SM once a tile, into the block's slice of
//      a partial [blocks, H + 1, 3H]. Where dW does not fit the registers
//      (H > 96) the walk runs twice, each pass keeping half its columns;
//   3. the chain dh_{t-1} = d z + dhp @ W_hh^T, on the same (m-tile, unit
//      group)s as product 1, so the dh carry stays in registers.
// W_hh is stored once, gate-major with each gate padded to HG = H rounded to
// 16; products 1 and 2 read it in its two orientations. Every shared tile is
// swizzled (column c of row r at c ^ ((r & 3) << 3 | (r & 4)), rows of a
// multiple of 32 floats) so that both orientations of a fragment load hit 32
// banks. hs[t-2], the next step's hprev, is copied in by cp.async while the
// chain product runs. A second kernel sums the blocks' partials in block
// order: no atomics, so two launches repeat their bits. The widest H is 128
// (W_hh gate-padded, 196.6 KB, and a 16-row tile fill the 227 KB of shared
// memory).
//
// What bounds it on the H100. At N = 19 558 rows, T = 100, H = 96 the
// forward's h @ W_hh is 2 N T 3H H = 108 GFLOP of f32 products, 324 GFLOP
// of TF32 as 3xTF32 (0.65 ms at the 495 TFLOP/s TF32 peak); xproj and hs
// are 3.0 GB, 0.90 ms at 3.35 TB/s: bytes. Its step is bound by its issue
// and latencies: for each k-step of 8 a task loads and splits one A and
// six B fragments for 18 mma.sync, on 3 warps a scheduler; the hardware's
// exp and division keep the gate math short.
// The backward's three products are 324 GFLOP, 972 GFLOP of TF32 as
// 3xTF32: 1.96 ms at the TF32 peak; its bytes (xproj, hs and g read once,
// dxproj written) are 6.0 GB, 1.8 ms. This design issues mma.sync well
// below the instruction's rate: a step's products are short chains of
// dependent mma.sync on 8 warps, fed by shared-memory loads and register
// splits, and dW_hh's accumulators leave the rest of the kernel few
// registers (it spills at H = 96).
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------- shapes, 3xTF32

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr size_t kSmemMax = 232448;  // a block's opt-in shared memory on an H100
constexpr int kMaxDwTiles = 28;      // 16 x 8 tiles of dW a warp keeps in registers
constexpr int kWidestH = 128;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int rup(int a, int b) { return cdiv(a, b) * b; }

// How the warps split dW [HG, 3HG] (mtd x ntd tiles of 16 x 8): p passes
// over the sequence, each over ntp n-tiles, on a wgm x (kWarps / wgm) warp
// grid of mw x nw tiles a warp; the fewest passes whose tiles a warp keeps
// fit kMaxDwTiles, then the fewest tiles and fragment loads.
struct DwGrid {
  int p, ntp, wgm, mw, nw;
};

__host__ __device__ constexpr DwGrid dw_grid(int mtd, int ntd) {
  for (int p = 1;; ++p) {
    const int ntp = cdiv(ntd, p);
    DwGrid best{p, ntp, 1, 0, 0};
    int best_tiles = 1 << 30, best_loads = 1 << 30;
    for (int wgm = 1; wgm <= kWarps; ++wgm) {
      if (kWarps % wgm) continue;
      const int mw = cdiv(mtd, wgm), nw = cdiv(ntp, kWarps / wgm);
      const int tiles = mw * nw, loads = 4 * mw + 2 * nw;
      if (tiles < best_tiles || (tiles == best_tiles && loads < best_loads)) {
        best = DwGrid{p, ntp, wgm, mw, nw};
        best_tiles = tiles;
        best_loads = loads;
      }
    }
    if (best_tiles <= kMaxDwTiles) return best;
  }
}

// Shared memory of the backward at HG = H rounded up to 16 and m rows a
// tile: W_hh [HG, LD] and the dhp tile [m, LD] (LD = 3 HG rounded up to
// 32), the hprev tile [m, LH] (LH = HG rounded up to 32), b_hh [3 HG].
__host__ __device__ constexpr size_t bwd_smem(int hg, int m) {
  return sizeof(float) * (static_cast<size_t>(hg + m) * rup(3 * hg, 32) +
                          static_cast<size_t>(m) * rup(hg, 32) + 3 * hg);
}

// The row tile: 32 rows, or 16 where 32 do not fit. The time of a step goes
// with the rows, so smaller tiles lose little and fill the SMs better
// (N = 19 558: 612 tiles of 32 on 132 SMs take 5 rounds of half the work of
// 3 rounds of 306 tiles of 64)
__host__ __device__ constexpr int bwd_rows(int hg) {
  return bwd_smem(hg, 32) <= kSmemMax ? 32 : 16;
}

// The backward's shapes for HG = H rounded up to 16.
template <int HG>
struct Bwd {
  static constexpr int LD = rup(3 * HG, 32);  // row length of W_hh and of the dhp tile
  static constexpr int LH = rup(HG, 32);      // row length of the hprev tile
  static constexpr int M = bwd_rows(HG);
  static constexpr size_t kSmem = bwd_smem(HG, M);
  static constexpr int WPM = kWarps / (M / 16);  // warps on one m-tile in products 1 and 3
  static constexpr int NU = HG / 8;               // 8-unit groups
  static constexpr int UPW = cdiv(NU, WPM);       // unit groups of a warp
  static constexpr DwGrid G = dw_grid(HG / 16, 3 * HG / 8);
  static_assert(kSmem <= kSmemMax, "the backward's tiles exceed shared memory");
};

// element (r8 + dr, c) of a shared tile with rows of L floats (L a multiple
// of 32; r8 a multiple of 8, dr < 8, so the swizzle depends on dr alone)
__device__ __forceinline__ int swz(int r8, int dr, int c, int L) {
  return (r8 + dr) * L + (c ^ (((dr & 3) << 3) | (dr & 4)));
}

// v ~ hi + lo, both TF32: hi is v cut to TF32's 10 mantissa bits, lo the
// exact rest cut the same way (a relative error of 2^-20 of v; bit masks
// and one subtraction, no conversion instruction)
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi)) & 0xffffe000u;
}

struct Frag {  // an A fragment of m16n8k8, split
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b (b0, b1 the B fragment's two values) in 3xTF32
__device__ __forceinline__ void mma3(float (&d)[4], const Frag& a, float b0, float b1) {
  uint32_t h0, l0, h1, l1;
  split(b0, h0, l0);
  split(b1, h1, l1);
  mma_tf32(d, a.lo, h0, h1);
  mma_tf32(d, a.hi, l0, l1);
  mma_tf32(d, a.hi, h0, h1);
}

// the same with the cross terms summed apart, in e (two dependent products
// a step, not three, on the recurrence's short chains)
__device__ __forceinline__ void mma3x(float (&d)[4], float (&e)[4], const Frag& a, float b0,
                                      float b1) {
  uint32_t h0, l0, h1, l1;
  split(b0, h0, l0);
  split(b1, h1, l1);
  mma_tf32(e, a.lo, h0, h1);
  mma_tf32(d, a.hi, h0, h1);
  mma_tf32(e, a.hi, l0, l1);
}

// the gate functions of both kernels: exp and division by the hardware's
// approximations (a few ulp: hs stays within 1e-6 of the plain version at
// T = 100); tanh as 1 - 2 / (e^2v + 1), not tanh.approx (2^-11, too coarse
// for the forward's 1e-5)
__device__ __forceinline__ float sigmoid_g(float v) {
  return __fdividef(1.0f, 1.0f + __expf(-v));
}

__device__ __forceinline__ float tanh_g(float v) {
  return 1.0f - __fdividef(2.0f, __expf(2.0f * v) + 1.0f);
}

// A = S[m0.., k0..] (rows of S are A's rows)
__device__ __forceinline__ void load_a(const float* s, int L, int m0, int k0, int gid, int tig,
                                       Frag& a) {
  const float v[4] = {s[swz(m0, gid, k0 + tig, L)], s[swz(m0 + 8, gid, k0 + tig, L)],
                      s[swz(m0, gid, k0 + tig + 4, L)], s[swz(m0 + 8, gid, k0 + tig + 4, L)]};
#pragma unroll
  for (int i = 0; i < 4; ++i) split(v[i], a.hi[i], a.lo[i]);
}

// A = S^T[m0.., k0..] (columns of S are A's rows)
__device__ __forceinline__ void load_at(const float* s, int L, int m0, int k0, int gid, int tig,
                                        Frag& a) {
  const float v[4] = {s[swz(k0, tig, m0 + gid, L)], s[swz(k0, tig, m0 + gid + 8, L)],
                      s[swz(k0, tig + 4, m0 + gid, L)], s[swz(k0, tig + 4, m0 + gid + 8, L)]};
#pragma unroll
  for (int i = 0; i < 4; ++i) split(v[i], a.hi[i], a.lo[i]);
}

// v, which the compiler cannot see through: an index made opaque inside the
// step loop keeps the addresses derived from it from being hoisted out of
// the loop and held in registers for the whole walk
__device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---------------------------------------------------------------- forward

constexpr int kFwdWarps = 12;
constexpr int kFwdThreads = 32 * kFwdWarps;
constexpr int kFwdTasks = 5;  // (m-tile, unit-group pair)s a warp keeps the carry of

// Shared memory of the forward at HG = H rounded up to 16 and mt m-tiles
// of 16 rows a block: W_hh [HG, LD] (LD = 3 HG rounded up to 32), the
// carry tile [16 mt, LH] (LH = HG rounded up to 32), b_hh [3 HG]; f32.
__host__ __device__ constexpr size_t fwd_smem(int hg, int mt) {
  return sizeof(float) * (static_cast<size_t>(hg) * rup(3 * hg, 32) +
                          static_cast<size_t>(16 * mt) * rup(hg, 32) + 3 * hg);
}

// The most m-tiles a block of the forward takes at HG: its warps keep the
// carries of at most kFwdTasks tasks each, and its tiles fit shared memory.
__host__ __device__ constexpr int fwd_max_mtiles(int hg) {
  int mt = kFwdTasks * kFwdWarps / (hg / 16);
  while (mt > 1 && fwd_smem(hg, mt) > kSmemMax) --mt;
  return mt;
}

// xproj [T, B, 3H] with element strides st (frames) and sb (rows), the last
// dimension contiguous; hs [T, B, H] contiguous. A block owns rows
// [16 mt blockIdx.x, 16 mt (blockIdx.x + 1)) for all T steps. vec2: H, st
// and sb even and xproj 8-byte aligned (two columns a load and a store).
template <int HG>
__global__ void __launch_bounds__(kFwdThreads, 1)
    gru_scan_fwd_kernel(const float* __restrict__ xproj, int64_t st, int64_t sb,
                        const float* __restrict__ w_hh, const float* __restrict__ b_hh, int T,
                        int B, int H, int mt, int vec2, float* __restrict__ hs) {
  constexpr int LD = rup(3 * HG, 32), LH = rup(HG, 32), NP = HG / 16;
  extern __shared__ __align__(16) float smem_f[];
  float* wsm = smem_f;             // W_hh [HG, LD], gate q of unit j at column q HG + j
  float* hsm = wsm + HG * LD;      // the carry [16 mt, LH]: A of the next step's product
  float* bsm = hsm + 16 * mt * LH;  // b_hh [3 HG]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int row0 = blockIdx.x * 16 * mt, ntasks = mt * NP;

  for (int e = tid; e < HG * LD; e += kFwdThreads) {
    const int k = e / LD, c = e - k * LD, q = c / HG, j = c - q * HG;
    wsm[swz(k & ~7, k & 7, c, LD)] =
        (k < H && q < 3 && j < H) ? w_hh[static_cast<size_t>(k) * 3 * H + q * H + j] : 0.0f;
  }
  for (int e = tid; e < 3 * HG; e += kFwdThreads) {
    const int q = e / HG, j = e - q * HG;
    bsm[e] = j < H ? b_hh[q * H + j] : 0.0f;
  }
  for (int e = tid; e < 16 * mt * LH; e += kFwdThreads) hsm[e] = 0.0f;  // h_0 = 0
  __syncthreads();

  // h at the fragment positions of this warp's tasks: task = warp + kFwdWarps i
  // is m-tile task / NP and unit groups 2 (task % NP) + ug; element f is row
  // 16 m + gid + 8 (f >> 1), unit 8 u + 2 tig + (f & 1)
  float carry[kFwdTasks][2][4];
#pragma unroll
  for (int i = 0; i < kFwdTasks; ++i)
#pragma unroll
    for (int ug = 0; ug < 2; ++ug)
#pragma unroll
      for (int f = 0; f < 4; ++f) carry[i][ug][f] = 0.0f;

  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int i = 0; i < kFwdTasks; ++i) {
      const int task = warp + kFwdWarps * i;
      if (task >= ntasks) break;
      const int m = task / NP, u0 = 2 * (task - m * NP);
      // this step's xproj at the task's positions, loaded ahead of the product
      float xin[2][2][3][2];  // [ug][row half][gate][column pair]
#pragma unroll
      for (int ug = 0; ug < 2; ++ug)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = row0 + 16 * m + gid + 8 * hf, j = 8 * (u0 + ug) + 2 * tig;
          const float* xp = xproj + t * st + static_cast<int64_t>(row < B ? row : 0) * sb + j;
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            if (vec2 && row < B && j < H) {
              const float2 v = *reinterpret_cast<const float2*>(xp + q * H);
              xin[ug][hf][q][0] = v.x;
              xin[ug][hf][q][1] = v.y;
            } else {
              xin[ug][hf][q][0] = row < B && j < H ? xp[q * H] : 0.0f;
              xin[ug][hf][q][1] = row < B && j + 1 < H ? xp[q * H + 1] : 0.0f;
            }
          }
        }
      // hproj = h @ W_hh for the task's two unit groups, gates r, z, n
      float acc[2][3][4];
#pragma unroll
      for (int ug = 0; ug < 2; ++ug)
#pragma unroll
        for (int q = 0; q < 3; ++q)
#pragma unroll
          for (int f = 0; f < 4; ++f) acc[ug][q][f] = 0.0f;
#pragma unroll 2
      for (int k0 = 0; k0 < HG; k0 += 8) {
        Frag a;
        load_a(hsm, LH, 16 * m, k0, gid, tig, a);
#pragma unroll
        for (int ug = 0; ug < 2; ++ug)
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            const int n = q * HG + 8 * (u0 + ug) + gid;
            mma3(acc[ug][q], a, wsm[swz(k0, tig, n, LD)], wsm[swz(k0, tig + 4, n, LD)]);
          }
      }
      // the gates on the product's fragments; the new h into the carry and hs[t]
#pragma unroll
      for (int ug = 0; ug < 2; ++ug)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = row0 + 16 * m + gid + 8 * hf, j = 8 * (u0 + ug) + 2 * tig;
          float hn[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int f = 2 * hf + c;
            const float r = sigmoid_g(xin[ug][hf][0][c] + (acc[ug][0][f] + bsm[j + c]));
            const float z = sigmoid_g(xin[ug][hf][1][c] + (acc[ug][1][f] + bsm[HG + j + c]));
            const float n =
                tanh_g(xin[ug][hf][2][c] + r * (acc[ug][2][f] + bsm[2 * HG + j + c]));
            hn[c] = row < B && j + c < H ? fmaf(1.0f - z, n, z * carry[i][ug][f]) : 0.0f;
            carry[i][ug][f] = hn[c];
          }
          float* out = hs + (static_cast<size_t>(t) * B + row) * H + j;
          if (row < B && j < H) {
            if (vec2) {
              *reinterpret_cast<float2*>(out) = make_float2(hn[0], hn[1]);
            } else {
              out[0] = hn[0];
              if (j + 1 < H) out[1] = hn[1];
            }
          }
        }
    }
    __syncthreads();  // every warp has read the old carry tile
#pragma unroll
    for (int i = 0; i < kFwdTasks; ++i) {
      const int task = warp + kFwdWarps * i;
      if (task >= ntasks) break;
      const int m = task / NP, u0 = 2 * (task - m * NP);
#pragma unroll
      for (int ug = 0; ug < 2; ++ug)
#pragma unroll
        for (int f = 0; f < 4; ++f)
          hsm[swz(16 * m + 8 * (f >> 1), gid, 8 * (u0 + ug) + 2 * tig + (f & 1), LH)] =
              carry[i][ug][f];
    }
    __syncthreads();  // the new carry is the next step's A
  }
}

// ---------------------------------------------------------------- backward

// g [T, B, H] with element strides gt, gb (last dimension contiguous);
// dxproj [T, B, 3H] contiguous; partial [gridDim.x, H + 1, 3H] (rows [0, H)
// dW_hh, row H db_hh), this block's slice written by its first tile.
// hs16: hs is 16-byte aligned and H a multiple of 4 (16-byte copies).
template <int HG>
__global__ void __launch_bounds__(kThreads, 1)
    gru_scan_bwd_kernel(const float* __restrict__ xproj, int64_t st, int64_t sb,
                        const float* __restrict__ hs, const float* __restrict__ w_hh,
                        const float* __restrict__ b_hh, const float* __restrict__ g, int64_t gt,
                        int64_t gb, int T, int B, int H, int hs16, int num_tiles,
                        float* __restrict__ dxproj, float* __restrict__ partial) {
  using S = Bwd<HG>;
  constexpr int M = S::M, LD = S::LD, LH = S::LH, WPM = S::WPM, NU = S::NU, UPW = S::UPW;
  constexpr DwGrid G = S::G;
  constexpr int WGN = kWarps / G.wgm;
  extern __shared__ __align__(16) float smem_f[];
  float* wsm = smem_f;              // W_hh [HG, LD], gate q of unit j at column q HG + j
  float* dsm = wsm + HG * LD;       // dhp [M, LD], the same columns
  float* hsm = dsm + M * LD;        // hprev [M, LH]
  float* bsm = hsm + M * LH;        // b_hh [3 HG]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int H3 = 3 * H;
  const int mt = warp / WPM, ug0 = warp % WPM;  // products 1 and 3: m-tile, first unit group
  const int wm = warp / WGN, wn = warp % WGN;   // product 2: place in the dW grid
  float* part = partial + static_cast<size_t>(blockIdx.x) * (H + 1) * H3;

  for (int e = tid; e < HG * LD; e += kThreads) {
    const int k = e / LD, c = e - k * LD, q = c / HG, j = c - q * HG;
    wsm[swz(k & ~7, k & 7, c, LD)] =
        (k < H && q < 3 && j < H) ? w_hh[static_cast<size_t>(k) * H3 + q * H + j] : 0.0f;
  }
  for (int e = tid; e < 3 * HG; e += kThreads) {
    const int q = e / HG, j = e - q * HG;
    bsm[e] = j < H ? b_hh[q * H + j] : 0.0f;
  }
  for (int e = tid; e < M * LH; e += kThreads) hsm[e] = 0.0f;  // pad columns stay 0
  __syncthreads();

  // hprev of step tt (hs[tt - 1]; zero at tt = 0 and past B) into hsm
  auto stage = [&](int row0, int tt) {
    if (hs16) {
      const int q4 = H >> 2;
      for (int e = tid; e < M * q4; e += kThreads) {
        const int r = e / q4, c = (e - r * q4) << 2, row = row0 + r;
        const bool ok = tt > 0 && row < B;
        cp_async16(hsm + swz(r & ~7, r & 7, c, LH),
                   ok ? hs + (static_cast<size_t>(tt - 1) * B + row) * H + c : hs, ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < M * H; e += kThreads) {
        const int r = e / H, c = e - r * H, row = row0 + r;
        const bool ok = tt > 0 && row < B;
        cp_async4(hsm + swz(r & ~7, r & 7, c, LH),
                  ok ? hs + (static_cast<size_t>(tt - 1) * B + row) * H + c : hs, ok ? 4 : 0);
      }
    }
  };

  for (int tile = blockIdx.x, first = 1; tile < num_tiles; tile += gridDim.x, first = 0) {
    const int row0 = tile * M;
    for (int pass = 0; pass < G.p; ++pass) {
      float dw[G.mw][G.nw][4];
      float db[G.nw];
      float dh[UPW][4];  // the dh carry at this warp's (m-tile, unit group)s
#pragma unroll
      for (int mi = 0; mi < G.mw; ++mi)
#pragma unroll
        for (int ni = 0; ni < G.nw; ++ni)
#pragma unroll
          for (int f = 0; f < 4; ++f) dw[mi][ni][f] = 0.0f;
#pragma unroll
      for (int ni = 0; ni < G.nw; ++ni) db[ni] = 0.0f;
#pragma unroll
      for (int i = 0; i < UPW; ++i)
#pragma unroll
        for (int f = 0; f < 4; ++f) dh[i][f] = 0.0f;
      stage(row0, T - 1);
      cp_async_wait_all();
      __syncthreads();

      for (int t = T - 1; t >= 0; --t) {
        // 1. hproj = hprev @ W_hh for each unit group; the gate math on its
        // fragments (row mt 16 + gid + 8 (f >> 1), unit 8u + 2 tig + (f & 1))
#pragma unroll
        for (int i = 0; i < UPW; ++i) {
          const int u = opaque(ug0 + WPM * i);
          if (u >= NU) continue;
          float xin[4][4];  // xr, xz, xn, g
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            const int row = row0 + mt * 16 + gid + 8 * (f >> 1), j = 8 * u + 2 * tig + (f & 1);
            const bool ok = row < B && j < H;
            const float* xp = xproj + t * st + static_cast<int64_t>(ok ? row : 0) * sb;
            xin[f][0] = ok ? xp[j] : 0.0f;
            xin[f][1] = ok ? xp[H + j] : 0.0f;
            xin[f][2] = ok ? xp[2 * H + j] : 0.0f;
            xin[f][3] = ok ? g[t * gt + static_cast<int64_t>(row) * gb + j] : 0.0f;
          }
          float acc[3][4], acx[3][4];
#pragma unroll
          for (int q = 0; q < 3; ++q)
#pragma unroll
            for (int f = 0; f < 4; ++f) acc[q][f] = acx[q][f] = 0.0f;
#pragma unroll 1
          for (int k0 = 0; k0 < HG; k0 += 8) {
            Frag a;
            load_a(hsm, LH, mt * 16, k0, gid, tig, a);
#pragma unroll
            for (int q = 0; q < 3; ++q) {
              const int n = q * HG + 8 * u + gid;
              mma3x(acc[q], acx[q], a, wsm[swz(k0, tig, n, LD)], wsm[swz(k0, tig + 4, n, LD)]);
            }
          }
#pragma unroll
          for (int q = 0; q < 3; ++q)
#pragma unroll
            for (int f = 0; f < 4; ++f) acc[q][f] += acx[q][f];
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            const int r8 = mt * 16 + 8 * (f >> 1), j = 8 * u + 2 * tig + (f & 1);
            const int row = row0 + r8 + gid;
            const bool ok = row < B && j < H;
            const float hn = acc[2][f] + bsm[2 * HG + j];
            const float rr = sigmoid_g(xin[f][0] + (acc[0][f] + bsm[j]));
            const float z = sigmoid_g(xin[f][1] + (acc[1][f] + bsm[HG + j]));
            const float n = tanh_g(xin[f][2] + rr * hn);
            const float d = dh[i][f] + xin[f][3];
            const float hprev = hsm[swz(r8, gid, j, LH)];
            const float dn_pre = d * (1.0f - z) * (1.0f - n * n);
            const float dr_pre = dn_pre * hn * rr * (1.0f - rr);
            const float dz_pre = d * (hprev - n) * z * (1.0f - z);
            if (ok && pass == 0) {
              float* dx = dxproj + (static_cast<size_t>(t) * B + row) * H3;
              dx[j] = dr_pre;
              dx[H + j] = dz_pre;
              dx[2 * H + j] = dn_pre;
            }
            dsm[swz(r8, gid, j, LD)] = ok ? dr_pre : 0.0f;
            dsm[swz(r8, gid, HG + j, LD)] = ok ? dz_pre : 0.0f;
            dsm[swz(r8, gid, 2 * HG + j, LD)] = ok ? dn_pre * rr : 0.0f;
            dh[i][f] = ok ? d * z : 0.0f;  // the chain's start: dh_{t-1} = d z + ...
          }
        }
        __syncthreads();  // dhp is whole

        // 2. dW_hh += hprev^T @ dhp on this pass's columns; db_hh from the
        // first warp row's B fragments
        const int wmo = opaque(wm), wno = opaque(wn);
#pragma unroll 1
        for (int k0 = 0; k0 < M; k0 += 8) {
          Frag a[G.mw];
#pragma unroll
          for (int mi = 0; mi < G.mw; ++mi)
            if ((wmo * G.mw + mi) * 16 < HG)
              load_at(hsm, LH, (wmo * G.mw + mi) * 16, k0, gid, tig, a[mi]);
#pragma unroll
          for (int ni = 0; ni < G.nw; ++ni) {
            const int nt = wno * G.nw + ni, n0 = (pass * G.ntp + nt) * 8;
            if (nt >= G.ntp || n0 >= 3 * HG) continue;
            const float b0 = dsm[swz(k0, tig, n0 + gid, LD)];
            const float b1 = dsm[swz(k0, tig + 4, n0 + gid, LD)];
            if (wmo == 0) db[ni] += b0 + b1;
#pragma unroll
            for (int mi = 0; mi < G.mw; ++mi)
              if ((wmo * G.mw + mi) * 16 < HG) mma3(dw[mi][ni], a[mi], b0, b1);
          }
        }
        __syncthreads();  // hprev is read: the next step's may come in
        if (t > 0) stage(row0, t - 1);

        // 3. dh_{t-1} = d z + dhp @ W_hh^T
        float dhx[UPW][4];
#pragma unroll
        for (int i = 0; i < UPW; ++i)
#pragma unroll
          for (int f = 0; f < 4; ++f) dhx[i][f] = 0.0f;
#pragma unroll 1
        for (int k0 = 0; k0 < 3 * HG; k0 += 8) {
          Frag a;
          load_a(dsm, LD, mt * 16, k0, gid, tig, a);
#pragma unroll
          for (int i = 0; i < UPW; ++i) {
            const int u = opaque(ug0 + WPM * i);
            if (u >= NU) continue;
            mma3x(dh[i], dhx[i], a, wsm[swz(8 * u, gid, k0 + tig, LD)],
                  wsm[swz(8 * u, gid, k0 + tig + 4, LD)]);
          }
        }
#pragma unroll
        for (int i = 0; i < UPW; ++i)
#pragma unroll
          for (int f = 0; f < 4; ++f) dh[i][f] += dhx[i][f];
        cp_async_wait_all();
        __syncthreads();  // hprev of step t - 1 is in; dhp is free
      }

      // this tile's dW_hh | db_hh into the block's slice
#pragma unroll
      for (int mi = 0; mi < G.mw; ++mi)
#pragma unroll
        for (int ni = 0; ni < G.nw; ++ni) {
          const int m0 = (wm * G.mw + mi) * 16, nt = wn * G.nw + ni;
          const int n0 = (pass * G.ntp + nt) * 8;
          if (m0 >= HG || nt >= G.ntp || n0 >= 3 * HG) continue;
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            const int h = m0 + gid + 8 * (f >> 1), c = n0 + 2 * tig + (f & 1);
            const int q = c / HG, j = c - q * HG;
            if (h >= H || j >= H) continue;
            float* p = part + static_cast<size_t>(h) * H3 + q * H + j;
            *p = first ? dw[mi][ni][f] : *p + dw[mi][ni][f];
          }
        }
      if (wm == 0) {
#pragma unroll
        for (int ni = 0; ni < G.nw; ++ni) {
          float v = db[ni];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          const int nt = wn * G.nw + ni, c = (pass * G.ntp + nt) * 8 + gid;
          const int q = c / HG, j = c - q * HG;
          if (tig == 0 && nt < G.ntp && c < 3 * HG && j < H) {
            float* p = part + static_cast<size_t>(H) * H3 + q * H + j;
            *p = first ? v : *p + v;
          }
        }
      }
    }
  }
}

// out[e] = sum over blocks b, in order, of partial[b, e]
__global__ void gru_scan_reduce_kernel(const float* __restrict__ partial, int nblocks, int n,
                                       float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.0f;
  for (int b = 0; b < nblocks; ++b) s += partial[static_cast<size_t>(b) * n + e];
  out[e] = s;
}

template <class Kernel>
int opt_in(Kernel kernel, size_t smem) {
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > static_cast<size_t>(smem_max)) return SLDM_ERR_SMEM;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// f(std::integral_constant<int, HG>) for HG = H rounded up to 16
template <class F>
int by_width(int H, F f) {
  switch (rup(H, 16)) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 48: return f(std::integral_constant<int, 48>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 80: return f(std::integral_constant<int, 80>{});
    case 96: return f(std::integral_constant<int, 96>{});
    case 112: return f(std::integral_constant<int, 112>{});
    case 128: return f(std::integral_constant<int, 128>{});
    default: return SLDM_ERR_SMEM;
  }
}

}  // namespace

// xproj [T, B, 3H] f32 (strides st, sb; last dimension contiguous), w_hh
// [H, 3H] and b_hh [3H] f32 contiguous -> hs [T, B, H] f32.
extern "C" int gru_scan_fwd_launch(const void* xproj, int64_t st, int64_t sb, const void* w_hh,
                                   const void* b_hh, int T, int B, int H, void* hs,
                                   void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return SLDM_ERR_SHAPE;
  if (H > kWidestH) return SLDM_ERR_SMEM;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int vec2 = H % 2 == 0 && st % 2 == 0 && sb % 2 == 0 &&
                   reinterpret_cast<uintptr_t>(xproj) % 8 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_width(H, [&](auto hg) {
    constexpr int HG = decltype(hg)::value;
    // the fewest waves of one block an SM at the most m-tiles a block holds,
    // then the fewest m-tiles a block that fill those waves
    const int mtiles = cdiv(B, 16), slots = sms > 0 ? sms : 1;
    const int waves = cdiv(mtiles, fwd_max_mtiles(HG) * slots);
    const int mt = cdiv(mtiles, waves * slots);
    const size_t smem = fwd_smem(HG, mt);
    auto kernel = gru_scan_fwd_kernel<HG>;
    const int code = opt_in(kernel, smem);
    if (code != 0) return code;
    kernel<<<cdiv(mtiles, mt), kFwdThreads, smem, s>>>(
        static_cast<const float*>(xproj), st, sb, static_cast<const float*>(w_hh),
        static_cast<const float*>(b_hh), T, B, H, mt, vec2, static_cast<float*>(hs));
    return static_cast<int>(cudaGetLastError());
  });
}

// The backward's row tile at width H (bwd_rows), 0 where H is wider than
// the kernel takes.
extern "C" int gru_scan_bwd_rows(int H, int* rows) {
  if (H <= 0) return SLDM_ERR_SHAPE;
  *rows = H > kWidestH ? 0 : bwd_rows(rup(H, 16));
  return 0;
}

// Blocks of the backward's persistent grid: one per SM the kernel can
// hold, at most one per tile of rows. H above 128 is SLDM_ERR_SMEM.
extern "C" int gru_scan_bwd_grid(int B, int H, int* blocks) {
  if (B <= 0 || H <= 0) return SLDM_ERR_SHAPE;
  if (H > kWidestH) return SLDM_ERR_SMEM;
  return by_width(H, [&](auto hg) {
    constexpr int HG = decltype(hg)::value;
    using S = Bwd<HG>;
    auto kernel = gru_scan_bwd_kernel<HG>;
    int code = opt_in(kernel, S::kSmem);
    if (code != 0) return code;
    int dev = 0, sms = 0, occ = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads, S::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (occ <= 0) return SLDM_ERR_SMEM;
    const int tiles = cdiv(B, S::M);
    *blocks = tiles < occ * sms ? tiles : occ * sms;
    return 0;
  });
}

// + hs [T, B, H] f32 contiguous and g [T, B, H] f32 (strides gt, gb) ->
// dxproj [T, B, 3H] f32 and out [H + 1, 3H] f32 = dW_hh | db_hh; partial
// [blocks, H + 1, 3H] f32 scratch, blocks from gru_scan_bwd_grid.
extern "C" int gru_scan_bwd_launch(const void* xproj, int64_t st, int64_t sb, const void* hs,
                                   const void* w_hh, const void* b_hh, const void* g,
                                   int64_t gt, int64_t gb, int T, int B, int H, void* dxproj,
                                   void* partial, int blocks, void* out, void* stream) {
  int want = 0;
  const int code = gru_scan_bwd_grid(B, H, &want);
  if (code != 0) return code;
  if (T <= 0 || blocks != want) return SLDM_ERR_SHAPE;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hs16 = H % 4 == 0 && reinterpret_cast<uintptr_t>(hs) % 16 == 0;
  const int launched = by_width(H, [&](auto hg) {
    constexpr int HG = decltype(hg)::value;
    using S = Bwd<HG>;
    gru_scan_bwd_kernel<HG><<<blocks, kThreads, S::kSmem, s>>>(
        static_cast<const float*>(xproj), st, sb, static_cast<const float*>(hs),
        static_cast<const float*>(w_hh), static_cast<const float*>(b_hh),
        static_cast<const float*>(g), gt, gb, T, B, H, hs16, cdiv(B, S::M),
        static_cast<float*>(dxproj), static_cast<float*>(partial));
    return static_cast<int>(cudaGetLastError());
  });
  if (launched != 0) return launched;
  const int n = (H + 1) * 3 * H;
  gru_scan_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(static_cast<const float*>(partial),
                                                          blocks, n, static_cast<float*>(out));
  return cudaGetLastError();
}
