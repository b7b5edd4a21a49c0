// Reverse BPTT of one GRU layer with bf16 operands: the kernels shared by
// gru_bwd.cu (gates recomputed from hs, kStored = false) and gru_bwd_sg.cu
// (gates read back from the store-gates forward, kStored = true). See those
// files for what each replaces; this header holds the design.
//
// Inputs: x [N, T, D] f32 (element strides, last dimension contiguous), the
// forward's hs [T, N, H] bf16, for kStored its gates [T, N, 4H] bf16
// (r | z | n | hn), W_ih [D, 3H] and W_hh [H, 3H] bf16 (JAX layout), biases
// [3H] f32 (read only to recompute the gates), and the cotangent g: h_last's
// [N, H], or with seq_cot one for every frame [N, T, H] (element strides).
// Outputs: dW_ih, db_ih, dW_hh, db_hh in f32, and dx [N, T, D] f32 when dx is
// not null. Numerics of `_bwd2_kernel` / `_bwd3_kernel`: the dh carry is f32,
// seeded from g at the last frame (or zero, plus g[t] every frame with
// seq_cot); dxp and dhp are rounded to bf16 before every product; products of
// bf16 values are exact in f32 and summed in f32; the bias gradients are the
// column sums of the rounded dxp and dhp (the TPU kernel's ones row).
//
// What bounds it on the H100, at the flagship shape (N=19558, T=100, D=6,
// H=96, no dx): the v2 backward does ~174 kFLOP of bf16 products per row and
// frame (the recomputed input and hidden projections, dh, dW_hh and dW_ih
// with their bias rows), 340 GFLOP over 0.38 GB of hs: bound by operations
// (0.34 ms at 989 TFLOP/s). The store-gates backward skips the recompute
// (~115 kFLOP per row and frame, 225 GFLOP) but reads the 1.5 GB of gates:
// bound by bytes (0.58 ms at 3.35 TB/s). The chain of T dependent steps sets
// a floor of its own: each step's dh needs the last step's.
//
// Design (H <= 128, D <= 128: the tensor-core route). Three kernels, no
// atomics, so two launches give the same bits:
//   1. gru_bwd_tc_kernel, the recurrence: one block of four warpgroups owns
//      a 64-row tile for all T steps, walked in reverse (the structure of
//      gru_fwd.cu's forward with the products' K and N swapped). H is padded
//      to Hp, a multiple of 32, with zero weights; warpgroup w owns the
//      units w Hw ... (Hw = Hp / 4). W_hh sits in shared memory once,
//      transposed and gate-major (row g Hp + j, column k; wgmma's 128-byte
//      swizzle), and serves both products: K-major it is the B of the
//      recompute, and with the transpose bit the B of the chain. Per step:
//      (v2) the gates are recomputed from hs[t-1] and x[t], staged in shared
//      memory a step ahead, by the forward's own products (x steps, then
//      h steps, into one accumulator for r and z) and gate functions
//      (gru_tc.cuh). W_ih^T is resident too, except at Hp = 128 with D > 16,
//      where it does not fit beside W_hh^T and the tiles: there its k-steps
//      stream from L2 through two 12 KB stages (bulk copies, mbarriers; a
//      stage is refilled once all four warpgroups have read it, so the next
//      step's first two arrive during this step's chain). (v3) the stored
//      gates and hs[t-1] come into registers
//      a step ahead. The elementwise math runs in the accumulators' layout:
//      dh (+ g[t]), dr/dz/dn_pre/dhn, the bf16 dhp and dn_pre into a [64,
//      4 Hp] tile (dr | dz | dhn | dn, gate-major). One barrier a step (two
//      where shared memory holds one set of tiles) publishes it; then the
//      one product on the chain, dh_{t-1} = dh z + dhp @ W_hh^T (each
//      warpgroup N = its units, K = 3 Hp), while TMA stores the tile to a
//      bf16 workspace [T, N, 4 Hp].
//   2. gru_dw_kernel, the weight gradients: [hprev | 1]^T dhp and [x | 1]^T
//      dxp over K = N T rows, split into ranges of 32-row chunks (one frame
//      a chunk), one warpgroup a block for each (operand, 64-row block of
//      its rows, gate), hs, [x | 1] (rounded to bf16 once by gru_xb_kernel)
//      and the workspace arriving by TMA through four stages, the ones row
//      in the padding of the operand's last block; gru_dw_reduce_kernel adds
//      the ranges' partials in range order.
//   3. with dx, gru_dx_kernel: dx = dxp @ W_ih^T over the workspace, 64-row
//      tiles of one frame by TMA, W_ih K-major in shared memory.
// The workspace costs a round trip of T N 4 Hp bf16 (1.5 GB at the
// flagship shape) that an in-kernel dW would save; the dW partials held in
// registers over a tile's steps did not fit beside the recurrence's.
//
// Wider H or D take gru_bwd_kernel below (the first version: f32 FMAs, the
// partial dW in a device workspace), chosen by shape in bwd_route() and
// exported, so Python asks the library.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "gru_tc.cuh"

namespace {

// ------------------------------------------------------------ the FMA kernel (wide H)

constexpr int kBwdRowsPerThread = 8;
constexpr int kBwdRowGroups = 3;  // block (H, 3): 3H threads, one per gate column
constexpr int kBwdRows = kBwdRowsPerThread * kBwdRowGroups;

__device__ __forceinline__ float bwd_sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

__host__ __device__ inline size_t align16(size_t v) { return (v + 15) & ~static_cast<size_t>(15); }

// Byte offsets of the FMA kernel's shared-memory regions.
struct BwdSmem {
  size_t whh2, bih, bhh, hpT, xT, dhp, dnx, total;
  __host__ __device__ BwdSmem(int D, int H) {
    const size_t H3 = 3 * static_cast<size_t>(H);
    const size_t Hh = (H + 1) / 2;
    const size_t ldh = (H3 + 7) & ~static_cast<size_t>(7);
    whh2 = 0;
    bih = align16(whh2 + 4 * Hh * (ldh + 1));        // W_hh pairs [Hh, ldh + 1]
    bhh = align16(bih + 4 * H3);
    hpT = align16(bhh + 4 * H3);
    xT = align16(hpT + 4 * 2 * Hh * kBwdRows);       // hprev^T [Hp, rows]
    dhp = align16(xT + 4 * static_cast<size_t>(D) * kBwdRows);  // x^T [D, rows]
    dnx = align16(dhp + 2 * kBwdRows * ldh);         // dhp bf16 [rows, ldh]
    total = align16(dnx + 2 * kBwdRows * static_cast<size_t>(H));  // dn_pre bf16 [rows, H]
  }
};

__device__ __forceinline__ void unpack8(const uint4 v, float* f) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    f[2 * u] = __uint_as_float(w[u] << 16);
    f[2 * u + 1] = __uint_as_float(w[u] & 0xffff0000u);
  }
}

// The first kernel of this port, kept for the widths the tensor-core route
// does not take. A persistent block of (H, 3) threads walks the row tiles
// blockIdx.x, + gridDim.x, ... (24 rows each, kBwdRows) for all T steps in
// reverse; per step, thread (j, y) recomputes the gates of unit j for 8
// rows (kStored loads them), advances its f32 dh carry, writes the rounded
// dhp (and dxp's n part) to shared memory, then forms dh_{t-1} = dh z +
// dhp @ W_hh^T; thread c (of 3H) owns gate column c of the block's partial
// dW_hh | db_hh | dW_ih | db_ih in its slice of the device workspace
// partial [gridDim.x, (H+1) + (D+1), 3H] (L2), summed in block order by
// gru_bwd_reduce_kernel; with dx, threads form dxp @ W_ih^T. W_hh sits in
// shared memory as bf16 pairs along k with an odd row stride (row-wise and
// column-wise reads free of bank conflicts). All products on the f32 FMA
// units.
template <bool kStored>
__global__ void gru_bwd_kernel(const float* __restrict__ x, int64_t xsn, int64_t xst,
                               const __nv_bfloat16* __restrict__ hs,
                               const __nv_bfloat16* __restrict__ gates,
                               const float* __restrict__ g, int64_t gsn, int64_t gst,
                               int seq_cot, int N, int T, int D, int H,
                               const __nv_bfloat16* __restrict__ w_ih,
                               const float* __restrict__ b_ih,
                               const __nv_bfloat16* __restrict__ w_hh,
                               const float* __restrict__ b_hh, float* __restrict__ dx,
                               float* __restrict__ partial, int num_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdSmem L(D, H);
  const int H3 = 3 * H;
  const int Hh = (H + 1) / 2;
  const int Hp = 2 * Hh;
  const int ldh = (H3 + 7) & ~7;
  const int ldw = ldh + 1;  // odd: conflict-free column reads
  __nv_bfloat162* whh2 = reinterpret_cast<__nv_bfloat162*>(smem + L.whh2);
  const size_t slice = static_cast<size_t>(H + D + 2) * 3 * H;
  float* dws = partial + blockIdx.x * slice;
  float* bih = reinterpret_cast<float*>(smem + L.bih);
  float* bhh = reinterpret_cast<float*>(smem + L.bhh);
  float* hpT = reinterpret_cast<float*>(smem + L.hpT);
  float* xT = reinterpret_cast<float*>(smem + L.xT);
  __nv_bfloat16* dhp = reinterpret_cast<__nv_bfloat16*>(smem + L.dhp);
  __nv_bfloat16* dnx = reinterpret_cast<__nv_bfloat16*>(smem + L.dnx);

  const int j = threadIdx.x;
  const int r0 = threadIdx.y * kBwdRowsPerThread;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;  // also the gate column c
  const int nthr = blockDim.x * blockDim.y;                 // == 3H
  float* pih = dws + static_cast<size_t>(H + 1) * H3;

  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  for (int e = tid; e < Hh * ldw; e += nthr) {
    const int kk = e / ldw, c = e - kk * ldw;
    const __nv_bfloat16 lo = c < H3 ? w_hh[static_cast<size_t>(2 * kk) * H3 + c] : zero;
    const __nv_bfloat16 hi =
        (c < H3 && 2 * kk + 1 < H) ? w_hh[static_cast<size_t>(2 * kk + 1) * H3 + c] : zero;
    whh2[e] = __halves2bfloat162(lo, hi);
  }
  for (int q = 0; q <= H; ++q) dws[static_cast<size_t>(q) * H3 + tid] = 0.0f;
  if (!kStored) {
    for (int e = tid; e < H3; e += nthr) {
      bih[e] = b_ih[e];
      bhh[e] = b_hh[e];
    }
  }
  for (int e = tid; e < (Hp - H) * kBwdRows; e += nthr) hpT[H * kBwdRows + e] = 0.0f;
  for (int e = tid; e < kBwdRows * ldh; e += nthr) dhp[e] = zero;  // pad columns stay 0
  for (int q = 0; q <= D; ++q) pih[static_cast<size_t>(q) * H3 + tid] = 0.0f;
  __syncthreads();

  for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int row0 = tile * kBwdRows;
    float dh[kBwdRowsPerThread];
#pragma unroll
    for (int i = 0; i < kBwdRowsPerThread; ++i) {
      const int row = row0 + r0 + i;
      dh[i] = (!seq_cot && row < N) ? g[row * gsn + j] : 0.0f;
    }

    for (int t = T - 1; t >= 0; --t) {
      // stage the tile's x[t] (bf16-rounded) and hprev = hs[t-1], transposed
      for (int e = tid; e < kBwdRows * D; e += nthr) {
        const int r = e / D, d = e - r * D, row = row0 + r;
        xT[d * kBwdRows + r] = row < N ? bf16_round(x[row * xsn + t * xst + d]) : 0.0f;
      }
      for (int e = tid; e < kBwdRows * H; e += nthr) {
        const int r = e / H, k = e - r * H, row = row0 + r;
        hpT[k * kBwdRows + r] =
            (t > 0 && row < N) ? __bfloat162float(hs[(static_cast<size_t>(t - 1) * N + row) * H + k])
                               : 0.0f;
      }
      __syncthreads();

      // A: gates, the dh carry, rounded dhp / dxp
      float ddir[kBwdRowsPerThread];
      {
        float gr[kBwdRowsPerThread], gz[kBwdRowsPerThread], gn[kBwdRowsPerThread],
            ghn[kBwdRowsPerThread];
        if (kStored) {
#pragma unroll
          for (int i = 0; i < kBwdRowsPerThread; ++i) {
            const int row = row0 + r0 + i;
            if (row < N) {
              const __nv_bfloat16* gt = gates + (static_cast<size_t>(t) * N + row) * (4 * H);
              gr[i] = __bfloat162float(gt[j]);
              gz[i] = __bfloat162float(gt[H + j]);
              gn[i] = __bfloat162float(gt[2 * H + j]);
              ghn[i] = __bfloat162float(gt[3 * H + j]);
            } else {
              gr[i] = gz[i] = gn[i] = ghn[i] = 0.0f;
            }
          }
        } else {
          float ar[kBwdRowsPerThread], az[kBwdRowsPerThread], an[kBwdRowsPerThread];
#pragma unroll
          for (int i = 0; i < kBwdRowsPerThread; ++i) ar[i] = az[i] = an[i] = 0.0f;
#pragma unroll 2
          for (int kk = 0; kk < Hh; ++kk) {
            const __nv_bfloat162* wrow = whh2 + static_cast<size_t>(kk) * ldw;
            const float2 wr = __bfloat1622float2(wrow[j]);
            const float2 wz = __bfloat1622float2(wrow[H + j]);
            const float2 wn = __bfloat1622float2(wrow[2 * H + j]);
            const float* h0 = hpT + (2 * kk) * kBwdRows + r0;
            const float* h1 = h0 + kBwdRows;
            const float4 a0 = *reinterpret_cast<const float4*>(h0);
            const float4 a1 = *reinterpret_cast<const float4*>(h0 + 4);
            const float4 b0 = *reinterpret_cast<const float4*>(h1);
            const float4 b1 = *reinterpret_cast<const float4*>(h1 + 4);
            const float hx[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const float hy[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < kBwdRowsPerThread; ++i) {
              ar[i] = fmaf(hx[i], wr.x, ar[i]);
              ar[i] = fmaf(hy[i], wr.y, ar[i]);
              az[i] = fmaf(hx[i], wz.x, az[i]);
              az[i] = fmaf(hy[i], wz.y, az[i]);
              an[i] = fmaf(hx[i], wn.x, an[i]);
              an[i] = fmaf(hy[i], wn.y, an[i]);
            }
          }
#pragma unroll
          for (int i = 0; i < kBwdRowsPerThread; ++i) {
            float xr = 0.0f, xz = 0.0f, xn = 0.0f;
            for (int d = 0; d < D; ++d) {
              const float xv = xT[d * kBwdRows + r0 + i];
              const __nv_bfloat16* w = w_ih + static_cast<size_t>(d) * H3;
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
            gr[i] = bwd_sigmoid(xr + hr);
            gz[i] = bwd_sigmoid(xz + hz);
            gn[i] = tanhf(xn + gr[i] * hn);
            ghn[i] = hn;
          }
        }
#pragma unroll
        for (int i = 0; i < kBwdRowsPerThread; ++i) {
          const int r = r0 + i, row = row0 + r;
          float dr_pre = 0.0f, dz_pre = 0.0f, dn_pre = 0.0f, dhn = 0.0f;
          ddir[i] = 0.0f;
          if (row < N) {
            const float d = seq_cot ? dh[i] + g[row * gsn + t * gst + j] : dh[i];
            const float r_ = gr[i], z_ = gz[i], n_ = gn[i];
            const float hprev = hpT[j * kBwdRows + r];
            const float dn = d * (1.0f - z_);
            const float dz = d * (hprev - n_);
            ddir[i] = d * z_;
            dn_pre = dn * (1.0f - n_ * n_);
            const float dr = dn_pre * ghn[i];
            dhn = dn_pre * r_;
            dr_pre = dr * r_ * (1.0f - r_);
            dz_pre = dz * z_ * (1.0f - z_);
          }
          dhp[r * ldh + j] = __float2bfloat16_rn(dr_pre);
          dhp[r * ldh + H + j] = __float2bfloat16_rn(dz_pre);
          dhp[r * ldh + 2 * H + j] = __float2bfloat16_rn(dhn);
          dnx[r * H + j] = __float2bfloat16_rn(dn_pre);
        }
      }
      __syncthreads();

      // B1: dh_{t-1} = dh * z + dhp @ W_hh^T for unit j of this thread's rows
      {
        float acc[kBwdRowsPerThread];
#pragma unroll
        for (int i = 0; i < kBwdRowsPerThread; ++i) acc[i] = 0.0f;
        const __nv_bfloat162* wk = whh2 + static_cast<size_t>(j >> 1) * ldw;
        const bool odd = j & 1;
        for (int c8 = 0; c8 < ldh; c8 += 8) {
          float w[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const __nv_bfloat162 p = wk[c8 + u];
            w[u] = odd ? __high2float(p) : __low2float(p);
          }
#pragma unroll
          for (int i = 0; i < kBwdRowsPerThread; ++i) {
            float v[8];
            unpack8(*reinterpret_cast<const uint4*>(dhp + (r0 + i) * ldh + c8), v);
#pragma unroll
            for (int u = 0; u < 8; ++u) acc[i] = fmaf(v[u], w[u], acc[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < kBwdRowsPerThread; ++i) dh[i] = ddir[i] + acc[i];
      }

      // B2: thread c adds this step's rows to gate column c of the partials
      {
        const int c = tid;
        float col[kBwdRows];
#pragma unroll
        for (int r = 0; r < kBwdRows; ++r) col[r] = __bfloat162float(dhp[r * ldh + c]);
        for (int q = 0; q < H; ++q) {
          const float* hq = hpT + q * kBwdRows;
          float acc = dws[q * H3 + c];
#pragma unroll
          for (int r4 = 0; r4 < kBwdRows; r4 += 4) {
            const float4 h4 = *reinterpret_cast<const float4*>(hq + r4);
            acc = fmaf(h4.x, col[r4], acc);
            acc = fmaf(h4.y, col[r4 + 1], acc);
            acc = fmaf(h4.z, col[r4 + 2], acc);
            acc = fmaf(h4.w, col[r4 + 3], acc);
          }
          dws[q * H3 + c] = acc;
        }
        float sum = dws[H * H3 + c];
#pragma unroll
        for (int r = 0; r < kBwdRows; ++r) sum += col[r];
        dws[H * H3 + c] = sum;
        if (c >= 2 * H) {  // dxp's n part is dn_pre, not dhn
#pragma unroll
          for (int r = 0; r < kBwdRows; ++r) col[r] = __bfloat162float(dnx[r * H + c - 2 * H]);
        }
        for (int q = 0; q < D; ++q) {
          const float* xq = xT + q * kBwdRows;
          float acc = pih[static_cast<size_t>(q) * H3 + c];
#pragma unroll
          for (int r = 0; r < kBwdRows; ++r) acc = fmaf(xq[r], col[r], acc);
          pih[static_cast<size_t>(q) * H3 + c] = acc;
        }
        sum = pih[static_cast<size_t>(D) * H3 + c];
#pragma unroll
        for (int r = 0; r < kBwdRows; ++r) sum += col[r];
        pih[static_cast<size_t>(D) * H3 + c] = sum;
      }

      // B3: dx[row, t] = dxp @ W_ih^T
      if (dx != nullptr) {
        for (int e = tid; e < kBwdRows * D; e += nthr) {
          const int r = e / D, d = e - r * D, row = row0 + r;
          if (row >= N) continue;
          const __nv_bfloat16* wd = w_ih + static_cast<size_t>(d) * H3;
          const __nv_bfloat16* pr = dhp + r * ldh;
          const __nv_bfloat16* nr = dnx + r * H;
          float acc = 0.0f;
          for (int c = 0; c < 2 * H; ++c)
            acc = fmaf(__bfloat162float(pr[c]), __bfloat162float(wd[c]), acc);
          for (int c = 0; c < H; ++c)
            acc = fmaf(__bfloat162float(nr[c]), __bfloat162float(wd[2 * H + c]), acc);
          dx[(static_cast<size_t>(row) * T + t) * D + d] = acc;
        }
      }
      __syncthreads();
    }
  }
}

// out[e] = sum over blocks b, in order, of partial[b, e]
__global__ void gru_bwd_reduce_kernel(const float* __restrict__ partial, int nblocks, int n,
                                      float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.0f;
  for (int b = 0; b < nblocks; ++b) s += partial[static_cast<size_t>(b) * n + e];
  out[e] = s;
}

// ------------------------------------------------------------ the tensor-core route

// element offset of (r, c) in a K-major bf16 tile of 16 columns under the
// 32-byte swizzle (desc_k32): the x tile and W_ih^T for D <= 16
__device__ __forceinline__ int sw32_off(int r, int c) {
  return r * 16 + ((((c >> 3) ^ (r >> 2)) & 1) << 3) + (c & 7);
}

// bytes of the x tile / W_ih^T of `rows` rows: K-major under the 32-byte
// swizzle for D <= 16 (kSmallX), else swz_h halves
__host__ __device__ inline size_t bwd_x_bytes(int rows, int D) {
  return D <= 16 ? static_cast<size_t>(rows) * 32 : tc_tile_bytes(rows, tc_dp(D));
}

// W_ih^T streamed (v2 where it does not fit beside W_hh^T and the tiles):
// kWihStages stages of one 16-column k-step each, [3 Hp, 16] under the
// 32-byte swizzle, copied from a pre-swizzled global copy (gru_wq_kernel)
constexpr int kWihStages = 2;

// Shared memory of the recurrent kernel: W_hh^T, nbuf dhp | dn tiles, and
// for v2 W_ih^T (or with stream_w its stages and their mbarriers), nbuf
// hprev and x tiles and the biases; 1024 to align.
inline size_t bwd_tc_smem(int D, int H, bool stored, int nbuf, bool stream_w = false) {
  const int hp = tc_hp(H), r = 3 * hp;
  size_t n = 1024 + tc_tile_bytes(r, hp) + nbuf * tc_tile_bytes(kTcRows, 4 * hp);
  if (!stored)
    n += (stream_w ? kWihStages * bwd_x_bytes(r, 16) : bwd_x_bytes(r, D)) +
         nbuf * (tc_tile_bytes(kTcRows, hp) + bwd_x_bytes(kTcRows, D)) + sizeof(float) * 4 * hp +
         (stream_w ? 2 * kWihStages * sizeof(uint64_t) : 0);
  return (n + 1023) / 1024 * 1024;
}

// W_ih [D, 3H] as gru_bwd_tc_kernel's streamed stages read it: k-step kk
// (columns d = 16 kk ...) of W_ih^T, row gate Hp + j, at wq[kk R 16 +
// sw32_off(row, d % 16)], zero past D and H
__global__ void gru_wq_kernel(const __nv_bfloat16* __restrict__ w_ih, int D, int H, int HP,
                              int kx, __nv_bfloat16* __restrict__ wq) {
  const int R = 3 * HP;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= kx * R * 16) return;
  const int kk = e / (R * 16), r = (e / 16) % R, c = e % 16;
  const int d = 16 * kk + c, gate = r / HP, j = r - gate * HP;
  wq[kk * R * 16 + sw32_off(r, c)] =
      d < D && j < H ? w_ih[d * 3 * H + gate * H + j] : __float2bfloat16_rn(0.0f);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

struct BwdTcArgs {
  CUtensorMap map_ws;  // the workspace [T, N, 4 Hp] bf16, store boxes of 64 x 64
  const float* x;
  int64_t xsn, xst;
  const __nv_bfloat16* hs;     // [T, N, H]
  const __nv_bfloat16* gates;  // kStored: [T, N, 4H]
  const float* g;
  int64_t gsn, gst;
  int seq_cot;
  int N, T, D, H;
  const __nv_bfloat16* w_ih;
  const float* b_ih;
  const __nv_bfloat16* w_hh;
  const float* b_hh;
  const __nv_bfloat16* wq;  // kStreamW: gru_wq_kernel's copy of W_ih^T
  int nbuf;  // 2: the step's tiles double-buffered, one barrier a step; 1: two barriers
};

// bf16 pair (base[i], base[i + 1]) of columns j, j + 1 of width W (0 past W)
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* base, size_t i, int j, int W) {
  if (j + 1 < W && W % 2 == 0) return __ldg(reinterpret_cast<const unsigned int*>(base + i));
  const uint32_t lo = j < W ? __bfloat16_as_ushort(base[i]) : 0u;
  const uint32_t hi = j + 1 < W ? __bfloat16_as_ushort(base[i + 1]) : 0u;
  return lo | hi << 16;
}

__device__ __forceinline__ float bf_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi(uint32_t v) { return __uint_as_float(v & 0xFFFF0000u); }

template <int HW, bool kStored, bool kSmallX, bool kStreamW = false>
__global__ void __launch_bounds__(kTcThreads, 1)
    gru_bwd_tc_kernel(const __grid_constant__ BwdTcArgs p) {
  constexpr int NT = HW / 8;  // n-tiles of 8 units a gate
  constexpr int HP = kTcWarpgroups * HW;
  constexpr int R = 3 * HP;  // rows of W^T, gate-major
  constexpr int KH = HP / 16;
  constexpr int KC = R / 16;                     // the chain's k-steps
  constexpr int HPC = HP / 8;                    // 16-byte pieces of an hprev row
  constexpr int HPQ = (kTcRows * HPC + kTcThreads - 1) / kTcThreads;  // pieces a thread
  const int N = p.N, T = p.T, D = p.D, H = p.H, nbuf = p.nbuf;
  const int dp = tc_dp(D), kx = dp / 16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  __nv_bfloat16* whh = reinterpret_cast<__nv_bfloat16*>(sm);  // swz_h(R, g Hp + j, k)
  unsigned char* at = sm + tc_tile_bytes(R, HP);
  __nv_bfloat16* dpn = reinterpret_cast<__nv_bfloat16*>(at);  // nbuf x swz_h(64, m, 4 Hp cols)
  const int dsz = tc_tile_bytes(kTcRows, 4 * HP) / 2;
  at += nbuf * tc_tile_bytes(kTcRows, 4 * HP);
  __nv_bfloat16* wih = reinterpret_cast<__nv_bfloat16*>(at);  // v2: W_ih^T (or its stages)
  at += kStored ? 0 : kStreamW ? kWihStages * bwd_x_bytes(R, 16) : bwd_x_bytes(R, D);
  __nv_bfloat16* hbuf = reinterpret_cast<__nv_bfloat16*>(at);  // v2: nbuf x swz_h(64, m, k)
  const int hsz = tc_tile_bytes(kTcRows, HP) / 2, xsz = bwd_x_bytes(kTcRows, D) / 2;
  at += kStored ? 0 : nbuf * tc_tile_bytes(kTcRows, HP);
  __nv_bfloat16* xbuf = reinterpret_cast<__nv_bfloat16*>(at);  // v2: nbuf x tiles
  at += kStored ? 0 : nbuf * bwd_x_bytes(kTcRows, D);
  float* bias = reinterpret_cast<float*>(at);  // v2: b_ir + b_hr | b_iz + b_hz | b_in | b_hn
  // kStreamW: a stage is full (the copy landed) and empty (four warpgroups read it)
  uint64_t* wfull = reinterpret_cast<uint64_t*>(bias + 4 * HP);
  uint64_t* wempty = wfull + kWihStages;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kTcRows;
  const int H3 = 3 * H;

  // zero the weights (padding stays 0) and the v2 tiles, then fill
  {
    const size_t words = (tc_tile_bytes(R, HP) + nbuf * tc_tile_bytes(kTcRows, 4 * HP) +
                          (kStored ? 0
                                   : (kStreamW ? kWihStages * bwd_x_bytes(R, 16)
                                               : bwd_x_bytes(R, D)) +
                                         nbuf * (tc_tile_bytes(kTcRows, HP) +
                                                 bwd_x_bytes(kTcRows, D)))) / 16;
    for (size_t e = tid; e < words; e += kTcThreads)
      reinterpret_cast<uint4*>(sm)[e] = make_uint4(0, 0, 0, 0);
  }
  if (kStreamW && tid == 0) {
    for (int i = 0; i < kWihStages; ++i) {
      mbar_init(&wfull[i], 1);
      mbar_init(&wempty[i], kTcWarpgroups);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // W [K, 3H] into W^T: column c = gate H + j becomes row gate Hp + j
  for (int e = tid; e < H * H3; e += kTcThreads) {
    const int k = e / H3, c = e - k * H3, gate = c / H, j = c - gate * H;
    whh[swz_h(R, gate * HP + j, k)] = p.w_hh[e];
  }
  if (!kStored && !kStreamW) {
    for (int e = tid; e < D * H3; e += kTcThreads) {
      const int d = e / H3, c = e - d * H3, gate = c / H, j = c - gate * H;
      wih[kSmallX ? sw32_off(gate * HP + j, d) : swz_h(R, gate * HP + j, d)] = p.w_ih[e];
    }
  }
  if (!kStored) {
    for (int j = tid; j < HP; j += kTcThreads) {
      const bool u = j < H;
      bias[j] = u ? p.b_ih[j] + p.b_hh[j] : 0.0f;
      bias[HP + j] = u ? p.b_ih[H + j] + p.b_hh[H + j] : 0.0f;
      bias[2 * HP + j] = u ? p.b_ih[2 * H + j] : 0.0f;
      bias[3 * HP + j] = u ? p.b_hh[2 * H + j] : 0.0f;
    }
  }

  const int warp = tid >> 5, wg = warp >> 2, v = warp & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  int rows[2];  // this thread's two rows, -1 past N
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 16 * v + g + 8 * h;
    rows[h] = row < N ? row : -1;
  }
  auto unit = [&](int nt) { return wg * HW + 8 * nt + 2 * t4; };  // units unit, unit + 1

  // v2 operand tiles of step s: x[s] (rounded) and hprev = hs[s - 1]
  const int xd = tid % dp, xrows = kTcThreads / dp, xm0 = tid / dp;
  const int xpass = xm0 < xrows ? (kTcRows - xm0 + xrows - 1) / xrows : 0;
  constexpr int XS = kTcRows * (kSmallX ? 16 : 128) / kTcThreads;
  float xr[kStored ? 1 : XS];
  uint4 hr[kStored ? 1 : HPQ];
  auto tiles_load = [&](int s) {
    if constexpr (!kStored) {
#pragma unroll
      for (int q = 0; q < XS; ++q) {
        const int row = row0 + xm0 + q * xrows;
        xr[q] = (q < xpass && xd < D && row < N) ? p.x[row * p.xsn + s * p.xst + xd] : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < HPQ; ++q) {
        const int idx = tid + q * kTcThreads, m = idx / HPC, c = 8 * (idx - m * HPC);
        const int row = row0 + m;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (m < kTcRows && s > 0 && row < N && c < H) {
          const __nv_bfloat16* src = p.hs + (static_cast<size_t>(s - 1) * N + row) * H + c;
          if (H % 8 == 0) {
            val = __ldg(reinterpret_cast<const uint4*>(src));
          } else {
            uint32_t w[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) w[u] = load_pair(src, 2 * u, c + 2 * u, H);
            val = make_uint4(w[0], w[1], w[2], w[3]);
          }
        }
        hr[q] = val;
      }
    }
  };
  auto tiles_put = [&](int buf) {
    if constexpr (!kStored) {
      __nv_bfloat16* xb = xbuf + buf * xsz;
#pragma unroll
      for (int q = 0; q < XS; ++q)
        if (q < xpass)
          xb[kSmallX ? sw32_off(xm0 + q * xrows, xd) : swz_h(kTcRows, xm0 + q * xrows, xd)] =
              __float2bfloat16_rn(xr[q]);
      __nv_bfloat16* hb = hbuf + buf * hsz;
#pragma unroll
      for (int q = 0; q < HPQ; ++q) {
        const int idx = tid + q * kTcThreads, m = idx / HPC, c = 8 * (idx - m * HPC);
        if (m < kTcRows) *reinterpret_cast<uint4*>(hb + swz_h(kTcRows, m, c)) = hr[q];
      }
    }
  };
  // v3: this thread's stored gates (r z n hn pairs) and hs[s - 1] of step s
  uint32_t gt[kStored ? 2 : 1][kStored ? NT : 1][4], hq[kStored ? 2 : 1][kStored ? NT : 1];
  auto regs_load = [&](int s) {
    if constexpr (kStored) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int j = unit(nt);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            gt[h][nt][q] =
                rows[h] >= 0
                    ? load_pair(p.gates, (static_cast<size_t>(s) * N + rows[h]) * 4 * H + q * H + j,
                                j, H)
                    : 0u;
          hq[h][nt] = (rows[h] >= 0 && s > 0)
                          ? load_pair(p.hs, (static_cast<size_t>(s - 1) * N + rows[h]) * H + j,
                                      j, H)
                          : 0u;
        }
    }
  };
  // the cotangent of step s (seq_cot) or h_last's, pairs of this thread's units
  float gc[2][NT][2];
  auto g_load = [&](int s) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = unit(nt) + e;
          gc[h][nt][e] = rows[h] >= 0 && j < H ? p.g[rows[h] * p.gsn + s * p.gst + j] : 0.0f;
        }
  };

  float dh[2][NT][2];  // the f32 dh carry of this thread's rows and units
  g_load(p.seq_cot ? T - 1 : 0);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) dh[h][nt][e] = p.seq_cot ? 0.0f : gc[h][nt][e];
  tiles_load(T - 1);
  tiles_put(0);
  regs_load(T - 1);
  fence_proxy_async();
  __syncthreads();
  // kStreamW: W_ih^T's k-steps q = 0, 1, ... of the whole walk (k-step q %
  // kx), stage q % kWihStages, refilled with q + kWihStages once read
  const int wq_total = kStreamW ? T * kx : 0;
  const uint32_t wq_bytes = R * 32;
  auto wq_copy = [&](int q) {
    const int s = q % kWihStages;
    mbar_expect(&wfull[s], wq_bytes);
    bulk_load(wih + s * (R * 16), p.wq + static_cast<size_t>(q % kx) * R * 16, wq_bytes,
              &wfull[s]);
  };
  if (kStreamW && tid == 0)
    for (int q = 0; q < kWihStages && q < wq_total; ++q) wq_copy(q);
  int wq_next = 0;  // the next k-step to read

  float ar[HW / 2], az[HW / 2], axn[HW / 2], ahn[HW / 2];  // v2: the recomputed projections
  float ch[HW / 2];                                        // the chain's product
  uint32_t hpv[2][NT];  // hprev pairs of this thread's rows and units
  int cur = 0;
  for (int t = T - 1; t >= 0; --t) {
    const int nxt = nbuf == 2 ? cur ^ 1 : cur;
    if constexpr (!kStored) {
      // the forward's products: [r z xn] = x_t W_ih (x steps first), then
      // r, z += h W_hh and hn = h W_hh, k-step by k-step
      const __nv_bfloat16* hb = hbuf + cur * hsz;
      const __nv_bfloat16* xb = xbuf + cur * xsz;
      const int n0 = wg * HW;
      if constexpr (kStreamW) {
        // x steps one stage at a time: each warpgroup frees the stage once
        // its products have read it, and thread 0 refills it
        for (int kk = 0; kk < kx; ++kk, ++wq_next) {
          const int s = wq_next % kWihStages;
          const uint32_t ph = (wq_next / kWihStages) & 1;
          mbar_wait(&wfull[s], ph);
          const __nv_bfloat16* wst = wih + s * (R * 16);
          const uint64_t da = desc_h(xb + swz_h(kTcRows, 0, 16 * kk), kTcRows);
          wgmma_fence();
          mma_n<HW>(ar, da, desc_k32(wst + sw32_off(n0, 0)), kk);
          mma_n<HW>(az, da, desc_k32(wst + sw32_off(HP + n0, 0)), kk);
          mma_n<HW>(axn, da, desc_k32(wst + sw32_off(2 * HP + n0, 0)), kk);
          wgmma_commit();
          wgmma_wait<0>();
          if ((tid & 127) == 0) mbar_arrive(&wempty[s]);
          if (tid == 0 && wq_next + kWihStages < wq_total) {
            mbar_wait(&wempty[s], ph);
            wq_copy(wq_next + kWihStages);
          }
          __syncwarp();
        }
      }
      wgmma_fence();
      for (int kk = 0; kk < (kStreamW ? 0 : kx); ++kk) {
        const uint64_t da =
            kSmallX ? desc_k32(xb) : desc_h(xb + swz_h(kTcRows, 0, 16 * kk), kTcRows);
        auto db = [&](int gate) {
          return kSmallX ? desc_k32(wih + sw32_off(gate * HP + n0, 0))
                         : desc_h(wih + swz_h(R, gate * HP + n0, 16 * kk), R);
        };
        mma_n<HW>(ar, da, db(0), kk);
        mma_n<HW>(az, da, db(1), kk);
        mma_n<HW>(axn, da, db(2), kk);
      }
#pragma unroll
      for (int kk = 0; kk < KH; ++kk) {
        const uint64_t da = desc_h(hb + swz_h(kTcRows, 0, 16 * kk), kTcRows);
        mma_n<HW>(ar, da, desc_h(whh + swz_h(R, n0, 16 * kk), R), 1);
        mma_n<HW>(az, da, desc_h(whh + swz_h(R, HP + n0, 16 * kk), R), 1);
        mma_n<HW>(ahn, da, desc_h(whh + swz_h(R, 2 * HP + n0, 16 * kk), R), kk);
      }
      wgmma_commit();
      if (t > 0) tiles_load(t - 1);  // the next step's tiles, while the products run
      wgmma_wait<0>();
      pin_n(ar);
      pin_n(az);
      pin_n(axn);
      pin_n(ahn);
      // hprev of this thread's rows and units, before the tile may change
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          hpv[h][nt] = *reinterpret_cast<const uint32_t*>(
              hb + swz_h(kTcRows, 16 * v + g + 8 * h, unit(nt)));
    }
    if (nbuf == 1) {
      // every warpgroup's products have read the tiles and the last step's
      // chain the dhp tile, which the last store has read too
      if (tid == 0) bulk_wait_read();
      __syncthreads();
    }
    __nv_bfloat16* dt = dpn + cur * dsz;
    // the elementwise math of each live row, in the accumulators' layout
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 16 * v + g + 8 * h;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int j = unit(nt);
        uint32_t hp2;
        float gr[2], gz[2], gn[2], ghn[2];
        if constexpr (kStored) {
          hp2 = hq[h][nt];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            gr[e] = e ? bf_hi(gt[h][nt][0]) : bf_lo(gt[h][nt][0]);
            gz[e] = e ? bf_hi(gt[h][nt][1]) : bf_lo(gt[h][nt][1]);
            gn[e] = e ? bf_hi(gt[h][nt][2]) : bf_lo(gt[h][nt][2]);
            ghn[e] = e ? bf_hi(gt[h][nt][3]) : bf_lo(gt[h][nt][3]);
          }
        } else {
          hp2 = hpv[h][nt];
          const float2 br = *reinterpret_cast<const float2*>(bias + j);
          const float2 bz = *reinterpret_cast<const float2*>(bias + HP + j);
          const float2 bi = *reinterpret_cast<const float2*>(bias + 2 * HP + j);
          const float2 bh = *reinterpret_cast<const float2*>(bias + 3 * HP + j);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = nt * 4 + 2 * h + e;
            const float r = sigmoid(ar[i] + (e ? br.y : br.x));
            const float z = sigmoid(az[i] + (e ? bz.y : bz.x));
            const float hv = ahn[i] + (e ? bh.y : bh.x);
            gn[e] = tanhf(axn[i] + (e ? bi.y : bi.x) + r * hv);
            gr[e] = r, gz[e] = z, ghn[e] = hv;
          }
        }
        float o[4][2];  // dr_pre, dz_pre, dhn, dn_pre
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float d = p.seq_cot ? dh[h][nt][e] + gc[h][nt][e] : dh[h][nt][e];
          const float r = gr[e], z = gz[e], n = gn[e];
          const float hprev = e ? bf_hi(hp2) : bf_lo(hp2);
          const float dn = d * (1.0f - z);
          const float dzv = d * (hprev - n);
          dh[h][nt][e] = d * z;  // dh_direct; the chain adds dhp @ W_hh^T
          const float dn_pre = dn * (1.0f - n * n);
          const float dr = dn_pre * ghn[e];
          o[2][e] = dn_pre * r;
          o[0][e] = dr * r * (1.0f - r);
          o[1][e] = dzv * z * (1.0f - z);
          o[3][e] = dn_pre;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
          *reinterpret_cast<uint32_t*>(dt + swz_h(kTcRows, m, q * HP + j)) =
              pack_bf16(o[q][0], o[q][1]);
      }
    }
    if (t > 0) {
      tiles_put(nxt);
      regs_load(t - 1);
      if (p.seq_cot) g_load(t - 1);
    }
    fence_proxy_async();
    // the last store has read the tile the next step writes (nbuf 2)
    if (nbuf == 2 && tid == 0) bulk_wait_read();
    __syncthreads();  // the dhp | dn tile and the next step's tiles are visible
    if (tid == 0) {
      for (int c = 0; c < 4 * HP; c += 64)
        tma_store_3d(&p.map_ws, dt + swz_h(kTcRows, 0, c), c, row0, t);
      bulk_commit();
    }
    // dh_{t-1} = dh z + dhp @ W_hh^T[:, this warpgroup's units]: W^T read
    // with the transpose bit (N-contiguous), K = the 3 Hp dhp columns
    wgmma_fence();
#pragma unroll 4
    for (int kk = 0; kk < KC; ++kk) {
      const uint64_t da = desc_h(dt + swz_h(kTcRows, 0, 16 * kk), kTcRows);
      const __nv_bfloat16* b0 = whh + swz_h(R, 16 * kk, wg * HW);
      if constexpr (HW == 24) {  // N 16 + 8: no piece crosses a 64-column half
        mma_n<16, 1>(*reinterpret_cast<float(*)[8]>(ch), da, desc_h(b0, R), kk);
        mma_n<8, 1>(*reinterpret_cast<float(*)[4]>(ch + 8), da,
                    desc_h(whh + swz_h(R, 16 * kk, wg * HW + 16), R), kk);
      } else {
        mma_n<HW, 1>(ch, da, desc_h(b0, R), kk);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin_n(ch);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) dh[h][nt][e] += ch[nt * 4 + 2 * h + e];
    cur = nxt;
  }
  if (tid == 0) bulk_wait();
}

// ------------------------------------------------------------ the weight gradients

constexpr int kDwStagesG = 4;
constexpr int kDwThreadsG = 128;
constexpr int kDwChunk = 32;                   // rows (of one frame) a chunk
constexpr int kDwABytes = kDwChunk * 64 * 2;   // A: 32 rows x 64 of the operand's rows
constexpr int kDwStageBytes = kDwABytes + kDwChunk * 128 * 2;  // + B: 32 x 128 columns

struct GruDwArgs {
  CUtensorMap map_hs;  // hs [T, N, H], boxes (64, 32, 1)
  CUtensorMap map_xb;  // [x | 1] [T, N, Dq] bf16 (gru_xb_kernel), boxes (64, 32, 1)
  CUtensorMap map_ws;  // the workspace [T, N, 4 Hp], boxes (64, 32, 1)
  int tma_hs;
  const __nv_bfloat16* hs;
  int N, T, D, H, HP, mh, cpt;  // mh: 64-row blocks of [hprev | 1]; cpt: chunks a frame
  long chunks;
  float* partial;  // [gridDim.y, gridDim.x, 64, 128]
};

// [x | 1] for the weight gradients, frame-major as hs: xb[t, n, c] =
// bf16(x[n, t, c]) for c < D, 1 at c = D (the TPU kernel's ones column),
// 0 up to Dq (D + 1 rounded up to 8: rows TMA can take)
__global__ void gru_xb_kernel(const float* __restrict__ x, int64_t xsn, int64_t xst, int N,
                              int T, int D, int Dq, __nv_bfloat16* __restrict__ xb) {
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<size_t>(T) * N * Dq) return;
  const int c = static_cast<int>(e % Dq);
  const size_t tn = e / Dq;
  const int n = static_cast<int>(tn % N), t = static_cast<int>(tn / N);
  xb[e] = __float2bfloat16_rn(c < D ? x[n * xsn + t * xst + c] : c == D ? 1.0f : 0.0f);
}

__host__ __device__ inline int xb_width(int D) { return (D + 1 + 7) / 8 * 8; }

// Block (job, range): job = 3 * m-block + gate; m-blocks [0, mh) are the
// rows of [hprev | 1] (B: dr, dz, dhn), the rest those of [x | 1] (B: dr,
// dz, dn). One warpgroup: acc = sum over the range's chunks of A^T B, A
// [32 rows, 64] (M-contiguous), B [32 rows, 128] (N-contiguous; columns
// past Hp belong to the next gate and are dropped by the reduction). A
// and B arrive by TMA; hprev takes an element path at t = 0 and where H is
// not a multiple of 8, its loads issued together. A range's blocks read
// the same chunks side by side, but far enough apart that L2 does not
// keep them: the kernel moves each job's bytes from device memory (one
// block a job and four an SM ran faster than a block of all of a gate's
// jobs sharing one ring, which halves the bytes; PERF.md).
__global__ void __launch_bounds__(kDwThreadsG)
    gru_dw_kernel(const __grid_constant__ GruDwArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ uint64_t full[kDwStagesG];
  unsigned char* smem = align1024(smem_raw);
  const int job = blockIdx.x, tid = threadIdx.x;
  const int gate = job % 3, mb = job / 3, is_x = mb >= a.mh;
  const int m0 = (is_x ? mb - a.mh : mb) * 64;
  const int col0 = is_x && gate == 2 ? 3 * a.HP : gate * a.HP;
  const int ones = a.H - m0;  // hprev's ones column of A, if in [0, 64)
  const long c0 = a.chunks * blockIdx.y / gridDim.y;
  const int n = static_cast<int>(a.chunks * (blockIdx.y + 1) / gridDim.y - c0);
  if (tid == 0) {
    for (int i = 0; i < kDwStagesG; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto tma_a = [&](int t) { return is_x || (a.tma_hs && t > 0); };
  auto copy_next = [&](int q) {
    if (q >= n) return;
    unsigned char* st = smem + (q % kDwStagesG) * kDwStageBytes;
    __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(st);
    uint64_t* bar = &full[q % kDwStagesG];
    const long c = c0 + q;
    const int t = static_cast<int>(c / a.cpt);
    const int r0 = static_cast<int>(c - static_cast<long>(t) * a.cpt) * kDwChunk;
    if (tid == 0) {
      mbar_expect(bar, 2 * kDwChunk * 128 + (tma_a(t) ? kDwABytes : 0));
      for (int h = 0; h < 2; ++h)
        tma_load_3d(st + kDwABytes + h * kDwChunk * 128, &a.map_ws, col0 + 64 * h, r0, t, bar);
      if (is_x)
        tma_load_3d(st, &a.map_xb, m0, r0, t, bar);
      else if (tma_a(t))
        tma_load_3d(st, &a.map_hs, m0, r0, t - 1, bar);
    }
    if (!tma_a(t)) {  // hprev by the element path, the ones column included
      constexpr int kPer = kDwChunk * 64 / kDwThreadsG;
      __nv_bfloat16 v[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int idx = tid + i * kDwThreadsG, k = idx >> 6, col = m0 + (idx & 63), row = r0 + k;
        v[i] = col == a.H ? __float2bfloat16_rn(1.0f)
               : t > 0 && row < a.N && col < a.H
                   ? a.hs[(static_cast<size_t>(t - 1) * a.N + row) * a.H + col]
                   : __float2bfloat16_rn(0.0f);
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int idx = tid + i * kDwThreadsG;
        as[swz_h(kDwChunk, idx >> 6, idx & 63)] = v[i];
      }
    }
  };
  for (int q = 0; q < kDwStagesG - 1; ++q) copy_next(q);
  float acc[16][4] = {};
  for (int q = 0; q < n; ++q) {
    const int s = q % kDwStagesG;
    unsigned char* st = smem + s * kDwStageBytes;
    mbar_wait(&full[s], (q / kDwStagesG) & 1);
    // the ones column where TMA brought hprev (it read past H as 0)
    if (!is_x && tma_a(static_cast<int>((c0 + q) / a.cpt)) && ones >= 0 && ones < 64 &&
        tid < kDwChunk)
      reinterpret_cast<__nv_bfloat16*>(st)[swz_h(kDwChunk, tid, ones)] = __float2bfloat16_rn(1.0f);
    fence_proxy_async();  // element-path writes, for wgmma's reads
    __syncthreads();
    copy_next(q + kDwStagesG - 1);
    const __nv_bfloat16* as = reinterpret_cast<const __nv_bfloat16*>(st);
    const __nv_bfloat16* bs = reinterpret_cast<const __nv_bfloat16*>(st + kDwABytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      wgmma_ss_n128<1>(acc, desc_h(as + swz_h(kDwChunk, 16 * kk, 0), kDwChunk),
                       desc_h(bs + swz_h(kDwChunk, 16 * kk, 0), kDwChunk));
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc);
  }
  float* out = a.partial + (static_cast<size_t>(blockIdx.y) * gridDim.x + job) * 64 * 128;
  const int warp = tid >> 5, g = (tid & 31) >> 2, tq = tid & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = warp * 16 + g + 8 * h;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
      *reinterpret_cast<float2*>(out + m * 128 + nt * 8 + 2 * tq) =
          make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
  }
}

// out [(H+1) + (D+1), 3H] = dW_hh | db_hh | dW_ih | db_ih: each element the
// sum over the ranges, in order, of its job's partial
__global__ void gru_dw_reduce_kernel(const float* __restrict__ partial, int parts, int jobs,
                                     int mh, int D, int H, float* __restrict__ out) {
  const int H3 = 3 * H;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (H + D + 2) * H3) return;
  const int q = e / H3, c = e - q * H3, gate = c / H, j = c - gate * H;
  const int mrow = q <= H ? q : q - (H + 1);
  const int job = ((q <= H ? 0 : mh) + mrow / 64) * 3 + gate;
  const float* src = partial + (static_cast<size_t>(job) * 64 + mrow % 64) * 128 + j;
  float s = 0.0f;
  for (int p = 0; p < parts; ++p) s += src[static_cast<size_t>(p) * jobs * 64 * 128];
  out[e] = s;
}

// ------------------------------------------------------------ dx

struct GruDxArgs {
  CUtensorMap map_ws;  // the workspace, boxes (64, 64, 1)
  const __nv_bfloat16* w_ih;
  float* dx;
  int N, T, D, H, HP, kc, tiles_n;  // kc: dxp columns staged (dr | dz | dn, whole halves)
  long tiles;
};

constexpr int kDxThreads = 128;

// Blocks walk the tiles (frame t, 64 rows) blockIdx.x, + gridDim.x, ...;
// a tile's dr | dz | dn columns arrive by TMA into one of two stages while
// the last tile's products run; dx = dxp @ W_ih^T by wgmma (N in pieces of
// 16 columns), W_ih K-major in shared memory for the whole grid walk.
__global__ void __launch_bounds__(kDxThreads)
    gru_dx_kernel(const __grid_constant__ GruDxArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ uint64_t full[2];
  unsigned char* smem = align1024(smem_raw);
  const int kc = a.kc, dp = tc_dp(a.D), HP = a.HP, H = a.H;
  __nv_bfloat16* wt = reinterpret_cast<__nv_bfloat16*>(smem);  // swz_h(dp, d, c)
  const size_t wbytes = tc_tile_bytes(dp, kc), abytes = tc_tile_bytes(kTcRows, kc);
  unsigned char* ring = smem + wbytes;
  const int tid = threadIdx.x;
  for (size_t e = tid; e < wbytes / 16; e += kDxThreads)
    reinterpret_cast<uint4*>(wt)[e] = make_uint4(0, 0, 0, 0);
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // W_ih [D, 3H]: column gate H + j at staged column gate Hp + j (dn at 2 Hp + j)
  for (int e = tid; e < a.D * 3 * H; e += kDxThreads) {
    const int d = e / (3 * H), c = e - d * 3 * H, gate = c / H, j = c - gate * H;
    wt[swz_h(dp, d, gate * HP + j)] = a.w_ih[e];
  }
  const int nblk = static_cast<int>((a.tiles - blockIdx.x + gridDim.x - 1) / gridDim.x);
  const int rz_halves = 2 * HP / 64, n_halves = (HP + 63) / 64;
  auto copy = [&](int i) {
    if (i >= nblk || tid != 0) return;
    const long tile = blockIdx.x + static_cast<long>(i) * gridDim.x;
    const int t = static_cast<int>(tile / a.tiles_n);
    const int r0 = static_cast<int>(tile % a.tiles_n) * kTcRows;
    unsigned char* st = ring + (i & 1) * abytes;
    mbar_expect(&full[i & 1], (rz_halves + n_halves) * kTcRows * 128);
    for (int h = 0; h < rz_halves; ++h)
      tma_load_3d(st + h * kTcRows * 128, &a.map_ws, 64 * h, r0, t, &full[i & 1]);
    for (int h = 0; h < n_halves; ++h)
      tma_load_3d(st + (rz_halves + h) * kTcRows * 128, &a.map_ws, 3 * HP + 64 * h, r0, t,
                  &full[i & 1]);
  };
  fence_proxy_async();
  __syncthreads();
  copy(0);
  const int warp = tid >> 5, g = (tid & 31) >> 2, tq = tid & 3;
  const int npieces = dp / 16, ksteps = kc / 16;
  for (int i = 0; i < nblk; ++i) {
    mbar_wait(&full[i & 1], (i >> 1) & 1);
    copy(i + 1);  // the other stage: its last reader was tile i - 1, done below
    const long tile = blockIdx.x + static_cast<long>(i) * gridDim.x;
    const int t = static_cast<int>(tile / a.tiles_n);
    const int r0 = static_cast<int>(tile % a.tiles_n) * kTcRows;
    const __nv_bfloat16* as = reinterpret_cast<const __nv_bfloat16*>(ring + (i & 1) * abytes);
    for (int pc = 0; pc < npieces; pc += 8) {
      float acc[8][8];
      wgmma_fence();
      for (int kk = 0; kk < ksteps; ++kk) {
        const uint64_t da = desc_h(as + swz_h(kTcRows, 0, 16 * kk), kTcRows);
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (pc + u < npieces)
            mma_n<16>(acc[u], da, desc_h(wt + swz_h(dp, 16 * (pc + u), 16 * kk), dp), kk);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        pin_n(acc[u]);
        if (pc + u >= npieces) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + warp * 16 + g + 8 * h;
          if (row >= a.N) continue;
          float* o = a.dx + (static_cast<size_t>(row) * a.T + t) * a.D;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int d = 16 * (pc + u) + 8 * nt + 2 * tq + e;
              if (d < a.D) o[d] = acc[u][nt * 4 + 2 * h + e];
            }
        }
      }
    }
    __syncthreads();  // the stage is free for tile i + 2
  }
}

// ------------------------------------------------------------ route and launch

// Blocks of the FMA kernel an SM holds at (D, H) (0: its shared memory or
// its registers over 3H threads do not fit), after opting in to the former.
template <bool kStored>
int fma_occupancy(int D, int H, int smem_max, int* occ) {
  *occ = 0;
  const size_t smem = BwdSmem(D, H).total;
  if (3 * H > 1024 || smem > static_cast<size_t>(smem_max)) return 0;
  const auto kernel = gru_bwd_kernel<kStored>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, kernel, 3 * H, smem);
}

// Which kernels take (D, H): 1 the tensor-core route, 0 the FMA kernel, -1
// neither (shared memory, or the FMA kernel's registers); smem_max is the
// device's opt-in limit a block. *occ: the FMA kernel's blocks an SM;
// *stream_w: the tensor-core route streams W_ih^T (v2 at Hp = 128, D > 16).
template <bool kStored>
int bwd_route(int D, int H, int smem_max, int* route, int* occ, int* stream_w = nullptr) {
  *occ = 0;
  const size_t lim = static_cast<size_t>(smem_max);
  if (H <= 128 && D <= 128) {
    const bool res = bwd_tc_smem(D, H, kStored, 1) <= lim;
    const bool str = !kStored && D > 16 && bwd_tc_smem(D, H, false, 1, true) <= lim;
    if (res || str) {
      *route = 1;
      if (stream_w != nullptr) *stream_w = !res;
      return 0;
    }
  }
  const int code = fma_occupancy<kStored>(D, H, smem_max, occ);
  *route = *occ > 0 ? 0 : -1;
  return code;
}

inline size_t align256(size_t v) { return (v + 255) & ~static_cast<size_t>(255); }

// A launch's plan: the route, its grid and the workspace it needs.
struct BwdPlan {
  int route = -1, stream_w = 0, nbuf = 1, parts = 0, jobs = 0, mh = 0, fma_blocks = 0;
  size_t ws_bytes = 0, xb_off = 0, part_off = 0, wq_off = 0, bytes = 0;
};

inline int device_limits(int* smem_max, int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

template <bool kStored>
int bwd_plan(int N, int T, int D, int H, BwdPlan* pl) {
  if (N <= 0 || T <= 0 || D <= 0 || H <= 0) return SLDM_ERR_SHAPE;
  int smem_max = 0, sms = 0;
  int code = device_limits(&smem_max, &sms);
  if (code != 0) return code;
  int occ = 0;
  code = bwd_route<kStored>(D, H, smem_max, &pl->route, &occ, &pl->stream_w);
  if (code != 0) return code;
  if (pl->route < 0) return 3 * H > 1024 ? SLDM_ERR_SHAPE : SLDM_ERR_SMEM;
  if (pl->route == 1) {
    const int hp = tc_hp(H);
    pl->nbuf =
        bwd_tc_smem(D, H, kStored, 2, pl->stream_w) <= static_cast<size_t>(smem_max) ? 2 : 1;
    pl->mh = (H + 1 + 63) / 64;
    pl->jobs = 3 * (pl->mh + (D + 1 + 63) / 64);
    // ranges: one wave of the weight-gradient kernel's blocks
    const size_t dsmem = 1024 + kDwStagesG * kDwStageBytes;
    code = smem_opt_in(gru_dw_kernel, dsmem);
    if (code != 0) return code;
    int dw_occ = 0;
    cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&dw_occ, gru_dw_kernel, kDwThreadsG, dsmem);
    if (err != cudaSuccess) return err;
    if (dw_occ <= 0) return SLDM_ERR_SMEM;
    const long chunks = static_cast<long>(T) * ((N + kDwChunk - 1) / kDwChunk);
    const long want = std::max(1L, static_cast<long>(dw_occ) * sms / pl->jobs);
    pl->parts = static_cast<int>(std::min(want, chunks));
    pl->ws_bytes = align256(static_cast<size_t>(T) * N * 4 * hp * 2);
    pl->xb_off = pl->ws_bytes;
    pl->part_off = pl->xb_off + align256(static_cast<size_t>(T) * N * xb_width(D) * 2);
    pl->wq_off = pl->part_off + static_cast<size_t>(pl->parts) * pl->jobs * 64 * 128 * 4;
    pl->bytes = pl->wq_off + (pl->stream_w ? static_cast<size_t>(tc_dp(D)) * 3 * hp * 2 : 0);
    return 0;
  }
  const int tiles = (N + kBwdRows - 1) / kBwdRows;
  pl->fma_blocks = tiles < occ * sms ? tiles : occ * sms;
  pl->bytes = static_cast<size_t>(pl->fma_blocks) * (H + D + 2) * 3 * H * 4;
  return 0;
}

template <int HW, bool kStored, bool kSmallX, bool kStreamW = false>
int launch_bwd_tc(BwdTcArgs& a, cudaStream_t s) {
  const size_t smem = bwd_tc_smem(a.D, a.H, kStored, a.nbuf, kStreamW);
  const auto kernel = gru_bwd_tc_kernel<HW, kStored, kSmallX, kStreamW>;
  const int code = smem_opt_in(kernel, smem);
  if (code != 0) return code;
  kernel<<<(a.N + kTcRows - 1) / kTcRows, kTcThreads, smem, s>>>(a);
  return cudaGetLastError();
}

// The tensor-core route: the recurrence, the weight gradients (and their
// ordered sum into out), and with dx its product.
template <bool kStored>
int bwd_launch_tc(const BwdPlan& pl, const void* x, int64_t xsn, int64_t xst, const void* hs,
                  const void* gates, const void* g, int64_t gsn, int64_t gst, int seq_cot, int N,
                  int T, int D, int H, const void* w_ih, const void* b_ih, const void* w_hh,
                  const void* b_hh, void* dx, unsigned char* ws, void* out, cudaStream_t s) {
  const int hp = tc_hp(H);
  BwdTcArgs a{};
  if (!make_out_map(&a.map_ws, ws, 4 * hp, N, T)) return SLDM_ERR_SHAPE;
  a.x = static_cast<const float*>(x);
  a.xsn = xsn, a.xst = xst;
  a.hs = static_cast<const __nv_bfloat16*>(hs);
  a.gates = static_cast<const __nv_bfloat16*>(gates);
  a.g = static_cast<const float*>(g);
  a.gsn = gsn, a.gst = gst, a.seq_cot = seq_cot;
  a.N = N, a.T = T, a.D = D, a.H = H;
  a.w_ih = static_cast<const __nv_bfloat16*>(w_ih);
  a.b_ih = static_cast<const float*>(b_ih);
  a.w_hh = static_cast<const __nv_bfloat16*>(w_hh);
  a.b_hh = static_cast<const float*>(b_hh);
  a.nbuf = pl.nbuf;
  int code = SLDM_ERR_SHAPE;
  if (pl.stream_w) {
    const int kx = tc_dp(D) / 16, n = kx * 3 * hp * 16;
    __nv_bfloat16* wq = reinterpret_cast<__nv_bfloat16*>(ws + pl.wq_off);
    gru_wq_kernel<<<(n + 255) / 256, 256, 0, s>>>(static_cast<const __nv_bfloat16*>(w_ih), D, H,
                                                  hp, kx, wq);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    a.wq = wq;
  }
  const bool small_x = D <= 16;
  // W_ih^T is streamed only where Hp = 128 (bwd_route)
  switch (hp / kTcWarpgroups) {
#define SLDM_GRU_BWD_TC(HW_)                                                       \
  case HW_:                                                                        \
    if constexpr (kStored)                                                         \
      code = launch_bwd_tc<HW_, true, false>(a, s);                                \
    else if constexpr (HW_ == 32)                                                  \
      code = small_x       ? launch_bwd_tc<HW_, false, true>(a, s)                 \
             : pl.stream_w ? launch_bwd_tc<HW_, false, false, true>(a, s)          \
                           : launch_bwd_tc<HW_, false, false>(a, s);               \
    else if (!pl.stream_w)                                                         \
      code = small_x ? launch_bwd_tc<HW_, false, true>(a, s)                       \
                     : launch_bwd_tc<HW_, false, false>(a, s);                     \
    break;
    SLDM_GRU_BWD_TC(8)
    SLDM_GRU_BWD_TC(16)
    SLDM_GRU_BWD_TC(24)
    SLDM_GRU_BWD_TC(32)
#undef SLDM_GRU_BWD_TC
  }
  if (code != 0) return code;

  __nv_bfloat16* xb = reinterpret_cast<__nv_bfloat16*>(ws + pl.xb_off);
  const size_t nxb = static_cast<size_t>(T) * N * xb_width(D);
  gru_xb_kernel<<<static_cast<unsigned>((nxb + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(x), xsn, xst, N, T, D, xb_width(D), xb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  GruDwArgs d{};
  d.tma_hs = make_out_map(&d.map_hs, hs, H, N, T, kDwChunk);
  if (!make_out_map(&d.map_ws, ws, 4 * hp, N, T, kDwChunk) ||
      !make_out_map(&d.map_xb, xb, xb_width(D), N, T, kDwChunk))
    return SLDM_ERR_SHAPE;
  d.hs = static_cast<const __nv_bfloat16*>(hs);
  d.N = N, d.T = T, d.D = D, d.H = H, d.HP = hp, d.mh = pl.mh;
  d.cpt = (N + kDwChunk - 1) / kDwChunk;
  d.chunks = static_cast<long>(T) * d.cpt;
  d.partial = reinterpret_cast<float*>(ws + pl.part_off);
  const size_t dsmem = 1024 + kDwStagesG * kDwStageBytes;  // opted in by bwd_plan
  gru_dw_kernel<<<dim3(pl.jobs, pl.parts), kDwThreadsG, dsmem, s>>>(d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = (H + D + 2) * 3 * H;
  gru_dw_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(d.partial, pl.parts, pl.jobs, pl.mh, D, H,
                                                        static_cast<float*>(out));
  err = cudaGetLastError();
  if (err != cudaSuccess || dx == nullptr) return err;

  GruDxArgs x3{};
  if (!make_out_map(&x3.map_ws, ws, 4 * hp, N, T)) return SLDM_ERR_SHAPE;
  x3.w_ih = static_cast<const __nv_bfloat16*>(w_ih);
  x3.dx = static_cast<float*>(dx);
  x3.N = N, x3.T = T, x3.D = D, x3.H = H, x3.HP = hp;
  x3.kc = 2 * hp + 64 * ((hp + 63) / 64);
  x3.tiles_n = (N + kTcRows - 1) / kTcRows;
  x3.tiles = static_cast<long>(T) * x3.tiles_n;
  const size_t xsmem = 1024 + tc_tile_bytes(tc_dp(D), x3.kc) + 2 * tc_tile_bytes(kTcRows, x3.kc);
  code = smem_opt_in(gru_dx_kernel, xsmem);
  if (code != 0) return code;
  int grid = 0;
  code = persistent_grid(gru_dx_kernel, kDxThreads, xsmem, static_cast<int>(
      x3.tiles < (1L << 30) ? x3.tiles : (1L << 30)), &grid);
  if (code != 0) return code;
  gru_dx_kernel<<<grid, kDxThreads, xsmem, s>>>(x3);
  return cudaGetLastError();
}

// ws: the workspace of bwd_plan's size (bytes); out: [(H+1)+(D+1), 3H] f32 =
// dW_hh | db_hh | dW_ih | db_ih.
template <bool kStored>
int bwd_launch(const void* x, int64_t xsn, int64_t xst, const void* hs, const void* gates,
               const void* g, int64_t gsn, int64_t gst, int seq_cot, int N, int T, int D, int H,
               const void* w_ih, const void* b_ih, const void* w_hh, const void* b_hh, void* dx,
               void* ws, int64_t ws_bytes, void* out, void* stream) {
  BwdPlan pl;
  int code = bwd_plan<kStored>(N, T, D, H, &pl);
  if (code != 0) return code;
  if (ws == nullptr || static_cast<size_t>(ws_bytes) != pl.bytes) return SLDM_ERR_SHAPE;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pl.route == 1)
    return bwd_launch_tc<kStored>(pl, x, xsn, xst, hs, gates, g, gsn, gst, seq_cot, N, T, D, H,
                                  w_ih, b_ih, w_hh, b_hh, dx, static_cast<unsigned char*>(ws), out,
                                  s);
  const size_t smem = BwdSmem(D, H).total;
  gru_bwd_kernel<kStored><<<pl.fma_blocks, dim3(H, kBwdRowGroups), smem, s>>>(
      static_cast<const float*>(x), xsn, xst, static_cast<const __nv_bfloat16*>(hs),
      static_cast<const __nv_bfloat16*>(gates), static_cast<const float*>(g), gsn, gst, seq_cot,
      N, T, D, H, static_cast<const __nv_bfloat16*>(w_ih), static_cast<const float*>(b_ih),
      static_cast<const __nv_bfloat16*>(w_hh), static_cast<const float*>(b_hh),
      static_cast<float*>(dx), static_cast<float*>(ws), (N + kBwdRows - 1) / kBwdRows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = (H + D + 2) * 3 * H;
  gru_bwd_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(static_cast<const float*>(ws),
                                                         pl.fma_blocks, n,
                                                         static_cast<float*>(out));
  return cudaGetLastError();
}

// bwd_route for the current device
template <bool kStored>
int bwd_route_query(int D, int H, int* out) {
  int smem_max = 0, sms = 0, occ = 0;
  const int code = device_limits(&smem_max, &sms);
  if (code != 0) return code;
  return bwd_route<kStored>(D, H, smem_max, out, &occ);
}

}  // namespace
