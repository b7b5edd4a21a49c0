// Reverse BPTT of one GRU layer with bf16 operands: the kernel shared by
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
// Design. The TPU grid walks row blocks in order and sums dW into one VMEM
// scratch; on the H100 blocks run in parallel. So each block is persistent:
// it walks the row tiles blockIdx.x, blockIdx.x + gridDim.x, ... (a fixed
// assignment) and keeps its own partial dW; a second kernel sums the
// blocks' partials in block order. No atomics, so two launches give the same
// bits. A block is (H, 3) threads and owns 24 rows (kRowsPerBlock) at a
// time, for all T steps in reverse. Per step, three phases separated by
// barriers:
//   A. thread (j, y) takes hidden unit j of 8 rows: it recomputes the gates
//      exactly as gru_fwd.cu computed them (same FMA order; kStored loads
//      them instead), advances its f32 dh carry and writes the rounded dhp
//      (and the n part of dxp) to shared memory;
//   B. the same thread forms dh_{t-1} = dh*z + dhp @ W_hh^T for its rows;
//      thread c (of 3H) owns gate column c of the partial dW and adds
//      hprev^T dhp and x^T dxp for the 24 rows; with dx, threads form
//      dxp @ W_ih^T.
// Shared memory: W_hh as bf16 pairs along k with an odd row stride (both
// the row-wise reads of phase A and the column-wise reads of phase B are
// free of bank conflicts), the 24-row tiles of hprev and x transposed, and
// the rounded dhp/dxp of the step. The block's partial dW_hh + db_hh
// ((H+1) x 3H f32) and dW_ih + db_ih ((D+1) x 3H) live in its slice of the
// device workspace (L2), each column updated only by its owner thread, so
// the shared memory holds no partial: 86 KB at H=96, D=6 (two blocks a
// SM), 139 KB at H=128, D=6 and 151 KB at H=128, D=128. kDwSmem keeps the
// partial dW_hh + db_hh in shared memory instead (198 KB at H=96, one
// block a SM; it fits up to H=104 at D=6); bwd_grid takes it where it
// fits, for widths at which it is faster (PERF.md). All products run on
// the f32 FMA units; the tensor cores are later work.
//
// What bounds it on the H100, at the flagship shape (N=19558, T=100, D=6,
// H=96, no dx): the v2 backward does ~174 kFLOP of bf16 products per row and
// frame (the recomputed input and hidden projections, dh, dW_hh and dW_ih
// with their bias rows), 340 GFLOP over 0.38 GB of hs: bound by operations
// (0.34 ms at 989 TFLOP/s). The store-gates backward skips the recompute
// (~115 kFLOP per row and frame, 225 GFLOP) but reads the 1.5 GB of gates:
// bound by bytes (0.58 ms at 3.35 TB/s).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kBwdRowsPerThread = 8;
constexpr int kBwdRowGroups = 3;  // block (H, 3): 3H threads, one per gate column
constexpr int kBwdRows = kBwdRowsPerThread * kBwdRowGroups;

__device__ __forceinline__ float bwd_bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float bwd_sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

__host__ __device__ inline size_t align16(size_t v) { return (v + 15) & ~static_cast<size_t>(15); }

// Byte offsets of the shared-memory regions.
struct BwdSmem {
  size_t whh2, dws, bih, bhh, hpT, xT, dhp, dnx, total;
  __host__ __device__ BwdSmem(int D, int H, bool dw_smem) {
    const size_t H3 = 3 * static_cast<size_t>(H);
    const size_t Hh = (H + 1) / 2;
    const size_t ldh = (H3 + 7) & ~static_cast<size_t>(7);
    whh2 = 0;
    dws = align16(whh2 + 4 * Hh * (ldh + 1));       // W_hh pairs [Hh, ldh + 1]
    bih = align16(dws + (dw_smem ? 4 * (H + 1) * H3 : 0));  // dW_hh + db_hh [(H+1), 3H]
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

// partial: [gridDim.x, (H+1) + (D+1), 3H] f32 workspace; this block owns
// its slice: rows [0, H) dW_hh, H db_hh, [H+1, H+1+D) dW_ih, H+1+D db_ih.
// kDwSmem sums rows [0, H] in shared memory and copies them there at the end.
template <bool kStored, bool kDwSmem>
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
  const BwdSmem L(D, H, kDwSmem);
  const int H3 = 3 * H;
  const int Hh = (H + 1) / 2;
  const int Hp = 2 * Hh;
  const int ldh = (H3 + 7) & ~7;
  const int ldw = ldh + 1;  // odd: conflict-free column reads
  __nv_bfloat162* whh2 = reinterpret_cast<__nv_bfloat162*>(smem + L.whh2);
  const size_t slice = static_cast<size_t>(H + D + 2) * 3 * H;
  float* dws = kDwSmem ? reinterpret_cast<float*>(smem + L.dws) : partial + blockIdx.x * slice;
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
  float* pih = partial + blockIdx.x * slice + static_cast<size_t>(H + 1) * H3;

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
        xT[d * kBwdRows + r] = row < N ? bwd_bf16_round(x[row * xsn + t * xst + d]) : 0.0f;
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
          // the forward's arithmetic, in its order (gru_fwd.cu)
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

  if (kDwSmem) {
    float* phh = partial + blockIdx.x * slice;
    for (int q = 0; q <= H; ++q) phh[static_cast<size_t>(q) * H3 + tid] = dws[q * H3 + tid];
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

// Blocks of the persistent grid: one per free SM slot, at most one per
// tile. *dw_smem: -1 picks the shared-memory partial where it fits, else
// the workspace one; on return it holds the placement taken (0 or 1).
template <bool kStored>
int bwd_grid(int N, int D, int H, int* dw_smem, int* blocks) {
  if (N <= 0 || D <= 0 || H <= 0 || 3 * H > 1024) return SLDM_ERR_SHAPE;
  int dev = 0, smem_max = 0, sms = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (*dw_smem < 0) *dw_smem = BwdSmem(D, H, true).total <= static_cast<size_t>(smem_max);
  const size_t smem = BwdSmem(D, H, *dw_smem != 0).total;
  if (smem > static_cast<size_t>(smem_max)) return SLDM_ERR_SMEM;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  auto kernel = *dw_smem ? gru_bwd_kernel<kStored, true> : gru_bwd_kernel<kStored, false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, 3 * H, smem);
  if (err != cudaSuccess) return err;
  if (occ <= 0) return SLDM_ERR_SMEM;
  const int tiles = (N + kBwdRows - 1) / kBwdRows;
  *blocks = tiles < occ * sms ? tiles : occ * sms;
  return 0;
}

// partial: [blocks, (H+1)+(D+1), 3H] f32 scratch, blocks and dw_smem from
// bwd_grid; out: [(H+1)+(D+1), 3H] f32 = dW_hh | db_hh | dW_ih | db_ih.
template <bool kStored>
int bwd_launch(const void* x, int64_t xsn, int64_t xst, const void* hs, const void* gates,
               const void* g, int64_t gsn, int64_t gst, int seq_cot, int N, int T, int D, int H,
               const void* w_ih, const void* b_ih, const void* w_hh, const void* b_hh, void* dx,
               void* partial, int dw_smem, int blocks, void* out, void* stream) {
  int want = 0, place = dw_smem;
  if (place != 0 && place != 1) return SLDM_ERR_SHAPE;
  const int code = bwd_grid<kStored>(N, D, H, &place, &want);
  if (code != 0) return code;
  if (T <= 0 || blocks != want) return SLDM_ERR_SHAPE;
  const size_t smem = BwdSmem(D, H, place != 0).total;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = place ? gru_bwd_kernel<kStored, true> : gru_bwd_kernel<kStored, false>;
  kernel<<<blocks, dim3(H, kBwdRowGroups), smem, s>>>(
      static_cast<const float*>(x), xsn, xst, static_cast<const __nv_bfloat16*>(hs),
      static_cast<const __nv_bfloat16*>(gates), static_cast<const float*>(g), gsn, gst, seq_cot,
      N, T, D, H, static_cast<const __nv_bfloat16*>(w_ih), static_cast<const float*>(b_ih),
      static_cast<const __nv_bfloat16*>(w_hh), static_cast<const float*>(b_hh),
      static_cast<float*>(dx), static_cast<float*>(partial), (N + kBwdRows - 1) / kBwdRows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = (H + D + 2) * 3 * H;
  gru_bwd_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(static_cast<const float*>(partial), blocks,
                                                         n, static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace
