// GRU forward over a whole sequence, one layer, bf16 operands.
//
// Replaces the TPU kernel `_fwd2_kernel` (sldm_gnn_tpu/ops/gru_pallas.py:246,
// launched by `_run_fwd2` :400 for `gru_last_pallas` :477 and
// `gru_seq_pallas` :544). Same numerics: x, W_ih and W_hh rounded to bf16,
// products summed in f32 (a bf16*bf16 product is exact in f32), gate math
// in f32 with expf/tanhf, and the carry rounded to bf16 after every step.
// Gate order r, z, n (torch's nn.GRU).
//
// The same kernel, instantiated with kStoreGates, also replaces
// `_fwd3_kernel` (gru_pallas.py:641, launched by `_run_fwd3` :759 for the
// store-gates `gru_last_sg_pallas` :840 and `gru_seq_sg_pallas` :888): it
// writes the packed bf16 gates r|z|n|hn [T, N, 4H] beside hs (hn is the
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
// products over 48 MB of input: bound by operations (0.12 ms at the tensor
// cores' 989 TFLOP/s), and this first kernel runs them on the f32 FMA units
// (67 TFLOP/s), not the tensor cores.
//
// Design. The TPU kernel's sequential T grid axis becomes a loop inside the
// block. One block owns kRowsPerBlock rows for all T steps: W_hh (as bf16
// pairs along k), W_ih (bf16), both biases and the [rows, H] carry stay in
// shared memory for the whole sequence, so device memory sees x once and the
// output once. Thread (j, g) owns hidden unit j for kRowsPerThread rows and
// keeps their three gate sums in registers; every W_hh value it reads from
// shared memory feeds kRowsPerThread rows, and the carry reads are
// broadcasts (all lanes of a warp read the same row). Two barriers per step
// separate reading the old carry from writing the new one. Rows past N are
// computed on zeros and never stored (no padded copy of x). Shared memory
// holds W_hh and W_ih whole, which caps H (227 KB a block; the widths are
// in PERF.md); a wider H is refused at launch. `wgmma` on the tensor cores
// and TMA loads are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kRowsPerThread = 8;
constexpr int kRowGroups = 2;
constexpr int kRowsPerBlock = kRowsPerThread * kRowGroups;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

size_t smem_bytes(int D, int H) {
  const size_t h3 = 3 * static_cast<size_t>(H);
  const size_t hh = (H + 1) / 2;
  return sizeof(float) * kRowsPerBlock * 2 * hh  // carry [rows, 2*hh] f32
         + sizeof(__nv_bfloat162) * hh * h3      // W_hh as k-pairs [hh, 3H]
         + sizeof(__nv_bfloat162) * ((D * h3 + 1) / 2)  // W_ih bf16 [D, 3H], even length
         + sizeof(float) * 2 * h3                // b_ih, b_hh
         + sizeof(float) * kRowsPerBlock * D;    // x tile of one step
}

// x [N, T, D] f32 with element strides sn (rows) and st (frames), the last
// dimension contiguous; w_ih [D, 3H], w_hh [H, 3H] bf16 (JAX layout);
// b_ih, b_hh [3H] f32. Writes h_last [N, H] f32 and/or hs [T, N, H] bf16.
// With kStoreGates also writes gates [T, N, 4H] bf16 = r | z | n | hn.
template <bool kStoreGates>
__global__ void gru_fwd_kernel(const float* __restrict__ x, int64_t sn, int64_t st,
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

template <bool kStoreGates>
int launch(const void* x, int64_t stride_n, int64_t stride_t, int N, int T, int D, int H,
           const void* w_ih, const void* b_ih, const void* w_hh, const void* b_hh, void* h_last,
           void* hs, void* gates, void* stream) {
  if (N <= 0 || T <= 0 || D <= 0 || H <= 0 || H * kRowGroups > 1024) return SLDM_ERR_SHAPE;
  const size_t smem = smem_bytes(D, H);
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > static_cast<size_t>(smem_max)) return SLDM_ERR_SMEM;
  err = cudaFuncSetAttribute(gru_fwd_kernel<kStoreGates>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 block(H, kRowGroups);
  const dim3 grid((N + kRowsPerBlock - 1) / kRowsPerBlock);
  gru_fwd_kernel<kStoreGates><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
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
