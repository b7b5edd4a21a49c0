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
//             hs[t-1] with the forward's own arithmetic (same FMA order, so
//             the same bits), and the dh carry runs in reverse.
//
// Design. Rows of a GRU are independent, so the TPU kernel's sequential T
// grid axis becomes a loop inside the block and a block owns a tile of
// rows for all T steps. W_hh lives in shared memory in f32 for the whole
// sequence (110.6 KB at H=96, 196.6 KB at H=128; the opt-in limit is
// 227 KB). A wider H than a block's shared memory or registers take is
// refused with SLDM_ERR_SMEM, and the wrapper names the widest H: 128 for
// the forward (its 4H threads' registers), 123 for the backward (shared
// memory).
//   * Forward: a block of (H, 4) threads owns 32 rows; thread (j, y) keeps
//     unit j of 8 rows in registers, so every W_hh value it reads from
//     shared memory feeds 8 rows and every carry read is a float4 broadcast
//     to the warp. Two barriers a step separate reading the old carry from
//     writing the new one.
//   * Backward: a persistent grid of (H, 3) blocks walks tiles of 24 rows
//     (tile blockIdx.x, + gridDim.x, ...). Per step: stage hs[t-1]
//     transposed; thread (j, y) recomputes the gates of unit j for 8 rows,
//     advances its f32 dh carry, writes dxproj and keeps dhp in shared
//     memory; then dh_{t-1} = dh * z + dhp @ W_hh^T (W_hh stored with an odd
//     row stride, so the column reads are free of bank conflicts) and
//     thread c (of 3H) adds hprev^T dhp and the column sum of dhp to column
//     c of its block's partial dW_hh | db_hh, kept in a device workspace (in
//     L2). A second kernel sums the blocks' partials in block order: no
//     atomics, so two launches repeat their bits.
//
// What bounds it on the H100: operations. At N = 19 558 rows, T = 100,
// H = 96 the forward's h @ W_hh is 2 N T 3H H = 108 GFLOP of f32 products
// (1.61 ms at 67 TFLOP/s; xproj and hs are 3.0 GB, 0.90 ms at 3.35 TB/s);
// the backward recomputes that product and adds dhp @ W_hh^T and hprev^T
// dhp, 324 GFLOP (4.84 ms). The f32 contract (1e-5) rules out TF32 and
// bf16 tensor-core products; the FMA units are the right ones, and this
// first kernel does not reach their peak.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kRowsPerThread = 8;
constexpr int kFwdGroups = 4;
constexpr int kFwdRows = kRowsPerThread * kFwdGroups;
constexpr int kBwdGroups = 3;  // block (H, 3): 3H threads, one per gate column
constexpr int kBwdRows = kRowsPerThread * kBwdGroups;

__device__ __forceinline__ float sigmoidf_(float v) { return 1.0f / (1.0f + expf(-v)); }

__host__ __device__ inline int pad4(int h) { return (h + 3) & ~3; }

size_t fwd_smem_bytes(int H) {
  const size_t hp = pad4(H), h3 = 3 * static_cast<size_t>(H);
  return sizeof(float) * (hp * h3 + kFwdRows * hp + h3);  // W_hh [Hp, 3H], carry, b_hh
}

// Row stride of W_hh in the backward's shared memory: odd, so that the
// reads of one column by 32 consecutive rows hit 32 banks.
__host__ __device__ inline int bwd_ldw(int H) { return (3 * H) | 1; }

size_t bwd_smem_bytes(int H) {
  const size_t hp = pad4(H), ldw = bwd_ldw(H), h3 = 3 * static_cast<size_t>(H);
  // W_hh [Hp, ldw] (pad rows zero), hprev^T [Hp, rows], dhp [rows, 3H], b_hh
  return sizeof(float) * (hp * ldw + hp * kBwdRows + kBwdRows * h3 + h3);
}

// hproj of unit j (columns j, H + j, 2H + j) for kRowsPerThread rows whose
// carries are hrow(i)[0 .. Hp), from W_hh rows of stride ldw, k ascending in
// steps of 4 (the pad rows of W_hh and of the carry are zero). The forward
// and the backward's recompute call this one function, so they round alike.
template <class HRow>
__device__ __forceinline__ void hidden_proj(const float* __restrict__ w, int ldw, int Hp, int H,
                                            int j, HRow hrow, float (&ar)[kRowsPerThread],
                                            float (&az)[kRowsPerThread],
                                            float (&an)[kRowsPerThread]) {
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) ar[i] = az[i] = an[i] = 0.0f;
  for (int k = 0; k < Hp; k += 4) {
    float wr[4], wz[4], wn[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float* wk = w + static_cast<size_t>(k + u) * ldw;
      wr[u] = wk[j];
      wz[u] = wk[H + j];
      wn[u] = wk[2 * H + j];
    }
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const float4 h4 = hrow(i, k);
      const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        ar[i] = fmaf(hv[u], wr[u], ar[i]);
        az[i] = fmaf(hv[u], wz[u], az[i]);
        an[i] = fmaf(hv[u], wn[u], an[i]);
      }
    }
  }
}

// xproj [T, B, 3H] with element strides st (frames) and sb (rows), the last
// dimension contiguous; hs [T, B, H] contiguous.
__global__ void gru_scan_fwd_kernel(const float* __restrict__ xproj, int64_t st, int64_t sb,
                                    const float* __restrict__ w_hh,
                                    const float* __restrict__ b_hh, int T, int B, int H,
                                    float* __restrict__ hs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H3 = 3 * H, Hp = pad4(H);
  float* w = reinterpret_cast<float*>(smem);  // [Hp, 3H]
  float* hc = w + static_cast<size_t>(Hp) * H3;  // [rows, Hp]
  float* bhh = hc + kFwdRows * Hp;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;
  const int j = threadIdx.x;
  const int r0 = threadIdx.y * kRowsPerThread;
  const int row0 = blockIdx.x * kFwdRows;

  for (int e = tid; e < Hp * H3; e += nthr) w[e] = e < H * H3 ? w_hh[e] : 0.0f;
  for (int e = tid; e < kFwdRows * Hp; e += nthr) hc[e] = 0.0f;
  for (int e = tid; e < H3; e += nthr) bhh[e] = b_hh[e];
  __syncthreads();

  auto hrow = [&](int i, int k) {
    return *reinterpret_cast<const float4*>(hc + (r0 + i) * Hp + k);
  };
  for (int t = 0; t < T; ++t) {
    float xr[kRowsPerThread], xz[kRowsPerThread], xn[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int row = row0 + r0 + i;
      const float* xp = xproj + t * st + static_cast<int64_t>(row < B ? row : 0) * sb;
      xr[i] = row < B ? xp[j] : 0.0f;
      xz[i] = row < B ? xp[H + j] : 0.0f;
      xn[i] = row < B ? xp[2 * H + j] : 0.0f;
    }
    float ar[kRowsPerThread], az[kRowsPerThread], an[kRowsPerThread];
    hidden_proj(w, H3, Hp, H, j, hrow, ar, az, an);
    float hnew[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const float r = sigmoidf_(xr[i] + (ar[i] + bhh[j]));
      const float z = sigmoidf_(xz[i] + (az[i] + bhh[H + j]));
      const float n = tanhf(xn[i] + r * (an[i] + bhh[2 * H + j]));
      hnew[i] = fmaf(1.0f - z, n, z * hc[(r0 + i) * Hp + j]);
    }
    __syncthreads();  // every thread has read the old carry
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      hc[(r0 + i) * Hp + j] = hnew[i];
      const int row = row0 + r0 + i;
      if (row < B) hs[(static_cast<size_t>(t) * B + row) * H + j] = hnew[i];
    }
    __syncthreads();  // the new carry is visible
  }
}

// The backward. g [T, B, H] with element strides gt, gb (last dimension
// contiguous); dxproj [T, B, 3H] contiguous; partial [gridDim.x, H + 1, 3H]
// (rows [0, H) dW_hh, row H db_hh), this block's slice zeroed here.
__global__ void gru_scan_bwd_kernel(const float* __restrict__ xproj, int64_t st, int64_t sb,
                                    const float* __restrict__ hs,
                                    const float* __restrict__ w_hh,
                                    const float* __restrict__ b_hh,
                                    const float* __restrict__ g, int64_t gt, int64_t gb, int T,
                                    int B, int H, int num_tiles, float* __restrict__ dxproj,
                                    float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H3 = 3 * H, Hp = pad4(H), ldw = bwd_ldw(H);
  float* w = reinterpret_cast<float*>(smem);       // [Hp, ldw]
  float* hpT = w + static_cast<size_t>(Hp) * ldw;  // [Hp, rows]
  float* dhp = hpT + Hp * kBwdRows;                // [rows, 3H]
  float* bhh = dhp + kBwdRows * H3;
  const int j = threadIdx.x;
  const int r0 = threadIdx.y * kRowsPerThread;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;  // also the gate column c
  const int nthr = blockDim.x * blockDim.y;                 // == 3H
  float* dws = partial + static_cast<size_t>(blockIdx.x) * (H + 1) * H3;

  for (int e = tid; e < Hp * ldw; e += nthr) {
    const int k = e / ldw, c = e - k * ldw;
    w[e] = (k < H && c < H3) ? w_hh[static_cast<size_t>(k) * H3 + c] : 0.0f;
  }
  for (int e = tid; e < H3; e += nthr) bhh[e] = b_hh[e];
  for (int e = tid; e < (Hp - H) * kBwdRows; e += nthr) hpT[H * kBwdRows + e] = 0.0f;
  for (int q = 0; q <= H; ++q) dws[static_cast<size_t>(q) * H3 + tid] = 0.0f;
  __syncthreads();

  auto hrow = [&](int i, int k) {
    const float* h = hpT + k * kBwdRows + r0 + i;
    return make_float4(h[0], h[kBwdRows], h[2 * kBwdRows], h[3 * kBwdRows]);
  };
  for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int row0 = tile * kBwdRows;
    float dh[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) dh[i] = 0.0f;

    for (int t = T - 1; t >= 0; --t) {
      for (int e = tid; e < kBwdRows * H; e += nthr) {
        const int r = e / H, k = e - r * H, row = row0 + r;
        hpT[k * kBwdRows + r] =
            (t > 0 && row < B) ? hs[(static_cast<size_t>(t - 1) * B + row) * H + k] : 0.0f;
      }
      __syncthreads();

      // A: the forward's gates of unit j, the dh carry, dxproj and dhp
      float ar[kRowsPerThread], az[kRowsPerThread], an[kRowsPerThread];
      hidden_proj(w, ldw, Hp, H, j, hrow, ar, az, an);
      float ddir[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int r = r0 + i, row = row0 + r;
        float dr_pre = 0.0f, dz_pre = 0.0f, dn_pre = 0.0f, dhn = 0.0f;
        ddir[i] = 0.0f;
        if (row < B) {
          const float* xp = xproj + t * st + row * sb;
          const float hn = an[i] + bhh[2 * H + j];
          const float rr = sigmoidf_(xp[j] + (ar[i] + bhh[j]));
          const float z = sigmoidf_(xp[H + j] + (az[i] + bhh[H + j]));
          const float n = tanhf(xp[2 * H + j] + rr * hn);
          const float d = dh[i] + g[t * gt + row * gb + j];
          const float hprev = hpT[j * kBwdRows + r];
          const float dn = d * (1.0f - z);
          const float dz = d * (hprev - n);
          ddir[i] = d * z;
          dn_pre = dn * (1.0f - n * n);
          const float dr = dn_pre * hn;
          dhn = dn_pre * rr;
          dr_pre = dr * rr * (1.0f - rr);
          dz_pre = dz * z * (1.0f - z);
          float* dx = dxproj + (static_cast<size_t>(t) * B + row) * H3;
          dx[j] = dr_pre;
          dx[H + j] = dz_pre;
          dx[2 * H + j] = dn_pre;
        }
        dhp[r * H3 + j] = dr_pre;
        dhp[r * H3 + H + j] = dz_pre;
        dhp[r * H3 + 2 * H + j] = dhn;
      }
      __syncthreads();

      // B1: dh_{t-1} = dh * z + dhp @ W_hh^T, unit j of this thread's rows
      {
        float acc[kRowsPerThread];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.0f;
        const float* wj = w + static_cast<size_t>(j) * ldw;
        for (int c = 0; c < H3; ++c) {
          const float wv = wj[c];
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i)
            acc[i] = fmaf(dhp[(r0 + i) * H3 + c], wv, acc[i]);
        }
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) dh[i] = ddir[i] + acc[i];
      }

      // B2: column c of the block's partial dW_hh and db_hh
      {
        const int c = tid;
        float col[kBwdRows];
#pragma unroll
        for (int r = 0; r < kBwdRows; ++r) col[r] = dhp[r * H3 + c];
        for (int q = 0; q < H; ++q) {
          const float* hq = hpT + q * kBwdRows;
          float acc = dws[static_cast<size_t>(q) * H3 + c];
#pragma unroll
          for (int r = 0; r < kBwdRows; r += 4) {
            const float4 h4 = *reinterpret_cast<const float4*>(hq + r);
            acc = fmaf(h4.x, col[r], acc);
            acc = fmaf(h4.y, col[r + 1], acc);
            acc = fmaf(h4.z, col[r + 2], acc);
            acc = fmaf(h4.w, col[r + 3], acc);
          }
          dws[static_cast<size_t>(q) * H3 + c] = acc;
        }
        float sum = dws[static_cast<size_t>(H) * H3 + c];
#pragma unroll
        for (int r = 0; r < kBwdRows; ++r) sum += col[r];
        dws[static_cast<size_t>(H) * H3 + c] = sum;
      }
      __syncthreads();  // hpT and dhp are free for the next step
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

}  // namespace

// xproj [T, B, 3H] f32 (strides st, sb; last dimension contiguous), w_hh
// [H, 3H] and b_hh [3H] f32 contiguous -> hs [T, B, H] f32.
extern "C" int gru_scan_fwd_launch(const void* xproj, int64_t st, int64_t sb, const void* w_hh,
                                   const void* b_hh, int T, int B, int H, void* hs,
                                   void* stream) {
  if (T <= 0 || B <= 0 || H <= 0 || H * kFwdGroups > 1024) return SLDM_ERR_SHAPE;
  const size_t smem = fwd_smem_bytes(H);
  const int code = opt_in(gru_scan_fwd_kernel, smem);
  if (code != 0) return code;
  // 4H threads of this kernel's registers must fit one SM (H <= 128 on an H100)
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, gru_scan_fwd_kernel);
  if (err != cudaSuccess) return err;
  if (H * kFwdGroups > attr.maxThreadsPerBlock) return SLDM_ERR_SMEM;
  const dim3 grid((B + kFwdRows - 1) / kFwdRows);
  gru_scan_fwd_kernel<<<grid, dim3(H, kFwdGroups), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xproj), st, sb, static_cast<const float*>(w_hh),
      static_cast<const float*>(b_hh), T, B, H, static_cast<float*>(hs));
  return cudaGetLastError();
}

// Blocks of the backward's persistent grid: one per free SM slot, at most
// one per tile of rows.
extern "C" int gru_scan_bwd_grid(int B, int H, int* blocks) {
  if (B <= 0 || H <= 0 || 3 * H > 1024) return SLDM_ERR_SHAPE;
  const size_t smem = bwd_smem_bytes(H);
  int code = opt_in(gru_scan_bwd_kernel, smem);
  if (code != 0) return code;
  int dev = 0, sms = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, gru_scan_bwd_kernel, 3 * H, smem);
  if (err != cudaSuccess) return err;
  if (occ <= 0) return SLDM_ERR_SMEM;
  const int tiles = (B + kBwdRows - 1) / kBwdRows;
  *blocks = tiles < occ * sms ? tiles : occ * sms;
  return 0;
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
  gru_scan_bwd_kernel<<<blocks, dim3(H, kBwdGroups), bwd_smem_bytes(H), s>>>(
      static_cast<const float*>(xproj), st, sb, static_cast<const float*>(hs),
      static_cast<const float*>(w_hh), static_cast<const float*>(b_hh),
      static_cast<const float*>(g), gt, gb, T, B, H, (B + kBwdRows - 1) / kBwdRows,
      static_cast<float*>(dxproj), static_cast<float*>(partial));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = (H + 1) * 3 * H;
  gru_scan_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(static_cast<const float*>(partial),
                                                          blocks, n, static_cast<float*>(out));
  return cudaGetLastError();
}
