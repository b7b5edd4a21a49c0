// Fused distance + top-k: the k nearest centroids of every point.
//
// Replaces the TPU kernel `_knn_kernel` (sldm_gnn_tpu/ops/knn_pallas.py:44,
// launched by `knn_topk_pallas` :81). Same contract: selection on
// d2 = dx*dx + dy*dy, the lowest centroid index wins among equal d2, and
// only the k winners are square-rooted. d2 is formed with __fsub_rn /
// __fmul_rn / __fadd_rn so that nvcc cannot contract it into an FMA and
// move a tie; sqrtf stays correctly rounded (no --use_fast_math).
//
// What bounds it on the H100: operations. Per (point, centroid) pair it
// does 5 f32 operations and a compare, over 12 bytes of input per point and
// 8 per centroid, and writes 8*k bytes per point; at V=20k, S=1000, k=5
// that is 0.1 GFLOP against ~1 MB, well under a microsecond of memory time.
// With one thread per point, V=20k gives ~160 blocks of 128 threads: the
// kernel is latency bound before it is throughput bound.
//
// Design. Centroids are staged through shared memory in chunks of kChunk,
// so S is not capped by shared memory; every thread of the block reads the
// same centroid at the same time (a broadcast). One thread per point keeps
// its sorted k-list in registers (KCAP slots, k <= KCAP, unrolled) and
// scans centroid indices in ascending order; a candidate enters only if it
// ranks strictly before the current k-th entry, so an equal d2 keeps the
// lower index already in the list. The [V, S] distance matrix never exists.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 2048;
constexpr int kMaxK = 128;

template <int KCAP>
__global__ void __launch_bounds__(kThreads)
    knn_topk_kernel(const float2* __restrict__ pts, int V, const float2* __restrict__ cts, int S,
                    int k, float* __restrict__ dists, int* __restrict__ idx) {
  __shared__ float2 cs[kChunk];
  const int v = blockIdx.x * kThreads + threadIdx.x;
  const bool live = v < V;
  const float2 p = live ? pts[v] : make_float2(0.0f, 0.0f);

  float bd[KCAP];
  int bi[KCAP];
#pragma unroll
  for (int q = 0; q < KCAP; ++q) {
    bd[q] = INFINITY;
    bi[q] = INT_MAX;
  }
  float worst = INFINITY;  // the k-th entry, the one a candidate must beat
  int worst_i = INT_MAX;

  for (int c0 = 0; c0 < S; c0 += kChunk) {
    const int n = min(kChunk, S - c0);
    __syncthreads();  // the previous chunk is no longer read
    for (int i = threadIdx.x; i < n; i += kThreads) cs[i] = cts[c0 + i];
    __syncthreads();
    if (!live) continue;
    for (int i = 0; i < n; ++i) {
      const float2 c = cs[i];
      const float dx = __fsub_rn(p.x, c.x);
      const float dy = __fsub_rn(p.y, c.y);
      const float d = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      const int s = c0 + i;
      if (d < worst || (d == worst && s < worst_i)) {
        // insert before the first entry that ranks after (d, s); from there
        // on the tail shifts down one slot and the k-th entry drops out
        float cd = d;
        int ci = s;
        bool shift = false;
#pragma unroll
        for (int q = 0; q < KCAP; ++q) {
          if (q < k && (shift || cd < bd[q] || (cd == bd[q] && ci < bi[q]))) {
            const float td = bd[q];
            const int ti = bi[q];
            bd[q] = cd;
            bi[q] = ci;
            cd = td;
            ci = ti;
            shift = true;
          }
        }
#pragma unroll
        for (int q = 0; q < KCAP; ++q) {
          if (q == k - 1) {
            worst = bd[q];
            worst_i = bi[q];
          }
        }
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int q = 0; q < KCAP; ++q) {
    if (q < k) {
      dists[static_cast<size_t>(v) * k + q] = sqrtf(bd[q]);
      idx[static_cast<size_t>(v) * k + q] = bi[q];
    }
  }
}

}  // namespace

// points [V, 2] f32, centroids [S, 2] f32 -> dists [V, k] f32, idx [V, k] i32
extern "C" int knn_topk_launch(const void* points, int V, const void* centroids, int S, int k,
                               void* dists, void* idx, void* stream) {
  if (V < 0 || k < 1 || k > S || k > kMaxK) return SLDM_ERR_SHAPE;
  if (V == 0) return 0;
  const dim3 grid((V + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* p = static_cast<const float2*>(points);
  const float2* c = static_cast<const float2*>(centroids);
  float* d = static_cast<float*>(dists);
  int* i = static_cast<int*>(idx);
  if (k <= 8)
    knn_topk_kernel<8><<<grid, kThreads, 0, s>>>(p, V, c, S, k, d, i);
  else if (k <= 32)
    knn_topk_kernel<32><<<grid, kThreads, 0, s>>>(p, V, c, S, k, d, i);
  else
    knn_topk_kernel<kMaxK><<<grid, kThreads, 0, s>>>(p, V, c, S, k, d, i);
  return cudaGetLastError();
}
