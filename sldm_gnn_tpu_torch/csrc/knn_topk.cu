// Fused distance + top-k: the k nearest centroids of every point.
//
// Replaces the TPU kernel `_knn_kernel` (sldm_gnn_tpu/ops/knn_pallas.py:44,
// launched by `knn_topk_pallas` :81). Same contract: selection on
// d2 = dx*dx + dy*dy, the lowest centroid index wins among equal d2, and
// only the k winners are square-rooted. d2 is formed with __fsub_rn /
// __fmul_rn / __fadd_rn so that nvcc cannot contract it into an FMA and
// move a tie; sqrtf stays correctly rounded (no --use_fast_math).
//
// What bounds it on the H100: neither bytes nor operations. Per (point,
// centroid) pair it does 5 f32 operations and a compare, over 8 bytes of
// input per point and per centroid, and writes 8*k bytes per point; at
// V=20k, S=1000, k=5 that is 0.1 GFLOP against ~1 MB, a microsecond or
// two of either. The first version gave each point one thread that
// scanned all S centroids in order, its sorted list in registers: the
// insertion, unrolled and predicated, sat in every step's chain (~220 ns a
// centroid), 0.22 ms at V=32 and 0.26 ms at V=19430 alike, one block on
// one SM at V=32. Sorted lists on every lane (each lane a strided share of
// S, merged by shuffles) kept that chain on all 32 lanes and ran no faster
// at V=19430.
//
// Design. W warps a point (W of 1, 2, 4 or 8, chosen by V so that the grid
// holds at least 8 warps an SM: one warp a point at a training batch,
// eight at one served window), eight warps a block. Centroids are staged
// in shared memory in chunks of kChunk, so S is not capped. A warp keeps
// one sorted list of k spread over its lanes: entry e = 32 r + lane in
// register row r (R rows, k <= 32 R). It takes the centroids 32 at a time
// in ascending index order (warp w of a point the batches w, w + W, ...):
// every lane forms one d2, a ballot marks the lanes whose candidate ranks
// before the k-th entry in (d2, index) order, and those enter one by one
// in lane order, each by one shift of the list across lanes (shuffles, no
// divergence). Candidates arrive in ascending index, so an equal d2 keeps
// the lower index ahead. Few enter after the first batches (about k ln(S /
// k)), so a batch costs about its ballot. With W > 1 the W sorted lists go
// to shared memory and the point's first warp merges them in k rounds,
// each taking the least head in (d2, index) order by shuffles; every index
// is distinct, so the lowest index wins on equal d2 across warps too.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kChunk = 2048;  // centroids staged at a time
constexpr int kMaxK = 128;
constexpr int kWarps = 8;  // warps a block
constexpr unsigned kAll = 0xffffffffu;

// (d, i) ranks strictly before (e, j)
__device__ __forceinline__ bool before(float d, int i, float e, int j) {
  return d < e || (d == e && i < j);
}

__device__ __forceinline__ float dist2(float2 p, float2 c) {
  const float dx = __fsub_rn(p.x, c.x);
  const float dy = __fsub_rn(p.y, c.y);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// The warp's sorted list of k (<= 32 R) entries, entry 32 r + lane in row
// r; entries past k hold (inf, INT_MAX).
template <int R>
struct WarpList {
  float d[R];
  int i[R];
  float wd = INFINITY;  // the k-th entry, the one a candidate must beat
  int wi = INT_MAX;

  __device__ WarpList() {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      d[r] = INFINITY;
      i[r] = INT_MAX;
    }
  }

  // insert (cd, ci), which ranks before the k-th: from the first entry that
  // ranks after it on, every entry moves up one place
  __device__ __forceinline__ void insert(float cd, int ci, int k, int lane) {
    float pd[R];
    int pi[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {  // the entry before this one (from the old list)
      pd[r] = __shfl_up_sync(kAll, d[r], 1);
      pi[r] = __shfl_up_sync(kAll, i[r], 1);
      if (r > 0) {
        const float ld = __shfl_sync(kAll, d[r - 1], 31);
        const int li = __shfl_sync(kAll, i[r - 1], 31);
        if (lane == 0) {
          pd[r] = ld;
          pi[r] = li;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int e = 32 * r + lane;
      if (e >= k || !before(cd, ci, d[r], i[r])) continue;
      const bool take_prev = e > 0 && before(cd, ci, pd[r], pi[r]);
      d[r] = take_prev ? pd[r] : cd;
      i[r] = take_prev ? pi[r] : ci;
    }
    float kd = 0.0f;
    int ki = 0;
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r == (k - 1) >> 5) {
        kd = d[r];
        ki = i[r];
      }
    wd = __shfl_sync(kAll, kd, (k - 1) & 31);
    wi = __shfl_sync(kAll, ki, (k - 1) & 31);
  }
};

// the warp's least (d, i) in (d2, index) order, on every lane
__device__ __forceinline__ void warp_least(float& d, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float e = __shfl_xor_sync(kAll, d, o);
    const int j = __shfl_xor_sync(kAll, i, o);
    if (before(e, j, d, i)) {
      d = e;
      i = j;
    }
  }
}

// W warps a point; block b's warp w serves point (8 b + w) / W.
template <int R>
__global__ void __launch_bounds__(kWarps * 32)
    knn_topk_kernel(const float2* __restrict__ pts, int V, const float2* __restrict__ cts, int S,
                    int k, int W, float* __restrict__ dists, int* __restrict__ idx) {
  __shared__ float2 cs[kChunk];
  __shared__ float md[kWarps][32 * R];
  __shared__ int mi[kWarps][32 * R];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gw = blockIdx.x * kWarps + warp;
  const int v = gw / W, sub = gw % W;  // (kWarps % W == 0: a point's warps share the block)
  const bool live = v < V;
  const float2 p = live ? pts[v] : make_float2(0.0f, 0.0f);

  WarpList<R> list;
  for (int c0 = 0; c0 < S; c0 += kChunk) {
    const int n = min(kChunk, S - c0);
    __syncthreads();  // the previous chunk is no longer read
    for (int c = threadIdx.x; c < n; c += kWarps * 32) cs[c] = cts[c0 + c];
    __syncthreads();
    if (!live) continue;
    for (int b0 = 32 * sub; b0 < n; b0 += 32 * W) {
      const int c = b0 + lane;
      const float d = c < n ? dist2(p, cs[c]) : INFINITY;
      unsigned m = __ballot_sync(kAll, c < n && before(d, c0 + c, list.wd, list.wi));
      while (m != 0) {
        const int src = __ffs(m) - 1;
        m &= m - 1;
        const float cd = __shfl_sync(kAll, d, src);
        const int ci = c0 + b0 + src;
        if (before(cd, ci, list.wd, list.wi)) list.insert(cd, ci, k, lane);
      }
    }
  }

  const size_t o = static_cast<size_t>(v) * k;
  if (W == 1) {
    if (!live) return;
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (32 * r + lane < k) {
        dists[o + 32 * r + lane] = sqrtf(list.d[r]);
        idx[o + 32 * r + lane] = list.i[r];
      }
    return;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    md[warp][32 * r + lane] = list.d[r];
    mi[warp][32 * r + lane] = list.i[r];
  }
  __syncthreads();
  if (sub != 0 || !live) return;
  // the point's W sorted lists: lane w < W walks warp + w's; round j's
  // least head is entry j
  int at = 0;
  float hd = lane < W ? md[warp + lane][0] : INFINITY;
  int hi = lane < W ? mi[warp + lane][0] : INT_MAX;
  for (int j = 0; j < k; ++j) {
    float d = hd;
    int i = hi;
    warp_least(d, i);
    if (lane == 0) {
      dists[o + j] = sqrtf(d);
      idx[o + j] = i;
    }
    if (lane < W && hi == i) {
      ++at;
      hd = at < k ? md[warp + lane][at] : INFINITY;
      hi = at < k ? mi[warp + lane][at] : INT_MAX;
    }
  }
}

// warps a point: at least kWarps warps an SM, at most kWarps a point
int plan(int V, int* warps) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  int w = 1;
  while (w < kWarps && static_cast<long>(V) * w < static_cast<long>(kWarps) * sms) w *= 2;
  *warps = w;
  return 0;
}

}  // namespace

// The warps a point knn_topk_launch gives V points (1, 2, 4 or 8).
extern "C" int knn_topk_plan(int V, int* warps) {
  if (V < 0) return SLDM_ERR_SHAPE;
  return plan(V, warps);
}

// points [V, 2] f32, centroids [S, 2] f32 -> dists [V, k] f32, idx [V, k] i32
extern "C" int knn_topk_launch(const void* points, int V, const void* centroids, int S, int k,
                               void* dists, void* idx, void* stream) {
  if (V < 0 || k < 1 || k > S || k > kMaxK) return SLDM_ERR_SHAPE;
  if (V == 0) return 0;
  int w = 0;
  const int code = plan(V, &w);
  if (code != 0) return code;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* p = static_cast<const float2*>(points);
  const float2* c = static_cast<const float2*>(centroids);
  float* d = static_cast<float*>(dists);
  int* i = static_cast<int*>(idx);
  const int grid = static_cast<int>((static_cast<long>(V) * w + kWarps - 1) / kWarps);
  if (k <= 32)
    knn_topk_kernel<1><<<grid, kWarps * 32, 0, s>>>(p, V, c, S, k, w, d, i);
  else
    knn_topk_kernel<kMaxK / 32><<<grid, kWarps * 32, 0, s>>>(p, V, c, S, k, w, d, i);
  return cudaGetLastError();
}
