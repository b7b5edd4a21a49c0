// Fully-int8 banded aggregation for inference:
// out[b] = (f32(sum_s A[b, s] @ xq[bo[b] + s]) * x_scale) * rs[b],
// int8 count tiles times int8 features, summed exactly in int32, f32 out.
//
// Replaces the TPU kernel `_banded_int8_kernel` (sldm_gnn_tpu/ops/spmm_banded.py
// :496, launched by `spmm_banded_int8_pallas` :517, pallas_call :564), which
// `spmm_banded_infer_int8` (:580) and BlockedSageClassifier's
// `int8_features=True` reach.
//
// One block of 256 threads per destination block; per source slot it stages
// the count tile as 4-byte words along j and the x tile packed four rows to
// a word (byte q of word (j4, c) is xq[4 j4 + q, c]), then every thread
// accumulates an 8 x 8 register block (the rows and columns of
// banded_gemm.cuh's acc_col) with __dp4a, four products a step. The sums are exact
// integers (|counts| <= 127, |xq| <= 127), so the order does not matter;
// the conversion and the two f32 multiplies run in the JAX order (:505-507)
// with __fmul_rn, and the plain version (exact sums in f64) agrees bit for
// bit.
//
// Bound at bench.py's banded shape (nb = 1572 blocks of 128 rows, s_span =
// 5, D = 128): bytes, 128.8 MB of A, 25.8 MB of xq, 103 MB of f32 out and
// the row scale (about 0.078 ms at 3.35 TB/s); the products are 33 GOP
// (0.017 ms at the int8 tensor-core rate). __dp4a runs on the CUDA cores at
// a fraction of that rate; the int8 mma is later work.
#include "banded_gemm.cuh"

namespace {

constexpr int kLdW = kTileMax / 4 + 1;  // words of a staged count-tile row, padded

struct StageI8 {
  int a[kTileMax * kLdW];            // [i][j4]
  int x[(kTileMax / 4) * kTileMax];  // [j4][c]
};

__global__ void __launch_bounds__(kThreads, 2)
    spmm_banded_int8_kernel(const int8_t* __restrict__ a, const int* __restrict__ bo,
                            int s_span, int tile, const int8_t* __restrict__ xq, int D,
                            const float* __restrict__ x_scale, const float* __restrict__ rs,
                            float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  StageI8& st = *reinterpret_cast<StageI8*>(smem);
  const int b = blockIdx.x, tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int w = tile / 4;  // words along j
  const size_t tt = static_cast<size_t>(tile) * tile;
  int acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0;

  for (int s = 0; s < s_span; ++s) {
    const int* at = reinterpret_cast<const int*>(a + (static_cast<size_t>(b) * s_span + s) * tt);
    for (int idx = tid; idx < tile * w; idx += kThreads) {
      const int i = idx / w, j4 = idx - i * w;
      st.a[i * kLdW + j4] = at[idx];
    }
    const int8_t* xt = xq + static_cast<size_t>(bo[b] + s) * tile * D;
    for (int idx = tid; idx < w * kTileMax; idx += kThreads) {
      const int j4 = idx / kTileMax, c = idx - j4 * kTileMax;
      int v = 0;
      if (c < D) {
        const int8_t* p = xt + static_cast<size_t>(4 * j4) * D + c;
        const unsigned u = static_cast<uint8_t>(p[0]) | static_cast<uint8_t>(p[D]) << 8 |
                           static_cast<uint8_t>(p[2 * D]) << 16 |
                           static_cast<unsigned>(static_cast<uint8_t>(p[3 * D])) << 24;
        v = static_cast<int>(u);
      }
      st.x[idx] = v;
    }
    __syncthreads();
    for (int j4 = 0; j4 < w; ++j4) {
      int av[8], xv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = st.a[(ty + 16 * i) * kLdW + j4];
      const int4 x0 = *reinterpret_cast<const int4*>(&st.x[j4 * kTileMax + 4 * tx]);
      const int4 x1 = *reinterpret_cast<const int4*>(&st.x[j4 * kTileMax + 64 + 4 * tx]);
      xv[0] = x0.x; xv[1] = x0.y; xv[2] = x0.z; xv[3] = x0.w;
      xv[4] = x1.x; xv[5] = x1.y; xv[6] = x1.z; xv[7] = x1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __dp4a(av[i], xv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const float xs = x_scale[0];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 16 * i;
    if (r >= tile) continue;
    const size_t row = static_cast<size_t>(b) * tile + r;
    const float sc = rs[row];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = acc_col(tx, j);
      if (c < D) out[row * D + c] = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j]), xs), sc);
    }
  }
}

}  // namespace

// a [nb, s_span, tile, tile] int8 counts, bo [nb] int32, xq [nb * tile, D]
// int8, x_scale [1] f32, rs [nb * tile] f32, out [nb * tile, D] f32.
extern "C" int spmm_banded_int8_launch(const void* a, const void* bo, int nb, int s_span,
                                       int tile, const void* xq, int D, const void* x_scale,
                                       const void* rs, void* out, void* stream) {
  if (!banded_shape_ok(nb, s_span, tile, D) || x_scale == nullptr || rs == nullptr)
    return SLDM_ERR_SHAPE;
  spmm_banded_int8_kernel<<<nb, kThreads, sizeof(StageI8), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int*>(bo), s_span, tile,
      static_cast<const int8_t*>(xq), D, static_cast<const float*>(x_scale),
      static_cast<const float*>(rs), static_cast<float*>(out));
  return cudaGetLastError();
}
