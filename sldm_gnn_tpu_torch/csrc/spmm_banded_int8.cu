// Fully-int8 banded aggregation for inference:
// out[b] = (f32(sum_s A[b, s] @ xq[bo[b] + s]) * x_scale) * rs[b],
// int8 count tiles times int8 features, summed exactly in int32, f32 out.
//
// Replaces the TPU kernel `_banded_int8_kernel` (sldm_gnn_tpu/ops/spmm_banded.py
// :496, launched by `spmm_banded_int8_pallas` :517, pallas_call :564), which
// `spmm_banded_infer_int8` (:580) and BlockedSageClassifier's
// `int8_features=True` reach. As the TPU kernel (int8 x int8 -> int32 on
// its matrix unit), the sums are exact integers (|counts|, |xq| <= 127), so
// their order does not matter; the conversion and the two f32 multiplies
// run in the JAX order (:505-507) with __fmul_rn, and the plain version
// (exact sums in f64) agrees bit for bit.
//
// Bound at bench.py's banded shape (nb = 1572 blocks of 128 rows, s_span =
// 5, D = 128): bytes, 128.8 MB of A, 25.8 MB of xq, 103 MB of f32 out and
// the row scale (about 0.078 ms at 3.35 TB/s); the products are 33 GOP
// (0.017 ms at the int8 tensor-core rate). The first version summed an
// 8 x 8 register block a thread with __dp4a on the CUDA cores, one block
// per destination block, each slot staged by plain loads between two
// barriers (no copy overlapped a product).
//
// This version is a client of banded_mma.cuh's slot loop in its kI8 mode:
// a persistent grid (two blocks of two warpgroups an SM) walks the
// destination blocks in ascending order, TMA brings each 32-deep chunk (the
// count tile's 32 columns, xq's 32 source rows) through a ring of four
// stages a chunk ahead, and the products run on the tensor cores as s8
// wgmma with s32 sums. s8 operands are read K-major only, and xq's
// contracted index is its row, so the kernel forms the transpose, out^T =
// xq^T A^T: the count chunk is B as it lies, and xq^T's fragments are built
// in registers from the staged rows by byte permutes (two features a
// thread). Rows that TMA cannot take (D not a multiple of 16, an unaligned
// operand) load by the loop's element path. The epilogue stages each f32
// row tile through shared memory (__int2float_rn, then * x_scale, then *
// rs) and writes it out in 16-byte rows.
#include "banded_mma.cuh"

namespace {

constexpr int kI8Stages = 4;
using I8Loop = SlotLoop<kI8Stages, false, false, true>;
constexpr int kI8Threads = I8Loop::kThreads;
constexpr int kI8Ld = kRow + 4;  // f32 output tile row stride: 64-bit stores free of conflicts

inline size_t int8_smem_bytes(const SlotArgs& p) {
  return 1024 + I8Loop::ring_bytes(p) + static_cast<size_t>(p.tile) * kI8Ld * 4;
}

__global__ void __launch_bounds__(kI8Threads, 2)
    spmm_banded_int8_kernel(const __grid_constant__ SlotArgs p, const float* __restrict__ x_scale,
                            const float* __restrict__ rs, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ int table[kTableInts];
  __shared__ uint64_t full[kI8Stages];
  unsigned char* smem = align1024(smem_raw);
  I8Loop loop(p, smem, table);
  float* out_s = reinterpret_cast<float*>(smem + I8Loop::ring_bytes(p));
  const int tile = p.tile, D = p.width, t = threadIdx.x & 3;
  const int f0 = I8Loop::x8_feature(0);
  const float xs = x_scale[0];

  auto epi = [&](int, int b, auto& acc) {
    const size_t row0 = static_cast<size_t>(b) * tile;
    // the previous block's copy-out is behind the stream's barriers
    if ((f0 & ~63) < D) {  // the warpgroup has features
#pragma unroll
      for (int nt = 0; nt < I8Loop::kNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = nt * 8 + 2 * t + e;
          if (r >= tile) continue;
          const float sc = rs[row0 + r];
          const float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[nt][e]), xs), sc);
          const float v1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[nt][e + 2]), xs), sc);
          *reinterpret_cast<float2*>(out_s + r * kI8Ld + f0) = make_float2(v0, v1);
        }
      }
    }
    __syncthreads();
    float* go = out + row0 * D;
    if (D % 4 == 0 && aligned16(out)) {
      const int cpr = D / 4;
      for (int idx = threadIdx.x; idx < tile * 32; idx += kI8Threads) {
        const int r = idx >> 5, c = idx & 31;
        if (c < cpr)
          *reinterpret_cast<float4*>(go + static_cast<size_t>(r) * D + 4 * c) =
              *reinterpret_cast<const float4*>(out_s + r * kI8Ld + 4 * c);
      }
    } else {
      for (int idx = threadIdx.x; idx < tile * kRow; idx += kI8Threads) {
        const int r = idx >> 7, c = idx & (kRow - 1);
        if (c < D) go[static_cast<size_t>(r) * D + c] = out_s[r * kI8Ld + c];
      }
    }
  };
  int acc[I8Loop::kNT][4] = {};
  auto first = [](int, int) {};
  auto mid = [](int, int, auto&) {};
  auto tail = [](int, const __nv_bfloat16*, auto&) {};
  loop.run(acc, full, first, mid, tail, epi);
}

}  // namespace

// a [nb, s_span, tile, tile] int8 counts, bo [nb] int32, xq [nb * tile, D]
// int8, x_scale [1] f32, rs [nb * tile] f32, out [nb * tile, D] f32.
extern "C" int spmm_banded_int8_launch(const void* a, const void* bo, int nb, int s_span,
                                       int tile, const void* xq, int D, const void* x_scale,
                                       const void* rs, void* out, void* stream) {
  if (!banded_shape_ok(nb, s_span, tile, D) || x_scale == nullptr || rs == nullptr)
    return SLDM_ERR_SHAPE;
  SlotArgs p{};
  p.a = a;
  p.a_kind = kAInt8;
  p.amode = kScaleNone;
  p.bo = static_cast<const int*>(bo);
  p.nb = nb;
  p.s_span = s_span;
  p.tile = tile;
  p.x = xq;
  p.width = D;
  I8Loop::make_maps(p);
  const size_t smem = int8_smem_bytes(p);
  int code = smem_opt_in(spmm_banded_int8_kernel, smem);
  if (code != 0) return code;
  int grid = 0;
  code = persistent_grid(spmm_banded_int8_kernel, kI8Threads, smem, nb, &grid);
  if (code != 0) return code;
  spmm_banded_int8_kernel<<<grid, kI8Threads, smem, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const float*>(x_scale), static_cast<const float*>(rs),
      static_cast<float*>(out));
  return cudaGetLastError();
}
