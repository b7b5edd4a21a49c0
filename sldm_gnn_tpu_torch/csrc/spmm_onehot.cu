// One-hot blocked SpMM: out[i] = sum over the live slots e (weight != 0 in
// the layout's structure) with destination row i of w_e * x[src_e], in f32,
// over the blocked layout (graph/csr.py).
//
// Replaces the TPU kernel `_spmm_kernel` (sldm_gnn_tpu/ops/spmm.py:64,
// launched by `spmm_pallas` :118, pallas_call :202): the aggregation of the
// one-hot layout, forward and (on the reverse layout) backward, the
// straggler half of the hybrid layout, and the SDDMM backward (per-edge
// cotangents as the weights).
//
// The TPU kernel gathers and scatters with two one-hot products per chunk
// on the MXU and carries a destination tile's sum across grid steps. On
// this card that is a gather and a scatter, so the products are not
// carried over: the wrapper derives once per layout (on the device, with
// torch ops) a plan of structure only, the live slots of every destination
// row in slot order (`row_ptr`, `perm`) and each live slot's global source
// row (`src_row`). The weights are read at every call through `perm`, so a
// layout that shares the plan with other weights (the SDDMM backward's)
// sums its own.
//
// Design. A destination row takes 16 lanes (bf16 x: 8 columns a lane) or a
// warp (f32 x: 4 columns a lane), so every lane reads its columns of a
// source row with one 16-byte load and a half-warp a 256-byte bf16 row.
// The row's group walks its slots in batches of one slot a lane: each lane
// loads its slot's source row and weight (two independent loads and the
// weight's gather through perm), and the group shares them by shuffles,
// 4 slots at a time, whose 4 row loads are issued before their adds. Where
// D is not a multiple of the lane's columns (or x or out is not 16-byte
// aligned) the loads are element by element, in the same kernel. Each
// output column adds its slots in slot order from 0, each step one f32
// multiply and one f32 add (__fmul_rn / __fadd_rn: no FMA contraction), so
// the plain version that adds in the same order agrees bit for bit and two
// launches repeat their bits (no atomics). Numerics of the TPU kernel: at
// DEFAULT (round = 1) the weight and x are rounded to bf16 and their exact
// product summed in f32; at HIGHEST (round = 0) f32 products.
//
// Bound at bench.py's one-hot shape (200 192 rows, tile 512, 7030 chunks
// of 512 slots, D = 128, bf16 x): bytes, the layout's 12 bytes a slot
// (src_local, dst_local, weight) plus x and out once (about 145 MB, 0.044
// ms at 3.35 TB/s); the plan adds 4 bytes a row and 8 a live slot. The
// gathers of x rows (256 bytes each, about 0.8 GB at bench.py's shape) are
// served mostly from the 50 MB L2, and the kernel is bound by them and by
// its issue (an unpack, a multiply and an add an element and slot).
#include "banded_gemm.cuh"

namespace {

constexpr int kBlockThreads = 256;
constexpr int kUnroll = 4;  // slots of a row whose loads are in flight together

// 16 bytes of a row: 8 bf16 or 4 f32 columns
template <bool kBf16>
struct Cols {
  static constexpr int kN = kBf16 ? 8 : 4;
  static constexpr int kLanes = 128 / kN;  // lanes a destination row
};

// the columns c .. c + kN - 1 of x's element offset `off` as their 16 raw
// bytes: one 16-byte load (kVec), else element by element, 0 past D
template <bool kBf16, bool kVec>
__device__ __forceinline__ uint4 load_cols(const void* __restrict__ x, size_t off, int c, int D) {
  if (kVec)
    return __ldg(reinterpret_cast<const uint4*>(static_cast<const char*>(x) +
                                                off * (kBf16 ? 2 : 4)));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < Cols<kBf16>::kN; ++j) {
    if (c + j >= D) continue;
    if (kBf16)
      w[j >> 1] |= static_cast<uint32_t>(__ldg(static_cast<const unsigned short*>(x) + off + j))
                   << (16 * (j & 1));
    else
      w[j] = __ldg(static_cast<const unsigned*>(x) + off + j);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// column j of 16 raw bytes as f32 (bf16 -> f32 is exact)
template <bool kBf16>
__device__ __forceinline__ float col(const uint4& u, int j) {
  const uint32_t w = (j >> (kBf16 ? 1 : 0)) == 0   ? u.x
                     : (j >> (kBf16 ? 1 : 0)) == 1 ? u.y
                     : (j >> (kBf16 ? 1 : 0)) == 2 ? u.z
                                                   : u.w;
  if (!kBf16) return __uint_as_float(w);
  return __uint_as_float((j & 1) ? (w & 0xffff0000u) : (w << 16));
}

template <bool kBf16, bool kVec>
__device__ __forceinline__ void store_cols(void* __restrict__ out, size_t off, int c, int D,
                                           const float (&v)[Cols<kBf16>::kN]) {
  constexpr int kN = Cols<kBf16>::kN;
  if (kVec) {
    uint32_t w[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      if (kBf16) {
        __nv_bfloat162 p;
        p.x = __float2bfloat16_rn(v[2 * h]);
        p.y = __float2bfloat16_rn(v[2 * h + 1]);
        w[h] = *reinterpret_cast<const uint32_t*>(&p);
      } else {
        w[h] = __float_as_uint(v[h]);
      }
    }
    *reinterpret_cast<uint4*>(static_cast<char*>(out) + off * (kBf16 ? 2 : 4)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      if (c + j >= D) continue;
      if (kBf16)
        static_cast<__nv_bfloat16*>(out)[off + j] = __float2bfloat16_rn(v[j]);
      else
        static_cast<float*>(out)[off + j] = v[j];
    }
  }
}

// slots j0 .. j0 + n - 1 of the group's batch (n <= kUnroll; lane q of the
// group holds slot q's source row and weight) added to acc in order, their
// row loads issued first. Every lane of the group runs the shuffles; only
// lanes with columns below D load and add.
template <bool kBf16, bool kVec, bool kTail>
__device__ __forceinline__ void add_slots(const void* __restrict__ x, unsigned mask, int src,
                                          float w, int j0, int n, int c, int D, bool round_x,
                                          float (&acc)[Cols<kBf16>::kN]) {
  constexpr int kN = Cols<kBf16>::kN, kLanes = Cols<kBf16>::kLanes;
  int s[kUnroll];
  float m[kUnroll];
#pragma unroll
  for (int q = 0; q < kUnroll; ++q) {
    if (kTail && q >= n) break;
    s[q] = __shfl_sync(mask, src, j0 + q, kLanes);
    m[q] = __shfl_sync(mask, w, j0 + q, kLanes);
  }
  if (c >= D) return;
  uint4 v[kUnroll];
#pragma unroll
  for (int q = 0; q < kUnroll; ++q)
    if (!kTail || q < n) v[q] = load_cols<kBf16, kVec>(x, static_cast<size_t>(s[q]) * D + c, c, D);
#pragma unroll
  for (int q = 0; q < kUnroll; ++q) {
    if (kTail && q >= n) break;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      float xv = col<kBf16>(v[q], j);
      if (!kBf16 && round_x) xv = bf16_round(xv);
      acc[j] = __fadd_rn(acc[j], __fmul_rn(m[q], xv));
    }
  }
}

// A group of kLanes lanes sums one destination row (kBlockThreads / kLanes
// rows a block).
template <bool kBf16, bool kVec>
__global__ void __launch_bounds__(kBlockThreads)
    spmm_onehot_kernel(const int* __restrict__ row_ptr, const int* __restrict__ perm,
                       const int* __restrict__ src_row, const float* __restrict__ weight,
                       int n_rows, const void* __restrict__ x, int D, int round,
                       void* __restrict__ out) {
  constexpr int kN = Cols<kBf16>::kN, kLanes = Cols<kBf16>::kLanes;
  constexpr int kRows = kBlockThreads / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int row = blockIdx.x * kRows + threadIdx.x / kLanes;
  if (row >= n_rows) return;  // the whole group leaves together
  const unsigned mask =
      kLanes == 32 ? 0xffffffffu : (0xffffu << (threadIdx.x & 31 & ~(kLanes - 1)));
  const int c = lane * kN;
  const bool round_x = round != 0;
  const int e0 = __ldg(row_ptr + row), e1 = __ldg(row_ptr + row + 1);
  float acc[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) acc[j] = 0.0f;
  for (int base = e0; base < e1; base += kLanes) {
    int src = 0;
    float w = 0.0f;
    if (base + lane < e1) {
      src = __ldg(src_row + base + lane);
      w = __ldg(weight + __ldg(perm + base + lane));
      if (round) w = bf16_round(w);
    }
    const int n = min(kLanes, e1 - base);
    int j0 = 0;
    for (; j0 + kUnroll <= n; j0 += kUnroll)
      add_slots<kBf16, kVec, false>(x, mask, src, w, j0, kUnroll, c, D, round_x, acc);
    if (j0 < n) add_slots<kBf16, kVec, true>(x, mask, src, w, j0, n - j0, c, D, round_x, acc);
  }
  if (c < D) store_cols<kBf16, kVec>(out, static_cast<size_t>(row) * D + c, c, D, acc);
}

template <bool kBf16, bool kVec>
int launch(const int* row_ptr, const int* perm, const int* src_row, const float* weight,
           int n_rows, const void* x, int D, int round, void* out, cudaStream_t stream) {
  constexpr int kRows = kBlockThreads / Cols<kBf16>::kLanes;
  spmm_onehot_kernel<kBf16, kVec><<<(n_rows + kRows - 1) / kRows, kBlockThreads, 0, stream>>>(
      row_ptr, perm, src_row, weight, n_rows, x, D, round, out);
  return cudaGetLastError();
}

}  // namespace

// row_ptr [n_rows + 1], perm and src_row [live slots] int32 (the wrapper's
// plan), weight [W * ec] f32 (the layout's, read through perm), x and out
// [n_rows, D] bf16 (x_bf16) or f32, D <= 128.
extern "C" int spmm_onehot_launch(const void* row_ptr, const void* perm, const void* src_row,
                                  const void* weight, int n_rows, const void* x, int x_bf16,
                                  int D, int round, void* out, void* stream) {
  if (n_rows <= 0 || D <= 0 || D > 128) return SLDM_ERR_SHAPE;
  // 16-byte loads and stores: D a multiple of their columns, x and out aligned
  const bool vec = D % (x_bf16 ? 8 : 4) == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const auto rp = static_cast<const int*>(row_ptr), pm = static_cast<const int*>(perm),
             sr = static_cast<const int*>(src_row);
  const auto w = static_cast<const float*>(weight);
  const auto s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return vec ? launch<true, true>(rp, pm, sr, w, n_rows, x, D, round, out, s)
               : launch<true, false>(rp, pm, sr, w, n_rows, x, D, round, out, s);
  return vec ? launch<false, true>(rp, pm, sr, w, n_rows, x, D, round, out, s)
             : launch<false, false>(rp, pm, sr, w, n_rows, x, D, round, out, s);
}
