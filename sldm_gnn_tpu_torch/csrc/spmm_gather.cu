// Banded row-gather SpMM: out[b*T + t] = rs * sum_{r < R} mult[b, r*T + t] *
// x[woff[b / k] * T + codes[b, r*T + t]], in f32, at x's dtype.
//
// Replaces the TPU kernel `_gather_kernel` (sldm_gnn_tpu/ops/spmm_gather.py:404,
// launched by `spmm_gather_pallas` :445, pallas_call :483), the low-degree
// tier's aggregation in both directions (the wrapper folds the reverse
// layout's column scale into x first). On the TPU that kernel never
// compiled (Mosaic gathers rows only within one vreg) and the JAX package
// runs its XLA form there; a row gather is native on this card.
//
// Design. A block of 8 warps sums one destination block of `tile` rows
// (or a run of its rows, for large R), whose source rows lie in one band
// of x, so the rows it gathers are served again from its SM's L1
// (read-only loads). It first copies the block's slots into shared memory:
// consecutive threads copy consecutive rows t (coalesced) into a
// [row][slot] layout, so a lane reads 4 slots' codes and multiplicities
// with two 16-byte loads. A destination row takes 16 lanes (bf16: 8
// columns a lane) or a warp (f32: 4 columns a lane), so every lane reads
// its columns of a source row with one 16-byte load, and a half-warp a
// 256-byte bf16 row. Each lane issues 4 slots' loads before their adds.
// Where D is not a multiple of those columns (or x is not aligned for the
// vector) the loads are element by element. Each output element adds slot
// 0, 1, ..., R-1 in order, each step one f32 multiply and one f32 add
// (__fmul_rn / __fadd_rn: no FMA contraction), so the plain version that
// adds in the same order agrees bit for bit; padding slots (multiplicity
// 0) are multiplied in like the others, as the plain version does. The
// card's time goes to issuing that arithmetic (a multiply, an add and a
// bf16 unpack an element and slot) more than to memory: with every code
// 0, so that each gather is an L1 hit, the kernel takes about as long as
// with bench.py's codes.
//
// Bound at bench.py's gather shape (201 216 rows, tile 128, K = 12, R = 24
// slots of an int32 code and an f32 multiplicity a row, D = 128, bf16 x):
// bytes, 8 R = 192 bytes a row of layout plus x and out once and the row
// scale, 142 MB: 0.0425 ms at 3.35 TB/s. The R row gathers (R x 256 bytes
// a destination row, 1.2 GB in all) come from L1 and the 50 MB L2, which
// holds x.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;              // slots of a row whose loads are in flight together
static_assert(kUnroll == 4, "a row's codes and multiplicities are read 4 slots a 16-byte load");
constexpr int kStageBytes = 24 * 1024;  // slot data of a block (fewer rows for large R)

// 16 bytes of a row: 8 bf16 or 4 f32 columns
template <bool kBf16>
struct Cols {
  static constexpr int kN = kBf16 ? 8 : 4;
};

// the columns c .. c + kN - 1 of one row as f32: one 16-byte load (kVec),
// else element by element, 0 past D
template <bool kBf16, bool kVec>
__device__ __forceinline__ void load_cols(const void* __restrict__ x, size_t off, int c, int D,
                                          float (&v)[Cols<kBf16>::kN]) {
  constexpr int kN = Cols<kBf16>::kN;
  if (kVec) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(
        static_cast<const char*>(x) + off * (kBf16 ? 2 : 4)));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      if (kBf16) {
        v[2 * h] = __uint_as_float(w[h] << 16);  // bf16 -> f32 is exact
        v[2 * h + 1] = __uint_as_float(w[h] & 0xffff0000u);
      } else {
        v[h] = __uint_as_float(w[h]);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      v[j] = 0.0f;
      if (c + j < D)
        v[j] = kBf16 ? __bfloat162float(__ldg(static_cast<const __nv_bfloat16*>(x) + off + j))
                     : __ldg(static_cast<const float*>(x) + off + j);
    }
  }
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

// slots r0 .. r0 + n - 1 of one row (n <= kUnroll; their codes and
// multiplicities at sc, sm) added to acc in order, their loads issued first
template <bool kBf16, bool kVec, bool kTail>
__device__ __forceinline__ void add_slots(const void* __restrict__ x, const int* sc,
                                          const float* sm, int base, int n, int c, int D,
                                          float (&acc)[Cols<kBf16>::kN]) {
  constexpr int kN = Cols<kBf16>::kN;
  const int4 cc = *reinterpret_cast<const int4*>(sc);
  const float4 mm = *reinterpret_cast<const float4*>(sm);
  const int src[kUnroll] = {cc.x, cc.y, cc.z, cc.w};
  const float m[kUnroll] = {mm.x, mm.y, mm.z, mm.w};
  float v[kUnroll][kN];
#pragma unroll
  for (int q = 0; q < kUnroll; ++q)
    if (!kTail || q < n)
      load_cols<kBf16, kVec>(x, static_cast<size_t>(base + src[q]) * D + c, c, D, v[q]);
#pragma unroll
  for (int q = 0; q < kUnroll; ++q) {
    if (kTail && q >= n) break;
#pragma unroll
    for (int j = 0; j < kN; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(m[q], v[q][j]));
  }
}

// A block sums `run` rows t0 .. t0 + run - 1 of destination block b
// (blockIdx.x = b, blockIdx.y = t0 / run). It first copies their slots
// into shared memory, consecutive threads on consecutive rows t (coalesced),
// as codes and multiplicities [run][Rp] (Rp = R rounded up to 4, so 4 slots
// of a row are one 16-byte shared load). A row takes 16 lanes (bf16, 8
// columns a lane) or 32 (f32, 4 columns a lane).
template <bool kBf16, bool kVec>
__global__ void __launch_bounds__(kThreads, 4)
    spmm_gather_kernel(const int* __restrict__ codes, int code_rows,
                       const float* __restrict__ mult, const int* __restrict__ woff, int tile,
                       int k, int R, int run, const void* __restrict__ x, int D,
                       const float* __restrict__ rs, void* __restrict__ out) {
  constexpr int kN = Cols<kBf16>::kN, kLanes = 128 / kN, kRows = kThreads / kLanes;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Rp = (R + 3) & ~3, Rfull = R & ~(kUnroll - 1);
  int* scode = reinterpret_cast<int*>(smem);                 // [run][Rp]
  float* smul = reinterpret_cast<float*>(scode + Rp * run);  // [run][Rp]
  const int b = blockIdx.x, t0 = blockIdx.y * run, n = min(run, tile - t0);
  const int* cb = codes + static_cast<size_t>(b) * code_rows + t0;
  const float* mb = mult + static_cast<size_t>(b) * R * tile + t0;
  for (int e = threadIdx.x; e < R * n; e += kThreads) {
    const int r = e / n, i = e - r * n;
    scode[i * Rp + r] = __ldg(cb + r * tile + i);
    smul[i * Rp + r] = __ldg(mb + r * tile + i);
  }
  __syncthreads();
  const int c = (threadIdx.x % kLanes) * kN;
  if (c >= D) return;
  const int base = woff[b / k] * tile;
  for (int i = threadIdx.x / kLanes; i < n; i += kRows) {
    const int* sc = scode + i * Rp;
    const float* sm = smul + i * Rp;
    float acc[kN];
#pragma unroll
    for (int j = 0; j < kN; ++j) acc[j] = 0.0f;
    for (int r0 = 0; r0 < Rfull; r0 += kUnroll)
      add_slots<kBf16, kVec, false>(x, sc + r0, sm + r0, base, kUnroll, c, D, acc);
    if (Rfull < R)
      add_slots<kBf16, kVec, true>(x, sc + Rfull, sm + Rfull, base, R - Rfull, c, D, acc);
    const size_t row = static_cast<size_t>(b) * tile + t0 + i;
    if (rs != nullptr) {
      const float scale = rs[row];
#pragma unroll
      for (int j = 0; j < kN; ++j) acc[j] = __fmul_rn(acc[j], scale);
    }
    store_cols<kBf16, kVec>(out, row * D + c, c, D, acc);
  }
}

}  // namespace

// codes [nb, code_rows] int32 (code_rows >= R * tile), mult [nb, R * tile]
// f32, woff [nb / k] int32, x and out [nb * tile, D] bf16 (x_bf16) or f32,
// rs [nb * tile] f32 or NULL; D <= 128.
extern "C" int spmm_gather_launch(const void* codes, int code_rows, const void* mult,
                                  const void* woff, int nb, int tile, int k, int R,
                                  const void* x, int x_bf16, int D, const void* rs, void* out,
                                  void* stream) {
  if (nb <= 0 || tile <= 0 || k <= 0 || nb % k || R <= 0 || code_rows < R * tile || D <= 0 ||
      D > 128)
    return SLDM_ERR_SHAPE;
  // rows of a block: the whole tile where its slots fit kStageBytes
  const int Rp = (R + 3) & ~3, run = max(1, min(tile, kStageBytes / (8 * Rp)));
  const size_t smem = static_cast<size_t>(Rp) * run * 8;
  if (smem > 48 * 1024) return SLDM_ERR_SHAPE;
  // 16-byte loads and stores: D a multiple of their columns, x and out aligned
  const bool vec = D % (x_bf16 ? 8 : 4) == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  using Kernel = decltype(&spmm_gather_kernel<true, true>);
  const Kernel kernel =
      x_bf16 ? (vec ? &spmm_gather_kernel<true, true> : &spmm_gather_kernel<true, false>)
             : (vec ? &spmm_gather_kernel<false, true> : &spmm_gather_kernel<false, false>);
  kernel<<<dim3(nb, (tile + run - 1) / run), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(codes), code_rows, static_cast<const float*>(mult),
      static_cast<const int*>(woff), tile, k, R, run, x, D, static_cast<const float*>(rs), out);
  return cudaGetLastError();
}
