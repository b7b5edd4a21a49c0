// The pieces the GRU's tensor-core kernels share (gru_fwd.cu's forward,
// gru_bwd.cuh's reverse kernels): the gate functions, wgmma with both
// operands from shared memory at the widths a warpgroup's units give, the
// padded widths, and TMA's 3-D tiles of [T, N, W] arrays.
#pragma once

#include "banded_mma.cuh"

namespace {

// 1 / (1 + e^-v): the correctly rounded reciprocal is the IEEE quotient 1 / x
__device__ __forceinline__ float sigmoid(float v) { return __frcp_rn(1.0f + expf(-v)); }

constexpr int kTcWarpgroups = 4;
constexpr int kTcThreads = 128 * kTcWarpgroups;
constexpr int kTcRows = 64;  // rows of a tile (wgmma's M)

// d (= or +=, by scale_d) A @ B: wgmma m64n8k16, A K-major, B K-major (TB 0) or
// N-contiguous (TB 1)
template <int TB>
__device__ __forceinline__ void wgmma_kk_n8(float (&d)[4], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1, 0, %7;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

// d (= or +=, by scale_d) A @ B: wgmma m64n16k16, A K-major, B K-major (TB 0) or
// N-contiguous (TB 1)
template <int TB>
__device__ __forceinline__ void wgmma_kk_n16(float (&d)[8], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, %11;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

// d (= or +=, by scale_d) A @ B: wgmma m64n24k16, A K-major, B K-major (TB 0) or
// N-contiguous (TB 1)
template <int TB>
__device__ __forceinline__ void wgmma_kk_n24(float (&d)[12], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
      "%12, %13, p, 1, 1, 0, %15;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

// d (= or +=, by scale_d) A @ B: wgmma m64n32k16, A K-major, B K-major (TB 0) or
// N-contiguous (TB 1)
template <int TB>
__device__ __forceinline__ void wgmma_kk_n32(float (&d)[16], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, %19;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

// d (= or +=, by scale_d) A @ B: wgmma m64n48k16, A K-major, B K-major (TB 0) or
// N-contiguous (TB 1)
template <int TB>
__device__ __forceinline__ void wgmma_kk_n48(float (&d)[24], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, 0, %27;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

// d (= or +=, by scale_d) A @ B: wgmma m64n64k16, A K-major, B K-major (TB 0) or
// N-contiguous (TB 1)
template <int TB>
__device__ __forceinline__ void wgmma_kk_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

// d (= or +=, by scale_d) A @ B: wgmma m64n72k16, A K-major, B K-major (TB 0) or
// N-contiguous (TB 1)
template <int TB>
__device__ __forceinline__ void wgmma_kk_n72(float (&d)[36], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35}, "
      "%36, %37, p, 1, 1, 0, %39;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

// d (= or +=, by scale_d) A @ B: wgmma m64n96k16, A K-major, B K-major (TB 0) or
// N-contiguous (TB 1)
template <int TB>
__device__ __forceinline__ void wgmma_kk_n96(float (&d)[48], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, 0, %51;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

// the padded widths of the tensor-core kernel
__host__ __device__ inline int tc_hp(int H) { return (H + 31) / 32 * 32; }
__host__ __device__ inline int tc_dp(int D) { return (D + 15) / 16 * 16; }
__host__ __device__ inline int halves(int k) { return (k + 63) / 64; }

// bytes of one K-major swz_h tile of `rows` rows and `k` columns
__host__ __device__ inline size_t tc_tile_bytes(int rows, int k) {
  return static_cast<size_t>(rows) * 128 * halves(k);
}

template <int N>
__device__ __forceinline__ void pin_n(float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(v[i])::"memory");
}

template <int N, int TB = 0>
__device__ __forceinline__ void mma_n(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 8) wgmma_kk_n8<TB>(d, da, db, scale_d);
  if constexpr (N == 16) wgmma_kk_n16<TB>(d, da, db, scale_d);
  if constexpr (N == 24) wgmma_kk_n24<TB>(d, da, db, scale_d);
  if constexpr (N == 32) wgmma_kk_n32<TB>(d, da, db, scale_d);
  if constexpr (N == 48) wgmma_kk_n48<TB>(d, da, db, scale_d);
  if constexpr (N == 64) wgmma_kk_n64<TB>(d, da, db, scale_d);
  if constexpr (N == 72) wgmma_kk_n72<TB>(d, da, db, scale_d);
  if constexpr (N == 96) wgmma_kk_n96<TB>(d, da, db, scale_d);
}

// TMA: the box of the 3-D `map` at (c0, c1, c2) from shared memory, in the
// thread's bulk group
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          map),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the thread's bulk stores have read their shared memory (read) or are done
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// a pair of bf16 outputs at p[i], p[i + 1] (columns j, j + 1 of width W);
// one 4-byte store where both exist and W is even (i is then even)
__device__ __forceinline__ void store_bf16_pair(__nv_bfloat16* p, size_t i, uint32_t v, int j,
                                                int W) {
  if (j + 1 < W && W % 2 == 0) {
    *reinterpret_cast<uint32_t*>(p + i) = v;
  } else {
    if (j < W) p[i] = *reinterpret_cast<const __nv_bfloat16*>(&v);
    if (j + 1 < W) p[i + 1] = reinterpret_cast<const __nv_bfloat16*>(&v)[1];
  }
}

// A map of a [T, N, W] bf16 array in boxes of one frame, box_rows rows and
// 64 columns under the 128-byte swizzle (a swz_h tile's 64-column half):
// stores skip rows past N and columns past W, loads read them as 0. False
// where TMA cannot take it (W * 2 not a multiple of 16, an unaligned start).
inline bool make_out_map(CUtensorMap* map, const void* base, int W, int N, int T,
                         int box_rows = kTcRows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr || base == nullptr || (reinterpret_cast<uintptr_t>(base) & 15) != 0 ||
      (static_cast<size_t>(W) * 2) % 16 != 0)
    return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(T)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(W) * 2,
                                 static_cast<cuuint64_t>(W) * 2 * N};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// TMA: the box of the 3-D `map` at (c0, c1, c2) into dst, signalling bar
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

}  // namespace
