// The tensor-core slot loop shared by the SpMM kernel of slot_spmm.cuh
// (spmm_banded.cu, spmm_dense.cu), the fused forward of sage_fused_fwd.cu,
// the reverse kernel of sage_fused_bwd.cu and the int8 banded kernel of
// spmm_banded_int8.cu (SlotLoop's kI8 mode, below), and the PTX building
// blocks they use.
//
// A block of two warpgroups accumulates an output tile of at most 128 x 128
// f32 sums, acc = sum_s A[b, s] @ B[src(b, s)], with wgmma m64n128k16 on
// bf16 operands (the product of two bf16 values is exact in f32, so only the
// order of the f32 sums differs from the FMA path); warpgroup w takes rows
// 64 w ... The depth is walked in chunks of 32 rows of B (32 columns of A):
//   * a ring of NST stages in shared memory is filled by TMA NST - 1 chunks
//     ahead of the products: one thread starts a chunk's few tensor and bulk
//     copies, and an mbarrier a stage counts their bytes. A stage holds the
//     count tile's 32 columns (int8 with TMA's 32-byte swizzle, bf16 with its
//     64-byte one, or f32 weights with its 128-byte one), B's 32 rows (bf16,
//     or the raw rows when B needs a pass) and the 32 source rows' scales cs
//     and rstd. (16-byte cp.async copies, started by every thread, kept the
//     warps waiting on the load/store queue longer than the products took.)
//   * A's fragments are built in registers (wgmma takes A from registers):
//     the conversion to bf16 and the column scale of the reverse kernels
//     (bf16(bf16(A) * bf16(cs)), or bf16(A * rstd * cs) under LayerNorm)
//     happen there, per element, as the TPU kernels fold them. Counts become
//     bf16 by byte permutes and one f32 add (exact for every int8) rather
//     than by the conversion unit, whose quarter rate would bound the loop;
//     bf16 tiles are read as they are.
//   * B is read by wgmma from shared memory through a descriptor: two
//     64-column halves of 32 rows of 128 bytes, each row's 16-byte pieces
//     XOR-swizzled by the row (wgmma's 128-byte swizzle, swz_h; N
//     contiguous). Where B is f32, or its rows carry the column scale cs
//     (spmm_banded's reverse layout), one pass over the arrived rows forms
//     bf16(cs * B) first. (mma.sync runs at half wgmma's rate on this card
//     and bounded the loop.)
//   * rows whose byte width is not a multiple of 16, and operands that are
//     not 16-byte aligned, which TMA cannot take, load by an element path in
//     the same kernel.
// With kI8 (int8 features, exact int32 sums) the product is transposed,
// out^T = xq^T A^T, by wgmma m64n128k32 on s8 operands: the count chunk as
// it lies is B (K-major, TMA's 32-byte swizzle, which wgmma reads as it is;
// s8 operands have no transpose bit), and xq's 32 staged rows (128 bytes
// each under TMA's 128-byte swizzle) become A's fragments in registers by
// byte permutes: warpgroup w takes the features 64 w ..., N the tile's rows
// (rows past the tile multiply as whatever lies there and are dropped).
// A persistent block walks destination blocks blockIdx.x, + gridDim.x, ...
// as one stream of chunks, so the next block's copies are in flight while
// the caller's epilogue runs. Slot s of block b reads source tile bo[b] + s
// (banded), the clamped woff[b / k] + cmap[b * s_span + s] (cmap; both
// looked up once, a chunk ahead of the block's first copy, into a table in
// shared memory), or src[b * s_span + s] as given (the dense layout's
// explicit source blocks: read by every thread a chunk ahead of the slot's
// first copy, so s_span has no bound there). A's slot tile is read where it
// lies: tile s of block b of the narrow layout [nb, s_span, tile, tile], or
// columns s * tile .. of block b's rows of the wide one [nb, tile, s_span *
// tile] (widen_banded); the chunks, their order and the sums are the same,
// so the two layouts give the same bits.
#pragma once

#include <cuda.h>  // CUtensorMap (the encoder comes through the runtime's entry-point query)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "banded_gemm.cuh"

namespace {

constexpr int kChunk = 32;              // depth of one staged chunk
constexpr int kRow = 128;               // elements of one staged row (the widest width)
constexpr int kVecFloats = 2 * kChunk;  // cs and rstd of a chunk's source rows

// the column scale of A (reverse kernels)
enum : int {
  kScaleNone = 0,    // bf16(A)
  kScaleCs = 1,      // bf16(bf16(A) * bf16(cs))       fused backward
  kScaleRstdCs = 2,  // bf16(A * (rstd * cs))          LayerNorm backward
  kScaleRstd = 3,    // bf16(A * rstd)                 LayerNorm backward, no 1/deg
};

// ------------------------------------------------------------ PTX

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// arrive on bar, expecting `bytes` more from the copies that signal it
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// TMA: the box of `map` at (column c0, row c1) into dst, signalling bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(map), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// shared memory written by the threads (generic proxy) becomes visible to
// wgmma's reads (async proxy); before the barrier that publishes it
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// keep the compiler from moving reads of v above a wgmma_wait
template <int R>
__device__ __forceinline__ void pin(float (&v)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(v[i][e])::"memory");
}

template <int R>
__device__ __forceinline__ void pin(int (&v)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(v[i][e])::"memory");
}

// d[16][4] += a @ B on s8 operands, s32 sums (wgmma m64n128k32: A from
// registers, mma.sync's m16n8k32 fragment layout a warp; B from shared
// memory, K-major). Integer sums are exact. Asynchronous, as wgmma_n128.
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[16][4], const uint32_t (&a)[4],
                                              uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
        "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
        "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
        "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3]),
        "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]),
        "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3]),
        "+r"(d[10][0]), "+r"(d[10][1]), "+r"(d[10][2]), "+r"(d[10][3]),
        "+r"(d[11][0]), "+r"(d[11][1]), "+r"(d[11][2]), "+r"(d[11][3]),
        "+r"(d[12][0]), "+r"(d[12][1]), "+r"(d[12][2]), "+r"(d[12][3]),
        "+r"(d[13][0]), "+r"(d[13][1]), "+r"(d[13][2]), "+r"(d[13][3]),
        "+r"(d[14][0]), "+r"(d[14][1]), "+r"(d[14][2]), "+r"(d[14][3]),
        "+r"(d[15][0]), "+r"(d[15][1]), "+r"(d[15][2]), "+r"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d[16][4] += a @ B (wgmma m64n128k16: A from registers, each warp 16 rows
// in mma.sync's m16n8k16 fragment layout; B from shared memory by
// descriptor, N-contiguous). Asynchronous: the accumulators are not to be
// touched before wgmma_wait.
__device__ __forceinline__ void wgmma_n128(float (&d)[16][4], const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d[16][4] += A @ B (wgmma m64n128k16, both from shared memory by descriptor;
// B N-contiguous, A K-contiguous (TA = 0) or M-contiguous (TA = 1)).
// Asynchronous, as wgmma_n128.
template <int TA>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[16][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(1), "n"(TA));
}

// two f32 -> one register of two bf16 (round to nearest even), lo first
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// v rounded to bf16 (to nearest, ties to even) by integer operations, for
// finite v: the conversion unit runs at a quarter of the rate
__device__ __forceinline__ float bf16_round_int(float v) {
  const uint32_t u = __float_as_uint(v);
  return __uint_as_float((u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u);
}

// Byte k of w (w = four int8 with 0x80 flipped in each) as an exact f32:
// the bit pattern 0x4B0000xx with xx = v + 128 is 2^23 + 128 + v.
__device__ __forceinline__ float s8_to_f32(uint32_t w, int k) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 | k)) - 8388736.0f;
}

// Bytes k, k + 1 of w as bf16x2: an int8 has at most 8 significant bits,
// so its f32 has a zero low half and the upper half is its bf16, exactly.
__device__ __forceinline__ uint32_t s8x2_to_bf16x2(uint32_t w, int k) {
  return __byte_perm(__float_as_uint(s8_to_f32(w, k)), __float_as_uint(s8_to_f32(w, k + 1)),
                     0x7632);
}

// ------------------------------------------------------------ layouts

// Element offset of (r, c) in a bf16 tile of `rows` rows and up to 128
// columns, stored as two 64-column halves of rows x 128 bytes, each row's
// 16-byte pieces XOR-swizzled by r % 8: wgmma's 128-byte swizzle (the tile
// 1024-byte aligned). Every tile the tensor cores read is laid out so.
__device__ __forceinline__ int swz_h(int rows, int r, int c) {
  return (c >> 6) * (rows * 64) + r * 64 + ((((c >> 3) & 7) ^ (r & 7)) << 3) + (c & 7);
}

// wgmma descriptor (128-byte swizzle) of the part of such a tile that
// starts at `at` (a row that is a multiple of 8; for the contiguous
// dimension, a column that is a multiple of 64, or of 16 within a half
// where the columns are the depth): 8-row groups 1024 bytes apart, the
// halves rows * 128 bytes apart
__device__ __forceinline__ uint64_t desc_h(const __nv_bfloat16* at, int rows) {
  const uint64_t a = smem_u32(at);
  return ((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>((rows * 128) >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// wgmma descriptor of a K-major s8 tile of 32-byte rows under the 32-byte
// swizzle (an int8 count chunk as TMA or a8_off lays it): 8-row groups 256
// bytes apart
__device__ __forceinline__ uint64_t desc_k32(const void* at) {
  const uint64_t a = smem_u32(at);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (static_cast<uint64_t>(256 >> 4) << 32) |
         (3ull << 62);
}

// byte offset of (r, c) in a staged int8 row chunk of 128-byte rows (TMA's
// 128-byte swizzle: the 16-byte pieces XOR-swizzled by r % 8)
__device__ __forceinline__ int x8_off(int r, int c) {
  return r * kRow + ((((c >> 4) ^ r) & 7) << 4) + (c & 15);
}

// byte offset of (r, c) in an int8 chunk of 32 columns (two pieces a row,
// swapped every four rows: fragment reads of eight rows are conflict-free)
__device__ __forceinline__ int a8_off(int r, int c) {
  return r * kChunk + ((((c >> 4) ^ (r >> 2)) & 1) << 4) + (c & 15);
}

// element offset of (r, c) in a bf16 chunk of 32 columns (TMA's 64-byte
// swizzle: four pieces a row, swapped by row / 2; fragment reads of eight
// rows are conflict-free)
__device__ __forceinline__ int a16_off(int r, int c) {
  return r * kChunk + ((((c >> 3) ^ (r >> 1)) & 3) << 3) + (c & 7);
}

// float offset of (r, c) in an f32 chunk of 32 columns (eight pieces a row,
// swizzled by row)
__device__ __forceinline__ int a32_off(int r, int c) {
  return r * kChunk + ((((c >> 2) ^ r) & 7) << 2) + (c & 3);
}

// The element path, where TMA cannot take an operand (rows whose bytes are
// not a multiple of 16, or an unaligned start): rows [r0, r0 + rows) of a
// [*, W] bf16 (src_bf16) or f32 array, as a swz_h tile of half_rows rows
// (half_rows > 0, bf16 source) or as raw rows of kRow elements of the
// source type; with `round`, an f32 source as a swz_h bf16 tile. Columns
// from W on are left as they are.
__device__ __forceinline__ void load_rows(void* dst, int half_rows, const void* src, int src_bf16,
                                          size_t r0, int rows, int W, bool round = false) {
  for (int idx = threadIdx.x; idx < rows * kRow; idx += blockDim.x) {
    const int r = idx >> 7, c = idx & (kRow - 1);
    if (c >= W) continue;
    const size_t gi = (r0 + r) * W + c;
    if (src_bf16)
      static_cast<__nv_bfloat16*>(dst)[half_rows > 0 ? swz_h(half_rows, r, c) : r * kRow + c] =
          static_cast<const __nv_bfloat16*>(src)[gi];
    else if (round)
      static_cast<__nv_bfloat16*>(dst)[swz_h(half_rows, r, c)] =
          __float2bfloat16_rn(static_cast<const float*>(src)[gi]);
    else
      static_cast<float*>(dst)[r * kRow + c] = static_cast<const float*>(src)[gi];
  }
}

// One pass over kChunk raw staged rows (bf16 or f32, kRow elements a row):
// dst (a swz_h tile of kChunk rows) = bf16(raw * scale[row]) (scale may be
// NULL), for the columns below W.
__device__ __forceinline__ void transform_rows(__nv_bfloat16* dst, const void* raw, int raw_bf16,
                                               const float* scale, int W) {
  for (int idx = threadIdx.x; idx < kChunk * (kRow / 8); idx += blockDim.x) {
    const int r = idx >> 4, c = idx & 15;
    if (c * 8 >= W) continue;
    float v[8];
    if (raw_bf16) {
      const uint4 u = *reinterpret_cast<const uint4*>(
          static_cast<const __nv_bfloat16*>(raw) + r * kRow + c * 8);
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
        v[2 * j] = f.x;
        v[2 * j + 1] = f.y;
      }
    } else {
      const float* f = static_cast<const float*>(raw) + r * kRow + c * 8;
      const float4 f0 = *reinterpret_cast<const float4*>(f);
      const float4 f1 = *reinterpret_cast<const float4*>(f + 4);
      v[0] = f0.x, v[1] = f0.y, v[2] = f0.z, v[3] = f0.w;
      v[4] = f1.x, v[5] = f1.y, v[6] = f1.z, v[7] = f1.w;
    }
    if (scale != nullptr) {
      const float s = scale[r];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] *= s;
    }
    uint4 o;
    o.x = pack_bf16(v[0], v[1]);
    o.y = pack_bf16(v[2], v[3]);
    o.z = pack_bf16(v[4], v[5]);
    o.w = pack_bf16(v[6], v[7]);
    *reinterpret_cast<uint4*>(dst + swz_h(kChunk, r, c * 8)) = o;
  }
}

// ------------------------------------------------------------ the slot loop

// Tensor maps for TMA, made on the host at each launch.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// A map of the [rows, cols] array at `base` (rows `cols` elements apart) in
// boxes of [box_rows, box_cols]; false where TMA cannot take it (a row's
// bytes not a multiple of 16, an unaligned start, no encoder), and then
// the kernels take the element path. Out-of-range parts of a box read as 0.
inline bool make_map(CUtensorMap* map, const void* base, int esz, size_t rows, int cols,
                     int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr || base == nullptr || (reinterpret_cast<uintptr_t>(base) & 15) != 0 ||
      (static_cast<size_t>(cols) * esz) % 16 != 0)
    return false;
  const CUtensorMapDataType t = esz == 1   ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                : esz == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                           : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * esz};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, t, 2, const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a map of B-like rows [rows, W]: 32-row boxes, as two swizzled 64-column
// halves (bf16, no pass) or as raw rows of kRow elements (with a pass)
inline bool make_rows_map(CUtensorMap* map, const void* base, int bf16, size_t rows, int W,
                          int box_rows, bool raw) {
  return raw ? make_map(map, base, bf16 ? 2 : 4, rows, W, box_rows, kRow,
                        CU_TENSOR_MAP_SWIZZLE_NONE)
             : make_map(map, base, 2, rows, W, box_rows, 64, CU_TENSOR_MAP_SWIZZLE_128B);
}

// the element type of A's tiles (spmm_dense.py's TILE_KINDS)
enum : int { kAInt8 = 0, kAF32 = 1, kABf16 = 2 };

__host__ __device__ inline int a_elem_bytes(int a_kind) {
  return a_kind == kAInt8 ? 1 : a_kind == kAF32 ? 4 : 2;
}

struct SlotArgs {
  CUtensorMap map_a;  // A as [nb * s_span * tile, tile] (wide: [nb * tile, s_span * tile]),
                      // boxes [tile, 32]
  CUtensorMap map_x;  // B as [nb * tile, width], boxes of 32 rows
  const void* a;      // [nb, s_span, tile, tile] of a_kind (wide: [nb, tile, s_span * tile])
  int a_kind;         // kAInt8, kAF32 or kABf16
  int wide;           // A's slots folded into columns (widen_banded), read in place
  int amode;  // kScale*: A's column scale
  const int* bo;
  const int* cmap;  // [nb * s_span] or NULL
  const int* woff;  // [nb / k] with cmap
  const int* src;   // [nb * s_span] source tiles as given (< nb): SlotLoop's kSrc
  int k, nb, s_span, tile;
  const void* x;  // B: [nb * tile, width] bf16 (x_bf16), f32, or int8 (SlotLoop's kI8)
  int x_bf16, width;
  const float* cs;    // [nb * tile] per source row, or NULL
  const float* rstd;  // [nb * tile] per source row, or NULL
  int transform;      // B staged raw, then bf16(B (* cs)) by one pass
  int bscale;         // that pass multiplies by cs
  int tma_a, tma_x;   // the maps are made (else the element paths)
};

// A tail of `tail` (> 0) chunks a block after the slots (SlotLoop's kTail):
// 32-row chunks of w[0] then of w[1] (bf16 [wrows, wcols] each, rows past
// wrows read as 0), in the B part of the stages (the reverse kernel's
// [Wl^T; Wr^T])
struct TailArgs {
  CUtensorMap map_w[2];
  const __nv_bfloat16* w[2];
  int wrows, wcols, tail, tma_w;
};

// the depth of a tail's halves: a width rounded up to whole 32-row chunks
__host__ __device__ inline int depth32(int w) { return (w + 31) / 32 * 32; }

// rows of a tile that a tail's products read from shared memory: whole
// 64-row wgmma blocks (rows past the tile are read, and their products
// dropped)
__host__ __device__ inline int tile_rows64(int tile) { return (tile + 63) / 64 * 64; }

// the slot loop's maps: A's chunks (rows of 32, 64 or 128 bytes for int8,
// bf16 or f32, each under the swizzle of its width) and B's rows (int8,
// x_i8: one box of 32 rows of 128 bytes, columns past the width read as 0).
// A kI8 loop's client asks SlotLoop::make_maps / ring_bytes, which pass it.
inline void make_slot_maps(SlotArgs& p, bool x_i8 = false) {
  const size_t a_rows = static_cast<size_t>(p.nb) * (p.wide ? 1 : p.s_span) * p.tile;
  const int a_cols = p.wide ? p.s_span * p.tile : p.tile;
  p.tma_a = make_map(&p.map_a, p.a, a_elem_bytes(p.a_kind), a_rows, a_cols, p.tile, kChunk,
                     p.a_kind == kAF32    ? CU_TENSOR_MAP_SWIZZLE_128B
                     : p.a_kind == kABf16 ? CU_TENSOR_MAP_SWIZZLE_64B
                                          : CU_TENSOR_MAP_SWIZZLE_32B);
  const size_t x_rows = static_cast<size_t>(p.nb) * p.tile;
  if (x_i8)
    p.tma_x = make_map(&p.map_x, p.x, 1, x_rows, p.width, kChunk, kRow,
                       CU_TENSOR_MAP_SWIZZLE_128B);
  else
    p.tma_x = (p.transform || p.x_bf16) &&
              make_rows_map(&p.map_x, p.x, p.x_bf16, x_rows, p.width, kChunk, p.transform != 0);
}

__host__ __device__ inline int slot_a_bytes(int tile, int a_kind) {
  return tile * kChunk * a_elem_bytes(a_kind);
}

__host__ __device__ inline int slot_b_bytes(int x_bf16, int transform, int x_i8) {
  return kChunk * kRow * (x_i8 ? 1 : transform && !x_bf16 ? 4 : 2);
}

__host__ __device__ inline int slot_stage_bytes(int tile, int a_kind, int x_bf16, int transform,
                                                int x_i8) {
  const int n =
      slot_a_bytes(tile, a_kind) + slot_b_bytes(x_bf16, transform, x_i8) + kVecFloats * 4;
  return (n + 1023) / 1024 * 1024;  // B's halves stay 1024-byte aligned
}

// bytes of the ring and of the transformed-B tile (the caller adds 1024 to
// align the ring's start)
__host__ __device__ inline size_t slot_ring_bytes(int nst, const SlotArgs& p,
                                                  bool x_i8 = false) {
  return static_cast<size_t>(nst) *
             slot_stage_bytes(p.tile, p.a_kind, p.x_bf16, p.transform, x_i8) +
         (p.transform ? kChunk * kRow * 2 : 0);
}

// slot tables: [2][kMaxCmapSlots] source tiles (cmap) and [2] bases, by
// the parity of the block's place in the stream
constexpr int kTableInts = 2 * kMaxCmapSlots + 2;

// 1024-byte aligned start of a block's dynamic shared memory (the launch
// asks for 1024 bytes more)
__device__ __forceinline__ unsigned char* align1024(unsigned char* smem) {
  return smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
}

// NST stages; with kTail the stream carries a TailArgs' tail; with kSrc
// the slots' sources are SlotArgs' src and A may be bf16 (the dense
// layout: a compile-time mode, so the banded kernels' loop carries none of
// its branches); warpgroup w at rows 64 w; warp v of a warpgroup holds
// rows 16 v + g and + 8 of its 64 (g = lane / 4, t = lane % 4): acc[j][e]
// is row 16 v + g + 8 (e / 2), column 8 j + 2 t + e % 2 of the
// warpgroup's tile. With kI8 (int8 B, s32 acc) the tile is transposed:
// acc[j][e] is tile row 8 j + 2 t + e % 2 and feature x8_feature(e / 2).
template <int NST, bool kTail = false, bool kSrc = false, bool kI8 = false>
struct SlotLoop {
  static constexpr int kNT = 16;  // n-tiles of 8 columns
  static constexpr int kThreads = 256;
  // the ring's bytes and the maps for this loop's mode (the host's view of kI8)
  __host__ __device__ static size_t ring_bytes(const SlotArgs& a) {
    return slot_ring_bytes(NST, a, kI8);
  }
  static void make_maps(SlotArgs& a) { make_slot_maps(a, kI8); }
  const SlotArgs& p;
  const TailArgs* tl;  // with kTail
  unsigned char* ring;
  __nv_bfloat16* bfb;  // transformed B
  int* table;
  int stage_bytes, a_bytes, b_bytes;
  int cpt, C, nblk;
  long Q;
  // copy cursor: the next chunk to copy (it: the chunk of the tail, or -1)
  int ib = 0, is = 0, ij = 0, it = -1, ist = 0;
  long qi = 0;
  int src_next = 0;  // with kSrc: the cursor's source tile

  __device__ SlotLoop(const SlotArgs& args, unsigned char* ring_1024, int* tab,
                      const TailArgs* tail_args = nullptr)
      : p(args), tl(tail_args), ring(ring_1024), table(tab) {
    stage_bytes = slot_stage_bytes(p.tile, akind(), p.x_bf16, p.transform, kI8);
    a_bytes = slot_a_bytes(p.tile, akind());
    b_bytes = slot_b_bytes(p.x_bf16, p.transform, kI8);
    bfb = reinterpret_cast<__nv_bfloat16*>(ring + NST * stage_bytes);
    cpt = p.tile / kChunk;
    C = p.s_span * cpt;
    nblk = (p.nb - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
    Q = static_cast<long>(nblk) * (C + (kTail ? tl->tail : 0));
    if constexpr (kSrc)
      if (Q > 0) src_next = src_load(0, 0);
  }

  // the given source tile of slot s of block i (clamped to [0, nb))
  __device__ int src_load(int i, int s) const {
    const int v = __ldg(p.src + static_cast<size_t>(block_of(i)) * p.s_span + s);
    return min(max(v, 0), p.nb - 1);
  }

  // A's tile kind. Without kSrc it is int8 or f32, and is tested as such
  // (a_kind != kAInt8 is f32): a three-valued kind in the banded loop's
  // sizes and branches cost its kernel 3-4 % on the H100 (PERF.md).
  __device__ int akind() const {
    if constexpr (kSrc) return p.a_kind;
    return p.a_kind != kAInt8 ? kAF32 : kAInt8;
  }
  __device__ bool a_f32() const {
    if constexpr (kSrc) return p.a_kind == kAF32;
    return p.a_kind != kAInt8;
  }

  // this thread's first row
  __device__ static int thread_row() {
    const int warp = threadIdx.x >> 5;
    return (warp >> 2) * 64 + (warp & 3) * 16 + ((threadIdx.x & 31) >> 2);
  }

  __device__ int block_of(int i) const { return blockIdx.x + i * gridDim.x; }

  // this thread's entry of block i's table (or 0; no table with kSrc)
  __device__ int table_load(int i) const {
    if constexpr (kSrc) return 0;
    const int b = block_of(i), tid = threadIdx.x;
    if (p.cmap != nullptr)
      return tid < p.s_span
                 ? min(max(p.woff[b / p.k] + p.cmap[static_cast<size_t>(b) * p.s_span + tid], 0),
                       p.nb - 1)
                 : 0;
    return tid == 0 ? p.bo[b] : 0;
  }

  __device__ void table_store(int i, int v) const {
    if constexpr (kSrc) return;
    const int tid = threadIdx.x;
    if (p.cmap != nullptr) {
      if (tid < p.s_span) table[(i & 1) * kMaxCmapSlots + tid] = v;
    } else if (tid == 0) {
      table[2 * kMaxCmapSlots + (i & 1)] = v;
    }
  }

  __device__ bool next_starts_block() const { return qi < Q && it < 0 && is == 0 && ij == 0; }

  // copy the cursor's chunk into its stage and advance: thread 0 starts the
  // TMA copies, which signal full[stage]; operands TMA cannot take load by
  // the element path here (the next barriers publish them)
  __device__ void copy_next(uint64_t* full) {
    if (qi >= Q) return;
    const int tid = threadIdx.x;
    if (kTail && it >= 0) {  // a chunk of the tail
      unsigned char* st = ring + ist * stage_bytes;
      const int per = tl->tail / 2, m = it < per ? 0 : 1, row0 = (it - m * per) * kChunk;
      if (tl->tma_w) {
        if (tid == 0) {
          const int halves = tl->wcols > 64 ? 2 : 1;
          mbar_expect(&full[ist], halves * kChunk * 128);
          for (int h = 0; h < halves; ++h)
            tma_load(st + a_bytes + h * kChunk * 128, &tl->map_w[m], 64 * h, row0, &full[ist]);
        }
      } else {
        if (tid == 0) mbar_expect(&full[ist], 0);
        __nv_bfloat16* sb = reinterpret_cast<__nv_bfloat16*>(st + a_bytes);
        for (int idx = tid; idx < kChunk * kRow; idx += kThreads) {
          const int r = idx >> 7, c = idx & (kRow - 1);
          if (c < tl->wcols)
            sb[swz_h(kChunk, r, c)] = row0 + r < tl->wrows
                                          ? tl->w[m][static_cast<size_t>(row0 + r) * tl->wcols + c]
                                          : __float2bfloat16_rn(0.0f);
        }
      }
      if (++it == tl->tail) {
        it = -1;
        ++ib;
      }
      ++qi;
      if (++ist == NST) ist = 0;
      return;
    }
    const int b = block_of(ib);
    const int par = ib & 1;
    int src;
    if constexpr (kSrc)
      src = src_next;
    else
      src = p.cmap != nullptr ? table[par * kMaxCmapSlots + is]
                              : table[2 * kMaxCmapSlots + par] + is;
    unsigned char* st = ring + ist * stage_bytes;
    const int j0 = ij * kChunk;
    // the slot tile's first row and column of A's 2-D view: slot is of block
    // b is rows (b * s_span + is) * tile .. (narrow) or columns is * tile ..
    // of rows b * tile .. (wide), read where it lies
    const int arow = (p.wide ? b : b * p.s_span + is) * p.tile;
    const int acol = (p.wide ? is * p.tile : 0) + j0;
    const size_t r0 = static_cast<size_t>(src) * p.tile + j0;
    float* vec = reinterpret_cast<float*>(st + a_bytes + b_bytes);
    const float* vs[2] = {p.cs, p.rstd};
    if (tid == 0) {
      const int halves = p.width > 64 ? 2 : 1;
      uint32_t tx = p.tma_a ? a_bytes : 0;
      if (p.tma_x)
        tx += kI8 ? kChunk * kRow
                  : p.transform ? kChunk * kRow * (p.x_bf16 ? 2 : 4) : halves * kChunk * 128;
      for (int v = 0; v < 2; ++v)
        if (vs[v] != nullptr && aligned16(vs[v])) tx += kChunk * 4;
      mbar_expect(&full[ist], tx);
      if (p.tma_a) tma_load(st, &p.map_a, acol, arow, &full[ist]);
      if (p.tma_x)
        for (int h = 0; h < (p.transform || kI8 ? 1 : halves); ++h)
          tma_load(st + a_bytes + h * kChunk * 128, &p.map_x, 64 * h, static_cast<int>(r0),
                   &full[ist]);
      for (int v = 0; v < 2; ++v)
        if (vs[v] != nullptr && aligned16(vs[v]))
          bulk_load(vec + kChunk * v, vs[v] + r0, kChunk * 4, &full[ist]);
    }
    if (!p.tma_a) {
      const size_t lda = p.wide ? static_cast<size_t>(p.s_span) * p.tile : p.tile;
      const size_t tile0 = static_cast<size_t>(arow) * lda + acol;
      for (int idx = tid; idx < p.tile * kChunk; idx += kThreads) {
        const int r = idx >> 5, c = idx & 31;
        if (a_f32())
          reinterpret_cast<float*>(st)[a32_off(r, c)] =
              static_cast<const float*>(p.a)[tile0 + r * lda + c];
        else if (kSrc && p.a_kind == kABf16)
          reinterpret_cast<__nv_bfloat16*>(st)[a16_off(r, c)] =
              static_cast<const __nv_bfloat16*>(p.a)[tile0 + r * lda + c];
        else
          reinterpret_cast<int8_t*>(st)[a8_off(r, c)] =
              static_cast<const int8_t*>(p.a)[tile0 + r * lda + c];
      }
    }
    if (!p.tma_x && kI8) {  // the columns past the width are zeroed, as TMA does
      for (int idx = tid; idx < kChunk * kRow; idx += kThreads) {
        const int r = idx >> 7, c = idx & (kRow - 1);
        st[a_bytes + x8_off(r, c)] =
            c < p.width ? static_cast<const unsigned char*>(p.x)[(r0 + r) * p.width + c] : 0;
      }
    } else if (!p.tma_x) {  // (f32 rows without a pass are rounded here)
      load_rows(st + a_bytes, p.transform ? 0 : kChunk, p.x, p.x_bf16, r0, kChunk, p.width,
                !p.transform && !p.x_bf16);
    }
    for (int v = 0; v < 2; ++v)
      if (vs[v] != nullptr && !aligned16(vs[v]) && tid < kChunk)
        vec[kChunk * v + tid] = vs[v][r0 + tid];
    if (++ij == cpt) {
      ij = 0;
      if (++is == p.s_span) {
        is = 0;
        if (kTail)
          it = 0;
        else
          ++ib;
      }
      // the next slot's source, a chunk of products ahead of its use
      if constexpr (kSrc)
        if (qi + 1 < Q) src_next = src_load(ib, is);
    }
    ++qi;
    if (++ist == NST) ist = 0;
  }

  // A's fragments of this chunk in registers, af[kk][q]: rows r, r + 8 at
  // columns 2t.. of step kk, then at 2t + 8..; false where the warpgroup
  // has no rows or columns here
  __device__ bool build_a(uint32_t (&af)[2][4], const unsigned char* st) const {
    const int r = thread_row();
    if ((r & ~63) >= p.tile) return false;  // the whole warpgroup
    const int t = threadIdx.x & 3;
    const float* vec = reinterpret_cast<const float*>(st + a_bytes + b_bytes);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int c0 = kk * 16 + 2 * t;  // this thread's columns c0, c0+1, c0+8, c0+9
      float sc[4] = {1.0f, 1.0f, 1.0f, 1.0f};
      if (p.amode != kScaleNone) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = c0 + (q & 1) + (q >> 1) * 8;
          const float cs = vec[c], rs = vec[kChunk + c];
          sc[q] = p.amode == kScaleCs ? bf16_round_int(cs) : p.amode == kScaleRstdCs ? rs * cs : rs;
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int rr = r + (q & 1) * 8, cc = c0 + (q >> 1) * 8;
        if (rr >= p.tile) {  // rows past the tile multiply as zeros
          af[kk][q] = 0;
          continue;
        }
        if (a_f32()) {
          const float2 f = *reinterpret_cast<const float2*>(
              reinterpret_cast<const float*>(st) + a32_off(rr, cc));
          // bf16(bf16(A) * bf16(cs)): the weights are rounded first
          const float e0 = p.amode == kScaleCs ? bf16_round(f.x) : f.x;
          const float e1 = p.amode == kScaleCs ? bf16_round(f.y) : f.y;
          af[kk][q] = pack_bf16(e0 * sc[(q >> 1) * 2], e1 * sc[(q >> 1) * 2 + 1]);
        } else if (kSrc && p.a_kind == kABf16) {
          // as it is: the dense layout has no column scale
          af[kk][q] = *reinterpret_cast<const uint32_t*>(
              reinterpret_cast<const __nv_bfloat16*>(st) + a16_off(rr, cc));
        } else {
          const uint32_t w = *reinterpret_cast<const uint16_t*>(st + a8_off(rr, cc)) ^ 0x8080u;
          af[kk][q] = p.amode == kScaleNone
                          ? s8x2_to_bf16x2(w, 0)
                          : pack_bf16(s8_to_f32(w, 0) * sc[(q >> 1) * 2],
                                      s8_to_f32(w, 1) * sc[(q >> 1) * 2 + 1]);
        }
      }
    }
    return true;
  }

  // kI8: the feature of accumulator row 16 v + g + 8 h (h = e / 2) of this
  // thread's warpgroup: two neighbouring features a thread, so that one
  // 16-bit read of a staged xq row gives both
  __device__ static int x8_feature(int h) {
    const int warp = threadIdx.x >> 5;
    return (warp >> 2) * 64 + (warp & 3) * 16 + 2 * ((threadIdx.x & 31) >> 2) + h;
  }

  // kI8: A's fragments (xq^T: rows = features, k = the chunk's 32 source
  // rows) from the staged xq rows, xf[2 kh + h]: features x8_feature(h),
  // source rows 16 kh + 4 t ... + 3, one byte each; false where the
  // warpgroup has no features
  __device__ bool build_x8(uint32_t (&xf)[4], const unsigned char* st) const {
    const int f0 = x8_feature(0);
    if ((f0 & ~63) >= p.width) return false;  // the whole warpgroup
    const unsigned char* xs = st + a_bytes;
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int kh = 0; kh < 2; ++kh) {
      uint32_t h[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        h[q] = *reinterpret_cast<const uint16_t*>(xs + x8_off(16 * kh + 4 * t + q, f0));
      const uint32_t x01 = __byte_perm(h[0], h[1], 0x5410), x23 = __byte_perm(h[2], h[3], 0x5410);
      xf[2 * kh] = __byte_perm(x01, x23, 0x6420);
      xf[2 * kh + 1] = __byte_perm(x01, x23, 0x7531);
    }
    return true;
  }

  // start the warpgroup's two wgmma (16 deep each) of this chunk; wgmma_wait
  // ends them
  __device__ void mma_start(float (&acc)[kNT][4], const uint32_t (&af)[2][4],
                            const __nv_bfloat16* bs) const {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      wgmma_n128(acc, af[kk], desc_h(bs + swz_h(kChunk, 16 * kk, 0), kChunk));
    wgmma_commit();
  }

  template <class T>
  __device__ static void zero(T (&acc)[kNT][4]) {
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0;
  }

  // wgmma reads A's registers asynchronously: keep them live until here
  template <int K>
  __device__ static void keep(const uint32_t (&af)[K][4]) {
#pragma unroll
    for (int kk = 0; kk < K; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) asm volatile("" ::"r"(af[kk][q]));
  }

  // Walk this block's chunks, with full[NST] mbarriers in shared memory.
  // first(i, b) runs after the barrier of the step that multiplies block
  // i's first chunk; epi(i, b, acc) after its last chunk. With a tail,
  // mid(i, b, acc) runs after the last slot chunk and tail(j, bs, acc) for
  // chunk j of the tail (its rows at bs). acc is zeroed after mid and epi.
  // Every thread calls each. acc is float, or int with kI8.
  template <class Acc, class First, class Mid, class Tail, class Epi>
  __device__ void run(Acc (&acc)[kNT][4], uint64_t* full, First first, Mid mid, Tail tail,
                      Epi epi) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < NST; ++i) mbar_init(&full[i], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    for (int n = 0; n < NST - 1; ++n) {
      if (next_starts_block()) {
        __syncthreads();
        table_store(ib, table_load(ib));
        __syncthreads();
      }
      copy_next(full);
    }
    if (next_starts_block()) {
      __syncthreads();
      table_store(ib, table_load(ib));
    }
    int cst = 0, ci = 0, cb = 0;
    uint32_t phases = 0;  // bit s: the parity stage s waits for next
    for (long q = 0; q < Q; ++q) {
      mbar_wait(&full[cst], (phases >> cst) & 1);
      phases ^= 1u << cst;
      fence_proxy_async();  // element-path writes, for wgmma's reads
      __syncthreads();
      copy_next(full);
      if (ci == 0) first(cb, block_of(cb));
      // the next copy starts a block: look its tiles up now, store them
      // after the products (the next step's barrier publishes them)
      const bool pre = next_starts_block();
      const int pend = pre ? table_load(ib) : 0;
      const unsigned char* st = ring + cst * stage_bytes;
      const __nv_bfloat16* bs = reinterpret_cast<const __nv_bfloat16*>(st + a_bytes);
      if (p.transform) {
        transform_rows(bfb, st + a_bytes, p.x_bf16,
                       p.bscale ? reinterpret_cast<const float*>(st + a_bytes + b_bytes) : nullptr,
                       p.width);
        fence_proxy_async();
        __syncthreads();
        bs = bfb;
      }
      if constexpr (kI8) {
        uint32_t xf[1][4];
        if (build_x8(xf[0], st)) {
          wgmma_fence();
          wgmma_s8_n128(acc, xf[0], desc_k32(st));
          wgmma_commit();
          wgmma_wait<0>();
          pin(acc);
          keep(xf);
        }
      } else if (!kTail || ci < C) {
        uint32_t af[2][4];
        if (build_a(af, st)) {
          mma_start(acc, af, bs);
          wgmma_wait<0>();
          pin(acc);
          keep(af);
        }
      } else {
        tail(ci - C, bs, acc);
      }
      if (pre) table_store(ib, pend);
      // (the end of a block is found by one test a step: two tests made
      // this loop measurably slower)
      if (++ci == C && kTail) {
        mid(cb, block_of(cb), acc);
        zero(acc);
      } else if (ci == C + (kTail ? tl->tail : 0)) {
        epi(cb, block_of(cb), acc);
        zero(acc);
        ci = 0;
        ++cb;
      }
      if (++cst == NST) cst = 0;
    }
  }
};

// Blocks of a persistent grid: every free slot of the card, at most nb.
template <class Kernel>
int persistent_grid(Kernel kernel, int threads, size_t smem, int nb, int* grid) {
  int dev = 0, sms = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (occ <= 0) return SLDM_ERR_SMEM;
  *grid = nb < occ * sms ? nb : occ * sms;
  return 0;
}

}  // namespace
