// Banded mean aggregation: out[b] = rs[b] * sum_s A[b, s] @ (cs * x)[src(b, s)].
//
// Replaces the TPU kernel `_banded_kernel` (sldm_gnn_tpu/ops/spmm_banded.py:388,
// launched by `spmm_banded_pallas` :434, pallas_call :478). It is the unfused
// SAGE layer's aggregation and, on the reverse layout, the backward of
// `spmm_banded_apply` (the 1/deg column scale cs then multiplies x's rows).
// Slot s of block b reads source tile bo[b] + s or, with a `cmap` layout
// (ops/spmm_cmap.py), the clamped window tile woff[b / k] + cmap[b * s_span
// + s] (the TPU kernel's scalar-prefetched `cmap_ref`, spmm_banded.py:419-
// 423). Numerics of the TPU kernel: the int8 counts (exact in bf16 up to
// 127) or f32 weights and cs * x are rounded to bf16, products summed in
// f32, the row scale applied in f32, the result stored at x's dtype.
//
// Bound at bench.py's shape (nb = 1572 blocks of 128 rows, s_span = 5,
// D = 128, bf16 x): bytes, 128.8 MB of A + 51.5 MB of x + 51.5 MB of out
// (0.069 ms at 3.35 TB/s), over 33 GFLOP (0.033 ms at the bf16 tensor-core
// rate). The first version ran the products on the f32 FMA units
// (banded_gemm.cuh's block_gemm: >= 0.49 ms at 67 TFLOP/s), staged every
// element through the caller's loaders with an integer division and a
// rounding each, as f32, and did not overlap loads with products (one
// stage). Here (banded_mma.cuh) the products run on the tensor cores
// (wgmma m64n128k16, bf16 in, f32 sums; two warpgroups a block), A's int8
// or f32 values become bf16 fragments in registers (counts by byte
// permutes), B is read from shared memory by wgmma itself, the copies
// arrive by TMA through a ring of four 32-deep chunks, and a persistent
// grid (two blocks of 8 warps an SM)
// walks the destination blocks in ascending order (neighbours share
// s_span - 1 source tiles in L2). The output goes through shared memory,
// scaled in f32, and out in 16-byte rows.
#include "banded_mma.cuh"

namespace {

constexpr int kSpmmStages = 4;
using SpmmLoop = SlotLoop<kSpmmStages>;
constexpr int kSpmmThreads = SpmmLoop::kThreads;

// output tile row stride (elements): 16 bytes of padding a row
__host__ __device__ inline int out_ld(int x_bf16) { return x_bf16 ? kRow + 8 : kRow + 4; }

inline size_t spmm_smem_bytes(const SlotArgs& p) {
  return 1024 + slot_ring_bytes(kSpmmStages, p) +
         static_cast<size_t>(p.tile) * out_ld(p.x_bf16) * (p.x_bf16 ? 2 : 4);
}

__global__ void __launch_bounds__(kSpmmThreads, 2)
    spmm_banded_kernel(const __grid_constant__ SlotArgs p, const float* __restrict__ rs,
                       void* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ int table[kTableInts];
  __shared__ uint64_t full[kSpmmStages];
  unsigned char* smem = align1024(smem_raw);
  SpmmLoop loop(p, smem, table);
  unsigned char* out_s = smem + slot_ring_bytes(kSpmmStages, p);
  const int ld = out_ld(p.x_bf16), esz = p.x_bf16 ? 2 : 4;
  const int r0t = SpmmLoop::thread_row(), t = threadIdx.x & 3;
  const int tile = p.tile, D = p.width;

  auto epi = [&](int, int b, float (&acc)[SpmmLoop::kNT][4]) {
    const size_t row0 = static_cast<size_t>(b) * tile;
    // the previous block's copy-out is behind the stream's barriers
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0t + 8 * h;
      if (r >= tile) continue;
      const float sc = rs != nullptr ? rs[row0 + r] : 1.0f;
#pragma unroll
      for (int nt = 0; nt < SpmmLoop::kNT; ++nt) {
        const int c = nt * 8 + 2 * t;
        const float v0 = acc[nt][2 * h] * sc, v1 = acc[nt][2 * h + 1] * sc;
        if (p.x_bf16)
          *reinterpret_cast<uint32_t*>(out_s + (r * ld + c) * 2) = pack_bf16(v0, v1);
        else
          *reinterpret_cast<float2*>(out_s + (r * ld + c) * 4) = make_float2(v0, v1);
      }
    }
    __syncthreads();
    char* go = static_cast<char*>(out) + row0 * D * esz;
    if ((D * esz) % 16 == 0 && aligned16(out)) {
      const int cpr = D * esz / 16;
      for (int idx = threadIdx.x; idx < tile * 32; idx += kSpmmThreads) {
        const int r = idx >> 5, c = idx & 31;
        if (c < cpr)
          *reinterpret_cast<uint4*>(go + (static_cast<size_t>(r) * D * esz) + c * 16) =
              *reinterpret_cast<const uint4*>(out_s + r * ld * esz + c * 16);
      }
    } else {
      for (int idx = threadIdx.x; idx < tile * kRow; idx += kSpmmThreads) {
        const int r = idx >> 7, c = idx & (kRow - 1);
        if (c >= D) continue;
        if (p.x_bf16)
          reinterpret_cast<__nv_bfloat16*>(go)[r * D + c] =
              reinterpret_cast<const __nv_bfloat16*>(out_s)[r * ld + c];
        else
          reinterpret_cast<float*>(go)[r * D + c] =
              reinterpret_cast<const float*>(out_s)[r * ld + c];
      }
    }
  };
  float acc[SpmmLoop::kNT][4] = {};
  // no tail: first, mid and tail do nothing
  auto first = [](int, int) {};
  auto mid = [](int, int, float (&)[SpmmLoop::kNT][4]) {};
  auto tail = [](int, const __nv_bfloat16*, float (&)[SpmmLoop::kNT][4]) {};
  loop.run(acc, full, first, mid, tail, epi);
}

}  // namespace

// a [nb, s_span, tile, tile] int8 (or f32 with a_f32), bo [nb] int32;
// cmap [nb * s_span] and woff [nb / k] int32, or NULL (contiguous slots);
// x and out [nb * tile, D] bf16 (x_bf16) or f32, cs/rs [nb * tile] f32 or
// NULL.
extern "C" int spmm_banded_launch(const void* a, int a_f32, const void* bo, const void* cmap,
                                  const void* woff, int k, int nb, int s_span, int tile,
                                  const void* x, int x_bf16, int D, const void* cs,
                                  const void* rs, void* out, void* stream) {
  if (!banded_shape_ok(nb, s_span, tile, D) || !cmap_ok(cmap, woff, s_span, k, nb))
    return SLDM_ERR_SHAPE;
  SlotArgs p{};
  p.a = a;
  p.a_f32 = a_f32;
  p.amode = kScaleNone;
  p.bo = static_cast<const int*>(bo);
  p.cmap = static_cast<const int*>(cmap);
  p.woff = static_cast<const int*>(woff);
  p.k = k;
  p.nb = nb;
  p.s_span = s_span;
  p.tile = tile;
  p.x = x;
  p.x_bf16 = x_bf16;
  p.width = D;
  p.cs = static_cast<const float*>(cs);
  p.rstd = nullptr;
  p.transform = !x_bf16 || cs != nullptr;
  p.bscale = cs != nullptr;
  make_slot_maps(p);
  const size_t smem = spmm_smem_bytes(p);
  int code = smem_opt_in(spmm_banded_kernel, smem);
  if (code != 0) return code;
  int grid = 0;
  code = persistent_grid(spmm_banded_kernel, kSpmmThreads, smem, nb, &grid);
  if (code != 0) return code;
  spmm_banded_kernel<<<grid, kSpmmThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const float*>(rs), out);
  return cudaGetLastError();
}
