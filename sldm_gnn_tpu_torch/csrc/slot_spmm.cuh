// The SpMM kernel on the slot loop of banded_mma.cuh, shared by the banded
// (spmm_banded.cu) and the dense-tile (spmm_dense.cu) aggregations: out[b] =
// rs[b] * sum_s A[b, s] @ B[src(b, s)], the row scale in f32, the result at
// x's dtype. The entry points fill SlotArgs (the source of each slot, the
// tiles' type, whether B needs a pass) and call launch_slot_spmm, with
// kSrc for the dense layout's given source blocks.
//
// Two warpgroups a block, two blocks an SM, a persistent grid that walks the
// destination blocks in ascending order (neighbours share source tiles in
// L2), a ring of four 32-deep chunks filled by TMA. The output goes through
// shared memory, scaled in f32, and out in 16-byte rows.
#pragma once

#include "banded_mma.cuh"

namespace {

constexpr int kSpmmStages = 4;
constexpr int kSpmmThreads = SlotLoop<kSpmmStages>::kThreads;

// output tile row stride (elements): 16 bytes of padding a row
__host__ __device__ inline int out_ld(int x_bf16) { return x_bf16 ? kRow + 8 : kRow + 4; }

inline size_t spmm_smem_bytes(const SlotArgs& p) {
  return 1024 + slot_ring_bytes(kSpmmStages, p) +
         static_cast<size_t>(p.tile) * out_ld(p.x_bf16) * (p.x_bf16 ? 2 : 4);
}

template <bool kSrc>
__global__ void __launch_bounds__(kSpmmThreads, 2)
    slot_spmm_kernel(const __grid_constant__ SlotArgs p, const float* __restrict__ rs,
                     void* __restrict__ out) {
  using SpmmLoop = SlotLoop<kSpmmStages, false, kSrc>;
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

// make the maps, opt in to the shared memory, launch on `stream`
template <bool kSrc>
int launch_slot_spmm(SlotArgs& p, const float* rs, void* out, cudaStream_t stream) {
  make_slot_maps(p);
  const size_t smem = spmm_smem_bytes(p);
  const auto kernel = slot_spmm_kernel<kSrc>;
  int code = smem_opt_in(kernel, smem);
  if (code != 0) return code;
  int grid = 0;
  code = persistent_grid(kernel, kSpmmThreads, smem, p.nb, &grid);
  if (code != 0) return code;
  kernel<<<grid, kSpmmThreads, smem, stream>>>(p, rs, out);
  return cudaGetLastError();
}

}  // namespace
