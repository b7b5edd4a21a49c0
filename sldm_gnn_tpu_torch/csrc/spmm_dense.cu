// Dense-tile SpMM: out[b] = rs[b] * sum_s bf16(A[b, s]) @ bf16(x[src_blk[b, s]]).
//
// Replaces the TPU kernel `_dense_kernel` (sldm_gnn_tpu/ops/spmm_dense.py:165,
// launched by `spmm_dense_pallas` :183, pallas_call :241): the aggregation
// of the dense-tile layout, both directions, and the dense half of the
// hybrid layout. The reverse layout's column scale is applied to x by the
// wrapper before the launch, as the JAX wrapper does (:220-227). Numerics of
// the TPU kernel: the tiles (int8 counts, exact in bf16 up to 127, f32 or
// bf16 weights) and x rounded to bf16, products summed in f32, the row
// scale applied in f32, the result stored at x's dtype. Padding slots hold
// zero tiles and source block 0, and add zeros. The TPU kernel's
// step_blocks (destination blocks per grid step) sets only how the layout
// is padded.
//
// Bound at bench.py's dense shape (200 000 nodes, tile 128, padded to 4
// blocks: nb = 1564, s_max = 5, int8 tiles, D = 128, bf16 x): bytes, 128 MB
// of A plus x and out once (about 232 MB, 0.069 ms at 3.35 TB/s), over the
// count-tile products' 33 GFLOP (0.033 ms at the bf16 tensor-core rate).
//
// The dense layout is the banded one with an explicit source block per slot
// (src_blk[b, s] in place of bo[b] + s), so this is the SpMM kernel of
// slot_spmm.cuh (wgmma m64n128k16 with A from registers, TMA through a ring
// of mbarrier stages, a persistent grid, the epilogue through shared memory)
// with the slot loop's `src` mode: every thread reads slot s's source block
// a chunk of products ahead of the slot's first copy, so s_max has no bound
// (a table in shared memory, as the cmap mode keeps, would cap it). bf16
// tiles arrive under TMA's 64-byte swizzle and are wgmma fragments as they
// are. The first version ran a block product on f32 FMAs (>= 0.49
// ms of products at 67 TFLOP/s), every element staged with an integer
// division and a rounding, one stage, one block a destination block.
#include "slot_spmm.cuh"

// a [nb, s_max, tile, tile] int8 / f32 / bf16 (a_kind 0 / 1 / 2),
// src_blk [nb, s_max] int32 (every entry < nb), x and out [nb * tile, D]
// bf16 (x_bf16) or f32, rs [nb * tile] f32 or NULL.
extern "C" int spmm_dense_launch(const void* a, int a_kind, const void* src_blk, int nb,
                                 int s_max, int tile, const void* x, int x_bf16, int D,
                                 const void* rs, void* out, void* stream) {
  if (!banded_shape_ok(nb, s_max, tile, D) || a_kind < kAInt8 || a_kind > kABf16 ||
      src_blk == nullptr)
    return SLDM_ERR_SHAPE;
  SlotArgs p{};
  p.a = a;
  p.a_kind = a_kind;
  p.amode = kScaleNone;
  p.src = static_cast<const int*>(src_blk);
  p.k = 1;
  p.nb = nb;
  p.s_span = s_max;
  p.tile = tile;
  p.x = x;
  p.x_bf16 = x_bf16;
  p.width = D;
  p.transform = !x_bf16;
  return launch_slot_spmm<true>(p, static_cast<const float*>(rs), out,
                                 static_cast<cudaStream_t>(stream));
}
