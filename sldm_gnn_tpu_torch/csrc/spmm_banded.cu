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
// The `wide` layout (the TPU kernel's `wide` branch, spmm_banded.py:404-415:
// one [T, S*T] @ [S*T, D] product a block over widen_banded's a [nb, T,
// S*T]) is the same function; here its slot s is read in place as columns
// s*T .. s*T+T-1 of the block's rows (a 2-D tensor map over [nb*T, S*T] with
// [T, 32] boxes, or a row stride of S*T in the element path), through the
// same chunks in the same order, so a wide layout gives the narrow layout's
// bits. Its bytes, and so its bound, are the narrow layout's.
//
// Bound at bench.py's shape (nb = 1572 blocks of 128 rows, s_span = 5,
// D = 128, bf16 x): bytes, 128.8 MB of A + 51.5 MB of x + 51.5 MB of out
// (0.069 ms at 3.35 TB/s), over 33 GFLOP (0.033 ms at the bf16 tensor-core
// rate). The first version ran the products on the f32 FMA units
// (a block product since removed: >= 0.49 ms at 67 TFLOP/s), staged every
// element through the caller's loaders with an integer division and a
// rounding each, as f32, and did not overlap loads with products (one
// stage). Here (the kernel of slot_spmm.cuh, on banded_mma.cuh's slot loop)
// the products run on the tensor cores (wgmma m64n128k16, bf16 in, f32
// sums; two warpgroups a block), A's int8 or f32 values become bf16
// fragments in registers (counts by byte permutes), B is read from shared
// memory by wgmma itself, the copies arrive by TMA through a ring of four
// 32-deep chunks, and a persistent grid (two blocks of 8 warps an SM) walks
// the destination blocks in ascending order (neighbours share s_span - 1
// source tiles in L2). The output goes through shared memory, scaled in
// f32, and out in 16-byte rows.
#include "slot_spmm.cuh"

// a [nb, s_span, tile, tile] int8 (or f32 with a_f32), or with `wide` [nb,
// tile, s_span * tile]; bo [nb] int32;
// cmap [nb * s_span] and woff [nb / k] int32, or NULL (contiguous slots);
// x and out [nb * tile, D] bf16 (x_bf16) or f32, cs/rs [nb * tile] f32 or
// NULL.
extern "C" int spmm_banded_launch(const void* a, int a_f32, int wide, const void* bo,
                                  const void* cmap, const void* woff, int k, int nb, int s_span,
                                  int tile, const void* x, int x_bf16, int D, const void* cs,
                                  const void* rs, void* out, void* stream) {
  if (!banded_shape_ok(nb, s_span, tile, D) || !cmap_ok(cmap, woff, s_span, k, nb) ||
      (wide && cmap != nullptr))  // cmap slots are not contiguous (spmm_banded.py:452)
    return SLDM_ERR_SHAPE;
  SlotArgs p{};
  p.a = a;
  p.a_kind = a_f32 ? kAF32 : kAInt8;
  p.wide = wide != 0;
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
  return launch_slot_spmm<false>(p, static_cast<const float*>(rs), out,
                                 static_cast<cudaStream_t>(stream));
}
