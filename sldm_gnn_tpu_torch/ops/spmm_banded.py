"""Banded dense SpMM for locality graphs: layouts, the f32 twin, the CUDA
kernel ``csrc/spmm_banded.cu`` and its plain version, and the autograd.

Port of ``sldm_gnn_tpu/ops/spmm_banded.py``. A destination block ``b`` of
``tile`` rows reads the ``s_span`` source tiles ``bo[b] + s``; slot ``s``
of ``a [nb, s_span, T, T]`` holds the count (or weight) tile for that
source tile:

    out[b] = rs[b] * sum_s A[b, s] @ (cs * x)[bo[b] + s]

The TPU kernel streams one x window per group of ``k`` blocks (``woff``,
``off``, ``wsz``); the layouts keep those arrays so that they stay equal
to the JAX builders', and the CUDA kernel reads ``bo`` alone. A ``cmap``
layout (:mod:`.spmm_cmap`) replaces the contiguous band by an arbitrary
set of source tiles: slot ``s`` of block ``b`` reads tile ``woff[b // k] +
cmap[b * s_span + s]``, in the kernels and in their plain versions.

A ``wide`` layout (:func:`widen_banded`) folds the slot axis into the
tile's columns, ``a [nb, T, S_SPAN*T]``: the TPU kernel's one ``[T,
S*T] @ [S*T, D]`` product a block. It is the same function; the twin,
the plain version and the CUDA kernel (which reads the wide tiles in
place) take it in both directions, and the kernel and the plain version
give the narrow layout's bits. As in the JAX package, the int8 kernel
and the fused kernels (:mod:`.sage_fused`) take the narrow layout only,
and ``cmap`` layouts stay narrow.

The int8 inference kernel (``csrc/spmm_banded_int8.cu``) aggregates
per-tensor int8 features over the int8 count tiles exactly in integers
(contiguous band only: the JAX package asserts no ``cmap``).

Left out: the int4 view (``counts_to_int4``), which only the
multi-chip streamed planner writes, ``chunk_blocks`` and the native
OpenMP count fill; the layouts are built by the numpy path.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..graph.csr import TILE, check_edge_range, mean_weights, pad_nodes

BF16 = torch.bfloat16


@dataclass(frozen=True)
class BandedBlocks:
    """Banded adjacency tiles and window metadata (tensors) plus static ints.

    a     [NB, S_SPAN, T, T] int8 counts (factored mean) or float weights;
          with ``wide`` [NB, T, S_SPAN*T], slot s at columns s*T .. s*T+T-1
    bo    [NB] int32    slot base: slot s of block b is source block bo[b]+s
    woff  [NB/K] int32  x-window base (in tiles) of each group of K blocks
    off   [NB] int32    bo[b] - woff[b // K]
    row_scale / col_scale [N, 1] f32 or None: the mean's 1/deg, on the
    destination rows (forward layout) or the source rows (reverse layout).
    cmap  [NB * S_SPAN] int32 or None: window-relative source tile of every
          slot (:mod:`.spmm_cmap` builds it); slot s of block b then reads
          tile woff[b // K] + cmap[b * S_SPAN + s] instead of bo[b] + s.
    """

    a: torch.Tensor
    bo: torch.Tensor
    woff: torch.Tensor
    off: torch.Tensor
    row_scale: torch.Tensor | None = None
    col_scale: torch.Tensor | None = None
    cmap: torch.Tensor | None = None
    tile: int = TILE
    wsz: int = 8
    k: int = 4
    wide: bool = False

    @property
    def num_dst_blocks(self) -> int:
        return self.a.shape[0]

    @property
    def s_span(self) -> int:
        return self.a.shape[2] // self.tile if self.wide else self.a.shape[1]

    def to(self, device) -> "BandedBlocks":
        move = lambda t: None if t is None else t.to(device)
        return dataclasses.replace(
            self, a=move(self.a), bo=move(self.bo), woff=move(self.woff), off=move(self.off),
            row_scale=move(self.row_scale), col_scale=move(self.col_scale),
            cmap=move(self.cmap))


def require_narrow(blocks: BandedBlocks) -> None:
    """The JAX package's assert of the kernels that take the per-slot
    layout only (the fused kernels, ``sage_fused.py:192, 473, 830``)."""
    if blocks.wide:
        raise ValueError("the fused kernels use the per-slot (narrow) layout, not wide")


def widen_banded(blocks: BandedBlocks) -> BandedBlocks:
    """``a [NB, S, T, T]`` -> ``[NB, T, S*T]``: the slot axis folded into
    the tile's columns (the JAX function, ``spmm_banded.py:97-112``; cmap
    layouts stay narrow). A wide layout is returned as it is."""
    if blocks.wide:
        return blocks
    if blocks.cmap is not None:
        raise ValueError("cmap slots are non-contiguous; keep narrow")
    nb, s, t, _ = blocks.a.shape
    a = blocks.a.permute(0, 2, 1, 3).contiguous().reshape(nb, t, s * t)
    return dataclasses.replace(blocks, a=a, wide=True)


def slot_tiles(blocks: BandedBlocks) -> torch.Tensor:
    """The tiles as ``[NB, S_SPAN, T, T]`` (a wide layout's, copied back)."""
    if not blocks.wide:
        return blocks.a
    nb, t, s = blocks.num_dst_blocks, blocks.tile, blocks.s_span
    return blocks.a.reshape(nb, t, s, t).permute(0, 2, 1, 3).contiguous()


def int4_count_safe(blocks: BandedBlocks) -> bool:
    """Every count tile value fits int4 ([-8, 7]): true for any simple
    (unique-edge) graph. The int4 view itself is not ported."""
    a = blocks.a
    return a.dtype == torch.int8 and int(a.max().item() if a.numel() else 0) <= 7


def _tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def build_banded_blocks(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    *,
    weight: np.ndarray | None = None,
    tile: int = TILE,
    k: int = 4,
    dtype=np.float32,
    max_span: int = 16,
    s_span_min: int = 1,
    wsz_min: int = 0,
) -> BandedBlocks:
    """Host-side banded layout (numpy, returned as CPU tensors). Raises
    ValueError when a destination block's source span exceeds
    ``max_span`` tiles."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    if len(src) and (src.min() < 0 or dst.min() < 0
                     or src.max() >= num_nodes or dst.max() >= num_nodes):
        raise ValueError(f"edge endpoints out of range [0, {num_nodes})")
    if weight is None:
        weight = np.ones(len(src), np.float32)
    weight = np.asarray(weight, np.float32)

    n_pad = pad_nodes(num_nodes, tile)
    nb = n_pad // tile
    nb = ((nb + k - 1) // k) * k
    db = dst // tile
    sb = src // tile

    bo = np.arange(nb, dtype=np.int64)  # empty blocks: window of themselves
    hi = bo.copy()
    if len(src):
        np.minimum.at(bo, db, sb)
        np.maximum.at(hi, db, sb)
    span = hi - bo + 1
    s_span = int(span.max()) if len(span) else 1
    if s_span > max_span:
        raise ValueError(
            f"source span {s_span} tiles exceeds max_span={max_span}: "
            "graph is not banded under this node order")
    s_span = max(s_span, min(s_span_min, nb))
    # slots [bo, bo + s_span) stay inside the node range
    bo = np.minimum(bo, max(nb - s_span, 0))

    a = np.zeros((nb, s_span, tile, tile), np.float32)
    if len(src):
        np.add.at(a, (db, sb - bo[db], dst - db * tile, src - sb * tile), weight)

    woff, off, wsz = _window_meta(bo, nb, k, s_span, wsz_min=wsz_min)
    return BandedBlocks(a=_tensor(a.astype(dtype)), bo=_tensor(bo.astype(np.int32)),
                        woff=_tensor(woff), off=_tensor(off), tile=tile, wsz=wsz, k=k)


def _window_meta(bo: np.ndarray, nb: int, k: int, s_span: int, *, wsz_min: int = 0):
    """Per-K-group x-window base/size and per-block in-window offsets;
    ``off + s_span <= wsz`` for every block."""
    steps = (len(bo) + k - 1) // k
    bo2 = np.asarray(bo, np.int64).reshape(steps, k)
    woff = bo2.min(axis=1)
    wsz = int((bo2.max(axis=1) - woff).max()) + s_span if len(bo) else s_span
    wsz = max(wsz, min(wsz_min, nb))
    woff = np.minimum(woff, max(nb - wsz, 0))
    off = bo2 - woff[:, None]
    return woff.astype(np.int32), off.reshape(-1).astype(np.int32), wsz


def build_banded_counts(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    *,
    tile: int = TILE,
    k: int = 4,
    max_span: int = 16,
    s_span_min: int = 1,
    wsz_min: int = 0,
) -> BandedBlocks:
    """int8 count-tile banded layout, no scales attached (the numpy path
    of the JAX builder). Raises on span or int8-count overflow."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    check_edge_range(src, dst, num_nodes)
    out = build_banded_blocks(src, dst, num_nodes, tile=tile, k=k, max_span=max_span,
                              s_span_min=s_span_min, wsz_min=wsz_min)
    cmax = max(out.a.max().item() if out.a.numel() else 0, 1)
    if cmax > 127:
        raise ValueError(f"duplicate-edge multiplicity {cmax} overflows int8 counts")
    return dataclasses.replace(out, a=out.a.to(torch.int8))


def _mean_scale(dst: np.ndarray, n_pad: int) -> torch.Tensor:
    deg = np.bincount(np.asarray(dst, np.int64), minlength=n_pad)
    return _tensor((1.0 / np.maximum(deg, 1)).astype(np.float32).reshape(-1, 1))


def prepare_banded_mean_aggregate(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    *,
    tile: int = TILE,
    k: int = 4,
    dtype=np.int8,
    max_span: int = 16,
    wide: bool = False,
) -> tuple[BandedBlocks, BandedBlocks, int]:
    """Forward and reverse banded layouts for mean aggregation: int8 count
    tiles with the 1/deg row scale (forward) and column scale (reverse),
    or for a float ``dtype`` the weights folded into the tiles. ``wide``
    folds each layout's slots into columns (:func:`widen_banded`)."""
    maybe_widen = widen_banded if wide else (lambda b: b)
    if np.dtype(dtype) == np.int8:
        fwd = build_banded_counts(src, dst, num_nodes, tile=tile, k=k, max_span=max_span)
        rev = build_banded_counts(dst, src, num_nodes, tile=tile, k=k, max_span=max_span)
        n_pad = fwd.num_dst_blocks * tile
        scale = _mean_scale(dst, n_pad)
        return (maybe_widen(dataclasses.replace(fwd, row_scale=scale)),
                maybe_widen(dataclasses.replace(rev, col_scale=scale)), n_pad)
    w = mean_weights(dst, num_nodes)
    fwd = build_banded_blocks(src, dst, num_nodes, weight=w, tile=tile, k=k,
                              dtype=dtype, max_span=max_span)
    rev = build_banded_blocks(dst, src, num_nodes, weight=w, tile=tile, k=k,
                              dtype=dtype, max_span=max_span)
    return maybe_widen(fwd), maybe_widen(rev), fwd.num_dst_blocks * tile


# ------------------------------------------------------------ shared helpers


def bf16r(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (nearest even), as f32."""
    return t.to(BF16).float()


def slot_index(blocks: BandedBlocks) -> torch.Tensor:
    """[NB, S_SPAN] source block of every slot: ``bo[b] + s`` (in range by
    the builder's base clamp), or with ``cmap`` ``woff[b // k] + cmap[b,
    s]`` clamped to the blocks (the JAX twin's ``spmm_banded.py:606-612``)."""
    nb, s_span = blocks.num_dst_blocks, blocks.s_span
    if blocks.cmap is not None:
        woff_b = torch.repeat_interleave(blocks.woff.long(), blocks.k)[:nb]
        return (woff_b[:, None] + blocks.cmap.long().reshape(nb, s_span)).clamp(0, nb - 1)
    ar = torch.arange(s_span, device=blocks.bo.device)
    return (blocks.bo.long()[:, None] + ar[None, :]).clamp(0, nb - 1)


def cmap_args(blocks: BandedBlocks) -> tuple[int | None, int | None]:
    """``(cmap, woff)`` device pointers for a launch, or ``(None, None)`` for
    a contiguous band. The kernels stage at most 64 slots of a ``cmap``
    block."""
    if blocks.cmap is None:
        return None, None
    if blocks.cmap.numel() != blocks.num_dst_blocks * blocks.s_span \
            or blocks.woff.numel() != blocks.num_dst_blocks // blocks.k:
        raise ValueError("cmap must be [NB * S_SPAN] and woff [NB / k]")
    if blocks.s_span > 64:
        raise ValueError(f"a cmap layout of {blocks.s_span} slots a block is not taken (<= 64)")
    for name in ("cmap", "woff"):
        t = getattr(blocks, name)
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != blocks.a.device:
            raise ValueError(f"{name} must be contiguous int32 on {blocks.a.device}")
    return blocks.cmap.data_ptr(), blocks.woff.data_ptr()


def gather_slots(v: torch.Tensor, blocks: BandedBlocks) -> torch.Tensor:
    """``v [N, C]`` -> ``[NB, S_SPAN, T, C]``: the source rows of every slot."""
    return v.reshape(-1, blocks.tile, v.shape[-1])[slot_index(blocks)]


def slot_aggregate(a: torch.Tensor, rows: torch.Tensor, blocks: BandedBlocks) -> torch.Tensor:
    """``sum_s a[b, s] @ rows[bo[b] + s]`` for every block: ``[N, C]``."""
    out = torch.einsum("bsij,bsjd->bid", a, gather_slots(rows, blocks))
    return out.reshape(-1, rows.shape[-1])


def check_cuda_layout(name: str, v: torch.Tensor, blocks: BandedBlocks) -> None:
    """What every banded kernel wrapper checks before a launch (the wide
    layout only ``spmm_banded`` takes)."""
    if name != "spmm_banded":
        require_narrow(blocks)
    nb, tile = blocks.num_dst_blocks, blocks.tile
    if v.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got {v.device}")
    if blocks.a.device != v.device or blocks.bo.device != v.device:
        raise ValueError(f"{name}: the layout must be on {v.device} (BandedBlocks.to)")
    if tile % 32 or not 32 <= tile <= 128:
        raise ValueError(f"{name}: tile {tile} not taken (32, 64, 96 or 128)")
    if nb % blocks.k:
        raise ValueError(f"{name}: {nb} blocks is not a multiple of k={blocks.k}")
    if v.dim() != 2 or v.shape[0] != nb * tile:
        raise ValueError(f"{name}: rows must be [{nb * tile}, C], got {tuple(v.shape)}")
    if v.dtype not in (torch.float32, BF16):
        raise ValueError(f"{name}: features must be float32 or bfloat16, got {v.dtype}")
    if not v.is_contiguous() or not blocks.a.is_contiguous():
        raise ValueError(f"{name}: inputs must be contiguous")
    if blocks.a.dtype not in (torch.int8, torch.float32):
        raise ValueError(f"{name}: tiles must be int8 or float32, got {blocks.a.dtype}")
    if v.shape[1] > 128:
        raise ValueError(f"{name}: feature width {v.shape[1]} > 128 is not taken")


def scale_ptr(s: torch.Tensor | None, n: int, dev) -> int | None:
    if s is None:
        return None
    if s.numel() != n or s.dtype != torch.float32 or s.device != dev or not s.is_contiguous():
        raise ValueError(f"scales must be contiguous float32 [{n}, 1] on {dev}")
    return s.data_ptr()


# ------------------------------------------------------------ f32 twin


def spmm_banded_xla(x: torch.Tensor, blocks: BandedBlocks) -> torch.Tensor:
    """The JAX ``spmm_banded_xla`` (:590) without ``chunk_blocks``: the
    same aggregation at x's dtype, with no bf16 rounding (``cmap`` slots
    and wide layouts included)."""
    if blocks.col_scale is not None:
        x = (x.float() * blocks.col_scale).to(x.dtype)
    out = slot_aggregate(slot_tiles(blocks).to(x.dtype), x, blocks)
    if blocks.row_scale is not None:
        out = (out.float() * blocks.row_scale).to(x.dtype)
    return out


# ------------------------------------------------------------ the kernel


def spmm_banded_plain(x: torch.Tensor, blocks: BandedBlocks) -> torch.Tensor:
    """Plain PyTorch version of ``csrc/spmm_banded.cu``, with the TPU
    kernel's roundings: ``cs * x`` and the tiles rounded to bf16, products
    summed in f32, the row scale applied in f32, the result at x's dtype. A
    wide layout's tiles are copied back to slots: the same sums, the same
    bits."""
    xs = x.float()
    if blocks.col_scale is not None:
        xs = xs * blocks.col_scale
    out = slot_aggregate(bf16r(slot_tiles(blocks).float()), bf16r(xs), blocks)
    if blocks.row_scale is not None:
        out = out * blocks.row_scale
    return out.to(x.dtype)


def spmm_banded(x: torch.Tensor, blocks: BandedBlocks) -> torch.Tensor:
    """:func:`spmm_banded_plain`'s function: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return spmm_banded_plain(x, blocks)
    check_cuda_layout("spmm_banded", x, blocks)
    nb, tile = blocks.num_dst_blocks, blocks.tile
    n, d = x.shape
    out = torch.empty_like(x)
    from . import _build

    lib = _build.load()
    with torch.cuda.device(x.device):
        code = lib.spmm_banded_launch(
            blocks.a.data_ptr(), int(blocks.a.dtype == torch.float32), int(blocks.wide),
            blocks.bo.to(torch.int32).contiguous().data_ptr(), *cmap_args(blocks), blocks.k,
            nb, blocks.s_span, tile,
            x.data_ptr(), int(x.dtype == BF16), d,
            scale_ptr(blocks.col_scale, n, x.device), scale_ptr(blocks.row_scale, n, x.device),
            out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, f"spmm_banded kernel (nb={nb}, tile={tile}, D={d})")
    spmm_banded.launches += 1
    return out


spmm_banded.launches = 0


# ------------------------------------------------------------ int8 inference


def _check_int8(xq: torch.Tensor, x_scale: torch.Tensor, blocks: BandedBlocks) -> None:
    """The JAX kernel's asserts, as ValueErrors."""
    nb, tile = blocks.num_dst_blocks, blocks.tile
    if xq.dtype != torch.int8:
        raise ValueError(f"int8 banded kernel: features must be int8, got {xq.dtype}")
    if blocks.wide:
        raise ValueError("int8 banded kernel uses the per-slot layout (not wide)")
    if blocks.cmap is not None:
        raise ValueError("int8 banded kernel: contiguous band only (no cmap)")
    if blocks.a.dtype != torch.int8:
        raise ValueError("int8 banded kernel needs int8 count tiles")
    if blocks.row_scale is None:
        raise ValueError("int8 banded kernel needs the factored-mean row scale")
    if x_scale.shape != (1,) or x_scale.dtype != torch.float32:
        raise ValueError(f"x_scale must be float32 of shape (1,), got {x_scale.dtype} "
                         f"{tuple(x_scale.shape)}")
    if xq.dim() != 2 or xq.shape[0] != nb * tile:
        raise ValueError(f"xq rows {tuple(xq.shape)} must be num_dst_blocks * tile = {nb * tile}")


def spmm_banded_int8_plain(xq: torch.Tensor, x_scale: torch.Tensor,
                           blocks: BandedBlocks) -> torch.Tensor:
    """Plain PyTorch version of ``csrc/spmm_banded_int8.cu``: the integer
    sums (exact in f64), converted to f32, times ``x_scale``, times the row
    scale; f32 out."""
    _check_int8(xq, x_scale, blocks)
    acc = slot_aggregate(blocks.a.double(), xq.double(), blocks)
    return (acc.float() * x_scale) * blocks.row_scale


def spmm_banded_int8(xq: torch.Tensor, x_scale: torch.Tensor,
                     blocks: BandedBlocks) -> torch.Tensor:
    """:func:`spmm_banded_int8_plain`'s function: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. ``xq [n_pad, D]`` int8 with
    one per-tensor scale ``x_scale [1]`` f32; ``blocks`` the int8
    count-tile layout with its row scale."""
    if xq.device.type == "cpu":
        return spmm_banded_int8_plain(xq, x_scale, blocks)
    _check_int8(xq, x_scale, blocks)
    nb, tile = blocks.num_dst_blocks, blocks.tile
    n, d = xq.shape
    if xq.device.type != "cuda":
        raise ValueError(f"spmm_banded_int8 runs on CUDA or CPU tensors, got {xq.device}")
    if blocks.a.device != xq.device or x_scale.device != xq.device:
        raise ValueError(f"spmm_banded_int8: the layout and x_scale must be on {xq.device}")
    if tile % 32 or not 32 <= tile <= 128 or d > 128:
        raise ValueError(f"spmm_banded_int8: tile {tile} (32..128 by 32) and D {d} (<= 128)")
    xq = xq.contiguous()
    a = blocks.a.contiguous()
    out = torch.empty((n, d), dtype=torch.float32, device=xq.device)
    from . import _build

    lib = _build.load()
    with torch.cuda.device(xq.device):
        code = lib.spmm_banded_int8_launch(
            a.data_ptr(), blocks.bo.to(torch.int32).contiguous().data_ptr(), nb, blocks.s_span,
            tile, xq.data_ptr(), d, x_scale.contiguous().data_ptr(),
            scale_ptr(blocks.row_scale, n, xq.device), out.data_ptr(),
            torch.cuda.current_stream(xq.device).cuda_stream)
    _build.check(lib, code, f"spmm_banded_int8 kernel (nb={nb}, tile={tile}, D={d})")
    spmm_banded_int8.launches += 1
    return out


spmm_banded_int8.launches = 0


def spmm_banded_infer_int8(x: torch.Tensor, blocks: BandedBlocks) -> torch.Tensor:
    """Quantize x per tensor (:func:`..ops.quant.quantize_tensor_xla`), then
    aggregate through :func:`spmm_banded_int8`. Inference only: no
    gradient flows through the quantized features."""
    from .quant import quantize_tensor_xla

    xq, scale = quantize_tensor_xla(x)
    return spmm_banded_int8(xq, scale, blocks)


# ------------------------------------------------------------ autograd


def _dispatch(x, blocks, use_pallas):
    return spmm_banded(x, blocks) if use_pallas else spmm_banded_xla(x, blocks)


class _SpmmBandedFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, blocks_fwd, blocks_rev, use_pallas):
        ctx.blocks_rev, ctx.use_pallas = blocks_rev, use_pallas
        return _dispatch(x, blocks_fwd, use_pallas)

    @staticmethod
    def backward(ctx, g):
        return _dispatch(g.contiguous(), ctx.blocks_rev, ctx.use_pallas), None, None, None


def spmm_banded_apply(x: torch.Tensor, blocks_fwd: BandedBlocks, blocks_rev: BandedBlocks,
                      use_pallas: bool) -> torch.Tensor:
    """Mean aggregation whose backward runs the same aggregation on the
    reverse layout (``use_pallas``: the kernel; else the f32 twin)."""
    return _SpmmBandedFn.apply(x, blocks_fwd, blocks_rev, use_pallas)
