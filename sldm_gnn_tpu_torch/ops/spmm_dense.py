"""Dense-tile SpMM: layouts, the reference einsum, the CUDA kernel
``csrc/spmm_dense.cu`` and its plain version, and the autograd.

Port of ``sldm_gnn_tpu/ops/spmm_dense.py``. For a locality graph every
destination block of ``tile`` rows reads a few source blocks; the layout
keeps one dense adjacency tile per (destination block, source block) pair:

    A[b, s][i, j] = sum of w_e over the edges src_blk[b, s]*T + j -> b*T + i
    out[b*T : b*T+T] = row_scale * sum_s A[b, s] @ (col_scale * x)[src_blk[b, s]]

Tiles are f32, bf16 or int8. The int8 form is the factored mean: duplicate
edge counts, with 1/deg as ``row_scale`` on the forward layout and as
``col_scale`` on the reverse one. The backward runs the same aggregation
on the reverse layout.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..graph.csr import TILE, check_edge_range, mean_weights, pad_nodes
from .spmm_banded import BF16, _mean_scale, _tensor, bf16r, scale_ptr

TILE_KINDS = {torch.int8: 0, torch.float32: 1, BF16: 2}


@dataclass(frozen=True)
class DenseBlocks:
    """Block-sparse adjacency in dense-tile form.

    a         [NB, S_MAX, T, T] f32, bf16 or int8 tiles (all-zero padding tiles)
    src_blk   [NB, S_MAX] int32 source block of every slot (0 on padding)
    row_scale [NB*T, 1] f32 or None  scale of the output rows
    col_scale [NB*T, 1] f32 or None  scale of x's rows, applied before the tiles
    """

    a: torch.Tensor
    src_blk: torch.Tensor
    row_scale: torch.Tensor | None = None
    col_scale: torch.Tensor | None = None
    tile: int = TILE

    @property
    def num_dst_blocks(self) -> int:
        return self.a.shape[0]

    @property
    def s_max(self) -> int:
        return self.a.shape[1]

    def to(self, device) -> "DenseBlocks":
        move = lambda t: None if t is None else t.to(device)
        return dataclasses.replace(self, a=move(self.a), src_blk=move(self.src_blk),
                                   row_scale=move(self.row_scale),
                                   col_scale=move(self.col_scale))


def torch_dtype(dtype) -> torch.dtype:
    """A numpy dtype, a torch dtype or ``"bfloat16"`` as a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if str(dtype) == "bfloat16":
        return BF16
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


def build_dense_blocks(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    *,
    weight: np.ndarray | None = None,
    tile: int = TILE,
    dtype=np.float32,
    pad_blocks_to: int = 1,
) -> DenseBlocks:
    """The dense tiles of an edge list (numpy, returned as CPU tensors);
    duplicate edges sum their weights. ``pad_blocks_to`` rounds the
    destination block count up with all-zero blocks."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    if len(src) and (
        src.min() < 0 or dst.min() < 0 or src.max() >= num_nodes or dst.max() >= num_nodes
    ):
        raise ValueError(f"edge endpoints out of range [0, {num_nodes})")
    weight = (np.ones(len(src), np.float32) if weight is None
              else np.asarray(weight, np.float32))
    nb = pad_nodes(num_nodes, tile) // tile
    nb = ((nb + pad_blocks_to - 1) // pad_blocks_to) * pad_blocks_to
    db, sb = dst // tile, src // tile

    # the non-empty (dst block, src block) pairs, in key order; a pair's
    # slot is its rank among its destination block's pairs
    key = db * nb + sb
    pair_keys = np.unique(key)
    pair_db, pair_sb = pair_keys // nb, pair_keys % nb
    counts = np.bincount(pair_db, minlength=nb)
    s_max = max(int(counts.max()) if len(counts) else 0, 1)
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pair_slot = np.arange(len(pair_keys)) - first[pair_db]

    a = np.zeros((nb, s_max, tile, tile), np.float32)
    src_blk = np.zeros((nb, s_max), np.int32)
    src_blk[pair_db, pair_slot] = pair_sb
    if len(src):
        slot = pair_slot[np.searchsorted(pair_keys, key)]
        np.add.at(a, (db, slot, dst - db * tile, src - sb * tile), weight)
    return DenseBlocks(a=_tensor(a).to(torch_dtype(dtype)), src_blk=_tensor(src_blk), tile=tile)


# ------------------------------------------------------------ reference


def spmm_dense_xla(x: torch.Tensor, blocks: DenseBlocks) -> torch.Tensor:
    """The JAX ``spmm_dense_xla``: an einsum over the same tiles at x's
    dtype, with no bf16 rounding."""
    nb, _, tile, _ = blocks.a.shape
    if blocks.col_scale is not None:
        x = (x.float() * blocks.col_scale).to(x.dtype)
    gathered = x.reshape(-1, tile, x.shape[1])[blocks.src_blk.long()]
    out = torch.einsum("bsij,bsjd->bid", blocks.a.to(x.dtype), gathered)
    out = out.reshape(nb * tile, x.shape[1])
    if blocks.row_scale is not None:
        out = (out.float() * blocks.row_scale).to(x.dtype)
    return out


# ------------------------------------------------------------ the kernel


def _prologue(x: torch.Tensor, blocks: DenseBlocks, step_blocks: int) -> torch.Tensor:
    """The JAX wrapper's checks, and x times the column scale (one pass
    over x outside the kernel, at x's dtype)."""
    nb, tile = blocks.num_dst_blocks, blocks.tile
    if x.dim() != 2 or x.shape[0] != nb * tile:
        raise ValueError(f"x rows {tuple(x.shape)} must be num_dst_blocks * tile = {nb * tile}")
    if nb % step_blocks:
        raise ValueError(f"num_dst_blocks {nb} not divisible by step_blocks {step_blocks}; "
                         f"build with pad_blocks_to={step_blocks}")
    if blocks.col_scale is not None:
        x = (x.float() * blocks.col_scale).to(x.dtype)
    return x


def spmm_dense_plain(x: torch.Tensor, blocks: DenseBlocks, *, step_blocks: int = 1) -> torch.Tensor:
    """Plain PyTorch version of ``csrc/spmm_dense.cu``: tiles and x rounded
    to bf16, products summed in f32, the row scale in f32, the result at
    x's dtype."""
    x = _prologue(x, blocks, step_blocks)
    tile, d = blocks.tile, x.shape[1]
    gathered = bf16r(x.float()).reshape(-1, tile, d)[blocks.src_blk.long()]
    out = torch.einsum("bsij,bsjd->bid", bf16r(blocks.a.float()), gathered).reshape(-1, d)
    if blocks.row_scale is not None:
        out = out * blocks.row_scale
    return out.to(x.dtype)


def spmm_dense(x: torch.Tensor, blocks: DenseBlocks, *, step_blocks: int = 1) -> torch.Tensor:
    """:func:`spmm_dense_plain`'s function: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return spmm_dense_plain(x, blocks, step_blocks=step_blocks)
    x = _prologue(x, blocks, step_blocks)
    nb, tile, s_max = blocks.num_dst_blocks, blocks.tile, blocks.s_max
    n, d = x.shape
    if x.device.type != "cuda":
        raise ValueError(f"spmm_dense runs on CUDA or CPU tensors, got {x.device}")
    if blocks.a.device != x.device or blocks.src_blk.device != x.device:
        raise ValueError(f"spmm_dense: the layout must be on {x.device} (DenseBlocks.to)")
    if tile % 32 or not 32 <= tile <= 128:
        raise ValueError(f"spmm_dense: tile {tile} not taken (32, 64, 96 or 128)")
    if x.dtype not in (torch.float32, BF16) or d > 128:
        raise ValueError(f"spmm_dense: x must be float32 or bfloat16 with D <= 128, got "
                         f"{x.dtype} D={d}")
    if blocks.a.dtype not in TILE_KINDS:
        raise ValueError(f"spmm_dense: tiles must be int8, float32 or bfloat16, got {blocks.a.dtype}")
    x = x.contiguous()
    a = blocks.a.contiguous()
    src_blk = blocks.src_blk.to(torch.int32).contiguous()
    out = torch.empty_like(x)
    from . import _build

    lib = _build.load()
    with torch.cuda.device(x.device):
        code = lib.spmm_dense_launch(
            a.data_ptr(), TILE_KINDS[a.dtype], src_blk.data_ptr(), nb, s_max, tile,
            x.data_ptr(), int(x.dtype == BF16), d, scale_ptr(blocks.row_scale, n, x.device),
            out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, f"spmm_dense kernel (nb={nb}, s_max={s_max}, tile={tile}, D={d})")
    spmm_dense.launches += 1
    return out


spmm_dense.launches = 0


# ------------------------------------------------------------ autograd


def _dispatch(x, blocks, use_pallas, step_blocks=1):
    if use_pallas:
        return spmm_dense(x, blocks, step_blocks=step_blocks)
    return spmm_dense_xla(x, blocks)


class _SpmmDenseFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, blocks_fwd, blocks_rev, use_pallas, step_blocks):
        ctx.saved = (blocks_rev, use_pallas, step_blocks)
        return _dispatch(x, blocks_fwd, use_pallas, step_blocks)

    @staticmethod
    def backward(ctx, g):
        blocks_rev, use_pallas, step_blocks = ctx.saved
        return _dispatch(g.contiguous(), blocks_rev, use_pallas, step_blocks), None, None, None, None


def spmm_dense_apply(x: torch.Tensor, blocks_fwd: DenseBlocks, blocks_rev: DenseBlocks,
                     use_pallas: bool, step_blocks: int = 1) -> torch.Tensor:
    """Aggregation whose backward runs the reverse layout (``use_pallas``:
    the kernel; else the reference einsum)."""
    return _SpmmDenseFn.apply(x, blocks_fwd, blocks_rev, use_pallas, step_blocks)


# ------------------------------------------------------------ host-side prep


def int8_counts(fwd: DenseBlocks) -> None:
    """Raise where a duplicate-edge count does not fit int8."""
    cmax = max(float(fwd.a.max()) if fwd.a.numel() else 0.0, 1.0)
    if cmax > 127:
        raise ValueError(f"duplicate-edge multiplicity {cmax:.0f} overflows int8 counts")


def prepare_dense_mean_aggregate(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    *,
    tile: int = TILE,
    dtype=np.float32,
    pad_blocks_to: int = 1,
) -> tuple[DenseBlocks, DenseBlocks, int]:
    """Forward and reverse dense layouts for mean aggregation and the
    padded row count. ``dtype`` int8 gives the factored form (count tiles,
    1/deg as the forward row scale and the reverse column scale; raises
    past 127 duplicate edges); a float dtype folds the weights in."""
    if torch_dtype(dtype) == torch.int8:
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        check_edge_range(src, dst, num_nodes)
        fwd = build_dense_blocks(src, dst, num_nodes, tile=tile, pad_blocks_to=pad_blocks_to)
        rev = build_dense_blocks(dst, src, num_nodes, tile=tile, pad_blocks_to=pad_blocks_to)
        int8_counts(fwd)
        n_pad = fwd.num_dst_blocks * tile
        scale = _mean_scale(dst, n_pad)
        fwd = DenseBlocks(a=fwd.a.to(torch.int8), src_blk=fwd.src_blk, row_scale=scale, tile=tile)
        rev = DenseBlocks(a=rev.a.to(torch.int8), src_blk=rev.src_blk, col_scale=scale, tile=tile)
        return fwd, rev, n_pad
    w = mean_weights(dst, num_nodes)
    fwd = build_dense_blocks(src, dst, num_nodes, weight=w, tile=tile, dtype=dtype,
                             pad_blocks_to=pad_blocks_to)
    rev = build_dense_blocks(dst, src, num_nodes, weight=w, tile=tile, dtype=dtype,
                             pad_blocks_to=pad_blocks_to)
    return fwd, rev, fwd.num_dst_blocks * tile
