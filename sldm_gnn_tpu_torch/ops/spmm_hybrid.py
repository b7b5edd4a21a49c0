"""Hybrid SpMM: dense tiles where the graph is dense, one-hot chunks
elsewhere.

Port of ``sldm_gnn_tpu/ops/spmm_hybrid.py``. The host splits the static
edge set once: (dst block, src block) pairs with at least
``min_pair_edges`` edges, within a per-block pair cap derived from the
A-tile budget (the cap holds for the pair's destination block and for its
source block, so both directions' dense layouts stay bounded), go to the
dense layouts of :mod:`.spmm_dense`; the other edges to the one-hot
layouts of :mod:`.spmm`. An aggregation is the sum of the two halves, and
its backward the sum of their backwards. Mean weights use the full degree
on both halves.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..graph.csr import EDGE_CHUNK, TILE, BlockedEdges, auto_edge_chunk, block_edges, check_edge_range, mean_weights
from .spmm import spmm_apply
from .spmm_banded import _mean_scale
from .spmm_dense import DenseBlocks, build_dense_blocks, int8_counts, spmm_dense_apply, torch_dtype


@dataclass(frozen=True)
class HybridLayout:
    """The edge set split into a dense-tile half and a one-hot half; either
    may be None. Pad x to ``n_pad`` rows. ``dense_frac`` is the share of
    the edges in the dense half."""

    dense_fwd: DenseBlocks | None
    dense_rev: DenseBlocks | None
    onehot_fwd: BlockedEdges | None
    onehot_rev: BlockedEdges | None
    n_pad: int
    dense_k: int = 1
    k_per_step: int = 1
    dense_frac: float = float("nan")

    @property
    def dense_edge_fraction(self) -> float:
        return self.dense_frac

    def to(self, device) -> "HybridLayout":
        move = lambda b: None if b is None else b.to(device)
        return dataclasses.replace(self, dense_fwd=move(self.dense_fwd),
                                   dense_rev=move(self.dense_rev),
                                   onehot_fwd=move(self.onehot_fwd),
                                   onehot_rev=move(self.onehot_rev))


def _rank_within_group(group: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Rank of each item within its group, by count descending."""
    order = np.lexsort((-counts, group))
    g_sorted = group[order]
    starts = np.r_[0, np.nonzero(np.diff(g_sorted))[0] + 1] if len(group) else np.zeros(1, np.int64)
    lens = np.diff(np.r_[starts, len(group)])
    rank = np.empty(len(group), np.int64)
    rank[order] = np.arange(len(group)) - np.repeat(starts, lens)
    return rank


def select_dense_edges(
    src: np.ndarray,
    dst: np.ndarray,
    nb: int,
    *,
    tile: int = TILE,
    min_pair_edges: int | None = None,
    max_pairs_per_block: int | None = None,
) -> np.ndarray:
    """Per-edge mask: True where the edge's block pair has at least
    ``min_pair_edges`` edges (default ``tile // 2``) and ranks within the
    ``max_pairs_per_block`` densest pairs of its dst block and of its src
    block."""
    if min_pair_edges is None:
        min_pair_edges = tile // 2
    if len(src) == 0:
        return np.zeros(0, bool)
    db = np.asarray(dst, np.int64) // tile
    sb = np.asarray(src, np.int64) // tile
    uniq, inv, counts = np.unique(db * nb + sb, return_inverse=True, return_counts=True)
    sel = counts >= min_pair_edges
    if max_pairs_per_block is not None:
        sel &= _rank_within_group(uniq // nb, counts) < max_pairs_per_block
        sel &= _rank_within_group(uniq % nb, counts) < max_pairs_per_block
    return sel[inv.reshape(-1)]


def _padded(num_nodes: int, tile: int, dense_k: int) -> int:
    lcm = math.lcm(tile * dense_k, tile)
    return max(((num_nodes + lcm - 1) // lcm) * lcm, lcm)


def prepare_hybrid_mean_aggregate(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    *,
    tile: int = TILE,
    dense_k: int = 1,
    k_per_step: int = 1,
    edge_chunk: int = EDGE_CHUNK,
    min_pair_edges: int | None = None,
    a_budget_bytes: float = 4e9,
    dense_dtype=np.float32,
) -> tuple[HybridLayout, int]:
    """Split the edges and build both halves' layouts, both directions.
    ``a_budget_bytes`` bounds the dense tiles (both directions) through
    the per-block pair cap; ``dense_dtype`` int8 gives the factored count
    tiles, a float dtype (f32, bf16) weight tiles. Returns (layout, n_pad)."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    check_edge_range(src, dst, num_nodes)
    n_pad = _padded(num_nodes, tile, dense_k)
    nb = n_pad // tile
    tdt = torch_dtype(dense_dtype)
    itemsize = torch.empty(0, dtype=tdt).element_size()
    cap = max(int(a_budget_bytes // (2 * nb * tile * tile * itemsize)), 1)

    w = mean_weights(dst, n_pad)
    dense_mask = select_dense_edges(src, dst, nb, tile=tile, min_pair_edges=min_pair_edges,
                                    max_pairs_per_block=cap)
    dense_fwd = dense_rev = onehot_fwd = onehot_rev = None
    if dense_mask.any():
        sd, dd, wd = src[dense_mask], dst[dense_mask], w[dense_mask]
        if tdt == torch.int8:
            fwd = build_dense_blocks(sd, dd, n_pad, tile=tile, pad_blocks_to=dense_k)
            rev = build_dense_blocks(dd, sd, n_pad, tile=tile, pad_blocks_to=dense_k)
            int8_counts(fwd)
            scale = _mean_scale(dst, n_pad)  # the full degree
            dense_fwd = DenseBlocks(a=fwd.a.to(torch.int8), src_blk=fwd.src_blk,
                                    row_scale=scale, tile=tile)
            dense_rev = DenseBlocks(a=rev.a.to(torch.int8), src_blk=rev.src_blk,
                                    col_scale=scale, tile=tile)
        else:
            dense_fwd = build_dense_blocks(sd, dd, n_pad, weight=wd, tile=tile, dtype=tdt,
                                           pad_blocks_to=dense_k)
            dense_rev = build_dense_blocks(dd, sd, n_pad, weight=wd, tile=tile, dtype=tdt,
                                           pad_blocks_to=dense_k)
    sparse_mask = ~dense_mask
    if sparse_mask.any() or not dense_mask.any():
        ss, ds, ws = src[sparse_mask], dst[sparse_mask], w[sparse_mask]
        ec = auto_edge_chunk(len(ss), edge_chunk)
        onehot_fwd = block_edges(ss, ds, n_pad, weight=ws, tile=tile, edge_chunk=ec,
                                 step_chunks=k_per_step)
        onehot_rev = block_edges(ds, ss, n_pad, weight=ws, tile=tile, edge_chunk=ec,
                                 step_chunks=k_per_step)
    layout = HybridLayout(
        dense_fwd=dense_fwd, dense_rev=dense_rev, onehot_fwd=onehot_fwd, onehot_rev=onehot_rev,
        n_pad=n_pad, dense_k=dense_k, k_per_step=k_per_step,
        dense_frac=float(dense_mask.mean()) if len(src) else 0.0)
    return layout, n_pad


def spmm_hybrid_apply(x: torch.Tensor, layout: HybridLayout, use_pallas: bool) -> torch.Tensor:
    """The sum of the two halves' aggregations; the backward composes from
    their reverse layouts."""
    out = None
    if layout.dense_fwd is not None:
        out = spmm_dense_apply(x, layout.dense_fwd, layout.dense_rev, use_pallas, layout.dense_k)
    if layout.onehot_fwd is not None:
        o = spmm_apply(x, layout.onehot_fwd, layout.onehot_rev, layout.n_pad, use_pallas,
                       layout.k_per_step)
        out = o if out is None else out + o
    return torch.zeros_like(x) if out is None else out


def dense_tile_bytes(src, dst, num_nodes, *, tile: int = TILE, dense_k: int = 1,
                     itemsize: int = 2) -> int:
    """The dense tiles' bytes, both directions, for this edge set."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    nb = _padded(num_nodes, tile, dense_k) // tile
    if not len(src):
        return 0
    pairs = np.unique(dst // tile * nb + src // tile)
    s_fwd = int(np.bincount(pairs // nb).max())
    s_rev = int(np.bincount(pairs % nb).max())
    return nb * (s_fwd + s_rev) * tile * tile * itemsize


def prepare_auto_mean_aggregate(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    *,
    tile: int = TILE,
    dense_k: int = 1,
    k_per_step: int = 1,
    edge_chunk: int = EDGE_CHUNK,
    a_budget_bytes: float = 8e9,
    min_pair_edges: int | None = None,
    reorder: bool = False,
    coords: np.ndarray | None = None,
):
    """The JAX package's layout choice under an A-tile budget: banded (or
    banded + residual) when the int8 dense tiles fit the budget and the
    graph is near-banded; else int8 dense tiles (bf16 weight tiles past 127
    duplicate edges); else the hybrid split. Returns ``(layout_fwd,
    layout_rev, n_pad)``, ``layout_rev`` None where the layout carries both
    directions.

    ``reorder=True`` first tries a bandwidth-reducing node order
    (:func:`..graph.reorder.reorder_for_banding`: Hilbert on ``coords``
    when given, else RCM) and returns ``(layout_fwd, layout_rev, n_pad,
    perm)``; ``perm`` (``perm[new] = old``) is None when the graph is
    banded already or no order bands it, else the layouts are in the new
    ids and x must be permuted once on the host (``x[perm]``)."""
    if reorder:
        from ..graph.reorder import relabel_edges, reorder_for_banding

        try:
            perm = reorder_for_banding(src, dst, num_nodes, tile=tile, coords=coords)
        except ValueError:
            perm = None
        if perm is not None:
            src, dst = relabel_edges(src, dst, perm)
        out = prepare_auto_mean_aggregate(
            src, dst, num_nodes, tile=tile, dense_k=dense_k, k_per_step=k_per_step,
            edge_chunk=edge_chunk, a_budget_bytes=a_budget_bytes, min_pair_edges=min_pair_edges)
        return (*out, perm)
    from .banded_residual import prepare_banded_residual_mean_aggregate
    from .spmm_banded import prepare_banded_mean_aggregate
    from .spmm_dense import prepare_dense_mean_aggregate

    if dense_tile_bytes(src, dst, num_nodes, tile=tile, dense_k=dense_k,
                        itemsize=1) <= a_budget_bytes:
        try:
            layout, n_pad = prepare_banded_residual_mean_aggregate(
                src, dst, num_nodes, tile=tile, k=max(dense_k, 4))
            if len(layout.r_src) == 0:
                return prepare_banded_mean_aggregate(src, dst, num_nodes, tile=tile,
                                                     k=max(dense_k, 4), dtype=np.int8)
            return layout, None, n_pad
        except ValueError:
            pass
        try:
            return prepare_dense_mean_aggregate(src, dst, num_nodes, tile=tile,
                                                pad_blocks_to=dense_k, dtype=np.int8)
        except ValueError:  # duplicate-edge multiplicity > 127
            if dense_tile_bytes(src, dst, num_nodes, tile=tile, dense_k=dense_k,
                                itemsize=2) <= a_budget_bytes:
                return prepare_dense_mean_aggregate(src, dst, num_nodes, tile=tile,
                                                    pad_blocks_to=dense_k, dtype=torch.bfloat16)
    layout, n_pad = prepare_hybrid_mean_aggregate(
        src, dst, num_nodes, tile=tile, dense_k=dense_k, k_per_step=k_per_step,
        edge_chunk=edge_chunk, min_pair_edges=min_pair_edges, a_budget_bytes=a_budget_bytes,
        dense_dtype=np.int8)
    return layout, None, n_pad
