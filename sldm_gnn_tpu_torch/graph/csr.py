"""Node padding, edge checks and the blocked (one-hot) edge layout.

Port of ``sldm_gnn_tpu/graph/csr.py`` (:32-237): ``TILE``, ``EDGE_CHUNK``,
:func:`auto_edge_chunk`, :class:`BlockedEdges`, :func:`block_edges`,
:func:`pad_nodes`, :func:`check_edge_range` and :func:`mean_weights`.
numpy, like the JAX package's host builders; :func:`block_edges` takes the
numpy path at every size (the JAX builder hands 100k edges or more to its
native library, whose chunk order within a destination block may differ).

The blocked layout groups the edges by (destination block, source block)
pair, cuts each group into chunks of ``edge_chunk`` slots (padding slots
carry weight 0), gives every destination block at least one chunk, pads
each block's chunk count to a multiple of ``step_chunks``, and keeps each
destination block's chunks contiguous.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

TILE = 128
EDGE_CHUNK = 256


def check_edge_range(src: np.ndarray, dst: np.ndarray, num_nodes: int) -> None:
    """Raise ValueError on edge endpoints outside ``[0, num_nodes)``."""
    if len(src) and (
        src.min() < 0 or dst.min() < 0 or src.max() >= num_nodes or dst.max() >= num_nodes
    ):
        raise ValueError(
            f"edge endpoints out of range [0, {num_nodes}): "
            f"src [{src.min()}, {src.max()}], dst [{dst.min()}, {dst.max()}]"
        )


def auto_edge_chunk(n_edges: int, edge_chunk: int = EDGE_CHUNK,
                    max_chunks: int = 65536) -> int:
    """Double the chunk width until the layout has at most ``max_chunks``
    chunks (the JAX kernel's per-chunk metadata must fit the TPU's SMEM;
    kept so that the layouts stay equal)."""
    ec = edge_chunk
    while n_edges > ec * max_chunks:
        ec *= 2
    return ec


@dataclass(frozen=True)
class BlockedEdges:
    """The blocked layout as tensors, plus its static ints.

    block_meta [W, 2] int32  (dst_block, src_block) of every chunk, sorted
                             by dst_block
    src_local  [W, EC] int32 source row within the source block
    dst_local  [W, EC] int32 destination row within the destination block
    weight     [W, EC] f32   per-slot weight; 0 on padding slots
    edge_id    [W, EC] int32 the slot's index in the edge list (0 on padding)
    tile          node-tile height
    step_chunks   every destination block's chunk count is a multiple of it
    """

    block_meta: torch.Tensor
    src_local: torch.Tensor
    dst_local: torch.Tensor
    weight: torch.Tensor
    edge_id: torch.Tensor | None = None
    tile: int = TILE
    step_chunks: int = 1

    @property
    def num_chunks(self) -> int:
        return self.block_meta.shape[0]

    @property
    def edge_chunk(self) -> int:
        return self.src_local.shape[1]

    def to(self, device) -> "BlockedEdges":
        move = lambda t: None if t is None else t.to(device)
        return dataclasses.replace(
            self, block_meta=move(self.block_meta), src_local=move(self.src_local),
            dst_local=move(self.dst_local), weight=move(self.weight),
            edge_id=move(self.edge_id))


def block_edges(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    *,
    weight: np.ndarray | None = None,
    tile: int = TILE,
    edge_chunk: int = EDGE_CHUNK,
    step_chunks: int = 1,
) -> BlockedEdges:
    """The blocked layout of an edge list (numpy, returned as CPU tensors),
    equal to the JAX builder's numpy path."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    check_edge_range(src, dst, num_nodes)
    n_edges = src.shape[0]
    weight = (np.ones(n_edges, np.float32) if weight is None
              else np.asarray(weight, dtype=np.float32))
    num_blocks = max((num_nodes + tile - 1) // tile, 1)

    sb, db = src // tile, dst // tile
    order = np.lexsort((sb, db))  # by (dst_block, src_block), stable
    src_s, dst_s, w_s, sb_s, db_s = src[order], dst[order], weight[order], sb[order], db[order]
    eid_s = order.astype(np.int32)

    # chunk c of group g holds the group's slots [c*EC, (c+1)*EC)
    metas: list[tuple[int, int]] = []
    starts: list[tuple[int, int]] = []  # (first sorted edge, count) of each chunk
    if n_edges:
        key = db_s * num_blocks + sb_s
        bounds = np.r_[0, np.nonzero(np.diff(key))[0] + 1, n_edges]
        for b0, b1 in zip(bounds[:-1], bounds[1:]):
            dblk, sblk = int(db_s[b0]), int(sb_s[b0])
            for off in range(b0, b1, edge_chunk):
                metas.append((dblk, sblk))
                starts.append((off, min(edge_chunk, b1 - off)))
    covered = {m[0] for m in metas}
    dummies = [d for d in range(num_blocks) if d not in covered]
    if step_chunks > 1:
        per_block: dict[int, int] = {}
        for d in [m[0] for m in metas] + dummies:
            per_block[d] = per_block.get(d, 0) + 1
        for d, cnt in per_block.items():
            dummies += [d] * ((-cnt) % step_chunks)
    metas += [(d, 0) for d in dummies]

    w_total = len(metas)
    src_arr = np.zeros((w_total, edge_chunk), np.int32)
    dst_arr = np.zeros((w_total, edge_chunk), np.int32)
    w_arr = np.zeros((w_total, edge_chunk), np.float32)
    e_arr = np.zeros((w_total, edge_chunk), np.int32)
    for c, (off, n) in enumerate(starts):
        dblk, sblk = metas[c]
        src_arr[c, :n] = src_s[off:off + n] - sblk * tile
        dst_arr[c, :n] = dst_s[off:off + n] - dblk * tile
        w_arr[c, :n] = w_s[off:off + n]
        e_arr[c, :n] = eid_s[off:off + n]

    meta_arr = np.array(metas, np.int32).reshape(-1, 2)
    order2 = np.argsort(meta_arr[:, 0], kind="stable")  # dst blocks contiguous
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return BlockedEdges(block_meta=t(meta_arr[order2]), src_local=t(src_arr[order2]),
                        dst_local=t(dst_arr[order2]), weight=t(w_arr[order2]),
                        edge_id=t(e_arr[order2]), tile=tile, step_chunks=step_chunks)


def mean_weights(dst: np.ndarray, num_nodes: int) -> np.ndarray:
    """Per-edge 1/deg(dst) weights turning sum aggregation into mean."""
    deg = np.bincount(np.asarray(dst, np.int64), minlength=num_nodes)
    return (1.0 / np.maximum(deg, 1))[dst].astype(np.float32)


def pad_nodes(num_nodes: int, tile: int = TILE) -> int:
    return max(((num_nodes + tile - 1) // tile) * tile, tile)
