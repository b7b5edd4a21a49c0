"""Collation of ragged graphs into a fixed-capacity :class:`PaddedGraphBatch`.

Port of ``sldm_gnn_tpu/graph/batching.py`` (``BatchDims``,
``compute_batch_dims`` :36, ``pad_and_batch``, ``pad_and_batch_aligned``
:130). The padding is built in numpy
on the host and becomes torch tensors once, at the end; the batch moves to
the card with :meth:`PaddedGraphBatch.to`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from .containers import GraphArrays, PaddedGraphBatch


@dataclass(frozen=True)
class BatchDims:
    node_capacity: int
    edge_capacity: int
    graph_capacity: int
    num_frames: int
    num_labels: int


def _round_up(x: int, m: int) -> int:
    return ((int(x) + m - 1) // m) * m


def compute_batch_dims(graphs: Sequence[GraphArrays], batch_size: int, num_labels: int,
                       *, align: int = 8) -> BatchDims:
    """Static capacities that fit any ``batch_size`` graphs of the dataset:
    the sums of the ``batch_size`` largest node and edge counts, rounded up
    to ``align``."""
    if not graphs:
        raise ValueError("empty dataset")
    v = np.sort(np.array([g.num_nodes for g in graphs]))[::-1]
    e = np.sort(np.array([g.num_edges for g in graphs]))[::-1]
    k = min(batch_size, len(graphs))
    return BatchDims(
        node_capacity=_round_up(max(int(v[:k].sum()), 1), align),
        edge_capacity=_round_up(max(int(e[:k].sum()), 1), align),
        graph_capacity=batch_size,
        num_frames=int(graphs[0].x.shape[1]),
        num_labels=num_labels,
    )


def pad_and_batch(graphs: Sequence[GraphArrays], dims: BatchDims) -> PaddedGraphBatch:
    """Concatenate up to ``dims.graph_capacity`` graphs and pad to capacity.

    Returns a CPU batch; raises if the graphs exceed the static capacities.
    """
    G, N, E = dims.graph_capacity, dims.node_capacity, dims.edge_capacity
    F, L = dims.num_frames, dims.num_labels
    if len(graphs) > G:
        raise ValueError(f"{len(graphs)} graphs > capacity {G}")

    x = np.zeros((N, F, 6), dtype=np.float32)
    xsttype = np.zeros((N,), dtype=np.int64)
    xdims = np.zeros((N, 2), dtype=np.float32)
    pos_raw = np.zeros((N, F, 2), dtype=np.float32)
    edge_src = np.zeros((E,), dtype=np.int64)
    edge_dst = np.full((E,), N, dtype=np.int64)  # out of range: dropped
    edge_attr = np.zeros((E, 4), dtype=np.float32)
    edge_mask = np.zeros((E,), dtype=bool)
    node_mask = np.zeros((N,), dtype=bool)
    node_graph = np.full((N,), G, dtype=np.int64)  # padding: dropped at pooling
    y = np.zeros((G, L), dtype=np.float32)
    graph_mask = np.zeros((G,), dtype=bool)

    n_off = 0
    e_off = 0
    for gi, g in enumerate(graphs):
        v, ne = g.num_nodes, g.num_edges
        if n_off + v > N or e_off + ne > E:
            raise ValueError(
                f"batch overflow: nodes {n_off + v}/{N}, edges {e_off + ne}/{E}"
            )
        x[n_off : n_off + v] = g.x
        xsttype[n_off : n_off + v] = g.xsttype
        xdims[n_off : n_off + v] = g.xdims
        pos_raw[n_off : n_off + v] = g.pos_raw if g.pos_raw is not None else g.x[:, :, :2]
        if ne:
            edge_src[e_off : e_off + ne] = g.edge_index[0] + n_off
            edge_dst[e_off : e_off + ne] = g.edge_index[1] + n_off
            edge_attr[e_off : e_off + ne] = g.edge_attr
            edge_mask[e_off : e_off + ne] = True
        node_mask[n_off : n_off + v] = True
        node_graph[n_off : n_off + v] = gi
        if g.y is not None:
            y[gi] = g.y
        graph_mask[gi] = True
        n_off += v
        e_off += ne

    arrays = dict(
        x=x, xsttype=xsttype, xdims=xdims, pos_raw=pos_raw, edge_src=edge_src,
        edge_dst=edge_dst, edge_attr=edge_attr, edge_mask=edge_mask,
        node_mask=node_mask, node_graph=node_graph, y=y, graph_mask=graph_mask,
    )
    return PaddedGraphBatch(**{k: torch.from_numpy(a) for k, a in arrays.items()})


def pad_and_batch_aligned(graphs: Sequence[GraphArrays], vmax: int, *, num_frames: int,
                          num_labels: int, graph_capacity: int | None = None,
                          edge_capacity: int | None = None) -> PaddedGraphBatch:
    """The dense block-diagonal layout: graph g's nodes at rows ``[g*vmax,
    (g+1)*vmax)`` and ``adj [G, vmax, vmax]`` the row-normalized
    mean-aggregation weights, so SAGE aggregation is one batched matmul and
    pooling a masked reshape-reduce. The edge arrays are filled too, so
    segment-op consumers work on the same batch. Raises if a graph has more
    than ``vmax`` nodes or the batch overflows a capacity."""
    G = graph_capacity if graph_capacity is not None else len(graphs)
    if len(graphs) > G:
        raise ValueError(f"{len(graphs)} graphs > capacity {G}")
    for g in graphs:
        if g.num_nodes > vmax:
            raise ValueError(f"graph with {g.num_nodes} nodes > vmax {vmax}")
    total_e = sum(g.num_edges for g in graphs)
    E = edge_capacity if edge_capacity is not None else max(_round_up(total_e, 128), 128)
    N = G * vmax
    F, L = num_frames, num_labels

    x = np.zeros((N, F, 6), dtype=np.float32)
    xsttype = np.zeros((N,), dtype=np.int64)
    xdims = np.zeros((N, 2), dtype=np.float32)
    pos_raw = np.zeros((N, F, 2), dtype=np.float32)
    edge_src = np.zeros((E,), dtype=np.int64)
    edge_dst = np.full((E,), N, dtype=np.int64)
    edge_attr = np.zeros((E, 4), dtype=np.float32)
    edge_mask = np.zeros((E,), dtype=bool)
    node_mask = np.zeros((N,), dtype=bool)
    node_graph = np.full((N,), G, dtype=np.int64)
    y = np.zeros((G, L), dtype=np.float32)
    graph_mask = np.zeros((G,), dtype=bool)
    adj = np.zeros((G, vmax, vmax), dtype=np.float32)

    e_off = 0
    for gi, g in enumerate(graphs):
        v, ne = g.num_nodes, g.num_edges
        n_off = gi * vmax
        if e_off + ne > E:
            raise ValueError(f"batch overflow: edges {e_off + ne}/{E}")
        x[n_off:n_off + v] = g.x
        xsttype[n_off:n_off + v] = g.xsttype
        xdims[n_off:n_off + v] = g.xdims
        pos_raw[n_off:n_off + v] = g.pos_raw if g.pos_raw is not None else g.x[:, :, :2]
        if ne:
            src_l = g.edge_index[0].astype(np.int64)
            dst_l = g.edge_index[1].astype(np.int64)
            edge_src[e_off:e_off + ne] = src_l + n_off
            edge_dst[e_off:e_off + ne] = dst_l + n_off
            edge_attr[e_off:e_off + ne] = g.edge_attr
            edge_mask[e_off:e_off + ne] = True
            np.add.at(adj, (gi, dst_l, src_l), 1.0)
        node_mask[n_off:n_off + v] = True
        node_graph[n_off:n_off + v] = gi
        if g.y is not None:
            y[gi] = g.y
        graph_mask[gi] = True
        e_off += ne
    adj /= np.maximum(adj.sum(axis=2, keepdims=True), 1.0)

    arrays = dict(
        x=x, xsttype=xsttype, xdims=xdims, pos_raw=pos_raw, edge_src=edge_src,
        edge_dst=edge_dst, edge_attr=edge_attr, edge_mask=edge_mask,
        node_mask=node_mask, node_graph=node_graph, y=y, graph_mask=graph_mask, adj=adj,
    )
    return PaddedGraphBatch(**{k: torch.from_numpy(a) for k, a in arrays.items()})
