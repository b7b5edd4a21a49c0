"""Segment reductions and masked neighbourhood aggregation.

Port of ``sldm_gnn_tpu/ops/segment.py`` (``segment_max`` :50,
``masked_mean_aggregate`` :70, ``global_mean_pool`` :105,
``global_max_pool`` :112, and the aligned layout's ``dense_mean_pool`` /
``dense_max_pool`` :119-137). The JAX package
leaves these to XLA's segment ops, so they are plain PyTorch here
(``index_add_`` / ``scatter_reduce_``). Out-of-range segment ids (the
padding contract: ``edge_dst == N``, ``node_graph == G``) land in one
extra bucket that is sliced off.
"""

from __future__ import annotations

import torch

_NEG_INF = -3.4e38  # large negative float32 sentinel for masked max


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum ``data`` rows into ``num_segments`` buckets; ids equal to
    ``num_segments`` are dropped."""
    out = data.new_zeros((num_segments + 1,) + tuple(data.shape[1:]))
    out.index_add_(0, segment_ids.clamp(0, num_segments), data)
    return out[:num_segments]


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Per-segment max of ``data`` rows; ids equal to ``num_segments`` are
    dropped, and an empty segment (any max at or below ``_NEG_INF / 2``)
    yields 0, as the JAX package's ``segment_max`` does."""
    out = data.new_full((num_segments + 1,) + tuple(data.shape[1:]), float("-inf"))
    idx = segment_ids.clamp(0, num_segments)
    if data.dim() > 1:
        idx = idx.reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    out.scatter_reduce_(0, idx, data, reduce="amax", include_self=True)
    out = out[:num_segments]
    return torch.where(out <= _NEG_INF / 2, torch.zeros_like(out), out)


def masked_mean_aggregate(x: torch.Tensor, edge_src: torch.Tensor,
                          edge_dst: torch.Tensor, edge_mask: torch.Tensor,
                          num_nodes: int) -> torch.Tensor:
    """For each node ``i``: ``mean_{(j -> i) in E} x[j]`` over unmasked
    edges; nodes without incoming edges get zeros (PyG
    ``SAGEConv(aggr='mean')``)."""
    w = edge_mask.to(x.dtype)
    sums = segment_sum(x[edge_src] * w[:, None], edge_dst, num_nodes)
    deg = segment_sum(w, edge_dst, num_nodes)
    return sums / deg.clamp_min(1.0)[:, None]


def global_mean_pool(x: torch.Tensor, node_graph: torch.Tensor,
                     node_mask: torch.Tensor, num_graphs: int) -> torch.Tensor:
    """Per-graph mean over valid nodes; empty graphs yield 0."""
    w = node_mask.to(x.dtype)
    sums = segment_sum(x * w[:, None], node_graph, num_graphs)
    counts = segment_sum(w, node_graph, num_graphs)
    return sums / counts.clamp_min(1.0)[:, None]


def _neg_inf(x: torch.Tensor) -> torch.Tensor:
    """The masked-max sentinel at x's dtype (in bf16, where -3.4e38 is past
    the largest value, it rounds to -inf, as JAX converts it)."""
    return torch.tensor(_NEG_INF, dtype=torch.float32, device=x.device).to(x.dtype)


def global_max_pool(x: torch.Tensor, node_graph: torch.Tensor,
                    node_mask: torch.Tensor, num_graphs: int) -> torch.Tensor:
    """Per-graph max over valid nodes; empty graphs yield 0."""
    neg = _neg_inf(x)
    data = torch.where(node_mask[:, None], x, neg)
    out = neg.expand(num_graphs + 1, x.shape[1]).clone()
    idx = node_graph.clamp(0, num_graphs)[:, None].expand_as(data)
    out.scatter_reduce_(0, idx, data, reduce="amax", include_self=True)
    out = out[:num_graphs]
    return torch.where(out <= _NEG_INF / 2, torch.zeros_like(out), out)


def dense_mean_pool(x: torch.Tensor, node_mask: torch.Tensor, num_graphs: int,
                    vmax: int) -> torch.Tensor:
    """:func:`global_mean_pool` for the aligned layout (graph g = rows
    ``[g*vmax, (g+1)*vmax)``): a masked reshape-reduce; empty graphs 0."""
    xg = x.reshape(num_graphs, vmax, x.shape[-1])
    m = node_mask.reshape(num_graphs, vmax, 1).to(x.dtype)
    return (xg * m).sum(1) / m.sum(1).clamp_min(1.0)


def dense_max_pool(x: torch.Tensor, node_mask: torch.Tensor, num_graphs: int,
                   vmax: int) -> torch.Tensor:
    """:func:`global_max_pool` for the aligned layout; empty graphs 0."""
    xg = x.reshape(num_graphs, vmax, x.shape[-1])
    m = node_mask.reshape(num_graphs, vmax, 1)
    out = torch.where(m, xg, _neg_inf(x)).amax(1)
    return torch.where(out <= _NEG_INF / 2, torch.zeros_like(out), out)
