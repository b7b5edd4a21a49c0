"""Map context: the static map encoder and the KNN spatial attention.

Port of ``sldm_gnn_tpu/models/map_modules.py``:

  * :func:`map_zscore_norm` (:28), :class:`MapData` (:37), :func:`dense_map_adj`
    (:109) and :class:`MapEncoder` (:203, replicated form: the lane-type
    embedding concatenated to the features, then a
    :class:`~.blocks.SageBlock` over the map graph, by one dense matmul
    when ``MapData.adj`` is set, else by segment ops). Training runs the
    encoder every step; :meth:`GruSage.encode_map` bakes its output into a
    snapshot for serving. The sharded variants are not ported.
  * :class:`MapSpatialAttention` (:250-321): the K nearest map segments per
    vehicle, a distance MLP (Linear(1,16) -> ReLU -> Linear(16,1)), a
    softmax over the K, and the weighted sum of the segments' embeddings.

``knn_impl='topk'`` selects on the square-rooted distances
(:func:`~sldm_gnn_tpu_torch.ops.knn.knn_topk`) and gathers the K rows;
``knn_impl='pallas'`` runs the fused selection kernel
(:func:`~sldm_gnn_tpu_torch.ops.knn.knn_topk_fused`) and the
scatter-free combine ``Wsel @ emb`` of the JAX package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import knn as knn_ops
from .blocks import SageBlock


def map_zscore_norm(feats: torch.Tensor) -> torch.Tensor:
    """One-shot population z-score over segments, sigma clamped >= 1e-8."""
    mu = feats.mean(dim=0, keepdim=True)
    sigma = torch.sqrt(((feats - mu) ** 2).mean(dim=0, keepdim=True)).clamp_min(1e-8)
    return (feats - mu) / sigma


@dataclass(frozen=True)
class MapData:
    """Static map graph tensors, preprocessed for the encoder:

      feats          [S, F]  float32 — z-scored float features concatenated
                              with the boolean ones cast to float
      lane_type_cats [S]     int64
      edge_src       [Em]    int64
      edge_dst       [Em]    int64
      centroids      [S, 2]  float32 — segment centroids for the attention
      edge_mask      [Em]    bool or None — False on padding edges
      adj            [1, S, S] float32 or None — the row-normalized dense
                              mean-aggregation matrix (:func:`dense_map_adj`);
                              the encoder then aggregates by one matmul
    """

    feats: torch.Tensor
    lane_type_cats: torch.Tensor
    edge_src: torch.Tensor
    edge_dst: torch.Tensor
    centroids: torch.Tensor
    edge_mask: torch.Tensor | None = None
    adj: torch.Tensor | None = None

    @property
    def num_segments(self) -> int:
        return self.feats.shape[0]

    def mask(self) -> torch.Tensor:
        if self.edge_mask is not None:
            return self.edge_mask
        return torch.ones(self.edge_src.shape[0], dtype=torch.bool,
                          device=self.edge_src.device)

    def to(self, device: str | torch.device) -> "MapData":
        """Every tensor on ``device``; indices become int64."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is not None:
                v = torch.as_tensor(v)
                if f.name in ("lane_type_cats", "edge_src", "edge_dst"):
                    v = v.long()
                v = v.to(device)
            out[f.name] = v
        return MapData(**out)


def dense_map_adj(map_data: MapData) -> np.ndarray:
    """Row-normalized ``[1, S, S]`` mean-aggregation matrix of the map graph
    (host side, once): multigraph edges add up their multiplicity and rows
    divide by max(deg, 1), as ``masked_mean_aggregate`` does. Attach with
    ``dataclasses.replace(md, adj=torch.from_numpy(dense_map_adj(md)))``."""
    s = map_data.num_segments
    mask = map_data.mask().cpu().numpy()
    src = map_data.edge_src.cpu().numpy()[mask]
    dst = map_data.edge_dst.cpu().numpy()[mask]
    adj = np.zeros((1, s, s), np.float32)
    np.add.at(adj, (0, dst, src), 1.0)
    adj /= np.maximum(adj.sum(axis=2, keepdims=True), 1.0)
    return adj


class MapEncoder(nn.Module):
    """Lane-type embedding concatenated to the segment features, then a
    SAGE stack over the map graph: ``[S, sage_hidden_dims[-1]]``."""

    def __init__(self, num_lane_types: int, feat_dim: int, lane_embed_dim: int = 2,
                 sage_hidden_dims: Sequence[int] = (8, 8), dropout: float | None = None,
                 negative_slope: float | None = None):
        super().__init__()
        self.feat_dim = feat_dim
        self.lane_embedding = nn.Embedding(num_lane_types, lane_embed_dim)
        self.sage = SageBlock(feat_dim + lane_embed_dim, sage_hidden_dims, negative_slope,
                              dropout)

    @property
    def out_dim(self) -> int:
        return getattr(self.sage, f"conv{self.sage.n_layers - 1}").lin_l.out_features

    def forward(self, map_data: MapData, *,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if map_data.feats.shape[1] != self.feat_dim:
            raise ValueError(f"map feats have {map_data.feats.shape[1]} columns; the "
                             f"encoder was built for {self.feat_dim}")
        x = torch.cat([map_data.feats, self.lane_embedding(map_data.lane_type_cats)], dim=1)
        return self.sage(x, map_data.edge_src, map_data.edge_dst, map_data.mask(),
                         map_data.num_segments, adj=map_data.adj, generator=generator)


class MapSpatialAttention(nn.Module):
    def __init__(self, k_neighbors: int = 5, knn_impl: str = "topk"):
        super().__init__()
        if knn_impl not in ("topk", "pallas"):
            raise ValueError(f"Unsupported knn_impl: {knn_impl!r} (use 'topk' or 'pallas')")
        self.k_neighbors = k_neighbors
        self.knn_impl = knn_impl
        self.attn_fc0 = nn.Linear(1, 16)
        self.attn_fc1 = nn.Linear(16, 1)

    def forward(self, vehicle_positions: torch.Tensor, centroids: torch.Tensor,
                map_embeddings: torch.Tensor) -> torch.Tensor:
        k = self.k_neighbors
        if self.knn_impl == "pallas":
            k_dists, idx = knn_ops.knn_topk_fused(vehicle_positions, centroids, k)
        else:
            k_dists, idx = knn_ops.knn_topk(vehicle_positions, centroids, k)
        h = F.relu(self.attn_fc0(k_dists[..., None]))
        scores = self.attn_fc1(h)[..., 0]  # [V, K]
        weights = torch.softmax(scores, dim=1)
        if self.knn_impl == "topk":
            return torch.sum(map_embeddings[idx] * weights[..., None], dim=1)
        # scatter-free combine: K compare-selects place the softmax weights
        # in a dense [V, S] matrix, then one matmul (map_modules.py:311-321)
        s = map_embeddings.shape[0]
        lane = torch.arange(s, device=idx.device, dtype=idx.dtype)[None, :]
        wsel = weights.new_zeros((vehicle_positions.shape[0], s))
        for j in range(k):
            wsel = wsel + torch.where(lane == idx[:, j:j + 1], weights[:, j:j + 1],
                                      torch.zeros((), dtype=weights.dtype,
                                                  device=weights.device))
        return torch.matmul(wsel, map_embeddings)
