"""KNN spatial attention over baked map embeddings, eval mode.

Port of ``MapSpatialAttention`` (``sldm_gnn_tpu/models/map_modules.py``
:250-321): the K nearest map segments per vehicle, a distance MLP
(Linear(1,16) -> ReLU -> Linear(16,1)), a softmax over the K, and the
weighted sum of the segments' embeddings. ``MapEncoder`` is not ported
yet: serving uses the embeddings baked into the snapshot.

``knn_impl='topk'`` selects on the square-rooted distances
(:func:`~sldm_gnn_tpu_torch.ops.knn.knn_topk`) and gathers the K rows;
``knn_impl='pallas'`` runs the fused selection kernel
(:func:`~sldm_gnn_tpu_torch.ops.knn.knn_topk_fused`) and the
scatter-free combine ``Wsel @ emb`` of the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import knn as knn_ops


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
