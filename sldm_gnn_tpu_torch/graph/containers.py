"""Graph containers: one ragged host graph (:class:`GraphArrays`, numpy)
and a fixed-capacity batch of graphs (:class:`PaddedGraphBatch`, torch).

Port of ``sldm_gnn_tpu/graph/containers.py``. The padding contract is the
same: nodes of all graphs are concatenated and zero-padded to ``N`` rows,
padding nodes carry graph id ``G`` and padding edges carry ``edge_dst ==
N`` with ``edge_mask`` False, so the segment ops drop them. A batch from
``pad_and_batch_aligned`` also carries the dense block-diagonal ``adj``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class GraphArrays:
    """A single un-padded graph, host-side (numpy):

      x         [V, F, 6] float32 — X, Y, Speed, HeadingSin, HeadingCos, PresenceFlag
      xsttype   [V]       int32   — station-type category
      xdims     [V, 2]    float32 — width, length
      edge_index[2, E]    int32   — directed (src, dst) pairs
      edge_attr [E, 4]    float32 — min/max/mean/meansq trajectory distance
      y         [L]       float32 or None — multi-hot labels
      pos_raw   [V, F, 2] float32 or None — XY before z-score normalization
    """

    x: np.ndarray
    xsttype: np.ndarray
    xdims: np.ndarray
    edge_index: np.ndarray
    edge_attr: np.ndarray
    y: np.ndarray | None = None
    pos_raw: np.ndarray | None = None

    @property
    def num_nodes(self) -> int:
        return int(self.x.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.edge_index.shape[1])


@dataclass(frozen=True)
class PaddedGraphBatch:
    """A fixed-capacity batch of graphs as torch tensors.

    N = node capacity, E = edge capacity, G = graph capacity, F = frames,
    L = labels. Index tensors are int64 (torch's index type).
    """

    x: torch.Tensor  # [N, F, 6] float32
    xsttype: torch.Tensor  # [N] int64
    xdims: torch.Tensor  # [N, 2]
    pos_raw: torch.Tensor  # [N, F, 2]
    edge_src: torch.Tensor  # [E] int64
    edge_dst: torch.Tensor  # [E] int64; padding edges carry N
    edge_attr: torch.Tensor  # [E, 4]
    edge_mask: torch.Tensor  # [E] bool
    node_mask: torch.Tensor  # [N] bool
    node_graph: torch.Tensor  # [N] int64; padding rows carry G
    y: torch.Tensor  # [G, L]
    graph_mask: torch.Tensor  # [G] bool
    # the dense block-diagonal layout (pad_and_batch_aligned): graph g's
    # nodes are rows [g*vmax, (g+1)*vmax) and adj[g, i, j] =
    # multiplicity(j -> i) / in_deg(i), so SAGE aggregation is a batched
    # matmul and pooling a masked reshape-reduce. None: the flat layout.
    adj: torch.Tensor | None = None  # [G, vmax, vmax] float32

    @property
    def node_capacity(self) -> int:
        return self.x.shape[0]

    @property
    def graph_capacity(self) -> int:
        return self.y.shape[0]

    @property
    def device(self) -> torch.device:
        return self.x.device

    def to(self, device: str | torch.device) -> "PaddedGraphBatch":
        """Copy every tensor to ``device`` (non-blocking where the source
        is pinned)."""
        return PaddedGraphBatch(**{
            f.name: None if getattr(self, f.name) is None
            else getattr(self, f.name).to(device, non_blocking=True)
            for f in dataclasses.fields(self)
        })
