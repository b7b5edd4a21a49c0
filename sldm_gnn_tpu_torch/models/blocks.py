"""SAGE convolution, SAGE stacks and MLP stacks.

Port of ``sldm_gnn_tpu/models/blocks.py`` (``SageConv`` :30, edge path;
``SageBlock`` :65; ``MLPStack`` :88). Layer names follow the JAX param
tree (``conv{i}``, ``norm{i}``, ``fc{i}``, ``lin_l``, ``lin_r``), so
:mod:`sldm_gnn_tpu_torch.interop` maps parameters one to one.

Dropout follows every activation (``blocks.py:84,102``) in ``train()``
mode only: a keep mask drawn from the ``generator`` passed with the call,
and the kept values scaled by ``1/(1-p)`` (flax ``nn.Dropout``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.segment import masked_mean_aggregate


def activation(x: torch.Tensor, negative_slope: float | None) -> torch.Tensor:
    if negative_slope is None:
        return F.relu(x)
    return F.leaky_relu(x, negative_slope)


def dropout(x: torch.Tensor, p: float | None, training: bool,
            generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout: zero each value with probability ``p`` and scale
    the rest by ``1/(1-p)``; the identity outside training or for
    ``p in (None, 0)``. The mask comes from ``generator`` (on ``x``'s
    device), which training must pass."""
    if not training or not p:
        return x
    if generator is None:
        raise ValueError("dropout in train mode needs a torch.Generator (pass generator=)")
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


class SageConv(nn.Module):
    """``out = lin_l(mean_{j->i} x_j) + lin_r(x_i)``, bias on ``lin_l``
    only (PyG ``SAGEConv`` defaults)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.lin_l = nn.Linear(in_dim, out_dim, bias=True)
        self.lin_r = nn.Linear(in_dim, out_dim, bias=False)

    def forward(self, x, edge_src, edge_dst, edge_mask, num_nodes: int):
        agg = masked_mean_aggregate(x, edge_src, edge_dst, edge_mask, num_nodes)
        return self.lin_l(agg) + self.lin_r(x)


class SageBlock(nn.Module):
    """SAGE layers, each followed by LayerNorm(eps 1e-5) -> activation ->
    dropout."""

    def __init__(self, in_dim: int, hidden_dims: Sequence[int],
                 negative_slope: float | None = None, dropout: float | None = None):
        super().__init__()
        self.negative_slope = negative_slope
        self.dropout = dropout
        self.n_layers = len(hidden_dims)
        dims = [in_dim, *hidden_dims]
        for i in range(self.n_layers):
            self.add_module(f"conv{i}", SageConv(dims[i], dims[i + 1]))
            self.add_module(f"norm{i}", nn.LayerNorm(dims[i + 1], eps=1e-5))

    def forward(self, x, edge_src, edge_dst, edge_mask, num_nodes: int, *,
                generator: torch.Generator | None = None):
        for i in range(self.n_layers):
            x = getattr(self, f"conv{i}")(x, edge_src, edge_dst, edge_mask, num_nodes)
            x = getattr(self, f"norm{i}")(x)
            x = activation(x, self.negative_slope)
            x = dropout(x, self.dropout, self.training, generator)
        return x


class MLPStack(nn.Module):
    """Linear -> (Leaky)ReLU -> dropout stack."""

    def __init__(self, in_dim: int, dims: Sequence[int],
                 negative_slope: float | None = None, dropout: float | None = None):
        super().__init__()
        self.negative_slope = negative_slope
        self.dropout = dropout
        self.n_layers = len(dims)
        self.out_dim = dims[-1] if dims else in_dim
        all_dims = [in_dim, *dims]
        for i in range(self.n_layers):
            self.add_module(f"fc{i}", nn.Linear(all_dims[i], all_dims[i + 1]))

    def forward(self, x, *, generator: torch.Generator | None = None):
        for i in range(self.n_layers):
            x = activation(getattr(self, f"fc{i}")(x), self.negative_slope)
            x = dropout(x, self.dropout, self.training, generator)
        return x
