"""SAGE convolution, SAGE stacks and MLP stacks.

Port of ``sldm_gnn_tpu/models/blocks.py`` (``SageConv`` :30, the edge
path and the dense ``adj`` path; ``SageBlock`` :65; ``MLPStack`` :88).
Layer names follow the JAX param tree (``conv{i}``, ``norm{i}``, ``fc{i}``,
``lin_l``, ``lin_r``), so :mod:`sldm_gnn_tpu_torch.interop` maps
parameters one to one.

``dtype`` is flax's computation dtype (``GruSageConfig.compute_dtype``):
None keeps f32; ``torch.bfloat16`` casts every Linear's input, weight and
bias to bf16 (:func:`linear`, flax ``nn.Dense(dtype=)``) and rounds each
LayerNorm's output to bf16 after f32 statistics (:func:`layer_norm`, flax
``nn.LayerNorm(dtype=)``). Parameters stay f32.

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


def linear(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype | None) -> torch.Tensor:
    """``lin(x)`` as flax ``nn.Dense(dtype=dtype)`` computes it: input,
    weight and bias cast to ``dtype``, or with None to the promoted dtype of
    the input and the (f32) parameters."""
    dt = dtype if dtype is not None else torch.promote_types(x.dtype, lin.weight.dtype)
    bias = None if lin.bias is None else lin.bias.to(dt)
    return F.linear(x.to(dt), lin.weight.to(dt), bias)


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype | None) -> torch.Tensor:
    """flax ``nn.LayerNorm(dtype=dtype)``: statistics and scaling in f32, the
    output at ``dtype`` (None: f32)."""
    y = F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias, norm.eps)
    return y if dtype is None else y.to(dtype)


def dense_mean_aggregate(x: torch.Tensor, adj: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """The aligned layout's mean aggregation: one batched matmul of the
    row-normalized ``adj [G, vmax, vmax]`` (at x's dtype) over ``x``'s
    ``[G, vmax, C]`` view."""
    g, vmax = adj.shape[0], adj.shape[1]
    xg = x.reshape(g, vmax, x.shape[-1])
    return torch.matmul(adj.to(x.dtype), xg).reshape(num_nodes, x.shape[-1])


class SageConv(nn.Module):
    """``out = lin_l(mean_{j->i} x_j) + lin_r(x_i)``, bias on ``lin_l``
    only (PyG ``SAGEConv`` defaults). With ``adj`` (a dense block-diagonal
    batch) the mean is :func:`dense_mean_aggregate`, else segment ops."""

    def __init__(self, in_dim: int, out_dim: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.lin_l = nn.Linear(in_dim, out_dim, bias=True)
        self.lin_r = nn.Linear(in_dim, out_dim, bias=False)

    def forward(self, x, edge_src, edge_dst, edge_mask, num_nodes: int, adj=None):
        if adj is not None:
            agg = dense_mean_aggregate(x, adj, num_nodes)
        else:
            agg = masked_mean_aggregate(x, edge_src, edge_dst, edge_mask, num_nodes)
        return linear(self.lin_l, agg, self.dtype) + linear(self.lin_r, x, self.dtype)


class SageBlock(nn.Module):
    """SAGE layers, each followed by LayerNorm(eps 1e-5) -> activation ->
    dropout."""

    def __init__(self, in_dim: int, hidden_dims: Sequence[int],
                 negative_slope: float | None = None, dropout: float | None = None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.negative_slope = negative_slope
        self.dropout = dropout
        self.dtype = dtype
        self.n_layers = len(hidden_dims)
        dims = [in_dim, *hidden_dims]
        for i in range(self.n_layers):
            self.add_module(f"conv{i}", SageConv(dims[i], dims[i + 1], dtype))
            self.add_module(f"norm{i}", nn.LayerNorm(dims[i + 1], eps=1e-5))

    def forward(self, x, edge_src, edge_dst, edge_mask, num_nodes: int, *, adj=None,
                generator: torch.Generator | None = None):
        for i in range(self.n_layers):
            x = getattr(self, f"conv{i}")(x, edge_src, edge_dst, edge_mask, num_nodes, adj)
            x = layer_norm(getattr(self, f"norm{i}"), x, self.dtype)
            x = activation(x, self.negative_slope)
            x = dropout(x, self.dropout, self.training, generator)
        return x


class MLPStack(nn.Module):
    """Linear -> (Leaky)ReLU -> dropout stack."""

    def __init__(self, in_dim: int, dims: Sequence[int],
                 negative_slope: float | None = None, dropout: float | None = None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.negative_slope = negative_slope
        self.dropout = dropout
        self.dtype = dtype
        self.n_layers = len(dims)
        self.out_dim = dims[-1] if dims else in_dim
        all_dims = [in_dim, *dims]
        for i in range(self.n_layers):
            self.add_module(f"fc{i}", nn.Linear(all_dims[i], all_dims[i + 1]))

    def forward(self, x, *, generator: torch.Generator | None = None):
        for i in range(self.n_layers):
            x = activation(linear(getattr(self, f"fc{i}"), x, self.dtype), self.negative_slope)
            x = dropout(x, self.dropout, self.training, generator)
        return x
