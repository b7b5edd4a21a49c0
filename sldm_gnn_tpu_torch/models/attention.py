"""Edge-attention graph convolution: GruSage's ``sage_type='attention'``.

Port of ``sldm_gnn_tpu/models/attention.py`` (``edge_softmax`` :28,
``AttentionConv`` :37, ``AttentionBlock`` :58). Per-edge dot-product
scores, a per-destination softmax over the incoming unmasked edges, and
the score-weighted sum of the source rows, all by segment ops (the JAX
package runs no Pallas kernel here):

    out = lin_l( sum_e alpha_e * x_src ) + lin_r(x_self),
    alpha = softmax_dst( <q(x_dst), k(x_src)> / sqrt(qk_dim) )

Scores and the softmax run in f32 whatever the computation dtype. Padding
edges carry ``edge_dst == N``: their gathers read row N-1 (JAX clamps
out-of-range gathers) and their scores are masked, so they add nothing.
Module names follow the JAX param tree (``conv{i}/q``, ``k``, ``lin_l``,
``lin_r``, ``norm{i}``), so :mod:`sldm_gnn_tpu_torch.interop` maps them.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ..ops.segment import segment_max, segment_sum
from .blocks import activation, dropout, layer_norm, linear

_NEG_BIG = -1e30


def edge_softmax(scores: torch.Tensor, edge_dst: torch.Tensor, edge_mask: torch.Tensor,
                 num_nodes: int) -> torch.Tensor:
    """Numerically stable softmax over each destination's incoming edges;
    masked edges get 0."""
    scores = torch.where(edge_mask, scores, torch.full_like(scores, _NEG_BIG))
    dst = edge_dst.clamp(max=num_nodes - 1)
    mx = segment_max(scores, edge_dst, num_nodes)
    ex = torch.where(edge_mask, torch.exp(scores - mx[dst]), torch.zeros_like(scores))
    denom = segment_sum(ex, edge_dst, num_nodes)
    return ex / denom[dst].clamp_min(1e-20)


class AttentionConv(nn.Module):
    """``lin_l(sum_e alpha_e x_src) + lin_r(x)``, ``alpha`` the softmax of
    the scaled ``q(x_dst) . k(x_src)`` scores over each node's in-edges."""

    def __init__(self, in_dim: int, out_dim: int, qk_dim: int = 32,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.qk_dim = qk_dim
        self.dtype = dtype
        self.q = nn.Linear(in_dim, qk_dim)
        self.k = nn.Linear(in_dim, qk_dim)
        self.lin_l = nn.Linear(in_dim, out_dim, bias=True)
        self.lin_r = nn.Linear(in_dim, out_dim, bias=False)

    def forward(self, x, edge_src, edge_dst, edge_mask, num_nodes: int):
        q = linear(self.q, x, self.dtype)
        k = linear(self.k, x, self.dtype)
        dst = edge_dst.clamp(max=num_nodes - 1)
        scores = (q[dst] * k[edge_src]).float().sum(-1) / math.sqrt(self.qk_dim)
        alpha = edge_softmax(scores, edge_dst, edge_mask, num_nodes)
        msgs = x[edge_src] * alpha[:, None]  # promotes to f32, as JAX does
        agg = segment_sum(msgs, edge_dst, num_nodes)
        return linear(self.lin_l, agg, self.dtype) + linear(self.lin_r, x, self.dtype)


class AttentionBlock(nn.Module):
    """AttentionConv layers, each followed by LayerNorm(eps 1e-5) ->
    activation -> dropout: the drop-in alternative to
    :class:`~.blocks.SageBlock`."""

    def __init__(self, in_dim: int, hidden_dims: Sequence[int], qk_dim: int = 32,
                 negative_slope: float | None = None, dropout: float | None = None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.negative_slope = negative_slope
        self.dropout = dropout
        self.dtype = dtype
        self.n_layers = len(hidden_dims)
        dims = [in_dim, *hidden_dims]
        for i in range(self.n_layers):
            self.add_module(f"conv{i}", AttentionConv(dims[i], dims[i + 1], qk_dim, dtype))
            self.add_module(f"norm{i}", nn.LayerNorm(dims[i + 1], eps=1e-5))

    def forward(self, x, edge_src, edge_dst, edge_mask, num_nodes: int, *,
                generator: torch.Generator | None = None):
        for i in range(self.n_layers):
            x = getattr(self, f"conv{i}")(x, edge_src, edge_dst, edge_mask, num_nodes)
            x = layer_norm(getattr(self, f"norm{i}"), x, self.dtype)
            x = activation(x, self.negative_slope)
            x = dropout(x, self.dropout, self.training, generator)
        return x
