"""GraphSAGE over the banded layouts (big-graph mode).

Port of ``sldm_gnn_tpu/models/blocked_sage.py``: the SAGE math of
:mod:`.blocks` on one large graph, aggregated over a banded layout
(:class:`~..ops.spmm_banded.BandedBlocks` with its reverse) or a banded +
residual split (:class:`~..ops.banded_residual.BandedResidualLayout`,
passed with ``blocked_rev=None``):

    h = lin_l(mean_agg(x)) + lin_r(x)     per layer, then
    LayerNorm -> (Leaky)ReLU -> dropout

``fused`` runs the whole conv as one kernel each way (``ops/sage_fused``);
``fused_ln`` folds the LayerNorm and the activation into it too. Module
names follow the JAX param tree (``sage/conv{i}/lin_l``, ``lin_r``,
``sage/norm{i}``, ``head``), so :mod:`..interop` carries parameters both
ways. ``use_pallas=False`` runs the f32 twins; ``use_pallas=True`` the
kernels on CUDA tensors and their plain versions on CPU tensors.

Not ported (``NotImplementedError``): the one-hot, dense, hybrid and
gather layouts, ``int8_features``, ``wide`` layouts and ``cmap`` slots.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.banded_residual import (
    BandedResidualLayout,
    banded_residual_sage_apply,
    banded_residual_sage_ln_apply,
    spmm_banded_residual_apply,
)
from ..ops.sage_fused import _act, _ln_fwd_xla, banded_sage_apply, banded_sage_ln_apply
from ..ops.spmm_banded import BandedBlocks, require_narrow, spmm_banded_apply
from .blocks import activation, dropout

LN_EPS = 1e-5


def _check_layout(blocked_fwd) -> None:
    if isinstance(blocked_fwd, BandedResidualLayout):
        require_narrow(blocked_fwd.banded_fwd)
        require_narrow(blocked_fwd.banded_rev)
    elif isinstance(blocked_fwd, BandedBlocks):
        require_narrow(blocked_fwd)
    else:
        raise NotImplementedError(
            f"layout {type(blocked_fwd).__name__} is not ported (banded and "
            "banded-residual layouts only)")


def _no_int8(int8_features: bool) -> None:
    if int8_features:
        raise NotImplementedError("int8_features (the int8 banded kernel) is not ported")


class BlockedSageConv(nn.Module):
    """``lin_l(mean_agg(x)) + lin_r(x)``; bias on ``lin_l`` only."""

    def __init__(self, in_dim: int, out_dim: int, *, use_pallas: bool = True,
                 int8_features: bool = False, fused: bool = False):
        super().__init__()
        _no_int8(int8_features)
        self.use_pallas = use_pallas
        self.fused = fused
        self.lin_l = nn.Linear(in_dim, out_dim, bias=True)
        self.lin_r = nn.Linear(in_dim, out_dim, bias=False)

    def forward(self, x, blocked_fwd, blocked_rev, num_nodes: int, *, ln=None,
                negative_slope: float | None = None):
        _check_layout(blocked_fwd)
        resid = isinstance(blocked_fwd, BandedResidualLayout)
        wl, bl, wr = self.lin_l.weight.T, self.lin_l.bias, self.lin_r.weight.T
        if ln is not None:
            # act(LN(conv(x))) in one kernel each way; None slope is ReLU
            slope = 0.0 if negative_slope is None else float(negative_slope)
            gamma, beta = ln
            if self.fused and resid:
                return banded_residual_sage_ln_apply(x, wl, wr, bl, gamma, beta, blocked_fwd,
                                                     self.use_pallas, slope, LN_EPS)
            if self.fused:
                return banded_sage_ln_apply(x, wl, wr, bl, gamma, beta, blocked_fwd,
                                            blocked_rev, self.use_pallas, slope, LN_EPS)
            agg = self._aggregate(x, blocked_fwd, blocked_rev)
            z, _, _ = _ln_fwd_xla(agg @ wl + bl + x @ wr, gamma, beta, LN_EPS)
            return _act(z, slope).to(x.dtype)
        if self.fused and resid:
            return banded_residual_sage_apply(x, wl, wr, bl, blocked_fwd, self.use_pallas, None)
        if self.fused:
            return banded_sage_apply(x, wl, wr, bl, blocked_fwd, blocked_rev, self.use_pallas,
                                     None)
        agg = self._aggregate(x, blocked_fwd, blocked_rev)
        return self.lin_l(agg) + self.lin_r(x)

    def _aggregate(self, x, blocked_fwd, blocked_rev):
        if isinstance(blocked_fwd, BandedResidualLayout):
            return spmm_banded_residual_apply(x, blocked_fwd, self.use_pallas)
        return spmm_banded_apply(x, blocked_fwd, blocked_rev, self.use_pallas)


class BlockedSageBlock(nn.Module):
    """SAGE layers ``conv{i}``, each followed by ``norm{i}`` (LayerNorm,
    eps 1e-5), the activation and dropout; with ``fused_ln`` the conv
    applies the norm and the activation itself."""

    def __init__(self, in_dim: int, hidden_dims: Sequence[int], *,
                 dropout: float | None = None, negative_slope: float | None = None,
                 use_pallas: bool = True, int8_features: bool = False,
                 fused: bool = False, fused_ln: bool = False):
        super().__init__()
        _no_int8(int8_features)
        self.dropout = dropout
        self.negative_slope = negative_slope
        self.fused_ln = fused_ln
        self.n_layers = len(hidden_dims)
        dims = [in_dim, *hidden_dims]
        for i in range(self.n_layers):
            self.add_module(f"conv{i}", BlockedSageConv(
                dims[i], dims[i + 1], use_pallas=use_pallas, fused=fused))
            self.add_module(f"norm{i}", nn.LayerNorm(dims[i + 1], eps=LN_EPS))

    def forward(self, x, blocked_fwd, blocked_rev, num_nodes: int, *,
                generator: torch.Generator | None = None):
        for i in range(self.n_layers):
            conv, norm = getattr(self, f"conv{i}"), getattr(self, f"norm{i}")
            if self.fused_ln:
                x = conv(x, blocked_fwd, blocked_rev, num_nodes, ln=(norm.weight, norm.bias),
                         negative_slope=self.negative_slope)
            else:
                x = activation(norm(conv(x, blocked_fwd, blocked_rev, num_nodes)),
                               self.negative_slope)
            x = dropout(x, self.dropout, self.training, generator)
        return x


class BlockedSageClassifier(nn.Module):
    """Node classifier: :class:`BlockedSageBlock` (``sage``) then a linear
    ``head``. ``in_features`` is the width of x (flax infers it)."""

    def __init__(self, hidden_dims: Sequence[int], num_classes: int, *, in_features: int,
                 dropout: float | None = None, negative_slope: float | None = None,
                 use_pallas: bool = True, int8_features: bool = False,
                 fused: bool = False, fused_ln: bool = False):
        super().__init__()
        self.sage = BlockedSageBlock(
            in_features, hidden_dims, dropout=dropout, negative_slope=negative_slope,
            use_pallas=use_pallas, int8_features=int8_features, fused=fused,
            fused_ln=fused_ln)
        self.head = nn.Linear(hidden_dims[-1] if hidden_dims else in_features, num_classes)

    def forward(self, x, blocked_fwd, blocked_rev, num_nodes: int, *,
                generator: torch.Generator | None = None):
        h = self.sage(x, blocked_fwd, blocked_rev, num_nodes, generator=generator)
        return self.head(h)
