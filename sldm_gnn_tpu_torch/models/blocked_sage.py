"""GraphSAGE over the blocked layouts (big-graph mode).

Port of ``sldm_gnn_tpu/models/blocked_sage.py``: the SAGE math of
:mod:`.blocks` on one large graph,

    h = lin_l(mean_agg(x)) + lin_r(x)     per layer, then
    LayerNorm -> (Leaky)ReLU -> dropout

aggregated over any of the port's layouts, each passed as
``(blocked_fwd, blocked_rev)``:

  * :class:`~..graph.csr.BlockedEdges` (one-hot, ``k_per_step`` chunks a
    step), :class:`~..ops.spmm_dense.DenseBlocks` and
    :class:`~..ops.spmm_banded.BandedBlocks`, each with its reverse;
  * :class:`~..ops.spmm_hybrid.HybridLayout`,
    :class:`~..ops.banded_residual.BandedResidualLayout` and
    :class:`~..ops.spmm_gather.GatherResidualLayout`, which carry both
    directions (``blocked_rev=None``).

``fused`` runs the whole conv as one kernel each way (``ops/sage_fused``)
and ``fused_ln`` folds the LayerNorm and the activation into it too, on
the banded and banded-residual layouts; on the others both take the
unfused path. ``int8_features`` (inference only, banded layouts) streams
per-tensor int8 features through the int8 banded kernel; with
``use_pallas=False`` it aggregates the dequantized features in f32.
Module names follow the JAX param tree (``sage/conv{i}/lin_l``, ``lin_r``,
``sage/norm{i}``, ``head``), so :mod:`..interop` carries parameters both
ways. ``use_pallas=False`` runs the reference paths; ``use_pallas=True``
the kernels on CUDA tensors and their plain versions on CPU tensors.

The banded layouts include ``cmap`` ones (:mod:`..ops.spmm_cmap`, the
low-degree tier: an arbitrary set of source tiles a block), whose
``BandedResidualLayout`` runs every mode, and ``wide`` ones
(``widen_banded``), which ``fused`` and ``fused_ln`` send to the unfused
path, as the JAX model does; ``int8_features`` keeps to the contiguous
narrow band, as the JAX package does.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..graph.csr import BlockedEdges
from ..ops.banded_residual import (
    BandedResidualLayout,
    banded_residual_sage_apply,
    banded_residual_sage_ln_apply,
    spmm_banded_residual_apply,
)
from ..ops.quant import quantize_tensor_xla
from ..ops.sage_fused import _act, _ln_fwd_xla, banded_sage_apply, banded_sage_ln_apply
from ..ops.spmm import spmm_apply
from ..ops.spmm_banded import (
    BandedBlocks,
    spmm_banded_apply,
    spmm_banded_infer_int8,
    spmm_banded_xla,
)
from ..ops.spmm_dense import DenseBlocks, spmm_dense_apply
from ..ops.spmm_gather import GatherResidualLayout, spmm_gather_residual_apply
from ..ops.spmm_hybrid import HybridLayout, spmm_hybrid_apply
from .blocks import activation, dropout

LN_EPS = 1e-5


class BlockedSageConv(nn.Module):
    """``lin_l(mean_agg(x)) + lin_r(x)``; bias on ``lin_l`` only."""

    def __init__(self, in_dim: int, out_dim: int, *, use_pallas: bool = True,
                 k_per_step: int = 1, int8_features: bool = False, fused: bool = False):
        super().__init__()
        self.use_pallas = use_pallas
        self.k_per_step = k_per_step
        self.int8_features = int8_features
        self.fused = fused
        self.lin_l = nn.Linear(in_dim, out_dim, bias=True)
        self.lin_r = nn.Linear(in_dim, out_dim, bias=False)

    def forward(self, x, blocked_fwd, blocked_rev, num_nodes: int, *, ln=None,
                negative_slope: float | None = None):
        if self.int8_features and not isinstance(blocked_fwd, BandedBlocks):
            raise TypeError("int8_features=True requires a BandedBlocks layout (the "
                            "fully-int8 kernel); got " + type(blocked_fwd).__name__)
        fuse_banded = (self.fused and isinstance(blocked_fwd, BandedBlocks)
                       and not blocked_fwd.wide and not self.int8_features)
        fuse_resid = self.fused and isinstance(blocked_fwd, BandedResidualLayout)
        wl, bl, wr = self.lin_l.weight.T, self.lin_l.bias, self.lin_r.weight.T
        if ln is not None:
            # act(LN(conv(x))) in one kernel each way; None slope is ReLU
            slope = 0.0 if negative_slope is None else float(negative_slope)
            gamma, beta = ln
            if fuse_resid:
                return banded_residual_sage_ln_apply(x, wl, wr, bl, gamma, beta, blocked_fwd,
                                                     self.use_pallas, slope, LN_EPS)
            if fuse_banded:
                return banded_sage_ln_apply(x, wl, wr, bl, gamma, beta, blocked_fwd,
                                            blocked_rev, self.use_pallas, slope, LN_EPS)
            agg = self._aggregate(x, blocked_fwd, blocked_rev, num_nodes)
            z, _, _ = _ln_fwd_xla(agg @ wl + bl + x @ wr, gamma, beta, LN_EPS)
            return _act(z, slope).to(x.dtype)
        if fuse_resid:
            return banded_residual_sage_apply(x, wl, wr, bl, blocked_fwd, self.use_pallas, None)
        if fuse_banded:
            return banded_sage_apply(x, wl, wr, bl, blocked_fwd, blocked_rev, self.use_pallas,
                                     None)
        agg = self._aggregate(x, blocked_fwd, blocked_rev, num_nodes)
        return self.lin_l(agg) + self.lin_r(x)

    def _aggregate(self, x, blocked_fwd, blocked_rev, num_nodes: int):
        if isinstance(blocked_fwd, GatherResidualLayout):
            return spmm_gather_residual_apply(x, blocked_fwd, self.use_pallas)
        if isinstance(blocked_fwd, BandedResidualLayout):
            return spmm_banded_residual_apply(x, blocked_fwd, self.use_pallas)
        if isinstance(blocked_fwd, BandedBlocks):
            if not self.int8_features:
                return spmm_banded_apply(x, blocked_fwd, blocked_rev, self.use_pallas)
            if self.use_pallas:
                return spmm_banded_infer_int8(x, blocked_fwd)
            # the same quantization, the dequantized features aggregated in
            # f32; inference only, like the kernel path
            xq, s = quantize_tensor_xla(x)
            return spmm_banded_xla(xq.float() * s[0], blocked_fwd)
        if isinstance(blocked_fwd, HybridLayout):
            return spmm_hybrid_apply(x, blocked_fwd, self.use_pallas)
        if isinstance(blocked_fwd, DenseBlocks):
            return spmm_dense_apply(x, blocked_fwd, blocked_rev, self.use_pallas)
        if isinstance(blocked_fwd, BlockedEdges):
            return spmm_apply(x, blocked_fwd, blocked_rev, num_nodes, self.use_pallas,
                              self.k_per_step)
        raise TypeError(f"unknown layout {type(blocked_fwd).__name__}")


class BlockedSageBlock(nn.Module):
    """SAGE layers ``conv{i}``, each followed by ``norm{i}`` (LayerNorm,
    eps 1e-5), the activation and dropout; with ``fused_ln`` the conv
    applies the norm and the activation itself."""

    def __init__(self, in_dim: int, hidden_dims: Sequence[int], *,
                 dropout: float | None = None, negative_slope: float | None = None,
                 use_pallas: bool = True, k_per_step: int = 1, int8_features: bool = False,
                 fused: bool = False, fused_ln: bool = False):
        super().__init__()
        self.dropout = dropout
        self.negative_slope = negative_slope
        # int8 features take the unfused LayerNorm (no LN-fused int8 kernel)
        self.fused_ln = fused_ln and not int8_features
        self.n_layers = len(hidden_dims)
        dims = [in_dim, *hidden_dims]
        for i in range(self.n_layers):
            self.add_module(f"conv{i}", BlockedSageConv(
                dims[i], dims[i + 1], use_pallas=use_pallas, k_per_step=k_per_step,
                int8_features=int8_features, fused=fused))
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
                 use_pallas: bool = True, k_per_step: int = 1, int8_features: bool = False,
                 fused: bool = False, fused_ln: bool = False):
        super().__init__()
        self.sage = BlockedSageBlock(
            in_features, hidden_dims, dropout=dropout, negative_slope=negative_slope,
            use_pallas=use_pallas, k_per_step=k_per_step, int8_features=int8_features,
            fused=fused, fused_ln=fused_ln)
        self.head = nn.Linear(hidden_dims[-1] if hidden_dims else in_features, num_classes)

    def forward(self, x, blocked_fwd, blocked_rev, num_nodes: int, *,
                generator: torch.Generator | None = None):
        h = self.sage(x, blocked_fwd, blocked_rev, num_nodes, generator=generator)
        return self.head(h)
