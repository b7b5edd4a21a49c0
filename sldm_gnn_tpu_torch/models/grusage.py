"""GruSage: per-node GRU -> feature concat -> MLP -> optional map context
(map encoder + KNN attention) -> GraphSAGE -> global pooling -> MLP ->
multi-label logits.

Port of ``sldm_gnn_tpu/models/grusage.py`` (``GruSageConfig``,
``GruSage.__call__`` :193-279, ``encode_map`` :189 and the ``GRUCell``
dispatch :333-351). Parameter names follow the JAX param tree; see
:mod:`sldm_gnn_tpu_torch.interop`. In ``train()`` mode dropout follows
every activation, with masks drawn from the ``generator`` passed to
:meth:`GruSage.forward`.

The map branch runs the live :class:`~.map_modules.MapEncoder` over a
:class:`~.map_modules.MapData` (training), or takes embeddings baked by
:meth:`GruSage.encode_map` (serving; the encoder is then not built).

A batch from ``pad_and_batch_aligned`` (``batch.adj`` set) takes the dense
branch under ``sage_type='sage'``: SAGE aggregation by one batched matmul
and pooling by a masked reshape-reduce (``grusage.py:240-253``).
``compute_dtype='bfloat16'`` runs FC1, the SAGE (or attention) stack and
FC2 in bf16 with f32 parameters and f32 logits; the GRU keeps its own
precision (f32 under ``'scan'``). ``sage_type='attention'`` swaps the SAGE
stack for :class:`~.attention.AttentionBlock`.

Not ported (``NotImplementedError``): the sharded map axes
(``map_edge_axis``, ``map_segment_axis``).
"""

from __future__ import annotations

from dataclasses import asdict, dataclass

import torch
from torch import nn

from ..graph.containers import PaddedGraphBatch
from ..ops import gru_cuda
from ..ops.gru import GRUParams, gru_forward
from ..ops.segment import dense_max_pool, dense_mean_pool, global_max_pool, global_mean_pool
from .attention import AttentionBlock
from .blocks import MLPStack, SageBlock, linear
from .map_modules import MapData, MapEncoder, MapSpatialAttention


@dataclass(frozen=True)
class GruSageConfig:
    """The JAX package's config, key for key, so snapshot configs load
    unchanged (``to_dict``/``from_dict``)."""

    dynamic_features_num: int = 6
    frames_num: int = 100
    gru_hidden_size: int = 96
    gru_num_layers: int = 1
    fc1dims: tuple[int, ...] = (96,)
    sage_hidden_dims: tuple[int, ...] = (96, 96)
    fc2dims: tuple[int, ...] = (32,)
    out_dim: int = 1
    num_st_types: int = 256
    emb_dim: int = 8
    dropout: float | None = 0.25
    negative_slope: float | None = 0.1
    global_pooling: str = "double"  # 'mean' | 'max' | 'double'
    map_included: bool = False
    num_lane_types: int = 8
    mapenc_sage_hdims: tuple[int, ...] = (8, 8)
    mapenc_lane_embdim: int = 2
    map_attention_topk: int = 5
    map_edge_axis: str | None = None
    map_segment_axis: str | None = None
    sage_type: str = "sage"
    attention_qk_dim: int = 32
    compute_dtype: str | None = None
    gru_pad_to: int | None = None
    gru_impl: str = "scan"  # 'scan' (f32) | 'pallas' / 'pallas_sg' (bf16 kernel)
    knn_impl: str = "topk"  # 'topk' | 'pallas' (fused kernel)

    def to_dict(self) -> dict:
        return asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "GruSageConfig":
        d = dict(d)
        for k in ("fc1dims", "sage_hidden_dims", "fc2dims", "mapenc_sage_hdims"):
            if k in d and d[k] is not None:
                d[k] = tuple(d[k])
        return GruSageConfig(**d)


class GRUCell(nn.Module):
    """Owns the stacked GRU parameters in the JAX layout (``w_ih0 [D,
    3H]``, layers 1.. stacked) and dispatches on ``impl``: ``'scan'`` is
    the f32 scan, ``'pallas'`` and ``'pallas_sg'`` the bf16 fused kernel
    (the two differ only in their training backward; their forwards are
    bit-equal in the JAX package). ``gru_pad_to`` pads H to TPU lane
    multiples, exact up to f32 summation order, and is not applied."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 impl: str = "scan"):
        super().__init__()
        if impl not in ("scan", "pallas", "pallas_sg"):
            raise ValueError(
                f"Unsupported gru_impl: {impl!r} (use 'scan', 'pallas', or 'pallas_sg')")
        self.impl = impl
        self.num_layers = num_layers
        h3 = 3 * hidden_size
        p = lambda *shape: nn.Parameter(torch.empty(shape))
        self.w_ih0 = p(input_size, h3)
        self.w_hh0 = p(hidden_size, h3)
        self.b_ih0 = p(h3)
        self.b_hh0 = p(h3)
        rest = num_layers - 1
        if rest > 0:
            self.w_ih = p(rest, hidden_size, h3)
            self.w_hh = p(rest, hidden_size, h3)
            self.b_ih = p(rest, h3)
            self.b_hh = p(rest, h3)
        self.hidden_size = hidden_size
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Uniform(-1/sqrt(H), 1/sqrt(H)), torch's GRU init."""
        bound = 1.0 / self.hidden_size ** 0.5
        with torch.no_grad():
            for prm in self.parameters():
                prm.uniform_(-bound, bound, generator=generator)

    def params(self) -> GRUParams:
        if self.num_layers > 1:
            rest = (self.w_ih, self.w_hh, self.b_ih, self.b_hh)
        else:
            h3 = self.w_hh0.shape[1]
            z = self.w_hh0.new_zeros
            rest = (z((0, self.hidden_size, h3)), z((0, self.hidden_size, h3)),
                    z((0, h3)), z((0, h3)))
        return GRUParams(self.w_ih0, self.w_hh0, self.b_ih0, self.b_hh0, *rest)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``h_last [N, H]`` of the top layer."""
        if self.impl == "scan":
            return gru_forward(self.params(), x)[1]
        return gru_cuda.gru_last_forward(self.params(), x,
                                         store_gates=self.impl == "pallas_sg")


class GruSage(nn.Module):
    """``map_feat_dim``: the width of ``MapData.feats`` that the live map
    encoder takes (a map model is trained with it); None builds no encoder,
    and the map branch then needs baked embeddings (serving)."""

    def __init__(self, cfg: GruSageConfig, *, map_feat_dim: int | None = None):
        super().__init__()
        c = cfg
        if c.compute_dtype not in (None, "bfloat16", "float32"):
            raise ValueError(f"Unsupported compute_dtype: {c.compute_dtype!r} "
                             "(use None/'float32' or 'bfloat16')")
        if c.sage_type not in ("sage", "attention"):
            raise ValueError(f"Unsupported sage_type: {c.sage_type}")
        if c.map_edge_axis is not None or c.map_segment_axis is not None:
            raise NotImplementedError("sharded map axes (map_edge_axis, map_segment_axis) "
                                      "are not ported")
        if c.global_pooling not in ("mean", "max", "double"):
            raise ValueError(f"Unsupported global_pooling: {c.global_pooling}")
        self.cfg = c
        dt = torch.bfloat16 if c.compute_dtype == "bfloat16" else None
        self.st_emb = nn.Embedding(c.num_st_types, c.emb_dim)
        self.gru = GRUCell(c.dynamic_features_num, c.gru_hidden_size,
                           c.gru_num_layers, impl=c.gru_impl)
        self.fc1s = MLPStack(c.gru_hidden_size + 2 + c.emb_dim, c.fc1dims,
                             c.negative_slope, c.dropout, dt)
        width = self.fc1s.out_dim
        self.map_encoder = None
        if c.map_included:
            if map_feat_dim is not None:
                self.map_encoder = MapEncoder(
                    c.num_lane_types, map_feat_dim, c.mapenc_lane_embdim,
                    c.mapenc_sage_hdims, c.dropout, c.negative_slope)
            self.map_attention = MapSpatialAttention(c.map_attention_topk, c.knn_impl)
            width += c.mapenc_sage_hdims[-1]
        if c.sage_type == "attention":
            self.sage = AttentionBlock(width, c.sage_hidden_dims, c.attention_qk_dim,
                                       c.negative_slope, c.dropout, dt)
        else:
            self.sage = SageBlock(width, c.sage_hidden_dims, c.negative_slope, c.dropout, dt)
        width = c.sage_hidden_dims[-1] * (2 if c.global_pooling == "double" else 1)
        self.fc2s = MLPStack(width, c.fc2dims, c.negative_slope, c.dropout, dt)
        self.linout = nn.Linear(self.fc2s.out_dim, c.out_dim)  # f32 logits

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random weights from ``generator`` (for smoke runs; trained
        weights come from a snapshot)."""
        with torch.no_grad():
            for name, prm in self.named_parameters():
                if name.startswith("gru."):
                    continue
                if name.endswith("bias") and "norm" not in name:
                    prm.zero_()
                elif "norm" in name:
                    prm.fill_(1.0 if name.endswith("weight") else 0.0)
                else:
                    fan_in = prm.shape[-1] if prm.dim() > 1 else 1
                    bound = 1.0 / max(fan_in, 1) ** 0.5
                    prm.uniform_(-bound, bound, generator=generator)
        self.gru.reset_parameters(generator)

    def encode_map(self, map_data: MapData, *,
                   generator: torch.Generator | None = None) -> torch.Tensor:
        """The map encoder alone: ``[S, mapenc_sage_hdims[-1]]`` embeddings
        (what a snapshot bakes for serving)."""
        if self.map_encoder is None:
            raise ValueError("this GruSage was built without a map encoder "
                             "(pass map_feat_dim=)")
        return self.map_encoder(map_data, generator=generator)

    def forward(self, batch: PaddedGraphBatch, *, map_data: MapData | None = None,
                map_embeddings: torch.Tensor | None = None,
                map_centroids: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits ``[G, out_dim]``. A map model takes either ``map_data``
        (the live encoder) or baked ``map_embeddings`` with their
        ``map_centroids``. ``generator`` draws the dropout masks in
        ``train()`` mode."""
        c = self.cfg
        N = batch.node_capacity
        G = batch.graph_capacity

        st = self.st_emb(batch.xsttype)
        h = self.gru(batch.x)
        x = torch.cat([h, batch.xdims, st], dim=1)
        x = self.fc1s(x, generator=generator)

        if c.map_included:
            if map_embeddings is None:
                if map_data is None:
                    raise ValueError("map_included model needs map_data or baked "
                                     "map_embeddings")
                map_embeddings = self.encode_map(map_data, generator=generator)
                map_centroids = map_data.centroids
            elif map_centroids is None:
                raise ValueError("baked map_embeddings require map_centroids")
            last_pos = batch.pos_raw[:, -1, :]
            ctx = self.map_attention(last_pos, map_centroids, map_embeddings)
            dt = torch.promote_types(x.dtype, ctx.dtype)  # jnp.concatenate promotes
            x = torch.cat([x.to(dt), ctx.to(dt)], dim=1)

        # a pad_and_batch_aligned batch: aggregation and pooling scatter-free
        dense = batch.adj is not None and c.sage_type == "sage"
        if dense:
            x = self.sage(x, batch.edge_src, batch.edge_dst, batch.edge_mask, N,
                          adj=batch.adj, generator=generator)
            vmax = batch.adj.shape[1]
            mean_pool = lambda: dense_mean_pool(x, batch.node_mask, G, vmax)
            max_pool = lambda: dense_max_pool(x, batch.node_mask, G, vmax)
        else:
            x = self.sage(x, batch.edge_src, batch.edge_dst, batch.edge_mask, N,
                          generator=generator)
            mean_pool = lambda: global_mean_pool(x, batch.node_graph, batch.node_mask, G)
            max_pool = lambda: global_max_pool(x, batch.node_graph, batch.node_mask, G)

        if c.global_pooling == "mean":
            x = mean_pool()
        elif c.global_pooling == "max":
            x = max_pool()
        else:
            x = torch.cat([mean_pool(), max_pool()], dim=1)
        x = self.fc2s(x, generator=generator)
        return linear(self.linout, x, None)
