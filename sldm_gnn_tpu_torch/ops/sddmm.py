"""SDDMM (sampled dense-dense product): the per-edge dot products
``score[e] = <x[dst_e], y[src_e]>``, the kernel ``csrc/sddmm.cu`` and its
plain version, and the autograd.

Port of ``sldm_gnn_tpu/ops/sddmm.py``. Over the blocked layout of
:mod:`..graph.csr`, :func:`sddmm` returns scores in chunk layout
``[W, EC]`` (0 on padding slots); :func:`chunk_scores_to_edge_order`
maps them back to edge order through the layout's ``edge_id``.

Backward (:func:`sddmm_apply`): ``dx[d] = sum_e g_e y[src_e]`` is an
aggregation of y with the cotangent as the slot weights, and ``dy`` the
same of x over the reverse layout; both run :func:`.spmm._dispatch` (the
one-hot kernel at DEFAULT precision, bf16 g and y, when ``use_pallas``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..graph.csr import BlockedEdges, auto_edge_chunk, block_edges, pad_nodes
from . import spmm as _spmm


def sddmm_xla(x: torch.Tensor, y: torch.Tensor, src: torch.Tensor,
              dst: torch.Tensor) -> torch.Tensor:
    """Per-edge dot products, in edge order (the reference path)."""
    return (x[dst.long()] * y[src.long()]).sum(-1)


def _sddmm_chunk_xla(x: torch.Tensor, y: torch.Tensor, blocked: BlockedEdges) -> torch.Tensor:
    """The reference path in chunk layout ``[W, EC]``, 0 on padding slots."""
    src, dst, w = _spmm.global_edges(blocked)
    valid = (w != 0).to(x.dtype)
    return ((x[dst] * y[src]).sum(-1) * valid).reshape(blocked.weight.shape)


def chunk_scores_to_edge_order(scores: torch.Tensor, blocked: BlockedEdges,
                               num_edges: int) -> torch.Tensor:
    """Chunk-layout scores ``[W, EC]`` to edge order ``[E]``. Every edge
    owns exactly one live slot, so this is a scatter (no sums): it
    repeats its bits on the card."""
    valid = blocked.weight.reshape(-1) != 0
    eid = blocked.edge_id.reshape(-1)[valid].long()
    out = scores.new_zeros(num_edges)
    out[eid] = scores.reshape(-1)[valid]
    return out


# ------------------------------------------------------------ the kernel


def _check_call(x: torch.Tensor, y: torch.Tensor, blocked: BlockedEdges) -> None:
    if x.dim() != 2 or x.shape != y.shape or x.dtype != torch.float32 or \
            y.dtype != torch.float32:
        raise ValueError(f"sddmm takes x and y of one [n_pad, D] float32 shape, got "
                         f"{tuple(x.shape)} {x.dtype} and {tuple(y.shape)} {y.dtype}")
    if x.shape[0] % blocked.tile:
        raise ValueError(f"x rows {x.shape[0]} not a multiple of {blocked.tile}")


def sddmm_plain(x: torch.Tensor, y: torch.Tensor, blocked: BlockedEdges) -> torch.Tensor:
    """Plain PyTorch version of ``csrc/sddmm.cu``, in its summation order:
    f32 products, lane l of 32 sums columns l, l + 32, ... in turn, then a
    tree over the lanes (l + 16, then + 8, + 4, + 2, + 1); 0 on padding
    slots. Returns ``[W, EC]`` f32."""
    _check_call(x, y, blocked)
    src, dst, w = _spmm.global_edges(blocked)
    d = x.shape[1]
    prod = x[dst] * y[src]
    groups = -(-d // 32)
    prod = torch.nn.functional.pad(prod, (0, groups * 32 - d)).reshape(-1, groups, 32)
    part = prod.new_zeros((prod.shape[0], 32))
    for g in range(groups):
        part = part + prod[:, g]
    for off in (16, 8, 4, 2, 1):
        part = part[:, :off] + part[:, off:2 * off]
    score = torch.where(w != 0, part[:, 0], torch.zeros_like(part[:, 0]))
    return score.reshape(blocked.weight.shape)


def _max_row(blocked: BlockedEdges) -> int:
    """One past the largest node row the layout touches; kept on the layout."""
    cached = blocked.__dict__.get("_max_row")
    if cached is None:
        cached = (int(blocked.block_meta.max()) + 1) * blocked.tile
        object.__setattr__(blocked, "_max_row", cached)
    return cached


def sddmm(x: torch.Tensor, y: torch.Tensor, blocked: BlockedEdges) -> torch.Tensor:
    """:func:`sddmm_plain`'s function, the counterpart of ``sddmm_pallas``:
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    ``x, y [n_pad, D]`` f32; returns the chunk-layout scores ``[W, EC]``."""
    if x.device.type == "cpu":
        return sddmm_plain(x, y, blocked)
    _check_call(x, y, blocked)
    if x.device.type != "cuda" or y.device != x.device:
        raise ValueError(f"sddmm runs on CUDA or CPU tensors, got {x.device} and {y.device}")
    if blocked.weight.device != x.device:
        raise ValueError(f"sddmm: the layout must be on {x.device} (BlockedEdges.to)")
    n, d = x.shape
    if _max_row(blocked) > n:
        raise ValueError(f"the layout has node rows past x's {n} rows")
    meta = blocked.block_meta.to(torch.int32).contiguous()
    src_local = blocked.src_local.to(torch.int32).contiguous()
    dst_local = blocked.dst_local.to(torch.int32).contiguous()
    weight = blocked.weight.float().contiguous()
    x, y = x.contiguous(), y.contiguous()
    out = torch.empty(blocked.weight.shape, dtype=torch.float32, device=x.device)
    from . import _build

    lib = _build.load()
    with torch.cuda.device(x.device):
        code = lib.sddmm_launch(meta.data_ptr(), src_local.data_ptr(), dst_local.data_ptr(),
                                weight.data_ptr(), blocked.num_chunks, blocked.edge_chunk,
                                blocked.tile, x.data_ptr(), y.data_ptr(), d, out.data_ptr(),
                                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, f"sddmm kernel (chunks={blocked.num_chunks}, D={d})")
    sddmm.launches += 1
    return out


sddmm.launches = 0


# ------------------------------------------------------------ autograd


def _with_weight(blocked: BlockedEdges, w: torch.Tensor) -> BlockedEdges:
    """``blocked`` with the slot weights ``w``. The one-hot kernel's plan
    (row and slot order) does not depend on the weights, so the
    structural layout's plan, where it has one, rides along instead of
    being derived again."""
    out = dataclasses.replace(blocked, weight=w)
    plan = blocked.__dict__.get("_onehot_plan")
    if plan is not None:
        object.__setattr__(out, "_onehot_plan", plan)
    return out


class _SddmmFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, blocked_fwd, blocked_rev, num_nodes, use_pallas, num_edges):
        ctx.save_for_backward(x, y)
        ctx.meta = (blocked_fwd, blocked_rev, num_nodes, use_pallas)
        chunks = sddmm(x, y, blocked_fwd) if use_pallas else _sddmm_chunk_xla(x, y, blocked_fwd)
        return chunk_scores_to_edge_order(chunks, blocked_fwd, num_edges)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        fwd, rev, num_nodes, use_pallas = ctx.meta
        if use_pallas and g.is_cuda:
            _spmm.onehot_plan(fwd, y.shape[0])
            _spmm.onehot_plan(rev, x.shape[0])
        # the per-edge cotangents in the chunk layouts of both orientations
        g_fwd = torch.where(fwd.weight != 0, g[fwd.edge_id.long()], 0.0)
        g_rev = torch.where(rev.weight != 0, g[rev.edge_id.long()], 0.0)
        dx = _spmm._dispatch(y.contiguous(), _with_weight(fwd, g_fwd), num_nodes, use_pallas)
        dy = _spmm._dispatch(x.contiguous(), _with_weight(rev, g_rev), num_nodes, use_pallas)
        return dx, dy, None, None, None, None, None


def sddmm_apply(x: torch.Tensor, y: torch.Tensor, blocked_fwd: BlockedEdges,
                blocked_rev: BlockedEdges, num_nodes: int, use_pallas: bool,
                num_edges: int) -> torch.Tensor:
    """Edge-order scores ``[E]`` whose backward aggregates over both
    layouts (``use_pallas``: the SDDMM and one-hot kernels; else the
    reference paths)."""
    return _SddmmFn.apply(x, y, blocked_fwd, blocked_rev, num_nodes, use_pallas, num_edges)


def prepare_sddmm(src: np.ndarray, dst: np.ndarray, num_nodes: int):
    """``(blocked_fwd, blocked_rev, n_pad)``: unit weights (validity only)
    and edge ids into the original edge list; the reverse layout's
    destinations are the sources, so aggregating over it lands on them."""
    n_pad = pad_nodes(num_nodes)
    ec = auto_edge_chunk(len(src))
    fwd = block_edges(src, dst, n_pad, edge_chunk=ec)
    rev = block_edges(dst, src, n_pad, edge_chunk=ec)
    return fwd, rev, n_pad
