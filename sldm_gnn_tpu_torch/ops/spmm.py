"""One-hot blocked SpMM: the reference aggregation, the CUDA kernel
``csrc/spmm_onehot.cu`` and its plain version, and the autograd.

Port of the f32 part of ``sldm_gnn_tpu/ops/spmm.py``: for every node i,
``out[i] = sum_{(j -> i)} w_e * x[j]`` over the blocked layout of
:mod:`..graph.csr` (with ``w_e = 1/deg(i)`` the SAGE mean). The backward
of a weighted sum is the same sum over the reversed edges, so
:func:`spmm_apply` runs the same aggregation on the reverse layout.

``precision``: ``"default"`` rounds x and the per-edge weight to bf16 and
sums their exact products in f32 (the TPU kernel's single-pass MXU form);
``"highest"`` sums f32 products and needs f32 x. The output has x's dtype.

The int8 variants, :func:`spmm_int8` and :func:`spmm_int8_pt` (the
kernels of ``csrc/spmm_onehot_int8.cu``), aggregate int8 x with per-row
scales (from :func:`.quant.quantize_rows`) or one per-tensor scale (from
:func:`.quant.quantize_tensor_xla`), in the TPU kernels' rounding: per
row, the f32 product ``w_e * xs[src_e]`` rounded to bf16 times the exact
int8 value; per tensor, ``bf16(w_e)`` times the int8 value and one
multiply by the scale at the write; both sum in f32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph.csr import EDGE_CHUNK, TILE, BlockedEdges, auto_edge_chunk, block_edges, mean_weights, pad_nodes
from .spmm_banded import BF16, bf16r

PRECISIONS = ("default", "highest")


def spmm_xla(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor, weight: torch.Tensor,
             num_nodes: int) -> torch.Tensor:
    """Gather + segment sum, at x's dtype (the reference path)."""
    msgs = x[src.long()] * weight[:, None].to(x.dtype)
    return msgs.new_zeros((num_nodes, x.shape[1])).index_add_(0, dst.long(), msgs)


def global_edges(blocked: BlockedEdges) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every slot's (source row, destination row, weight), flattened."""
    meta = blocked.block_meta.long()
    src = meta[:, 1:2] * blocked.tile + blocked.src_local.long()
    dst = meta[:, 0:1] * blocked.tile + blocked.dst_local.long()
    return src.reshape(-1), dst.reshape(-1), blocked.weight.reshape(-1)


def check_steps(blocked: BlockedEdges, k_per_step: int) -> None:
    """The JAX kernel's ``k_per_step`` contract (grid steps of K chunks must
    never straddle a destination block): a ValueError where it would run
    K chunks of two blocks in one step."""
    w, k = blocked.num_chunks, k_per_step
    if w % k:
        raise ValueError(
            f"num_chunks {w} not divisible by k_per_step {k}; build the layout "
            f"with block_edges(..., step_chunks={k})")
    if k > 1 and blocked.step_chunks % k:
        raise ValueError(
            f"layout built with step_chunks={blocked.step_chunks} cannot run "
            f"at k_per_step={k}: per-dst-block chunk counts must be a "
            f"multiple of K (rebuild with step_chunks={k})")


def _check_call(x: torch.Tensor, blocked: BlockedEdges, precision: str, k_per_step: int) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    if x.dim() != 2 or x.shape[0] % blocked.tile:
        raise ValueError(f"x rows {tuple(x.shape)} not a multiple of {blocked.tile}")
    if precision == "highest" and x.dtype != torch.float32:
        raise ValueError(f"HIGHEST-precision SpMM requires f32 input, got {x.dtype}")
    check_steps(blocked, k_per_step)


# ------------------------------------------------------------ the kernel


def spmm_onehot_plain(x: torch.Tensor, blocked: BlockedEdges, *, precision: str = "default",
                      k_per_step: int = 1) -> torch.Tensor:
    """Plain PyTorch version of ``csrc/spmm_onehot.cu``: for every row, its
    live slots' products (the TPU kernel's precision) added in slot order
    from 0, in f32, the result at x's dtype. It walks the rows' live slots
    by position over :func:`onehot_plan`, each step one f32 multiply and
    one f32 add, as the kernel does, so the two agree bit for bit; padding
    slots never read x."""
    _check_call(x, blocked, precision, k_per_step)
    n, d = x.shape
    row_ptr, perm, src_row = onehot_plan(blocked, n)
    w = blocked.weight.reshape(-1).float()[perm.long()]
    if precision == "default":
        w = bf16r(w)
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    # rows by falling slot count: the rows live at position j are a prefix
    order = torch.argsort(counts, descending=True, stable=True)
    start = row_ptr[:-1].long()[order]
    by_count = counts[order].cpu()
    longest = int(by_count[0]) if n else 0
    live_at = torch.searchsorted(-by_count, -torch.arange(longest), side="left").tolist()
    acc = x.new_zeros((n, d), dtype=torch.float32)
    for j, k in enumerate(live_at):
        e = start[:k] + j
        xj = x[src_row[e].long()].float()
        if precision == "default":
            xj = bf16r(xj)
        acc[:k] = acc[:k] + w[e][:, None] * xj
    out = torch.empty_like(acc)
    out[order] = acc
    return out.to(x.dtype)


def onehot_plan(blocked: BlockedEdges,
                n_rows: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(row_ptr [n_rows + 1], perm, src_row)`` int32: the live slots
    (weight != 0) of every destination row in slot order, and each live
    slot's global source row. Structure only, no weight: derived once per
    layout, on its device, and kept on the layout object, where a layout
    with other weights on the same structure may share it
    (``sddmm._with_weight``)."""
    cached = blocked.__dict__.get("_onehot_plan")
    if cached is not None and cached[0] == n_rows:
        return cached[1]
    src, rows, w = global_edges(blocked)
    live = torch.nonzero(w != 0).flatten()
    key = rows[live]
    if key.numel() and int(key.max()) >= n_rows:
        raise ValueError(f"the layout has destination rows past x's {n_rows} rows")
    perm = live[torch.argsort(key, stable=True)]
    src_row = src[perm]
    if src_row.numel() and int(src_row.max()) >= n_rows:
        raise ValueError(f"the layout has source rows past x's {n_rows} rows")
    row_ptr = torch.zeros(n_rows + 1, dtype=torch.int32, device=w.device)
    row_ptr[1:] = torch.cumsum(torch.bincount(key, minlength=n_rows), 0)
    plan = (row_ptr, perm.to(torch.int32).contiguous(), src_row.to(torch.int32).contiguous())
    object.__setattr__(blocked, "_onehot_plan", (n_rows, plan))
    return plan


def spmm_onehot(x: torch.Tensor, blocked: BlockedEdges, *, precision: str = "default",
                k_per_step: int = 1) -> torch.Tensor:
    """:func:`spmm_onehot_plain`'s function: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. ``x [n_pad, D]``, n_pad a
    multiple of the layout's tile; returns ``[n_pad, D]`` sums."""
    if x.device.type == "cpu":
        return spmm_onehot_plain(x, blocked, precision=precision, k_per_step=k_per_step)
    _check_call(x, blocked, precision, k_per_step)
    if x.device.type != "cuda":
        raise ValueError(f"spmm_onehot runs on CUDA or CPU tensors, got {x.device}")
    if blocked.weight.device != x.device:
        raise ValueError(f"spmm_onehot: the layout must be on {x.device} (BlockedEdges.to)")
    if x.dtype not in (torch.float32, BF16) or not x.is_contiguous():
        raise ValueError(f"spmm_onehot: x must be contiguous float32 or bfloat16, got {x.dtype}")
    n, d = x.shape
    if d > 128:
        raise ValueError(f"spmm_onehot: feature width {d} > 128 is not taken")
    row_ptr, perm, src_row = onehot_plan(blocked, n)
    weight = blocked.weight.float().contiguous()
    out = torch.empty_like(x)
    from . import _build

    lib = _build.load()
    with torch.cuda.device(x.device):
        code = lib.spmm_onehot_launch(
            row_ptr.data_ptr(), perm.data_ptr(), src_row.data_ptr(), weight.data_ptr(), n,
            x.data_ptr(), int(x.dtype == BF16), d, int(precision == "default"), out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, f"spmm_onehot kernel (rows={n}, D={d})")
    spmm_onehot.launches += 1
    return out


spmm_onehot.launches = 0


# ------------------------------------------------------------ the int8 kernels


def _check_int8(xq: torch.Tensor, scales: torch.Tensor, blocked: BlockedEdges, per_row: bool,
                k_per_step: int, out_dtype) -> None:
    """The JAX int8 kernels' contracts, as ValueErrors."""
    if xq.dim() != 2 or xq.dtype != torch.int8:
        raise ValueError(f"int8 SpMM takes [n_pad, D] int8 x, got {tuple(xq.shape)} {xq.dtype}")
    if xq.shape[0] % blocked.tile:
        raise ValueError(f"x rows {xq.shape[0]} not a multiple of {blocked.tile}")
    want = (xq.shape[0], 1) if per_row else (1,)
    if tuple(scales.shape) != want or scales.dtype != torch.float32:
        raise ValueError(f"{'per-row' if per_row else 'per-tensor'} scales must be {want} "
                         f"float32, got {tuple(scales.shape)} {scales.dtype}")
    if out_dtype not in (torch.float32, BF16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    check_steps(blocked, k_per_step)


def _int8_plain(xq, scales, blocked, per_row, k_per_step, out_dtype):
    _check_int8(xq, scales, blocked, per_row, k_per_step, out_dtype)
    src, dst, w = global_edges(blocked)
    w = bf16r(w * scales[src, 0]) if per_row else bf16r(w)
    out = w.new_zeros(xq.shape).index_add_(0, dst, xq[src].float() * w[:, None])
    return (out if per_row else out * scales).to(out_dtype)


def spmm_int8_plain(xq: torch.Tensor, xs: torch.Tensor, blocked: BlockedEdges, num_nodes: int,
                    *, k_per_step: int = 1, out_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of the per-row kernel: ``out[i] = sum_e
    bf16(w_e * xs[src_e]) * xq[src_e]`` in f32."""
    return _int8_plain(xq, xs, blocked, True, k_per_step, out_dtype)


def spmm_int8_pt_plain(xq: torch.Tensor, scale: torch.Tensor, blocked: BlockedEdges,
                       num_nodes: int, *, k_per_step: int = 1,
                       out_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of the per-tensor kernel: ``out[i] = scale *
    sum_e bf16(w_e) * xq[src_e]`` in f32."""
    return _int8_plain(xq, scale, blocked, False, k_per_step, out_dtype)


def _int8_launch(name, xq, scales, blocked, per_row, k_per_step, out_dtype):
    _check_int8(xq, scales, blocked, per_row, k_per_step, out_dtype)
    if xq.device.type != "cuda" or not xq.is_contiguous():
        raise ValueError(f"{name} runs on contiguous CUDA or CPU tensors, got {xq.device}")
    if blocked.weight.device != xq.device or scales.device != xq.device:
        raise ValueError(f"{name}: the layout and the scales must be on {xq.device}")
    n, d = xq.shape
    if d > 128:
        raise ValueError(f"{name}: feature width {d} > 128 is not taken")
    row_ptr, perm, _ = onehot_plan(blocked, n)
    meta = blocked.block_meta.to(torch.int32).contiguous()
    src_local = blocked.src_local.to(torch.int32).contiguous()
    weight = blocked.weight.float().contiguous()
    scales = scales.contiguous()
    out = torch.empty((n, d), dtype=out_dtype, device=xq.device)
    from . import _build

    lib = _build.load()
    with torch.cuda.device(xq.device):
        code = lib.spmm_onehot_int8_launch(
            row_ptr.data_ptr(), perm.data_ptr(), meta.data_ptr(), src_local.data_ptr(),
            weight.data_ptr(), blocked.edge_chunk, blocked.tile, n, xq.data_ptr(), d,
            scales.data_ptr(), int(per_row), int(out_dtype == BF16), out.data_ptr(),
            torch.cuda.current_stream(xq.device).cuda_stream)
    _build.check(lib, code, f"{name} kernel (rows={n}, D={d})")
    return out


def spmm_int8(xq: torch.Tensor, xs: torch.Tensor, blocked: BlockedEdges, num_nodes: int, *,
              k_per_step: int = 1, out_dtype=torch.float32) -> torch.Tensor:
    """:func:`spmm_int8_plain`'s function, the counterpart of
    ``spmm_pallas_int8``: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. ``xq [n_pad, D] int8`` (D <= 128), ``xs
    [n_pad, 1] f32``."""
    if xq.device.type == "cpu":
        return spmm_int8_plain(xq, xs, blocked, num_nodes, k_per_step=k_per_step,
                               out_dtype=out_dtype)
    out = _int8_launch("spmm_int8", xq, xs, blocked, True, k_per_step, out_dtype)
    spmm_int8.launches += 1
    return out


def spmm_int8_pt(xq: torch.Tensor, scale: torch.Tensor, blocked: BlockedEdges, num_nodes: int,
                 *, k_per_step: int = 1, out_dtype=torch.float32) -> torch.Tensor:
    """:func:`spmm_int8_pt_plain`'s function, the counterpart of
    ``spmm_pallas_int8_pt``: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. ``xq [n_pad, D] int8`` (D <= 128), ``scale
    [1] f32``."""
    if xq.device.type == "cpu":
        return spmm_int8_pt_plain(xq, scale, blocked, num_nodes, k_per_step=k_per_step,
                                  out_dtype=out_dtype)
    out = _int8_launch("spmm_int8_pt", xq, scale, blocked, False, k_per_step, out_dtype)
    spmm_int8_pt.launches += 1
    return out


spmm_int8.launches = 0
spmm_int8_pt.launches = 0


# ------------------------------------------------------------ autograd


def _dispatch(x, blocked, num_nodes, use_pallas, k_per_step=1):
    if use_pallas:
        return spmm_onehot(x, blocked, k_per_step=k_per_step)
    src, dst, w = global_edges(blocked)
    return spmm_xla(x, src, dst, w, num_nodes)


class _SpmmFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, blocked_fwd, blocked_rev, num_nodes, use_pallas, k_per_step):
        ctx.saved = (blocked_rev, num_nodes, use_pallas, k_per_step)
        return _dispatch(x, blocked_fwd, num_nodes, use_pallas, k_per_step)

    @staticmethod
    def backward(ctx, g):
        blocked_rev, num_nodes, use_pallas, k_per_step = ctx.saved
        return (_dispatch(g.contiguous(), blocked_rev, num_nodes, use_pallas, k_per_step),
                None, None, None, None, None)


def spmm_apply(x: torch.Tensor, blocked_fwd: BlockedEdges, blocked_rev: BlockedEdges,
               num_nodes: int, use_pallas: bool, k_per_step: int = 1) -> torch.Tensor:
    """Weighted aggregation whose backward runs the same aggregation on the
    reverse layout (``use_pallas``: the kernel at DEFAULT precision; else
    the reference path)."""
    return _SpmmFn.apply(x, blocked_fwd, blocked_rev, num_nodes, use_pallas, k_per_step)


# ------------------------------------------------------------ host-side prep


def prepare_mean_aggregate(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    *,
    step_chunks: int = 1,
    tile: int = TILE,
    edge_chunk: int = EDGE_CHUNK,
) -> tuple[BlockedEdges, BlockedEdges, int]:
    """Forward and reverse blocked layouts for mean aggregation and the
    padded node count; the 1/deg weights ride the edges both ways.
    ``step_chunks`` must be a multiple of the ``k_per_step`` they run at."""
    n_pad = pad_nodes(num_nodes, tile)
    w = mean_weights(dst, num_nodes)
    edge_chunk = auto_edge_chunk(len(src), edge_chunk)
    fwd = block_edges(src, dst, n_pad, weight=w, tile=tile, edge_chunk=edge_chunk,
                      step_chunks=step_chunks)
    rev = block_edges(dst, src, n_pad, weight=w, tile=tile, edge_chunk=edge_chunk,
                      step_chunks=step_chunks)
    return fwd, rev, n_pad
