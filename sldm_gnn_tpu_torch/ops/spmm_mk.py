"""Megakernel blocked SpMM: the layout, the CUDA kernel ``csrc/spmm_mk.cu``
and its plain version.

Port of ``sldm_gnn_tpu/ops/spmm_mk.py``. The layout
(:class:`MegaBlockedEdges`, from :func:`to_megakernel_layout`) sorts the
blocked layout's live chunks by destination block, with ``chunk_ptr
[NB+1]`` ranges per block. For every destination block ``b`` the kernel
walks its chunks ``c`` in order and adds ``A_c @ x[sblk[c]*tile : +tile]``,
``A_c[d, s]`` being the sum of the chunk's weights with local destination
``d`` and local source ``s``:

  * ``fast=True``: each weight rounded to bf16, ``A_c`` summed in f32 and
    rounded to bf16, x rounded to bf16, products summed in f32;
  * ``fast=False``: f32 throughout.

Forward only, as in the JAX package (which gives it no AD rule). No model
calls it; its path is the public op API.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..graph.csr import TILE, BlockedEdges
from .spmm_banded import BF16, bf16r


@dataclass(frozen=True)
class MegaBlockedEdges:
    """chunk_ptr [NB+1] int32; sblk [W] int32; srcdst [W, 1, 2*EC] int32
    (source locals, then destination locals); weight [W, 1, EC] float32 —
    the JAX layout's arrays, as CPU tensors (the singleton middle axis is
    the TPU's DMA slicing rule, kept so that the arrays stay equal)."""

    chunk_ptr: torch.Tensor
    sblk: torch.Tensor
    srcdst: torch.Tensor
    weight: torch.Tensor
    tile: int = TILE

    @property
    def num_chunks(self) -> int:
        return self.sblk.shape[0]

    @property
    def edge_chunk(self) -> int:
        return self.weight.shape[-1]

    def to(self, device) -> "MegaBlockedEdges":
        return dataclasses.replace(self, chunk_ptr=self.chunk_ptr.to(device),
                                   sblk=self.sblk.to(device), srcdst=self.srcdst.to(device),
                                   weight=self.weight.to(device))


def to_megakernel_layout(blocked: BlockedEdges, num_nodes_padded: int) -> MegaBlockedEdges:
    """The blocked layout (destination-sorted, possibly with all-dummy
    coverage chunks) as the megakernel layout; dummy chunks are dropped
    (numpy, equal to the JAX builder's arrays)."""
    meta = blocked.block_meta.numpy()
    src = blocked.src_local.numpy()
    dst = blocked.dst_local.numpy()
    w = blocked.weight.numpy()
    keep = (w != 0).any(axis=1)
    meta, src, dst, w = meta[keep], src[keep], dst[keep], w[keep]
    order = np.argsort(meta[:, 0], kind="stable")
    meta, src, dst, w = meta[order], src[order], dst[order], w[order]
    tile = blocked.tile
    nb = num_nodes_padded // tile
    ptr = np.zeros(nb + 1, np.int32)
    np.cumsum(np.bincount(meta[:, 0], minlength=nb), out=ptr[1:])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    if meta.shape[0] == 0:
        ec = src.shape[1] if src.size else 256
        return MegaBlockedEdges(chunk_ptr=t(ptr), sblk=t(np.zeros(1, np.int32)),
                                srcdst=t(np.zeros((1, 1, 2 * ec), np.int32)),
                                weight=t(np.zeros((1, 1, ec), np.float32)), tile=tile)
    return MegaBlockedEdges(
        chunk_ptr=t(ptr), sblk=t(meta[:, 1].astype(np.int32)),
        srcdst=t(np.concatenate([src, dst], axis=1).astype(np.int32)[:, None, :]),
        weight=t(w.astype(np.float32)[:, None, :]), tile=tile)


def _check(x: torch.Tensor, mk: MegaBlockedEdges) -> None:
    if x.dim() != 2 or x.shape[0] % mk.tile:
        raise ValueError(f"x must be [n_pad, D] with n_pad a multiple of {mk.tile}, got "
                         f"{tuple(x.shape)}")
    nb = x.shape[0] // mk.tile
    if mk.chunk_ptr.numel() != nb + 1:
        raise ValueError(f"the layout has {mk.chunk_ptr.numel() - 1} destination blocks, x "
                         f"{nb}")
    if x.dtype not in (torch.float32, BF16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")


def _slots(mk: MegaBlockedEdges):
    """(destination block [W'], source locals, destination locals, weights
    [W', EC]) of the W' chunks that ``chunk_ptr`` references."""
    used = int(mk.chunk_ptr[-1])
    counts = (mk.chunk_ptr[1:] - mk.chunk_ptr[:-1]).long()
    nb = counts.numel()
    blk = torch.repeat_interleave(torch.arange(nb, device=counts.device), counts)
    ec = mk.edge_chunk
    sd = mk.srcdst[:used, 0].long()
    return blk, sd[:, :ec], sd[:, ec:], mk.weight[:used, 0].float()


def spmm_mk_plain(x: torch.Tensor, mk: MegaBlockedEdges, num_nodes: int, *,
                  fast: bool = True) -> torch.Tensor:
    """Plain PyTorch version of ``csrc/spmm_mk.cu``: each chunk's ``A_c``
    entries summed over its duplicate (d, s) pairs (of bf16 weights, then
    rounded to bf16, under ``fast``), times the (bf16-rounded) source rows,
    summed in f32; ``[n_pad, D]`` at x's dtype."""
    _check(x, mk)
    tile = mk.tile
    blk, src_l, dst_l, w = _slots(mk)
    used = blk.numel()
    if fast:
        w = bf16r(w)
    chunk = torch.arange(used, device=w.device)[:, None].expand_as(src_l)
    key = ((chunk * tile + dst_l) * tile + src_l).reshape(-1)
    uniq, inv = torch.unique(key, return_inverse=True)
    a = w.new_zeros(uniq.numel()).index_add_(0, inv, w.reshape(-1))
    if fast:
        a = bf16r(a)
    g_chunk = uniq // (tile * tile)
    g_dst = blk[g_chunk] * tile + (uniq // tile) % tile
    g_src = mk.sblk.long()[g_chunk] * tile + uniq % tile
    xs = bf16r(x.float()) if fast else x.float()
    out = xs.new_zeros(x.shape).index_add_(0, g_dst, a[:, None] * xs[g_src])
    return out.to(x.dtype)


def mk_plan(mk: MegaBlockedEdges, n_rows: int):
    """The kernel's plan, derived once per layout on its device and kept on
    the layout object: the live slots (weight != 0) sorted by (destination
    row, chunk, local source) and grouped by equal key. Returns int32
    ``(row_ptr [n_rows + 1] group ranges, grp_src [G] global source rows,
    grp_ptr [G + 1] slot ranges, perm [live slots] flat slot indices)``."""
    cached = mk.__dict__.get("_mk_plan")
    if cached is not None and cached[0] == n_rows:
        return cached[1]
    tile = mk.tile
    blk, src_l, dst_l, w = _slots(mk)
    used, ec = src_l.shape[0], mk.edge_chunk
    dev = w.device
    chunk = torch.arange(used, device=dev)[:, None]
    dst_row = blk[:, None] * tile + dst_l
    key = ((dst_row * max(used, 1) + chunk) * tile + src_l).reshape(-1)
    slot = torch.arange(used * ec, device=dev)
    live = (w != 0).reshape(-1)
    key, slot = key[live], slot[live]
    order = torch.argsort(key, stable=True)
    key, perm = key[order], slot[order]
    new = torch.ones_like(key, dtype=torch.bool)
    new[1:] = key[1:] != key[:-1]
    start = torch.nonzero(new).flatten()
    grp_ptr = torch.cat([start, start.new_tensor([key.numel()])])
    gk = key[start]
    g_dst = gk // (tile * max(used, 1))
    g_chunk = (gk // tile) % max(used, 1)
    grp_src = mk.sblk.long()[g_chunk] * tile + gk % tile
    if g_dst.numel() and int(g_dst.max()) >= n_rows:
        raise ValueError(f"the layout has destination rows past x's {n_rows} rows")
    row_ptr = torch.zeros(n_rows + 1, dtype=torch.int64, device=dev)
    row_ptr[1:] = torch.cumsum(torch.bincount(g_dst, minlength=n_rows), 0)
    i32 = lambda t: t.to(torch.int32).contiguous()
    plan = (i32(row_ptr), i32(grp_src), i32(grp_ptr), i32(perm))
    object.__setattr__(mk, "_mk_plan", (n_rows, plan))
    return plan


def spmm_mk(x: torch.Tensor, mk: MegaBlockedEdges, num_nodes: int, *,
            fast: bool = True) -> torch.Tensor:
    """:func:`spmm_mk_plain`'s function (``spmm_pallas_mk``): the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors. Returns ``[n_pad,
    D]`` weighted sums at x's dtype."""
    if x.device.type == "cpu":
        return spmm_mk_plain(x, mk, num_nodes, fast=fast)
    _check(x, mk)
    if x.device.type != "cuda":
        raise ValueError(f"spmm_mk runs on CUDA or CPU tensors, got {x.device}")
    if mk.weight.device != x.device:
        raise ValueError(f"spmm_mk: the layout must be on {x.device} (MegaBlockedEdges.to)")
    x = x.contiguous()
    n, d = x.shape
    row_ptr, grp_src, grp_ptr, perm = mk_plan(mk, n)
    weight = mk.weight.float().contiguous()
    out = torch.empty_like(x)
    from . import _build

    lib = _build.load()
    with torch.cuda.device(x.device):
        code = lib.spmm_mk_launch(
            row_ptr.data_ptr(), grp_src.data_ptr(), grp_ptr.data_ptr(), perm.data_ptr(),
            weight.data_ptr(), n, x.data_ptr(), int(x.dtype == BF16), d, int(fast),
            out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, f"spmm_mk kernel (rows={n}, D={d})")
    spmm_mk.launches += 1
    return out


spmm_mk.launches = 0
