"""Fused SAGE layers on one shard of the halo-sharded path.

Port of ``sldm_gnn_tpu/parallel/halo_fused.py``. A shard owns the padded
rows ``x [n_pad_local, D]`` and has received the halo table ``halo
[ep * H, D]`` (the rows of other shards that its edges read; see
:mod:`.halo`). One layer ``act(LN?((B_int x + R halo) Wl + x Wr + b))``
splits its aggregation in two:

  * the interior edges run the fused banded kernels
    (:mod:`..ops.sage_fused`) on the shard's banded layouts;
  * the boundary edges (and the interior edges outside the banded span,
    "interior overflow") are a compact residual: gathered and summed into
    one slot of ``K*T`` rows a touched group of K blocks
    (:class:`CompactBoundary`), which the forward kernel adds before its
    epilogue. Full-degree weights make the two parts sum to the global mean.

The overlap layers (:func:`halo_fused_sage_ov`, :func:`halo_fused_sage_ln_ov`)
keep the forward kernel free of anything the exchange delivers: its
residual carries the interior overflow only, and its ``ypre`` output
``y_pre_c [m_b, K*T, H]`` (``csrc/sage_fused_fwd.cu``) holds the
pre-LN, pre-activation ``y`` of every group a boundary edge touches. A
small epilogue adds ``(R_b halo) Wl`` to those rows, redoes LN and the
activation on them and patches them into the kernel's outputs. The
backward is shared with the non-overlap layers: ``dhalo`` (what the
reverse exchange sends back) comes from the boundary transpose alone.

Each layer is a ``torch.autograd.Function`` differentiable in x, halo and
the parameters. ``use_pallas`` runs the kernels (their plain versions on
CPU tensors) and, like the JAX package, takes the f32 twin where a layout
is ``wide``; ``use_pallas=False`` is the twin. In the JAX package
``axis_name`` sums the parameter gradients over the shards inside
``shard_map``. Here each call returns its shard's own partial gradients;
summing them across shards (``torch.distributed``), like the exchange
itself, waits for the slice that ports the collectives.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..graph.csr import TILE, pad_nodes
from ..ops.banded_residual import _residual_maps, split_banded_residual
from ..ops.sage_fused import (
    _act,
    _expand_compact,
    _fused_fwd_impl,
    _ln_bwd_prologue,
    _ln_fwd_xla,
    banded_sage_bwd,
    banded_sage_ln_bwd,
    mask_act,
)
from ..ops.spmm_banded import BandedBlocks, spmm_banded_xla
from .halo import plan_banded_interior, plan_halo_partition, shard_blocks, split_halo_plan


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


@dataclass(frozen=True)
class CompactBoundary:
    """A shard's residual edges in the orders the layers need (stacked over a
    leading ``ep`` axis in a plan; :meth:`HaloFusedPlan.shard` takes one
    shard). Padding edges carry w = 0 and sit first.

    Boundary edges (source on another shard) add ``w_f[e] * halo[src_f[e]]``
    to compact row ``row_f[e]``; their transpose lands in halo-row space,
    ``t_bnd[src_r[e]] += w_r[e] * dy[dst_r[e]]``. Interior-overflow edges
    add ``i_w_f[e] * x[i_src_f[e]]`` to row ``i_row_f[e]`` (the same slot
    space, ``rg`` maps a group to its slot, slot 0 is zeros); their
    transpose targets local rows, compact rows ``i_row_rev`` (slot map
    ``rg_rev``), fed by ``i_w_r[e] * dy[i_dst_r[e]]``. The overlap layers'
    separated maps give the boundary edges their own slots (``b_*``,
    ``rg_b``, and ``slot_grp`` from slot to group, ``steps`` for none) and
    the interior overflow its own (``io_*``, ``rg_io``).
    """

    src_f: torch.Tensor
    row_f: torch.Tensor
    w_f: torch.Tensor
    dst_r: torch.Tensor
    src_r: torch.Tensor
    w_r: torch.Tensor
    rg: torch.Tensor
    i_src_f: torch.Tensor
    i_row_f: torch.Tensor
    i_w_f: torch.Tensor
    i_dst_r: torch.Tensor
    i_row_rev: torch.Tensor
    i_w_r: torch.Tensor
    rg_rev: torch.Tensor
    b_src_s: torch.Tensor
    b_row_s: torch.Tensor
    b_w_s: torch.Tensor
    rg_b: torch.Tensor
    slot_grp: torch.Tensor
    io_src_s: torch.Tensor
    io_row_s: torch.Tensor
    io_w_s: torch.Tensor
    rg_io: torch.Tensor
    m: int        # forward compact slots
    m_rev: int    # reverse compact slots
    kt: int       # K * tile rows a slot
    h_rows: int   # halo table rows (ep * H)
    m_b: int = 1  # boundary-only slots (overlap)
    m_io: int = 1  # interior-overflow-only slots (overlap)

    def _tensors(self):
        return [f.name for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)]

    def to(self, device) -> "CompactBoundary":
        return dataclasses.replace(self, **{n: getattr(self, n).to(device)
                                            for n in self._tensors()})

    def shard(self, p: int) -> "CompactBoundary":
        return dataclasses.replace(self, **{n: getattr(self, n)[p] for n in self._tensors()})


@dataclass(frozen=True)
class HaloFusedPlan:
    """The exchange plan and the fused layers' layouts, stacked over ``ep``
    shards: ``send_idx [ep, ep, H]``, the banded interior layouts
    ``int_fwd`` / ``int_rev`` and the :class:`CompactBoundary`.
    :meth:`shard` gives one shard's layouts."""

    send_idx: torch.Tensor
    int_fwd: BandedBlocks
    int_rev: BandedBlocks
    bnd: CompactBoundary
    n_local: int
    n_pad_local: int

    @property
    def ep(self) -> int:
        return self.send_idx.shape[0]

    def to(self, device) -> "HaloFusedPlan":
        return dataclasses.replace(self, send_idx=self.send_idx.to(device),
                                   int_fwd=self.int_fwd.to(device),
                                   int_rev=self.int_rev.to(device), bnd=self.bnd.to(device))

    def shard(self, p: int) -> tuple[BandedBlocks, BandedBlocks, CompactBoundary]:
        """Shard ``p``'s ``(int_fwd, int_rev, bnd)``."""
        return shard_blocks(self.int_fwd, p), shard_blocks(self.int_rev, p), self.bnd.shard(p)


def _pad_front(vals, order, size, fill=0, dtype=np.int32):
    """Ordered values right-aligned in a fixed-size array (padding first,
    so that sorted index sequences stay non-decreasing)."""
    out = np.full(size, fill, dtype)
    if len(vals):
        out[size - len(vals):] = np.asarray(vals)[order]
    return out


def _compact_shard(bsrc, bdst, bw, io, steps: int, k: int, tile: int) -> dict:
    """One shard's compact-residual maps; ``io = (src, dst, w)`` its
    interior overflow (possibly empty)."""
    io_s, io_d, io_w = (np.asarray(a) for a in io)
    bsrc = np.asarray(bsrc, np.int64)
    bdst = np.asarray(bdst, np.int64)
    bw = np.asarray(bw, np.float32)
    # forward: boundary and interior overflow share the slot space
    rows, rg, _, m = _residual_maps(np.concatenate([bdst, io_d.astype(np.int64)]), k, tile,
                                    steps)
    b_rows, i_rows = rows[: len(bdst)], rows[len(bdst):]
    # reverse: interior overflow only (its transpose targets local rows)
    i_rows_rev, rg_rev, _, m_rev = _residual_maps(io_s.astype(np.int64), k, tile, steps)
    # the overlap layers' separated forward maps
    b_rows_sep, rg_b, _, m_b = _residual_maps(bdst, k, tile, steps)
    slot_grp = np.full(m_b, steps, np.int32)
    if len(bdst):
        slot_grp[1:] = np.unique(bdst // (k * tile)).astype(np.int32)
    io_rows_sep, rg_io, _, m_io = _residual_maps(io_d.astype(np.int64), k, tile, steps)
    return dict(
        bsrc=bsrc, bdst=bdst, bw=bw, b_rows=b_rows,
        io_s=io_s, io_d=io_d, io_w=io_w.astype(np.float32), i_rows=i_rows,
        i_rows_rev=i_rows_rev, rg=rg, rg_rev=rg_rev, m=m, m_rev=m_rev,
        b_rows_sep=b_rows_sep, rg_b=rg_b, m_b=m_b, slot_grp=slot_grp,
        io_rows_sep=io_rows_sep, rg_io=rg_io, m_io=m_io,
        order_bf=np.argsort(b_rows, kind="stable"),
        order_if=np.argsort(i_rows, kind="stable"),
        order_br=np.argsort(bsrc, kind="stable"),
        order_ir=np.argsort(i_rows_rev, kind="stable"),
        order_bs=np.argsort(b_rows_sep, kind="stable"),
        order_is=np.argsort(io_rows_sep, kind="stable"))


def _stack_compact(per, kt: int, h_rows: int) -> CompactBoundary:
    """Per-shard compact maps stacked (leading dim ``len(per)``)."""
    eb = max(max((len(t["bsrc"]) for t in per), default=1), 1)
    ei = max(max((len(t["io_s"]) for t in per), default=1), 1)
    m_b = max(t["m_b"] for t in per)
    steps = per[0]["rg"].shape[0]

    def col(key, order, size, fill=0, dtype=np.int32):
        return _tensor(np.stack([_pad_front(t[key], t[order], size, fill, dtype) for t in per]))

    def slots(sg):
        out = np.full(m_b, steps, np.int32)
        out[: len(sg)] = sg
        return out

    f32 = dict(fill=0.0, dtype=np.float32)
    return CompactBoundary(
        src_f=col("bsrc", "order_bf", eb), row_f=col("b_rows", "order_bf", eb),
        w_f=col("bw", "order_bf", eb, **f32),
        dst_r=col("bdst", "order_br", eb), src_r=col("bsrc", "order_br", eb),
        w_r=col("bw", "order_br", eb, **f32),
        rg=_tensor(np.stack([t["rg"] for t in per])),
        i_src_f=col("io_s", "order_if", ei), i_row_f=col("i_rows", "order_if", ei),
        i_w_f=col("io_w", "order_if", ei, **f32),
        i_dst_r=col("io_d", "order_ir", ei), i_row_rev=col("i_rows_rev", "order_ir", ei),
        i_w_r=col("io_w", "order_ir", ei, **f32),
        rg_rev=_tensor(np.stack([t["rg_rev"] for t in per])),
        b_src_s=col("bsrc", "order_bs", eb), b_row_s=col("b_rows_sep", "order_bs", eb),
        b_w_s=col("bw", "order_bs", eb, **f32),
        rg_b=_tensor(np.stack([t["rg_b"] for t in per])),
        slot_grp=_tensor(np.stack([slots(t["slot_grp"]) for t in per])),
        io_src_s=col("io_s", "order_is", ei), io_row_s=col("io_rows_sep", "order_is", ei),
        io_w_s=col("io_w", "order_is", ei, **f32),
        rg_io=_tensor(np.stack([t["rg_io"] for t in per])),
        m=max(t["m"] for t in per), m_rev=max(t["m_rev"] for t in per), kt=kt,
        h_rows=h_rows, m_b=m_b, m_io=max(t["m_io"] for t in per))


def plan_halo_fused(src: np.ndarray, dst: np.ndarray, num_nodes: int, ep: int, *,
                    mean: bool = True, tile: int | None = None, banded_k: int = 4,
                    banded_max_span: int = 16, span: int | None = None,
                    resid_frac: float = 0.01) -> HaloFusedPlan:
    """The fused layers' plan from a global edge list: the halo split, the
    interior as stacked banded layouts, the boundary and the interior edges
    outside the span windows as the compact residual. ``span=None`` takes
    the tightest candidate span (percentiles of the per-edge span) whose
    overflow stays within ``resid_frac`` of the interior edges; raises
    ValueError past ``4 * resid_frac``."""
    tile = tile or TILE
    plan, n_local = plan_halo_partition(src, dst, num_nodes, ep, mean=mean)
    split = split_halo_plan(plan, n_local)
    n_pad_local = pad_nodes(n_local, tile)
    nbl = n_pad_local // tile
    nbl = ((nbl + banded_k - 1) // banded_k) * banded_k

    interiors = []
    for p in range(ep):
        mi = split.int_w[p].numpy() > 0
        interiors.append((split.int_src[p].numpy()[mi].astype(np.int64),
                          split.int_dst[p].numpy()[mi].astype(np.int64),
                          split.int_w[p].numpy()[mi].astype(np.float32)))

    e_int = max(sum(len(s) for s, _, _ in interiors), 1)
    if span is None:
        spans_all = []
        for s, d_, _ in interiors:
            if not len(s):
                continue
            bo = np.arange(nbl, dtype=np.int64)
            hi = bo.copy()
            np.minimum.at(bo, d_ // tile, s // tile)
            np.maximum.at(hi, d_ // tile, s // tile)
            spans_all.append((hi - bo + 1)[d_ // tile])
        pooled = np.concatenate(spans_all) if spans_all else np.array([1])
        cands = sorted({int(np.percentile(pooled, q)) for q in (50, 75, 90, 99)}
                       | {min(banded_max_span, int(pooled.max()))})
        cands = [c for c in cands if c <= banded_max_span]
        span = cands[-1]
        for c in cands:
            kept = sum(int(split_banded_residual(s, d_, nbl, tile=tile, span=c).sum())
                       for s, d_, _ in interiors)
            if (e_int - kept) / e_int <= resid_frac:
                span = c
                break
    if span > banded_max_span:
        raise ValueError(f"span {span} exceeds max_span={banded_max_span}")

    keep_masks = [split_banded_residual(s, d_, nbl, tile=tile, span=span)
                  for s, d_, _ in interiors]
    overflow = float(sum(len(s) - k.sum() for (s, _, _), k in zip(interiors, keep_masks)))
    if overflow / e_int > 4 * resid_frac:
        raise ValueError(
            f"interior overflow fraction {overflow / e_int:.4f} at span={span} exceeds "
            f"{4 * resid_frac:.4f}: shard interiors are not near-banded under this node order")

    int_fwd, int_rev, n_pad_local = plan_banded_interior(
        split, dst, n_local, n_pad_local, mean=mean, tile=tile, banded_k=banded_k,
        banded_max_span=span, keep_masks=keep_masks)
    steps = n_pad_local // (banded_k * tile)
    h_max = split.send_idx.shape[2]
    per = []
    for p in range(ep):
        mb = split.hal_w[p].numpy() > 0
        s, d_, w = interiors[p]
        k = keep_masks[p]
        per.append(_compact_shard(split.hal_src[p].numpy()[mb], split.hal_dst[p].numpy()[mb],
                                  split.hal_w[p].numpy()[mb], (s[~k], d_[~k], w[~k]), steps,
                                  banded_k, tile))
    bnd = _stack_compact(per, banded_k * tile, ep * h_max)
    return HaloFusedPlan(send_idx=plan.send_idx, int_fwd=int_fwd, int_rev=int_rev, bnd=bnd,
                         n_local=n_local, n_pad_local=n_pad_local)


# ------------------------------------------------------------ the compact parts


def _segment_sum(msgs: torch.Tensor, rows: torch.Tensor, n: int) -> torch.Tensor:
    out = msgs.new_zeros((n, msgs.shape[1]))
    return out.index_add_(0, rows.long(), msgs)


def _gather_msgs(v: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return v[idx.long()].float() * w[:, None]


def boundary_fwd_compact(x: torch.Tensor, halo: torch.Tensor,
                         bnd: CompactBoundary) -> torch.Tensor:
    """Compact forward residual ``[m, K*T, D]`` f32 (slot 0 zeros): the
    boundary edges from the halo table plus the interior overflow from x."""
    n = bnd.m * bnd.kt
    r = _segment_sum(_gather_msgs(halo, bnd.src_f, bnd.w_f), bnd.row_f, n)
    r = r + _segment_sum(_gather_msgs(x, bnd.i_src_f, bnd.i_w_f), bnd.i_row_f, n)
    return r.reshape(bnd.m, bnd.kt, halo.shape[1])


def io_fwd_compact(x: torch.Tensor, bnd: CompactBoundary) -> torch.Tensor:
    """The interior overflow alone, ``[m_io, K*T, D]`` f32 (the overlap
    layers' kernel residual: x only, nothing from the exchange)."""
    r = _segment_sum(_gather_msgs(x, bnd.io_src_s, bnd.io_w_s), bnd.io_row_s,
                     bnd.m_io * bnd.kt)
    return r.reshape(bnd.m_io, bnd.kt, x.shape[1])


def boundary_fwd_sep(halo: torch.Tensor, bnd: CompactBoundary) -> torch.Tensor:
    """The boundary edges alone in their own slots, ``[m_b, K*T, D]`` f32
    (slot 0 stays zero: padding edges carry w = 0)."""
    r = _segment_sum(_gather_msgs(halo, bnd.b_src_s, bnd.b_w_s), bnd.b_row_s, bnd.m_b * bnd.kt)
    return r.reshape(bnd.m_b, bnd.kt, halo.shape[1])


def _patch_groups(full: torch.Tensor, slots: torch.Tensor, slot_grp: torch.Tensor,
                  kt: int) -> torch.Tensor:
    """``full`` with the rows of group ``slot_grp[s]`` replaced by
    ``slots[s]`` (at full's dtype); slot ids equal to the group count are
    no-ops. One ``index_copy_`` into a copy with one spare group that takes
    the no-ops, so the card never waits on the host."""
    steps = full.shape[0] // kt
    trail = full.shape[1:]
    grid = torch.cat([full.reshape(steps, kt, *trail), full.new_zeros((1, kt, *trail))])
    grid.index_copy_(0, slot_grp.long(), slots.reshape(-1, kt, *trail).to(full.dtype))
    return grid[:steps].reshape(full.shape)


def boundary_rev(dy: torch.Tensor, bnd: CompactBoundary) -> torch.Tensor:
    """Boundary transpose ``t_bnd = R^T dy``: ``[h_rows, H]`` f32."""
    return _segment_sum(_gather_msgs(dy, bnd.dst_r, bnd.w_r), bnd.src_r, bnd.h_rows)


def interior_rev_compact(dy: torch.Tensor, bnd: CompactBoundary) -> torch.Tensor:
    """Interior-overflow transpose, compact ``[m_rev, K*T, H]`` f32 (the
    reverse kernel's residual: it targets local rows)."""
    t = _segment_sum(_gather_msgs(dy, bnd.i_dst_r, bnd.i_w_r), bnd.i_row_rev,
                     bnd.m_rev * bnd.kt)
    return t.reshape(bnd.m_rev, bnd.kt, dy.shape[1])


def _ov_epilogue_y(ypre: torch.Tensor, halo: torch.Tensor, wl: torch.Tensor, x_dtype,
                   bnd: CompactBoundary) -> torch.Tensor:
    """``y_s [m_b, K*T, H]`` f32: the touched groups' pre-epilogue y
    completed by the boundary term ``(R_b halo) @ Wl`` (R_b halo at x's
    dtype, products summed in f32)."""
    r_b = boundary_fwd_sep(halo, bnd).reshape(bnd.m_b * bnd.kt, -1).to(x_dtype)
    add = r_b.float() @ wl.to(torch.promote_types(x_dtype, wl.dtype)).float()
    return ypre + add.reshape(bnd.m_b, bnd.kt, -1)


def _kernels(use_pallas: bool, blocks: BandedBlocks) -> bool:
    """The fused kernels run (JAX ``halo_fused.py:440, 491, 528, 570, 664,
    709``): with ``use_pallas`` and a narrow layout."""
    return use_pallas and not blocks.wide


# ------------------------------------------------------------ forwards


def _fwd_impl(x, halo, wl, wr, bias, int_fwd, bnd, use_pallas, slope, ln=None, eps=1e-5):
    return _fused_fwd_impl(x, wl, wr, bias, int_fwd, _kernels(use_pallas, int_fwd), slope,
                           (boundary_fwd_compact(x, halo, bnd), bnd.rg), ln=ln, eps=eps)


def _ov_fwd_impl(x, halo, wl, wr, bias, int_fwd, bnd, use_pallas, slope, ln=None, eps=1e-5):
    """The overlap forward: the kernel (or twin) on the interior and the
    interior overflow, with ``y_pre_c``; then the boundary epilogue on the
    touched groups' rows, patched in."""
    outs = _fused_fwd_impl(x, wl, wr, bias, int_fwd, _kernels(use_pallas, int_fwd), slope,
                           (io_fwd_compact(x, bnd), bnd.rg_io), ln=ln, eps=eps,
                           ypre=(bnd.rg_b, bnd.m_b))
    y_s = _ov_epilogue_y(outs[-1], halo, wl, x.dtype, bnd)
    if ln is None:
        return _patch_groups(outs[0], _act(y_s, slope), bnd.slot_grp, bnd.kt)
    z_s, xhat_s, rstd_s = _ln_fwd_xla(y_s, *ln, eps)
    return tuple(_patch_groups(full, part, bnd.slot_grp, bnd.kt)
                 for full, part in zip(outs[:3], (_act(z_s, slope), xhat_s, rstd_s)))


# ------------------------------------------------------------ backwards


def _halo_terms(dwl, t_bnd, halo, wl):
    """``dWl += halo^T t_bnd`` and ``dhalo = t_bnd Wl^T``, t_bnd at halo's
    dtype, products summed in f32."""
    tb = t_bnd.to(halo.dtype).float()
    dwl = dwl + halo.float().T @ tb
    dhalo = (tb @ wl.T.to(halo.dtype).float()).to(halo.dtype)
    return dwl, dhalo


def _twin_grads(gq, x, wl, wr, int_rev, t_i, bnd):
    """dx, dWl, dWr (f32) of the interior through the twin."""
    f32 = torch.float32
    t = _expand_compact(spmm_banded_xla(gq, int_rev), t_i, bnd.rg_rev)
    dx = (t.float() @ wl.T.to(t.dtype).to(f32) + gq.float() @ wr.T.to(gq.dtype).to(f32))
    xt = x.T.float()
    return dx.to(x.dtype), xt @ t.to(x.dtype).float(), xt @ gq.to(x.dtype).float()


def _bwd(ctx, g):
    x, halo, wl, wr, y = ctx.saved_tensors
    bnd, int_rev = ctx.bnd, ctx.int_rev
    g = mask_act(g, y, ctx.slope)
    gq = g.to(x.dtype).contiguous()
    t_bnd = boundary_rev(gq, bnd)
    t_i = interior_rev_compact(gq, bnd)
    if _kernels(ctx.use_pallas, int_rev):
        dx, dwl, dwr = banded_sage_bwd(gq, wl, wr, int_rev, x=x,
                                       resid=(t_i.to(gq.dtype), bnd.rg_rev))
        dx, dwl, dwr = dx.to(x.dtype), dwl.float(), dwr.float()
    else:
        dx, dwl, dwr = _twin_grads(gq, x, wl, wr, int_rev, t_i, bnd)
    dwl, dhalo = _halo_terms(dwl, t_bnd, halo, wl)
    db = None if ctx.bias_dtype is None else g.sum(0).to(ctx.bias_dtype)
    return dx, dhalo, dwl.to(wl.dtype), dwr.to(wr.dtype), db


def _ln_bwd(ctx, g):
    x, halo, wl, wr, gamma, beta, xhat, rstd = ctx.saved_tensors
    bnd, int_rev, slope = ctx.bnd, ctx.int_rev, ctx.slope
    if _kernels(ctx.use_pallas, int_rev):
        # dy only at the rows the boundary and overflow transposes read
        rows = bnd.dst_r.long()
        dy_e, _, _ = _ln_bwd_prologue(g[rows], xhat[rows], rstd[rows], gamma, beta, slope)
        t_bnd = _segment_sum(dy_e * bnd.w_r[:, None], bnd.src_r, bnd.h_rows)
        rows = bnd.i_dst_r.long()
        dy_i, _, _ = _ln_bwd_prologue(g[rows], xhat[rows], rstd[rows], gamma, beta, slope)
        t_i = _segment_sum(dy_i * bnd.i_w_r[:, None], bnd.i_row_rev,
                           bnd.m_rev * bnd.kt).reshape(bnd.m_rev, bnd.kt, g.shape[1])
        dx, dwl, dwr, dstats = banded_sage_ln_bwd(
            g.to(x.dtype).contiguous(), xhat, rstd, wl, wr, gamma, beta, int_rev, x,
            negative_slope=slope, resid=(t_i.to(x.dtype), bnd.rg_rev))
        dx, dwl, dwr = dx.to(x.dtype), dwl.float(), dwr.float()
        dgamma, dbeta, db = dstats[0], dstats[1], dstats[2]
    else:
        dy, dgamma, dbeta = _ln_bwd_prologue(g, xhat, rstd, gamma, beta, slope)
        gq = dy.to(x.dtype)
        t_bnd = boundary_rev(gq, bnd)
        dx, dwl, dwr = _twin_grads(gq, x, wl, wr, int_rev, interior_rev_compact(gq, bnd), bnd)
        db = dy.sum(0)
    dwl, dhalo = _halo_terms(dwl, t_bnd, halo, wl)
    db = None if ctx.bias_dtype is None else db.to(ctx.bias_dtype)
    return (dx, dhalo, dwl.to(wl.dtype), dwr.to(wr.dtype), db, dgamma.to(gamma.dtype),
            dbeta.to(beta.dtype))


def _save(ctx, int_rev, bnd, use_pallas, slope, bias, *tensors):
    ctx.save_for_backward(*tensors)
    ctx.int_rev, ctx.bnd, ctx.use_pallas, ctx.slope = int_rev, bnd, use_pallas, slope
    ctx.bias_dtype = None if bias is None else bias.dtype


class _HaloSageFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, halo, wl, wr, bias, int_fwd, int_rev, bnd, use_pallas, slope, overlap):
        impl = _ov_fwd_impl if overlap else _fwd_impl
        y = impl(x, halo, wl, wr, bias, int_fwd, bnd, use_pallas, slope)
        _save(ctx, int_rev, bnd, use_pallas, slope, bias, x, halo, wl, wr, y)
        return y

    @staticmethod
    def backward(ctx, g):
        return (*_bwd(ctx, g), None, None, None, None, None, None)


class _HaloSageLnFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, halo, wl, wr, bias, gamma, beta, int_fwd, int_rev, bnd, use_pallas,
                slope, eps, overlap):
        impl = _ov_fwd_impl if overlap else _fwd_impl
        out, xhat, rstd = impl(x, halo, wl, wr, bias, int_fwd, bnd, use_pallas, slope,
                               ln=(gamma, beta), eps=eps)
        _save(ctx, int_rev, bnd, use_pallas, slope, bias, x, halo, wl, wr, gamma, beta, xhat,
              rstd)
        return out

    @staticmethod
    def backward(ctx, g):
        return (*_ln_bwd(ctx, g), None, None, None, None, None, None, None)


def halo_fused_sage(x, halo, wl, wr, bias, int_fwd: BandedBlocks, int_rev: BandedBlocks,
                    bnd: CompactBoundary, use_pallas: bool,
                    negative_slope: float | None = None):
    """``act((B_int x + R halo) Wl + x Wr + bias)`` on one shard, the
    boundary partial added inside the fused forward kernel. ``x`` is the
    padded shard ``[n_pad_local, D]``, ``halo`` the received table
    ``[h_rows, D]``; the layouts are the shard's (:meth:`HaloFusedPlan.shard`).
    The parameter gradients are this shard's partial sums."""
    return _HaloSageFn.apply(x, halo, wl, wr, bias, int_fwd, int_rev, bnd, use_pallas,
                             negative_slope, False)


def halo_fused_sage_ln(x, halo, wl, wr, bias, gamma, beta, int_fwd: BandedBlocks,
                       int_rev: BandedBlocks, bnd: CompactBoundary, use_pallas: bool,
                       negative_slope: float | None = None, eps: float = 1e-5):
    """``act(LN((B_int x + R halo) Wl + x Wr + bias))`` on one shard, one
    fused kernel each way (:func:`halo_fused_sage`'s arguments, and the
    LayerNorm's gamma, beta and eps)."""
    return _HaloSageLnFn.apply(x, halo, wl, wr, bias, gamma, beta, int_fwd, int_rev, bnd,
                               use_pallas, negative_slope, eps, False)


def halo_fused_sage_ov(x, halo, wl, wr, bias, int_fwd: BandedBlocks, int_rev: BandedBlocks,
                       bnd: CompactBoundary, use_pallas: bool,
                       negative_slope: float | None = None):
    """The overlap twin of :func:`halo_fused_sage`: the same layer, with the
    forward kernel independent of the halo table (its ``ypre`` output and
    the boundary epilogue); the backward is shared."""
    return _HaloSageFn.apply(x, halo, wl, wr, bias, int_fwd, int_rev, bnd, use_pallas,
                             negative_slope, True)


def halo_fused_sage_ln_ov(x, halo, wl, wr, bias, gamma, beta, int_fwd: BandedBlocks,
                          int_rev: BandedBlocks, bnd: CompactBoundary, use_pallas: bool,
                          negative_slope: float | None = None, eps: float = 1e-5):
    """The overlap twin of :func:`halo_fused_sage_ln` (the path of the JAX
    package's ``cli/train_halo.py --fused-ln``); the backward is shared."""
    return _HaloSageLnFn.apply(x, halo, wl, wr, bias, gamma, beta, int_fwd, int_rev, bnd,
                               use_pallas, negative_slope, eps, True)
