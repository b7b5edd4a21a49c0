"""Banded row-gather SpMM, the low-degree tier: layouts, the reference
path, the CUDA kernel ``csrc/spmm_gather.cu`` and its plain version, and
the autograd.

Port of ``sldm_gnn_tpu/ops/spmm_gather.py``. Each destination row keeps
up to R in-window source rows, as codes relative to its group's x window
(``woff``), with their multiplicities:

    out[b*T + t] = row_scale * sum_{r < R} mult[b, r*T + t] * x[woff[b // k]*T + codes[b, r*T + t]]

Edges outside the window, or past the R slots of a row, go to the compact
residual of :mod:`.banded_residual`, so the split is exact for any graph;
the mean uses the full degree on both halves. The backward runs the
reverse layout (``col_scale``, folded into x first) plus the reverse
residual.

On the TPU this kernel never ran: Mosaic cannot gather rows across vregs,
so the JAX package keeps it off (``_PALLAS_GATHER_ENABLED = False``) and
its ``use_pallas=True`` runs the XLA form there. Here ``use_pallas=True``
launches the CUDA kernel, which computes the same function (the JAX tests
hold the interpret kernel to the XLA form at 1e-5); a row gather is
native on this card.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..graph.csr import TILE, check_edge_range, pad_nodes
from .banded_residual import _choose_windows, _residual_maps, residual_fwd_compact, residual_rev_compact
from .sage_fused import _expand_compact
from .spmm_banded import BF16, _tensor, _window_meta, scale_ptr


@dataclass(frozen=True)
class GatherBlocks:
    """The in-band adjacency in gather form.

    codes [NB, n_g*wsz*T, 1] int32  row j*T + t: slot j's source row of
                                    destination row t, relative to the
                                    group's window (rows >= R*T hold 0)
    mult  [NB, R*T, 1] f32          multiplicity per (slot, row), 0 = padding
    bo    [NB] int32                window base (tiles) of every block
    woff  [NB/K] int32              x-window base (tiles) of each group of K blocks
    off   [NB] int32                bo[b] - woff[b // K]
    row_scale / col_scale           [N_pad, 1] f32 mean scales (full degree)
    """

    codes: torch.Tensor
    mult: torch.Tensor
    bo: torch.Tensor
    woff: torch.Tensor
    off: torch.Tensor
    row_scale: torch.Tensor | None = None
    col_scale: torch.Tensor | None = None
    tile: int = TILE
    wsz: int = 8
    k: int = 4

    @property
    def num_dst_blocks(self) -> int:
        return self.codes.shape[0]

    @property
    def r(self) -> int:
        return self.mult.shape[1] // self.tile

    def to(self, device) -> "GatherBlocks":
        move = lambda t: None if t is None else t.to(device)
        return dataclasses.replace(
            self, codes=move(self.codes), mult=move(self.mult), bo=move(self.bo),
            woff=move(self.woff), off=move(self.off), row_scale=move(self.row_scale),
            col_scale=move(self.col_scale))


@dataclass(frozen=True)
class GatherResidualLayout:
    """Gather layouts (both directions) and the compact residual COO, with
    the field names of ``BandedResidualLayout`` so that its residual
    helpers apply unchanged."""

    gather_fwd: GatherBlocks
    gather_rev: GatherBlocks
    r_src: torch.Tensor
    r_row_fwd: torch.Tensor
    r_w: torch.Tensor
    r_dst: torch.Tensor
    r_row_rev: torch.Tensor
    r_w_rev: torch.Tensor
    rg_fwd: torch.Tensor
    rg_rev: torch.Tensor
    n_pad: int
    m_fwd: int
    m_rev: int
    resid_frac: float = float("nan")

    @property
    def group_rows(self) -> int:
        return self.gather_fwd.k * self.gather_fwd.tile

    @property
    def steps(self) -> int:
        return self.n_pad // self.group_rows

    def to(self, device) -> "GatherResidualLayout":
        kw = {f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)
              if isinstance(getattr(self, f.name), (torch.Tensor, GatherBlocks))}
        return dataclasses.replace(self, **kw)


def _build_gather_blocks(src, dst, mult, nb, bo, *, tile, k, r, span, wsz_min=0):
    """Pack unique in-band (src, dst, mult) edges into the window-shaped code
    column and the mult array (numpy). The caller guarantees at most ``r``
    unique sources per destination row, each inside its block's window."""
    woff, off, wsz = _window_meta(bo, nb, k, span, wsz_min=max(wsz_min, r))
    n_g = -(-r // wsz)
    codes = np.zeros((nb, n_g * wsz * tile, 1), np.int32)
    multa = np.zeros((nb, r * tile, 1), np.float32)
    if len(src):
        order = np.lexsort((src, dst))
        s, d, m = src[order], dst[order], mult[order]
        first = np.ones(len(d), bool)
        first[1:] = d[1:] != d[:-1]
        starts = np.nonzero(first)[0]
        slot = np.arange(len(d)) - starts[np.cumsum(first) - 1]
        assert slot.max() < r, (slot.max(), r)
        db = d // tile
        row = d - db * tile
        rel = s - woff[db // k].astype(np.int64) * tile
        assert rel.min() >= 0 and rel.max() < wsz * tile, (rel.min(), rel.max(), wsz * tile)
        codes[db, slot * tile + row, 0] = rel.astype(np.int32)
        multa[db, slot * tile + row, 0] = m.astype(np.float32)
    return GatherBlocks(codes=_tensor(codes), mult=_tensor(multa), bo=_tensor(bo.astype(np.int32)),
                        woff=_tensor(woff), off=_tensor(off), tile=tile, wsz=wsz, k=k)


def _unique_pairs(s, d):
    """Unique (s, d) pairs sorted by (d, s): (us, ud, multiplicity, rank of
    the pair among its d's pairs)."""
    order = np.lexsort((s, d))
    ss, dd = s[order], d[order]
    new = np.ones(len(ss), bool)
    if len(ss):
        new[1:] = (ss[1:] != ss[:-1]) | (dd[1:] != dd[:-1])
    mult = np.bincount(np.cumsum(new) - 1, minlength=new.sum())
    us, ud = ss[new], dd[new]
    first = np.ones(len(ud), bool)
    if len(ud):
        first[1:] = ud[1:] != ud[:-1]
    starts = np.nonzero(first)[0]
    rank = (np.arange(len(ud)) - starts[np.cumsum(first) - 1] if len(ud)
            else np.zeros(0, np.int64))
    return us, ud, mult.astype(np.float32), rank


def prepare_gather_residual_mean_aggregate(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    *,
    tile: int = TILE,
    k: int = 4,
    r: int | None = None,
    span: int | None = None,
    max_span: int = 16,
    resid_frac: float = 0.02,
) -> tuple[GatherResidualLayout, int]:
    """The gather + compact-residual split for mean aggregation (numpy,
    returned as CPU tensors). ``span=None`` picks the tightest window span
    that keeps the out-of-window share under ``resid_frac``; ``r=None``
    the slot cap of least modelled traffic. Raises ValueError when more
    than ``4 * resid_frac`` of the edges stay in the residual."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    check_edge_range(src, dst, num_nodes)
    nb = pad_nodes(num_nodes, tile) // tile
    nb = ((nb + k - 1) // k) * k
    n_pad = nb * tile
    steps = nb // k
    e = max(len(src), 1)
    sb, db = src // tile, dst // tile

    def window_keep(span_c):
        _, in_f = _choose_windows(sb, db, nb, span_c)
        keep = in_f.copy()
        if keep.any():
            _, in_r = _choose_windows(db[keep], sb[keep], nb, span_c)
            idx = np.nonzero(keep)[0]
            keep[idx[~in_r]] = False
        return keep

    if span is None:
        bo0 = np.arange(nb, dtype=np.int64)
        hi0 = bo0.copy()
        if len(src):
            np.minimum.at(bo0, db, sb)
            np.maximum.at(hi0, db, sb)
        per_edge_span = (hi0 - bo0 + 1)[db] if len(src) else np.array([1])
        cands = sorted(
            {int(np.percentile(per_edge_span, q)) for q in (50, 75, 90, 99)}
            | {min(max_span, int(per_edge_span.max()) if len(src) else 1)})
        cands = [c for c in cands if c <= max_span]
        span = cands[-1]
        for c in cands:  # the tightest window within the residual budget
            if (len(src) - int(window_keep(c).sum())) / e <= resid_frac:
                span = c
                break
    if span > max_span:
        raise ValueError(f"span {span} exceeds max_span={max_span}")
    keep = window_keep(span)

    if r is None:
        # each slot costs n_pad * 8 bytes of codes and mult a direction; each
        # spilled edge's group a [K*T, D] residual slot written and read
        ki = np.nonzero(keep)[0]
        _, ud_p, m_fp, rk_fp = _unique_pairs(src[ki], dst[ki])
        _, ud_rp, m_rp, rk_rp = _unique_pairs(dst[ki], src[ki])
        kt = k * tile
        best_cost = np.inf
        r = 16
        for cap in (2, 3, 4, 6, 8, 12, 16):
            spilled = float(m_fp[rk_fp >= cap].sum() + m_rp[rk_rp >= cap].sum())
            if spilled / e > 2 * resid_frac:
                continue
            mg = (len(np.unique(ud_p[rk_fp >= cap] // kt))
                  + len(np.unique(ud_rp[rk_rp >= cap] // kt)))
            cost = 2 * n_pad * cap * 8 + mg * kt * 128 * 4 * 2
            if cost < best_cost:
                best_cost, r = cost, cap

    kept = _joint_cap(src, dst, keep, r)
    frac = float((len(src) - kept.sum()) / e)
    if frac > 4 * resid_frac:
        raise ValueError(
            f"residual fraction {frac:.4f} at span={span}, r={r} exceeds "
            f"{4 * resid_frac:.4f}: use the banded/dense tiers")

    deg = np.bincount(dst, minlength=n_pad)
    scale = (1.0 / np.maximum(deg, 1)).astype(np.float32).reshape(-1, 1)
    ki = np.nonzero(kept)[0]
    us_f, ud_f, m_f, rk_f = _unique_pairs(src[ki], dst[ki])
    us_r, ud_r, m_r, rk_r = _unique_pairs(dst[ki], src[ki])
    assert (rk_f < r).all() and (rk_r < r).all()
    # windows recomputed on the kept set (the cap can only tighten them)
    bo_f2, in_f2 = _choose_windows(us_f // tile, ud_f // tile, nb, span)
    bo_r2, in_r2 = _choose_windows(us_r // tile, ud_r // tile, nb, span)
    assert in_f2.all() and in_r2.all()
    gf = _build_gather_blocks(us_f, ud_f, m_f, nb, bo_f2, tile=tile, k=k, r=r, span=span)
    gr = _build_gather_blocks(us_r, ud_r, m_r, nb, bo_r2, tile=tile, k=k, r=r, span=span)
    st = _tensor(scale)
    gf = dataclasses.replace(gf, row_scale=st)
    gr = dataclasses.replace(gr, col_scale=st)

    r_src_e, r_dst_e = src[~kept], dst[~kept]
    r_w = (1.0 / np.maximum(deg, 1))[r_dst_e].astype(np.float32)
    row_f, rg_f, of, m_fc = _residual_maps(r_dst_e, k, tile, steps)
    row_r, rg_r, orv, m_rc = _residual_maps(r_src_e, k, tile, steps)
    layout = GatherResidualLayout(
        gather_fwd=gf, gather_rev=gr,
        r_src=_tensor(r_src_e[of].astype(np.int32)), r_row_fwd=_tensor(row_f[of]),
        r_w=_tensor(r_w[of]),
        r_dst=_tensor(r_dst_e[orv].astype(np.int32)), r_row_rev=_tensor(row_r[orv]),
        r_w_rev=_tensor(r_w[orv]),
        rg_fwd=_tensor(rg_f), rg_rev=_tensor(rg_r),
        n_pad=n_pad, m_fwd=m_fc, m_rev=m_rc, resid_frac=frac)
    return layout, n_pad


def _joint_cap(src, dst, kept_mask, r):
    """Drop the unique pairs past rank ``r`` of their destination, then of
    the survivors those past rank ``r`` of their source (numpy)."""
    ki = np.nonzero(kept_mask)[0]
    s, d = src[ki], dst[ki]
    order = np.lexsort((s, d))
    ss, dd = s[order], d[order]
    new = np.ones(len(ss), bool)
    if len(ss):
        new[1:] = (ss[1:] != ss[:-1]) | (dd[1:] != dd[:-1])
    uid = np.cumsum(new) - 1
    ud, us = dd[new], ss[new]
    firstd = np.ones(len(ud), bool)
    if len(ud):
        firstd[1:] = ud[1:] != ud[:-1]
    starts = np.nonzero(firstd)[0]
    rank_f = (np.arange(len(ud)) - starts[np.cumsum(firstd) - 1] if len(ud)
              else np.zeros(0, np.int64))
    drop_pair = rank_f >= r
    alive = ~drop_pair
    o2 = np.lexsort((ud[alive], us[alive]))
    us2 = us[alive][o2]
    firsts = np.ones(len(us2), bool)
    if len(us2):
        firsts[1:] = us2[1:] != us2[:-1]
    st2 = np.nonzero(firsts)[0]
    rank_r = (np.arange(len(us2)) - st2[np.cumsum(firsts) - 1] if len(us2)
              else np.zeros(0, np.int64))
    drop2 = np.zeros(alive.sum(), bool)
    drop2[o2[rank_r >= r]] = True
    drop_pair[np.nonzero(alive)[0][drop2]] = True
    out = kept_mask.copy()
    out[ki[order[drop_pair[uid]]]] = False
    return out


# ------------------------------------------------------------ reference


def _source_rows(blocks: GatherBlocks) -> torch.Tensor:
    """[NB, R, T] absolute source row of every (slot, row)."""
    nb, tile, r = blocks.num_dst_blocks, blocks.tile, blocks.r
    base = blocks.woff.long()[torch.arange(nb, device=blocks.codes.device) // blocks.k] * tile
    codes = blocks.codes[:, : r * tile, 0].reshape(nb, r, tile).long()
    return codes + base[:, None, None]


def spmm_gather_xla(x: torch.Tensor, blocks: GatherBlocks) -> torch.Tensor:
    """The JAX ``spmm_gather_xla``: gathered rows times mult summed over the
    slots in f32, the row scale, the result at x's dtype."""
    nb, tile, r = blocks.num_dst_blocks, blocks.tile, blocks.r
    if blocks.col_scale is not None:
        x = (x.float() * blocks.col_scale).to(x.dtype)
    gathered = x[_source_rows(blocks).reshape(-1)].reshape(nb, r, tile, x.shape[1])
    out = (gathered.float() * blocks.mult.reshape(nb, r, tile)[..., None]).sum(1)
    out = out.reshape(nb * tile, x.shape[1])
    if blocks.row_scale is not None:
        out = out * blocks.row_scale
    return out.to(x.dtype)


# ------------------------------------------------------------ the kernel


def _check(x: torch.Tensor, blocks: GatherBlocks) -> None:
    nb, tile = blocks.num_dst_blocks, blocks.tile
    if blocks.col_scale is not None:
        raise ValueError("spmm_gather takes the forward layout (row_scale); fold the "
                         "column scale into x first")
    if x.dim() != 2 or x.shape[0] != nb * tile:
        raise ValueError(f"x rows {tuple(x.shape)} must be num_dst_blocks * tile = {nb * tile}")


def spmm_gather_plain(x: torch.Tensor, blocks: GatherBlocks) -> torch.Tensor:
    """Plain PyTorch version of ``csrc/spmm_gather.cu``: for every row, the
    slots' ``mult * f32(x row)`` added in slot order from 0, times the row
    scale, at x's dtype. Each step is one f32 multiply and one f32 add, as
    in the kernel, so the two agree bit for bit."""
    _check(x, blocks)
    nb, tile, r, d = blocks.num_dst_blocks, blocks.tile, blocks.r, x.shape[1]
    rows = _source_rows(blocks)
    mult = blocks.mult.reshape(nb, r, tile, 1)
    acc = x.new_zeros((nb, tile, d), dtype=torch.float32)
    for j in range(r):
        acc = acc + mult[:, j] * x[rows[:, j].reshape(-1)].float().reshape(nb, tile, d)
    out = acc.reshape(nb * tile, d)
    if blocks.row_scale is not None:
        out = out * blocks.row_scale
    return out.to(x.dtype)


def spmm_gather(x: torch.Tensor, blocks: GatherBlocks) -> torch.Tensor:
    """:func:`spmm_gather_plain`'s function: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return spmm_gather_plain(x, blocks)
    _check(x, blocks)
    nb, tile, r = blocks.num_dst_blocks, blocks.tile, blocks.r
    n, d = x.shape
    if x.device.type != "cuda":
        raise ValueError(f"spmm_gather runs on CUDA or CPU tensors, got {x.device}")
    if blocks.codes.device != x.device:
        raise ValueError(f"spmm_gather: the layout must be on {x.device} (GatherBlocks.to)")
    if x.dtype not in (torch.float32, BF16) or d > 128 or not x.is_contiguous():
        raise ValueError(f"spmm_gather: x must be contiguous float32 or bfloat16 with D <= 128, "
                         f"got {x.dtype} D={d}")
    if nb % blocks.k:
        raise ValueError(f"spmm_gather: {nb} blocks is not a multiple of k={blocks.k}")
    codes = blocks.codes.to(torch.int32).contiguous()
    mult = blocks.mult.float().contiguous()
    woff = blocks.woff.to(torch.int32).contiguous()
    out = torch.empty_like(x)
    from . import _build

    lib = _build.load()
    with torch.cuda.device(x.device):
        code = lib.spmm_gather_launch(
            codes.data_ptr(), codes.shape[1], mult.data_ptr(), woff.data_ptr(), nb, tile,
            blocks.k, r, x.data_ptr(), int(x.dtype == BF16), d,
            scale_ptr(blocks.row_scale, n, x.device), out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, f"spmm_gather kernel (nb={nb}, R={r}, tile={tile}, D={d})")
    spmm_gather.launches += 1
    return out


spmm_gather.launches = 0


# ------------------------------------------------------------ autograd


def _dispatch(x, blocks, use_pallas):
    if use_pallas:
        if blocks.col_scale is not None:
            # the reverse layout: fold the scale into x, as the JAX dispatch does
            x = (x.float() * blocks.col_scale).to(x.dtype)
            blocks = dataclasses.replace(blocks, col_scale=None)
        return spmm_gather(x.contiguous(), blocks)
    return spmm_gather_xla(x, blocks)


class _GatherResidFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, layout, use_pallas):
        ctx.layout, ctx.use_pallas = layout, use_pallas
        out = _dispatch(x, layout.gather_fwd, use_pallas)
        return _expand_compact(out, residual_fwd_compact(x, layout), layout.rg_fwd)

    @staticmethod
    def backward(ctx, g):
        layout = ctx.layout
        g = g.contiguous()
        t = _dispatch(g, layout.gather_rev, ctx.use_pallas)
        return _expand_compact(t, residual_rev_compact(g, layout), layout.rg_rev), None, None


def spmm_gather_residual_apply(x: torch.Tensor, layout: GatherResidualLayout,
                               use_pallas: bool) -> torch.Tensor:
    """Exact mean aggregation: the gather part plus the compact residual;
    the backward runs the reverse gather layout plus the reverse residual."""
    return _GatherResidFn.apply(x, layout, use_pallas)
