"""Banded SpMM with a compact residual for near-banded graphs.

Port of ``sldm_gnn_tpu/ops/banded_residual.py``. The host splits the edges
once: edges inside a per-destination-block window of ``span`` tiles go to
the banded layouts (:mod:`.spmm_banded`), the few others to a compact
residual whose aggregate ``[m, K*T, D]`` (one slot per group of K blocks
that holds a residual destination; slot 0 is zeros) the fused kernels add
to the groups with ``rg > 0``. The compact residual is a gather plus a
sorted segment sum in JAX, with no Pallas kernel; here it is
``index_add_``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..graph.csr import TILE, check_edge_range, pad_nodes
from .sage_fused import _expand_compact, banded_sage_apply, banded_sage_ln_apply
from .spmm_banded import BandedBlocks, _tensor, build_banded_counts, spmm_banded_apply


@dataclass(frozen=True)
class BandedResidualLayout:
    """Banded layouts (span-bounded) and the compact residual COO.

    Edge e (src -> dst) adds ``w[e] * x[src[e]]`` to row ``r_row_fwd[e]``
    of the compact forward residual and ``w[e] * g[dst[e]]`` to row
    ``r_row_rev[e]`` of the reverse one; ``rg_fwd/rg_rev [steps]`` map each
    group to its slot (0: none). ``r_w`` is the full-degree 1/deg(dst).
    """

    banded_fwd: BandedBlocks
    banded_rev: BandedBlocks
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
        return self.banded_fwd.k * self.banded_fwd.tile

    @property
    def steps(self) -> int:
        return self.n_pad // self.group_rows

    # the compact residual as the fused layers of ops/sage_fused add it
    def compact_fwd(self, x: torch.Tensor) -> torch.Tensor:
        return residual_fwd_compact(x, self)

    def compact_rev(self, g: torch.Tensor, *, gathered: bool = False) -> torch.Tensor:
        return residual_rev_compact(g, self, gathered=gathered)

    def to(self, device) -> "BandedResidualLayout":
        kw = {f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)
              if isinstance(getattr(self, f.name), (torch.Tensor, BandedBlocks))}
        return dataclasses.replace(self, **kw)


def _choose_windows(sb: np.ndarray, db: np.ndarray, nb: int, span: int):
    """Per-destination-block source window base covering the most edges;
    returns ``(bo, in_band)`` (the per-edge coverage mask)."""
    bo = np.arange(nb, dtype=np.int64)
    hi = bo.copy()
    if len(sb):
        np.minimum.at(bo, db, sb)
        np.maximum.at(hi, db, sb)
    over = np.nonzero(hi - bo + 1 > span)[0]
    if len(over):
        order = np.lexsort((sb, db))
        dbs, sbs = db[order], sb[order]
        starts = np.searchsorted(dbs, over)
        ends = np.searchsorted(dbs, over + 1)
        for b, s0, s1 in zip(over, starts, ends):
            v = sbs[s0:s1]
            lo = np.searchsorted(v, v - span + 1, side="left")
            cnt = np.arange(1, len(v) + 1) - lo
            i = int(np.argmax(cnt))
            bo[b] = min(max(int(v[i]) - span + 1, 0), max(nb - span, 0))
    in_band = (sb >= bo[db]) & (sb < bo[db] + span) if len(sb) else np.zeros(0, bool)
    return bo, in_band


def _residual_maps(nodes_r: np.ndarray, k: int, tile: int, steps: int):
    """Compact slot assignment for one direction's residual rows: (rows
    [Er], rg [steps], order [Er] sorting the edges by row, m)."""
    kt = k * tile
    grp = nodes_r // kt
    uniq = np.unique(grp)
    rg = np.zeros(steps, np.int32)
    rg[uniq] = np.arange(1, len(uniq) + 1, dtype=np.int32)
    rows = rg[grp].astype(np.int64) * kt + (nodes_r - grp * kt)
    order = np.argsort(rows, kind="stable")
    return rows.astype(np.int32), rg, order, len(uniq) + 1


def cap_multiplicity(src: np.ndarray, dst: np.ndarray, keep: np.ndarray,
                     cap: int) -> np.ndarray:
    """Spill the copies of a (src, dst) pair beyond ``cap`` out of ``keep``
    (in place; returned), so that the count tiles stay within ``cap``."""
    kept_idx = np.nonzero(keep)[0]
    s_in0, d_in0 = src[kept_idx], dst[kept_idx]
    order = np.lexsort((s_in0, d_in0))
    ss, dd = s_in0[order], d_in0[order]
    new = np.ones(len(ss), bool)
    new[1:] = (ss[1:] != ss[:-1]) | (dd[1:] != dd[:-1])
    run_id = np.cumsum(new) - 1
    first = np.nonzero(new)[0]
    within = np.arange(len(ss)) - first[run_id]
    drop = within >= cap
    if drop.any():
        keep[kept_idx[order[drop]]] = False
    return keep


def split_banded_residual(src: np.ndarray, dst: np.ndarray, nb: int, *, tile: int = TILE,
                          span: int = 8) -> np.ndarray:
    """In-band mask for ``span``: forward windows over all edges, then
    reverse windows over the forward survivors."""
    db = np.asarray(dst, np.int64) // tile
    sb = np.asarray(src, np.int64) // tile
    _, in_f = _choose_windows(sb, db, nb, span)
    keep = in_f.copy()
    if keep.any():
        _, in_r = _choose_windows(db[keep], sb[keep], nb, span)
        idx = np.nonzero(keep)[0]
        keep[idx[~in_r]] = False
    return keep


def prepare_banded_residual_mean_aggregate(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    *,
    tile: int = TILE,
    k: int = 4,
    span: int | None = None,
    max_span: int = 16,
    resid_frac: float = 0.005,
    count_cap: int | None = None,
) -> tuple[BandedResidualLayout, int]:
    """The span-bounded banded + compact-residual split for mean
    aggregation (int8 count tiles, full-degree scales). ``span=None`` picks
    the candidate span with the least modelled traffic; ``count_cap``
    spills edge multiplicity beyond the cap into the residual. Raises
    ValueError when more than ``4 * resid_frac`` of the edges stay out of
    the band."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    check_edge_range(src, dst, num_nodes)
    nb = pad_nodes(num_nodes, tile) // tile
    nb = ((nb + k - 1) // k) * k
    n_pad = nb * tile
    steps = nb // k
    e = max(len(src), 1)
    feat_dim_hint = 128  # nominal D for the traffic model (relative choice)

    if span is None:
        db = dst // tile
        bo = np.arange(nb, dtype=np.int64)
        hi = bo.copy()
        if len(src):
            np.minimum.at(bo, db, src // tile)
            np.maximum.at(hi, db, src // tile)
        per_edge_span = (hi - bo + 1)[db] if len(src) else np.array([1])
        cands = sorted(
            {int(np.percentile(per_edge_span, q)) for q in (50, 75, 90, 99)} | {max_span})
        cands = [c for c in cands if c <= max_span]
        best_cost = np.inf
        span = cands[-1]
        kt = k * tile
        for c in cands:
            keep_c = split_banded_residual(src, dst, nb, tile=tile, span=c)
            er = len(src) - int(keep_c.sum())
            if er / e > 4 * resid_frac:
                continue
            rs, rd = src[~keep_c], dst[~keep_c]
            m = len(np.unique(rd // kt)) + len(np.unique(rs // kt))
            cost = 2 * nb * c * tile * tile + 2 * m * kt * feat_dim_hint * 2
            if cost < best_cost:
                best_cost, span = cost, c

    keep = split_banded_residual(src, dst, nb, tile=tile, span=span)
    frac = float((len(src) - keep.sum()) / e)
    if frac > 4 * resid_frac:
        raise ValueError(
            f"residual fraction {frac:.4f} at span={span} exceeds "
            f"{4 * resid_frac:.4f}: graph is not near-banded — use the "
            "dense/hybrid backends")
    if count_cap is not None and keep.any():
        keep = cap_multiplicity(src, dst, keep, count_cap)
        frac = float((len(src) - keep.sum()) / e)
        if frac > 4 * resid_frac:
            raise ValueError(
                f"residual fraction {frac:.4f} after count_cap={count_cap} "
                f"multiplicity spill exceeds {4 * resid_frac:.4f}: graph has "
                "too much edge multiplicity for the near-banded tier — use "
                "the dense/hybrid backends")

    s_in, d_in = src[keep], dst[keep]
    fwd = build_banded_counts(s_in, d_in, num_nodes, tile=tile, k=k, max_span=span)
    rev = build_banded_counts(d_in, s_in, num_nodes, tile=tile, k=k, max_span=span)
    assert fwd.num_dst_blocks == nb, (fwd.num_dst_blocks, nb)
    # full degree (banded + residual edges): the two halves sum to the mean
    deg = np.bincount(dst, minlength=n_pad)
    scale = _tensor((1.0 / np.maximum(deg, 1)).astype(np.float32).reshape(-1, 1))
    fwd = dataclasses.replace(fwd, row_scale=scale)
    rev = dataclasses.replace(rev, col_scale=scale)

    r_src = src[~keep]
    r_dst = dst[~keep]
    r_w = (1.0 / np.maximum(deg, 1))[r_dst].astype(np.float32)
    row_f, rg_f, of, m_f = _residual_maps(r_dst, k, tile, steps)
    row_r, rg_r, orv, m_r = _residual_maps(r_src, k, tile, steps)

    layout = BandedResidualLayout(
        banded_fwd=fwd, banded_rev=rev,
        r_src=_tensor(r_src[of].astype(np.int32)), r_row_fwd=_tensor(row_f[of]),
        r_w=_tensor(r_w[of]),
        r_dst=_tensor(r_dst[orv].astype(np.int32)), r_row_rev=_tensor(row_r[orv]),
        r_w_rev=_tensor(r_w[orv]),
        rg_fwd=_tensor(rg_f), rg_rev=_tensor(rg_r),
        n_pad=n_pad, m_fwd=m_f, m_rev=m_r, resid_frac=frac,
    )
    return layout, n_pad


# ------------------------------------------------------------- apply paths


def _compact(msgs: torch.Tensor, rows: torch.Tensor, m: int, kt: int) -> torch.Tensor:
    out = msgs.new_zeros((m * kt, msgs.shape[1]))
    out.index_add_(0, rows.long(), msgs)
    return out.reshape(m, kt, msgs.shape[1])


def residual_fwd_compact(x: torch.Tensor, layout: BandedResidualLayout) -> torch.Tensor:
    """Compact forward residual aggregate ``[m_fwd, K*T, D]`` f32 (slot 0
    zeros)."""
    msgs = x[layout.r_src.long()].float() * layout.r_w[:, None]
    return _compact(msgs, layout.r_row_fwd, layout.m_fwd, layout.group_rows)


def residual_rev_compact(g: torch.Tensor, layout: BandedResidualLayout, *,
                         gathered: bool = False) -> torch.Tensor:
    """Compact reverse residual (``R^T g`` rows) ``[m_rev, K*T, H]`` f32.
    ``gathered``: ``g`` holds only the rows ``layout.r_dst``, in order."""
    msgs = (g if gathered else g[layout.r_dst.long()]).float() * layout.r_w_rev[:, None]
    return _compact(msgs, layout.r_row_rev, layout.m_rev, layout.group_rows)


class _ResidAggFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, layout, use_pallas):
        ctx.layout, ctx.use_pallas = layout, use_pallas
        out = spmm_banded_apply(x, layout.banded_fwd, layout.banded_rev, use_pallas)
        return _expand_compact(out, residual_fwd_compact(x, layout), layout.rg_fwd)

    @staticmethod
    def backward(ctx, g):
        layout = ctx.layout
        g = g.contiguous()
        t = spmm_banded_apply(g, layout.banded_rev, layout.banded_fwd, ctx.use_pallas)
        return _expand_compact(t, residual_rev_compact(g, layout), layout.rg_rev), None, None


def spmm_banded_residual_apply(x: torch.Tensor, layout: BandedResidualLayout,
                               use_pallas: bool) -> torch.Tensor:
    """Mean aggregation = banded part + expanded residual; the backward
    runs the reverse banded layout plus the reverse residual."""
    return _ResidAggFn.apply(x, layout, use_pallas)


def banded_residual_sage_apply(x, wl, wr, bias, layout: BandedResidualLayout,
                               use_pallas: bool, negative_slope: float | None = None):
    """Differentiable fused SAGE layer over the banded + residual split:
    ``act((B + R) x Wl + x Wr + bias)``, the compact residual added inside
    the fused kernels."""
    return banded_sage_apply(x, wl, wr, bias, layout.banded_fwd, layout.banded_rev, use_pallas,
                             negative_slope, resid=layout)


def banded_residual_sage_ln_apply(x, wl, wr, bias, gamma, beta, layout: BandedResidualLayout,
                                  use_pallas: bool, negative_slope: float | None = None,
                                  eps: float = 1e-5):
    """``act(LN((B + R) x Wl + x Wr + bias))``, one fused kernel each way."""
    return banded_sage_ln_apply(x, wl, wr, bias, gamma, beta, layout.banded_fwd,
                                layout.banded_rev, use_pallas, negative_slope, eps, resid=layout)
