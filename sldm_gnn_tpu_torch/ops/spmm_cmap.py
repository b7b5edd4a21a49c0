"""Column-tile-indirect banded layouts (``cmap`` slots): the low-degree tier.

Port of ``sldm_gnn_tpu/ops/spmm_cmap.py``. A banded layout gives every
destination block a contiguous band of ``s_span`` source tiles; here each
block keeps its C most-populated source tiles as an arbitrary set, and
``BandedBlocks.cmap [NB * C]`` maps slot s of block b to the window tile
``woff[b // K] + cmap[b * C + s]``. Everything downstream is the banded
tier's: the CUDA kernels (``csrc/spmm_banded.cu``, ``sage_fused_fwd.cu``,
``sage_fused_bwd.cu``) and their plain versions read the slot's tile
through ``cmap`` when the layout has one, and the layouts are ordinary
:class:`~.spmm_banded.BandedBlocks` inside a
:class:`~.banded_residual.BandedResidualLayout`. Edges outside the kept
tile sets (either direction) spill into the compact residual with
full-degree weights, so the mean stays exact.

The builders are numpy on the host; their arrays equal the JAX
package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..graph.csr import TILE, check_edge_range, pad_nodes
from .banded_residual import (BandedResidualLayout, _choose_windows, _residual_maps,
                              cap_multiplicity)
from .spmm_banded import BandedBlocks, _tensor


def _select_tiles(src: np.ndarray, dst: np.ndarray, nb: int, tile: int, c: int,
                  range_budget: int):
    """Per destination block: the densest width-``range_budget`` source-tile
    window, then the C most-populated source tiles inside it. Returns
    ``(keep [E] bool, kept_abs [nb, c] int64)``: source-tile ids sorted
    ascending, the sentinel ``nb`` in empty slots."""
    db = dst // tile
    sb = src // tile
    _, in_win = _choose_windows(sb, db, nb, range_budget)
    kept_abs = np.full((nb, c), nb, np.int64)
    keep = np.zeros(len(src), bool)
    if not in_win.any():
        return keep, kept_abs
    iw = np.nonzero(in_win)[0]
    pair = db[iw] * np.int64(nb) + sb[iw]
    uniq, inv, cnt = np.unique(pair, return_inverse=True, return_counts=True)
    updb = uniq // nb
    upsb = uniq % nb
    # per block: tiles by descending edge count (ties -> lower tile id)
    order = np.lexsort((upsb, -cnt, updb))
    updb_o = updb[order]
    first = np.searchsorted(updb_o, np.arange(nb), "left")
    rank = np.arange(len(order)) - first[updb_o]
    sel = rank < c
    kept_abs[updb_o[sel], rank[sel]] = upsb[order[sel]]
    kept_abs.sort(axis=1)
    kept_pair = np.zeros(len(uniq), bool)
    kept_pair[order[sel]] = True
    keep[iw] = kept_pair[inv.reshape(-1)]
    return keep, kept_abs


def _fill_cmap_counts(src: np.ndarray, dst: np.ndarray, kept_abs: np.ndarray, nb: int,
                      tile: int, k: int) -> BandedBlocks:
    """int8 count tiles and window metadata for a kept edge set whose source
    tiles all appear in ``kept_abs``'s rows."""
    c = kept_abs.shape[1]
    db = dst // tile
    sb = src // tile
    slot = (kept_abs[db] < sb[:, None]).sum(axis=1) if len(src) else np.zeros(0, np.int64)
    if len(src) and not (kept_abs[db, np.minimum(slot, c - 1)] == sb).all():
        raise ValueError("an edge's source tile is missing from its block's kept set")
    a = np.zeros((nb, c, tile, tile), np.float32)
    if len(src):
        np.add.at(a, (db, slot, dst - db * tile, src - sb * tile), 1.0)
    cmax = int(a.max()) if a.size else 0
    if cmax > 127:
        raise ValueError(f"edge multiplicity {cmax} overflows int8 counts")

    own = np.arange(nb, dtype=np.int64)
    valid = kept_abs < nb
    lo = np.where(valid[:, 0], np.minimum(kept_abs[:, 0], own), own)
    hi = np.maximum(np.where(valid, kept_abs, -1).max(axis=1), own)
    steps = nb // k
    woff = lo.reshape(steps, k).min(axis=1)
    wsz = int((hi.reshape(steps, k).max(axis=1) - woff).max()) + 1
    woff = np.minimum(woff, max(nb - wsz, 0))
    off = (lo.reshape(steps, k) - woff[:, None]).reshape(-1)
    # window-relative slot map; empty slots point at tile 0 of the window
    # (their count tiles are all zero, so the read contributes nothing)
    cmap = np.where(valid, kept_abs - np.repeat(woff, k)[:, None], 0)
    if cmap.min(initial=0) < 0 or cmap.max(initial=0) >= wsz:
        raise ValueError(f"cmap outside its window ({cmap.min()}..{cmap.max()}, wsz {wsz})")
    return BandedBlocks(a=_tensor(a.astype(np.int8)), bo=_tensor(lo.astype(np.int32)),
                        woff=_tensor(woff.astype(np.int32)), off=_tensor(off.astype(np.int32)),
                        cmap=_tensor(cmap.reshape(-1).astype(np.int32)), tile=tile, wsz=wsz,
                        k=k)


def prepare_cmap_residual_mean_aggregate(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    *,
    tile: int = TILE,
    k: int = 4,
    c: int | None = None,
    range_budget: int = 32,
    resid_frac: float = 0.005,
    count_cap: int | None = None,
) -> tuple[BandedResidualLayout, int]:
    """``cmap`` layouts plus the compact residual for exact mean aggregation
    (int8 counts, full-degree scales): a drop-in for
    :func:`~.banded_residual.prepare_banded_residual_mean_aggregate` on
    low-degree graphs. ``c=None`` tries the 50/75/90/99th percentiles of
    the per-block distinct source-tile counts (both directions) and keeps
    the smallest whose spilled fraction stays within ``resid_frac``;
    ``range_budget`` bounds each block's candidate tile window. Raises
    ValueError when more than ``4 * resid_frac`` of the edges spill."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    check_edge_range(src, dst, num_nodes)
    nb = pad_nodes(num_nodes, tile) // tile
    nb = ((nb + k - 1) // k) * k
    n_pad = nb * tile
    steps = nb // k
    e = max(len(src), 1)

    if c is None:
        nz_all = []
        for a_, b_ in ((src, dst), (dst, src)):
            pair = np.unique((b_ // tile) * np.int64(nb) + a_ // tile)
            per_blk = np.bincount((pair // nb).astype(np.int64), minlength=nb)
            nz_all.append(per_blk[per_blk > 0])
        nz = np.concatenate(nz_all) if any(len(z) for z in nz_all) else np.array([1])
        cands = sorted({int(np.percentile(nz, q)) for q in (50, 75, 90, 99)} | {int(nz.max())})
        c = cands[-1]
        for cc in cands:
            k1, _ = _select_tiles(src, dst, nb, tile, cc, range_budget)
            i1 = np.nonzero(k1)[0]
            k2, _ = _select_tiles(dst[i1], src[i1], nb, tile, cc, range_budget)
            if (e - int(k2.sum())) / e <= resid_frac:
                c = cc
                break

    keep, kept_fwd = _select_tiles(src, dst, nb, tile, c, range_budget)
    i1 = np.nonzero(keep)[0]
    keep2, kept_rev = _select_tiles(dst[i1], src[i1], nb, tile, c, range_budget)
    keep[i1[~keep2]] = False
    if count_cap is not None and keep.any():
        keep = cap_multiplicity(src, dst, keep, count_cap)
    frac = float((e - keep.sum()) / e)
    if frac > 4 * resid_frac:
        raise ValueError(
            f"residual fraction {frac:.4f} at c={c} exceeds {4 * resid_frac:.4f}: raise "
            "c/range_budget or use the banded/dense tiers")

    s_in, d_in = src[keep], dst[keep]
    fwd = _fill_cmap_counts(s_in, d_in, kept_fwd, nb, tile, k)
    rev = _fill_cmap_counts(d_in, s_in, kept_rev, nb, tile, k)
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
