"""Node-sharded edge partitioning with a boundary-row exchange: the host
planners.

Port of the planners of ``sldm_gnn_tpu/parallel/halo.py``. Each of ``ep``
shards owns a contiguous range of ``n_local`` nodes and the edges whose
destinations it owns. Sources on other shards ("halo" rows) come from one
exchange of exactly the rows each ordered pair of shards needs, padded to
the largest pair ``H``:

  1. :func:`plan_halo_partition` finds, for every pair (q -> p), the unique
     source rows p needs from q (``send_idx``), and remaps each shard's
     edges into the table ``[n_local + ep * H]`` of its own rows then the
     received ones;
  2. :func:`split_halo_plan` splits each shard's edges into interior ones
     (source owned by the shard) and boundary ones (source in the received
     halo table ``[ep * H]``);
  3. :func:`plan_banded_interior` lays the interior edges out as stacked
     banded layouts (:class:`~..ops.spmm_banded.BandedBlocks` with a
     leading ``ep`` axis) with the global graph's full-degree scales.

The plans are numpy work on the host; their arrays are CPU tensors, equal
to the JAX planners'. The per-shard layers that consume them are
:mod:`.halo_fused`.

Left for the slice that ports the collectives: the exchange itself (an
all-to-all on ``torch.distributed``), ``halo_aggregate*``,
``make_halo_*_step``, ``HaloBlockedPlan`` and ``plan_halo_blocked``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.spmm_banded import BandedBlocks, build_banded_counts


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


@dataclass(frozen=True)
class HaloPlan:
    """Stacked per-shard arrays (leading dim ``ep``):

    send_idx  [ep, ep, H] int32   rows shard p sends to shard q (local rows
                                  of p's shard; padded with 0)
    src_local [ep, E_max] int32   edge source in the table [n_local + ep*H]
    dst_local [ep, E_max] int32   edge destination (local row); padding
                                  edges point at n_local
    weight    [ep, E_max] float32 per-edge weight (0 on padding)
    """

    send_idx: torch.Tensor
    src_local: torch.Tensor
    dst_local: torch.Tensor
    weight: torch.Tensor

    @property
    def ep(self) -> int:
        return self.send_idx.shape[0]

    @property
    def halo_size(self) -> int:
        return self.send_idx.shape[2]


def plan_halo_partition(src: np.ndarray, dst: np.ndarray, num_nodes: int, ep: int, *,
                        weight: np.ndarray | None = None,
                        mean: bool = True) -> tuple[HaloPlan, int]:
    """The exchange plan; returns ``(plan, n_local)`` with ``n_local`` the
    per-shard node count (``num_nodes`` padded to ``ep * n_local``).
    ``weight`` defaults to the mean's 1/deg(dst) (``mean``) or ones."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    n_local = (num_nodes + ep - 1) // ep
    if weight is None:
        if mean:
            deg = np.bincount(dst, minlength=num_nodes)
            weight = (1.0 / np.maximum(deg, 1))[dst].astype(np.float32)
        else:
            weight = np.ones(len(src), np.float32)
    weight = np.asarray(weight, np.float32)

    owner_dst = dst // n_local
    owner_src = src // n_local
    edges_p = [np.nonzero(owner_dst == p)[0] for p in range(ep)]
    e_max = max(max((len(e) for e in edges_p), default=1), 1)

    # need[p][q]: the sorted unique global sources p needs from q
    need = [[np.zeros(0, np.int64) if q == p
             else np.unique(src[edges_p[p]][owner_src[edges_p[p]] == q])
             for q in range(ep)] for p in range(ep)]
    h_max = max(max((len(need[p][q]) for p in range(ep) for q in range(ep)), default=1), 1)

    send_idx = np.zeros((ep, ep, h_max), np.int32)
    for q in range(ep):
        for p in range(ep):
            ids = need[p][q]
            send_idx[q, p, : len(ids)] = (ids - q * n_local).astype(np.int32)

    src_local = np.zeros((ep, e_max), np.int32)
    dst_local = np.full((ep, e_max), n_local, np.int32)  # padding -> dropped
    w_arr = np.zeros((ep, e_max), np.float32)
    for p in range(ep):
        es = edges_p[p]
        s, d = src[es], dst[es]
        remapped = np.empty(len(es), np.int64)
        local = owner_src[es] == p
        remapped[local] = s[local] - p * n_local
        for q in range(ep):
            m = owner_src[es] == q
            if q == p or not m.any():
                continue
            remapped[m] = n_local + q * h_max + np.searchsorted(need[p][q], s[m])
        src_local[p, : len(es)] = remapped
        dst_local[p, : len(es)] = d - p * n_local
        w_arr[p, : len(es)] = weight[es]

    plan = HaloPlan(send_idx=_tensor(send_idx), src_local=_tensor(src_local),
                    dst_local=_tensor(dst_local), weight=_tensor(w_arr))
    return plan, n_local


@dataclass(frozen=True)
class HaloPlanSplit:
    """Interior/boundary split of a :class:`HaloPlan` (stacked, leading dim
    ``ep``; each list padded to its largest shard):

    send_idx [ep, ep, H]     as :class:`HaloPlan`
    int_src  [ep, Ei] int32  interior sources (local rows)
    int_dst  [ep, Ei] int32  interior destinations; padding -> n_local
    int_w    [ep, Ei] f32    interior weights (0 on padding)
    hal_src  [ep, Eh] int32  boundary sources, rows of the received halo
                             table [ep * H] (q * H + pos)
    hal_dst  [ep, Eh] int32  boundary destinations; padding -> n_local
    hal_w    [ep, Eh] f32    boundary weights (0 on padding)
    """

    send_idx: torch.Tensor
    int_src: torch.Tensor
    int_dst: torch.Tensor
    int_w: torch.Tensor
    hal_src: torch.Tensor
    hal_dst: torch.Tensor
    hal_w: torch.Tensor

    @property
    def ep(self) -> int:
        return self.send_idx.shape[0]


def split_halo_plan(plan: HaloPlan, n_local: int) -> HaloPlanSplit:
    """Split a :class:`HaloPlan` into interior and boundary edge lists."""
    ep = plan.send_idx.shape[0]
    src = plan.src_local.numpy()
    dst = plan.dst_local.numpy()
    w = plan.weight.numpy()
    interior = [np.nonzero((src[p] < n_local) & (dst[p] < n_local))[0] for p in range(ep)]
    boundary = [np.nonzero((src[p] >= n_local) & (dst[p] < n_local))[0] for p in range(ep)]
    ei = max(max((len(e) for e in interior), default=1), 1)
    eh = max(max((len(e) for e in boundary), default=1), 1)

    int_src = np.zeros((ep, ei), np.int32)
    int_dst = np.full((ep, ei), n_local, np.int32)
    int_w = np.zeros((ep, ei), np.float32)
    hal_src = np.zeros((ep, eh), np.int32)
    hal_dst = np.full((ep, eh), n_local, np.int32)
    hal_w = np.zeros((ep, eh), np.float32)
    for p in range(ep):
        ii, bb = interior[p], boundary[p]
        int_src[p, : len(ii)] = src[p][ii]
        int_dst[p, : len(ii)] = dst[p][ii]
        int_w[p, : len(ii)] = w[p][ii]
        hal_src[p, : len(bb)] = src[p][bb] - n_local  # rows of the [ep * H] halo table
        hal_dst[p, : len(bb)] = dst[p][bb]
        hal_w[p, : len(bb)] = w[p][bb]
    return HaloPlanSplit(send_idx=plan.send_idx, int_src=_tensor(int_src),
                         int_dst=_tensor(int_dst), int_w=_tensor(int_w),
                         hal_src=_tensor(hal_src), hal_dst=_tensor(hal_dst),
                         hal_w=_tensor(hal_w))


def stack_blocks(blocks: list[BandedBlocks], **kw) -> BandedBlocks:
    """Per-shard layouts of one shape -> one :class:`BandedBlocks` whose
    tensors have a leading shard axis (``kw`` replaces fields)."""
    stack = lambda name: torch.stack([getattr(b, name) for b in blocks])
    b0 = blocks[0]
    return dataclasses.replace(b0, a=stack("a"), bo=stack("bo"), woff=stack("woff"),
                               off=stack("off"), **kw)


def shard_blocks(stacked: BandedBlocks, p: int) -> BandedBlocks:
    """Shard ``p``'s layout of a stacked :class:`BandedBlocks`."""
    take = lambda t: None if t is None else t[p]
    return dataclasses.replace(stacked, a=stacked.a[p], bo=stacked.bo[p],
                               woff=stacked.woff[p], off=stacked.off[p],
                               row_scale=take(stacked.row_scale),
                               col_scale=take(stacked.col_scale), cmap=take(stacked.cmap))


def plan_banded_interior(split: HaloPlanSplit, dst: np.ndarray, n_local: int, n_pad_local: int,
                         *, mean: bool = True, tile: int, banded_k: int, banded_max_span: int,
                         keep_masks=None):
    """Stacked per-shard banded layouts of the interior edges of a halo
    split: ``(int_fwd, int_rev, n_pad_local)``, int8 count tiles with the
    global graph's full-degree row (forward) and column (reverse) scales,
    every shard at one common ``s_span`` and ``wsz``. Raises ValueError when
    a shard's interior span exceeds ``banded_max_span``. ``keep_masks``:
    per-shard masks over each shard's valid interior edges; the edges masked
    out stay out of the layouts (:mod:`.halo_fused` spills them into its
    compact residual)."""
    ep = split.ep
    nbl = n_pad_local // tile
    nbl = ((nbl + banded_k - 1) // banded_k) * banded_k
    n_pad_local = nbl * tile
    deg = np.bincount(np.asarray(dst, np.int64), minlength=ep * n_local)
    inv = ((1.0 / np.maximum(deg, 1)) if mean else np.ones(ep * n_local)).astype(np.float32)

    edges = []
    for p in range(ep):
        mi = split.int_w[p].numpy() > 0
        isrc = split.int_src[p].numpy()[mi].astype(np.int64)
        idst = split.int_dst[p].numpy()[mi].astype(np.int64)
        if keep_masks is not None:
            isrc, idst = isrc[keep_masks[p]], idst[keep_masks[p]]
        edges.append((isrc, idst))

    def span_bounds(s, d_):
        bo = np.arange(nbl, dtype=np.int64)
        hi = bo.copy()
        if len(s):
            np.minimum.at(bo, d_ // tile, s // tile)
            np.maximum.at(hi, d_ // tile, s // tile)
        return bo, hi

    # the common (s_span, wsz) from per-block source bounds, so that every
    # adjacency fill runs once with the floors forced
    bounds = [span_bounds(*pair) for p in range(ep) for pair in (edges[p], edges[p][::-1])]
    s_common = max(int((hi - bo + 1).max()) for bo, hi in bounds)
    if s_common > banded_max_span:
        raise ValueError(f"source span {s_common} tiles exceeds max_span={banded_max_span}: "
                         "shard interiors are not banded")
    w_common = 0
    for bo, _ in bounds:
        base = np.minimum(bo, max(nbl - s_common, 0)).reshape(-1, banded_k)
        spread = int((base.max(axis=1) - base.min(axis=1)).max()) if len(base) else 0
        w_common = max(w_common, spread + s_common)

    built = [tuple(build_banded_counts(s, d_, n_pad_local, tile=tile, k=banded_k,
                                       max_span=banded_max_span, s_span_min=s_common,
                                       wsz_min=w_common)
                   for s, d_ in (pair, pair[::-1]))
             for pair in edges]
    assert len({b.s_span for t in built for b in t}) == 1
    assert len({b.wsz for t in built for b in t}) == 1
    scale = np.zeros((ep, n_pad_local, 1), np.float32)
    for p in range(ep):
        scale[p, :n_local, 0] = inv[p * n_local: (p + 1) * n_local]
    scale = _tensor(scale)
    return (stack_blocks([b[0] for b in built], row_scale=scale),
            stack_blocks([b[1] for b in built], col_scale=scale), n_pad_local)
