"""Bandwidth-reducing node orders (Cuthill-McKee, reverse Cuthill-McKee,
Hilbert curve), in numpy.

Port of ``sldm_gnn_tpu/graph/reorder.py``; every function returns the
same permutation as the JAX package's on the same input. The banded
layouts need every destination block's sources in a narrow band of
source blocks, that is nodes numbered in spatial order; graphs read in
file order are not. :func:`reorder_for_banding` finds an order under
which the graph is banded, or raises.

Convention: ``perm[new_id] = old_id`` and ``inv[old_id] = new_id``.
Relabel the edges with ``inv[src], inv[dst]``, permute the node features
once on the host (``x[perm]``) and run the whole model in the new order.
"""

from __future__ import annotations

import numpy as np

from .csr import TILE


def _to_csr(src: np.ndarray, dst: np.ndarray, num_nodes: int):
    """Undirected CSR (both directions): bandwidth is symmetric."""
    u = np.concatenate([src, dst])
    v = np.concatenate([dst, src])
    order = np.argsort(u, kind="stable")
    u, v = u[order], v[order]
    indptr = np.zeros(num_nodes + 1, np.int64)
    np.add.at(indptr, u + 1, 1)
    np.cumsum(indptr, out=indptr)
    return indptr, v


def _gather_neighbors(indptr, indices, frontier):
    """The adjacency lists of ``frontier``, concatenated in order, and the
    frontier position of each entry's parent."""
    starts = indptr[frontier]
    counts = indptr[frontier + 1] - starts
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, indices.dtype), np.zeros(0, np.int64)
    offs = np.repeat(np.cumsum(counts) - counts, counts)
    idx = np.arange(total, dtype=np.int64) - offs + np.repeat(starts, counts)
    return indices[idx], np.repeat(np.arange(len(frontier), dtype=np.int64), counts)


def _pseudo_peripheral(indptr, indices, deg, start, sweeps: int = 2):
    """A few BFS sweeps toward an eccentric low-degree start node."""
    n = len(deg)
    for _ in range(sweeps):
        dist = np.full(n, -1, np.int64)
        dist[start] = 0
        frontier = np.array([start], np.int64)
        level = 0
        last = frontier
        while len(frontier):
            nbrs, _ = _gather_neighbors(indptr, indices, frontier)
            nbrs = np.unique(nbrs)
            nbrs = nbrs[dist[nbrs] < 0]
            level += 1
            dist[nbrs] = level
            last, frontier = frontier if not len(nbrs) else nbrs, nbrs
        start = int(last[np.argmin(deg[last])])
    return start


def cuthill_mckee(src: np.ndarray, dst: np.ndarray, num_nodes: int) -> np.ndarray:
    """Cuthill-McKee order, ``perm[new_id] = old_id``: a level-synchronous
    BFS whose children are ordered by (position of their first parent,
    degree, id); components in order of their lowest-degree node."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    indptr, indices = _to_csr(src, dst, num_nodes)
    deg = (indptr[1:] - indptr[:-1]).astype(np.int64)

    visited = np.zeros(num_nodes, bool)
    order = np.empty(num_nodes, np.int64)
    pos = 0
    entry_order = np.lexsort((np.arange(num_nodes), deg))
    entry_ptr = 0
    while pos < num_nodes:
        while entry_ptr < num_nodes and visited[entry_order[entry_ptr]]:
            entry_ptr += 1
        start = int(entry_order[entry_ptr])
        if deg[start] > 0:
            start = _pseudo_peripheral(indptr, indices, deg, start)
        visited[start] = True
        order[pos] = start
        pos += 1
        frontier = np.array([start], np.int64)
        while len(frontier):
            nbrs, parent_pos = _gather_neighbors(indptr, indices, frontier)
            keep = ~visited[nbrs]
            nbrs, parent_pos = nbrs[keep], parent_pos[keep]
            if not len(nbrs):
                break
            o = np.lexsort((parent_pos, nbrs))
            nb_s, pp_s = nbrs[o], parent_pos[o]
            head = np.empty(len(nb_s), bool)
            head[0] = True
            head[1:] = nb_s[1:] != nb_s[:-1]
            uniq, first = nb_s[head], pp_s[head]
            level = uniq[np.lexsort((uniq, deg[uniq], first))]
            visited[level] = True
            order[pos : pos + len(level)] = level
            pos += len(level)
            frontier = level
    return order


def rcm_order(src: np.ndarray, dst: np.ndarray, num_nodes: int) -> np.ndarray:
    """Reverse Cuthill-McKee: ``perm[new_id] = old_id``."""
    return cuthill_mckee(src, dst, num_nodes)[::-1].copy()


def _hilbert_keys(coords: np.ndarray, lo: np.ndarray, span: np.ndarray,
                  bits: int) -> np.ndarray:
    """Hilbert index of every point on a 2^bits grid over the box
    ``[lo, lo + span]``: the rotate-and-fold loop, vectorised."""
    side = (1 << bits) - 1
    xy = ((np.asarray(coords, np.float64) - lo) / span * side).astype(np.uint64)
    x, y = xy[:, 0].copy(), xy[:, 1].copy()
    d = np.zeros_like(x)
    s = np.uint64(1) << np.uint64(bits - 1)
    while s > 0:
        rx = ((x & s) > 0).astype(np.uint64)
        ry = ((y & s) > 0).astype(np.uint64)
        d += s * s * ((np.uint64(3) * rx) ^ ry)
        swap = ry == 0
        flip = swap & (rx == 1)
        x_f = np.where(flip, s - np.uint64(1) - x, x)
        y_f = np.where(flip, s - np.uint64(1) - y, y)
        x, y = np.where(swap, y_f, x_f), np.where(swap, x_f, y_f)
        s >>= np.uint64(1)
    return d


def hilbert_order(coords: np.ndarray, bits: int = 24) -> np.ndarray:
    """Hilbert-curve order of 2D points, ``perm[new_id] = old_id``.
    Coordinates are min-max scaled onto a 2^bits grid; points that share a
    cell keep their input order."""
    coords = np.asarray(coords, np.float64)
    if coords.ndim != 2 or coords.shape[1] != 2:
        raise ValueError(f"expected [N, 2] coordinates, got {coords.shape}")
    lo = coords.min(axis=0)
    span = np.maximum(coords.max(axis=0) - lo, 1e-12)
    return np.argsort(_hilbert_keys(coords, lo, span, bits), kind="stable").astype(np.int64)


def source_span_tiles(src: np.ndarray, dst: np.ndarray, num_nodes: int,
                      tile: int = TILE) -> int:
    """The widest source span of a destination block, in tiles (the
    quantity the banded builder bounds)."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    if not len(src):
        return 1
    nb = (num_nodes + tile - 1) // tile
    bo = np.arange(nb, dtype=np.int64)
    hi = bo.copy()
    np.minimum.at(bo, dst // tile, src // tile)
    np.maximum.at(hi, dst // tile, src // tile)
    return int((hi - bo + 1).max())


def invert_perm(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=perm.dtype)
    return inv


def relabel_edges(src: np.ndarray, dst: np.ndarray, perm: np.ndarray):
    """Edge endpoints in the reordered ids (``perm[new] = old``)."""
    inv = invert_perm(np.asarray(perm, np.int64))
    return inv[np.asarray(src, np.int64)], inv[np.asarray(dst, np.int64)]


def reorder_for_banding(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    *,
    tile: int = TILE,
    max_span: int = 16,
    coords: np.ndarray | None = None,
) -> np.ndarray | None:
    """A permutation under which the graph's source span is at most
    ``max_span`` tiles: None when the graph is banded already; else the
    tighter of Hilbert on ``coords`` (when given) and RCM. Raises
    ValueError when neither reaches the bound."""
    if source_span_tiles(src, dst, num_nodes, tile) <= max_span:
        return None
    candidates = []
    if coords is not None:
        candidates.append(hilbert_order(coords))
    candidates.append(rcm_order(src, dst, num_nodes))
    best_perm, best_span = None, np.inf
    for perm in candidates:
        s2, d2 = relabel_edges(src, dst, perm)
        span = source_span_tiles(s2, d2, num_nodes, tile)
        if span < best_span:
            best_perm, best_span = perm, span
    if best_span <= max_span:
        return best_perm
    raise ValueError(
        f"no reordering reached span<={max_span} tiles (best {best_span}); "
        "graph is not bandable — use the dense/hybrid backends")


class StreamingHilbert:
    """Hilbert order from a stream of per-node coordinates, in two passes
    (bounds, then keys); holds one uint64 key a node::

        sh = StreamingHilbert(num_nodes)
        for ids, xy in chunks: sh.observe_bounds(xy)
        for ids, xy in chunks: sh.add_keys(ids, xy)
        perm = sh.order()  # perm[new] = old
    """

    def __init__(self, num_nodes: int, bits: int = 24):
        self.num_nodes = int(num_nodes)
        self.bits = bits
        self._lo = np.full(2, np.inf)
        self._hi = np.full(2, -np.inf)
        self._keys = None

    def observe_bounds(self, coords: np.ndarray) -> None:
        c = np.asarray(coords, np.float64)
        self._lo = np.minimum(self._lo, c.min(axis=0))
        self._hi = np.maximum(self._hi, c.max(axis=0))

    def add_keys(self, node_ids: np.ndarray, coords: np.ndarray) -> None:
        if self._keys is None:
            self._keys = np.zeros(self.num_nodes, np.uint64)
        span = np.maximum(self._hi - self._lo, 1e-12)
        self._keys[np.asarray(node_ids, np.int64)] = _hilbert_keys(
            coords, self._lo, span, self.bits)

    def order(self) -> np.ndarray:
        """perm[new_id] = old_id."""
        if self._keys is None:
            raise ValueError("no coordinates streamed")
        return np.argsort(self._keys, kind="stable").astype(np.int64)
