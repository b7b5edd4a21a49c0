"""Stride-1 sliding-window graph construction for serving.

Port of ``IncrementalGraphOnlineCreator`` (``sldm_gnn_tpu/build/online.py``
:95, ``push_arrays`` :243, ``window`` :396), its numpy path: no pandas and
no native library. Each push costs O(V) featurisation of the incoming
frame, O(V²) pair distances and accumulator updates, and lazy
sliding-window min/max maintenance; emitted graphs equal a full rebuild
of the window (the JAX package tests that, and that its native path is
byte-equal to this numpy path).

Featurisation per vehicle and frame (the JAX ``build/tensorize.py``
contract): angle in degrees -> radians, XY moved from the front-border
centre to the box centre by half the length along the heading, channels
``X, Y, Speed, sin, cos, PresenceFlag``; absent frames hold
``(-length/2, 0, 0, 0, 1, 0)``. Edges (i, j) join vehicles whose minimum
co-present distance is <= ``m_radius``, with attributes min, max, mean
and mean square over co-present frames, emitted i-major.
"""

from __future__ import annotations

import numpy as np

from ..graph.containers import GraphArrays
from ..labels import ALL_LABELS, decode_bitmask


def _check_norm_stats(norm_stats: dict | None) -> dict | None:
    if norm_stats is None:
        return None
    for stat in ("mu", "sigma"):
        if stat not in norm_stats:
            raise ValueError(f"norm_stats missing '{stat}'")
        for key in ("x", "xdims"):
            if key not in norm_stats[stat]:
                raise ValueError(f"norm_stats['{stat}'] missing '{key}'")
    return {s: {k: np.asarray(norm_stats[s][k]) for k in ("x", "xdims")}
            for s in ("mu", "sigma")}


class IncrementalGraphOnlineCreator:
    """Ring buffers of the last ``frames_num`` frames plus decremental pair
    statistics (float64 sums refreshed exactly every ``frames_num`` pushes,
    so subtract-on-evict rounding cannot drift)."""

    def __init__(self, frames_num: int, m_radius: float,
                 active_labels: list[int] | None = None, *,
                 norm_stats: dict | None = None, capacity: int = 32):
        self.frames_num = frames_num
        self.m_radius = m_radius
        self.active_labels = list(active_labels) if active_labels is not None else list(ALL_LABELS)
        self.norm_stats = _check_norm_stats(norm_stats)
        self._cap = max(capacity, 4)
        self._alloc(self._cap)
        self._vid2slot: dict = {}
        self._free: list[int] = list(range(self._cap))[::-1]
        self._head = 0  # ring position of the oldest frame
        self._n_frames = 0  # frames in the window (<= frames_num)
        self._pushes_since_refresh = 0

    # ------------------------------------------------------------ storage

    def _alloc(self, cap: int):
        F = self.frames_num
        self._x = np.zeros((cap, F, 6), np.float32)
        self._x[:, :, 4] = 1.0  # absent frames: cos(0) = 1
        self._present = np.zeros((cap, F), bool)
        self._d = np.zeros((F, cap, cap), np.float32)  # per-frame pair distances
        self._dsum = np.zeros((cap, cap), np.float64)
        self._d2sum = np.zeros((cap, cap), np.float64)
        self._cnt = np.zeros((cap, cap), np.int64)
        # sliding min/max: value and the ring position attaining it
        self._dmin = np.full((cap, cap), np.inf, np.float32)
        self._dmin_pos = np.full((cap, cap), -1, np.int32)
        self._dmax = np.full((cap, cap), -np.inf, np.float32)
        self._dmax_pos = np.full((cap, cap), -1, np.int32)
        self._vids: list = [None] * cap
        self._wl = np.zeros((cap, 2), np.float32)  # width, length
        self._stt = np.zeros(cap, np.int32)

    def _grow(self):
        old_cap = self._cap
        cap = old_cap * 2
        per_slot = {k: getattr(self, k) for k in ("_x", "_present", "_wl", "_stt")}
        per_pair = {k: getattr(self, k) for k in (
            "_dsum", "_d2sum", "_cnt", "_dmin", "_dmin_pos", "_dmax", "_dmax_pos")}
        d, vids = self._d, self._vids
        self._alloc(cap)
        for k, a in per_slot.items():
            getattr(self, k)[:old_cap] = a
        for k, a in per_pair.items():
            getattr(self, k)[:old_cap, :old_cap] = a
        self._d[:, :old_cap, :old_cap] = d
        self._vids[:old_cap] = vids[:old_cap]
        self._free.extend(range(cap - 1, old_cap - 1, -1))
        self._cap = cap

    def _slot_for(self, vid, width, length, sttype) -> int:
        s = self._vid2slot.get(vid)
        if s is not None:
            return s
        if not self._free:
            self._grow()
        s = self._free.pop()
        self._vid2slot[vid] = s
        self._vids[s] = vid
        self._wl[s] = (width, length)
        self._stt[s] = sttype
        self._x[s] = 0.0
        self._x[s, :, 0] = -length / 2.0
        self._x[s, :, 4] = 1.0
        self._present[s] = False
        self._d[:, s, :] = 0.0
        self._d[:, :, s] = 0.0
        self._dsum[s, :] = self._dsum[:, s] = 0.0
        self._d2sum[s, :] = self._d2sum[:, s] = 0.0
        self._cnt[s, :] = self._cnt[:, s] = 0
        self._dmin[s, :] = self._dmin[:, s] = np.inf
        self._dmin_pos[s, :] = self._dmin_pos[:, s] = -1
        self._dmax[s, :] = self._dmax[:, s] = -np.inf
        self._dmax_pos[s, :] = self._dmax_pos[:, s] = -1
        return s

    # ------------------------------------------------------------- update

    def push_arrays(self, vid, x, y, speed, angle, width, length, sttype):
        """Ingest one frame, one entry per vehicle present. NaN
        width/length must already be 0.0 (NaN would poison the pair
        distances). Evicts the oldest frame once the window is full."""
        F = self.frames_num
        pos = self._head if self._n_frames >= F else (self._head + self._n_frames) % F

        # slots first (may grow the arrays); fresh-slot resets commute with
        # the eviction below (their counts are 0)
        if len(vid):
            slots = np.array([self._slot_for(v, width[i], length[i], sttype[i])
                              for i, v in enumerate(vid)], np.int64)
            ang = np.deg2rad(np.asarray(angle, np.float32))
            slen = self._wl[slots, 1]
            cos_a = np.cos(ang)
            sin_a = np.sin(ang)
            px = np.asarray(x, np.float32) - slen / 2.0 * cos_a
            py = np.asarray(y, np.float32) - slen / 2.0 * sin_a
            spd = np.asarray(speed, np.float32)

        if self._n_frames >= F:
            # evict the oldest frame's contribution
            co_old = np.outer(self._present[:, pos], self._present[:, pos])
            d_old = self._d[pos]
            self._dsum -= d_old * co_old
            self._d2sum -= d_old * d_old * co_old
            self._cnt -= co_old
            self._present[:, pos] = False
            self._head = (self._head + 1) % F
            # pairs left without co-present frames reset; pairs whose
            # extremum lived in the evicted frame recompute from the ring
            empty = self._cnt == 0
            self._dmin[empty] = np.inf
            self._dmin_pos[empty] = -1
            self._dmax[empty] = -np.inf
            self._dmax_pos[empty] = -1
            stale = ((self._dmin_pos == pos) | (self._dmax_pos == pos)) & ~empty
            if stale.any():
                ii, jj = np.nonzero(stale)
                dcols = self._d[:, ii, jj]  # [F, n]
                co = (self._present[ii] & self._present[jj]).T
                ar = np.arange(len(ii))
                dm = np.where(co, dcols, np.inf)
                k = np.argmin(dm, axis=0)
                self._dmin[ii, jj] = dm[k, ar]
                self._dmin_pos[ii, jj] = k
                dM = np.where(co, dcols, -np.inf)
                k = np.argmax(dM, axis=0)
                self._dmax[ii, jj] = dM[k, ar]
                self._dmax_pos[ii, jj] = k
        else:
            self._n_frames += 1

        # clear the ring column, then write the incoming frame
        self._x[:, pos, :] = 0.0
        self._x[:, pos, 0] = -self._wl[:, 1] / 2.0
        self._x[:, pos, 4] = 1.0
        if len(vid):
            self._x[slots, pos, 0] = px
            self._x[slots, pos, 1] = py
            self._x[slots, pos, 2] = spd
            self._x[slots, pos, 3] = sin_a
            self._x[slots, pos, 4] = cos_a
            self._x[slots, pos, 5] = 1.0
            self._present[slots, pos] = True

        # pair distances of the incoming frame over all slots, masked by the
        # presence outer product in the accumulators
        xy = self._x[:, pos, :2]
        diff = xy[:, None, :] - xy[None, :, :]
        d_new = np.sqrt(np.sum(diff * diff, axis=-1), dtype=np.float32)
        self._d[pos] = d_new
        co_new = np.outer(self._present[:, pos], self._present[:, pos])
        self._dsum += d_new.astype(np.float64) * co_new
        self._d2sum += d_new.astype(np.float64) * d_new * co_new
        self._cnt += co_new
        upd = co_new & (d_new < self._dmin)
        self._dmin[upd] = d_new[upd]
        self._dmin_pos[upd] = pos
        upd = co_new & (d_new > self._dmax)
        self._dmax[upd] = d_new[upd]
        self._dmax_pos[upd] = pos

        # free the slots of vehicles that left the window entirely
        alive = self._present.any(axis=1)
        for v, s in list(self._vid2slot.items()):
            if not alive[s]:
                del self._vid2slot[v]
                self._free.append(s)

        self._pushes_since_refresh += 1
        if self._pushes_since_refresh >= F:
            self._refresh_accumulators()
            self._pushes_since_refresh = 0

    def _refresh_accumulators(self):
        """Exact rebuild of the float64 sum/count accumulators over live
        slots (dead slots are zeroed when reallocated)."""
        live = sorted(self._vid2slot.values())
        if not live:
            return
        sl = np.asarray(live, np.int64)
        d = self._d[np.ix_(np.arange(self.frames_num), sl, sl)]  # [F, L, L]
        pr = self._present[sl]  # [L, F]
        co = pr.T[:, :, None] & pr.T[:, None, :]
        ix2 = np.ix_(sl, sl)
        self._dsum[ix2] = np.sum(d * co, axis=0, dtype=np.float64)
        self._d2sum[ix2] = np.sum(d.astype(np.float64) ** 2 * co, axis=0)
        self._cnt[ix2] = co.sum(axis=0, dtype=np.int64)

    # --------------------------------------------------------------- emit

    @property
    def warm(self) -> bool:
        return self._n_frames >= self.frames_num

    def window(self, mlb: int | None = None) -> GraphArrays:
        """The current window's graph, vehicles in VehicleId order. An
        empty window has no labels (``y`` None), as in the JAX package."""
        F = self.frames_num
        slots = sorted(self._vid2slot.items())
        if not slots:
            return GraphArrays(
                x=np.zeros((0, F, 6), np.float32), xsttype=np.zeros((0,), np.int32),
                xdims=np.zeros((0, 2), np.float32), edge_index=np.zeros((2, 0), np.int32),
                edge_attr=np.zeros((0, 4), np.float32), y=None,
                pos_raw=np.zeros((0, F, 2), np.float32))
        sl = np.array([s for _, s in slots], np.int64)

        order = (self._head + np.arange(F)) % F  # ring -> window order
        x = self._x[np.ix_(sl, order)]  # [V, F, 6]

        pair_ix = np.ix_(sl, sl)
        dmin = self._dmin[pair_ix]
        cnt = self._cnt[pair_ix]
        valid = (cnt > 0) & (dmin <= self.m_radius)
        np.fill_diagonal(valid, False)
        loc = np.argwhere(valid)  # i-major
        if len(loc):
            dmax = self._dmax[pair_ix]
            cntf = np.maximum(cnt, 1).astype(np.float64)
            dmean = (self._dsum[pair_ix] / cntf).astype(np.float32)
            dmsq = (self._d2sum[pair_ix] / cntf).astype(np.float32)
            ii, jj = loc[:, 0], loc[:, 1]
            edge_index = np.stack([ii, jj]).astype(np.int32)
            edge_attr = np.stack([dmin[ii, jj], dmax[ii, jj], dmean[ii, jj],
                                  dmsq[ii, jj]], axis=1).astype(np.float32)
        else:
            edge_index = np.zeros((2, 0), np.int32)
            edge_attr = np.zeros((0, 4), np.float32)

        y = None
        if mlb is not None:
            y = np.array(decode_bitmask(mlb, self.active_labels), dtype=np.float32)

        xdims = self._wl[sl].copy()
        pos_raw = x[:, :, :2].copy()
        ns = self.norm_stats
        if ns is not None:
            x = x.copy()
            x[:, :, :-1] = (x[:, :, :-1] - ns["mu"]["x"]) / ns["sigma"]["x"]
            xdims = (xdims - ns["mu"]["xdims"]) / ns["sigma"]["xdims"]

        return GraphArrays(x=x.astype(np.float32), xsttype=self._stt[sl].copy(),
                           xdims=xdims.astype(np.float32), edge_index=edge_index,
                           edge_attr=edge_attr, y=y, pos_raw=pos_raw)
