"""K-nearest map segments for the spatial attention.

Port of ``sldm_gnn_tpu/ops/knn.py`` (``knn_topk`` :25, the
``knn_impl='topk'`` path) and ``sldm_gnn_tpu/ops/knn_pallas.py``
(``_knn_kernel`` :44, ``knn_topk_pallas`` :81, the ``knn_impl='pallas'``
path), whose TPU kernel becomes the CUDA kernel ``csrc/knn_topk.cu``.

Both keep ``lax.top_k``'s rule: the lowest index wins on equal keys. The
selections are k sweeps of (argmin, mask): ``torch.argmin`` returns the
first minimum, while ``torch.topk`` promises no order among ties.
"""

from __future__ import annotations

import torch

KNN_MAX_K = 128  # the kernels' cap on k, as knn_pallas._KP


def pairwise_dists(points: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Euclidean distances [V, S] between points [V, 2] and centroids [S, 2]."""
    diff = points[:, None, :] - centroids[None, :, :]
    return torch.sqrt(torch.sum(diff * diff, dim=-1))


def _select_k(keys: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """k sweeps of (first argmin, mask): the k smallest keys per row in
    ascending order, lowest index first among ties."""
    keys = keys.clone()
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmin(keys, dim=1, keepdim=True)
        vals.append(torch.gather(keys, 1, i))
        idxs.append(i)
        keys.scatter_(1, i, float("inf"))
    return torch.cat(vals, dim=1), torch.cat(idxs, dim=1)


def knn_topk(points: torch.Tensor, centroids: torch.Tensor,
             k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(dists [V, k], indices [V, k] int64) of the k nearest centroids, on
    the square-rooted distances (the ``knn_impl='topk'`` path)."""
    if k > centroids.shape[0]:
        raise ValueError(f"k={k} exceeds num segments ({centroids.shape[0]})")
    return _select_k(pairwise_dists(points, centroids), k)


def _check(points, centroids, k):
    if points.dim() != 2 or points.shape[1] != 2 or centroids.dim() != 2 \
            or centroids.shape[1] != 2:
        raise ValueError("points must be [V, 2] and centroids [S, 2]")
    s = centroids.shape[0]
    if not 1 <= k <= min(s, KNN_MAX_K):
        raise ValueError(f"k={k} exceeds num segments ({s}) or kernel cap ({KNN_MAX_K})")


def knn_topk_plain(points: torch.Tensor, centroids: torch.Tensor,
                   k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the fused kernel: selection on
    ``d2 = dx*dx + dy*dy`` (separate rounded operations, no FMA), lowest
    index on ties, and only the k winners square-rooted. Returns
    (dists [V, k] f32, indices [V, k] int32)."""
    _check(points, centroids, k)
    p = points.float()
    c = centroids.float()
    dx = p[:, None, 0] - c[None, :, 0]
    dy = p[:, None, 1] - c[None, :, 1]
    d2 = dx * dx + dy * dy
    vals, idx = _select_k(d2, k)
    return torch.sqrt(vals), idx.to(torch.int32)


def knn_topk_warps(v: int) -> int:
    """Warps a point (1, 2, 4 or 8) that :func:`knn_topk_fused` gives ``v``
    points, as the library's ``knn_topk_plan`` reports it for the current
    card (``plan`` in ``csrc/knn_topk.cu``), so this builds the library and
    needs the card."""
    import ctypes

    from . import _build

    lib = _build.load()
    out = ctypes.c_int(0)
    _build.check(lib, lib.knn_topk_plan(v, ctypes.byref(out)), "knn_topk_plan")
    return out.value


def knn_topk_fused(points: torch.Tensor, centroids: torch.Tensor,
                   k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`knn_topk_plain`'s function: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if points.device.type == "cpu":
        return knn_topk_plain(points, centroids, k)
    if points.device.type != "cuda" or centroids.device != points.device:
        raise ValueError(
            f"knn_topk_fused runs on CUDA or CPU tensors on one device, got "
            f"{points.device} and {centroids.device}")
    _check(points, centroids, k)
    V, S = points.shape[0], centroids.shape[0]
    p = points.to(torch.float32).contiguous()
    c = centroids.to(torch.float32).contiguous()
    dists = torch.empty((V, k), device=p.device, dtype=torch.float32)
    idx = torch.empty((V, k), device=p.device, dtype=torch.int32)
    if V == 0:
        return dists, idx
    from . import _build

    lib = _build.load()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        code = lib.knn_topk_launch(p.data_ptr(), V, c.data_ptr(), S, k,
                                   dists.data_ptr(), idx.data_ptr(), stream)
    _build.check(lib, code, f"knn_topk kernel (V={V}, S={S}, k={k})")
    knn_topk_fused.launches += 1
    return dists, idx


knn_topk_fused.launches = 0
