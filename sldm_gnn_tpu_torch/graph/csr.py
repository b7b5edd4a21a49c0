"""Node padding and edge checks shared by the banded layout builders.

Port of the parts of ``sldm_gnn_tpu/graph/csr.py`` (:32-237) that the
banded layouts use: ``TILE``, :func:`pad_nodes`, :func:`check_edge_range`
and :func:`mean_weights`. numpy, like the JAX package's host builders.
"""

from __future__ import annotations

import numpy as np

TILE = 128


def check_edge_range(src: np.ndarray, dst: np.ndarray, num_nodes: int) -> None:
    """Raise ValueError on edge endpoints outside ``[0, num_nodes)``."""
    if len(src) and (
        src.min() < 0 or dst.min() < 0 or src.max() >= num_nodes or dst.max() >= num_nodes
    ):
        raise ValueError(
            f"edge endpoints out of range [0, {num_nodes}): "
            f"src [{src.min()}, {src.max()}], dst [{dst.min()}, {dst.max()}]"
        )


def mean_weights(dst: np.ndarray, num_nodes: int) -> np.ndarray:
    """Per-edge 1/deg(dst) weights turning sum aggregation into mean."""
    deg = np.bincount(np.asarray(dst, np.int64), minlength=num_nodes)
    return (1.0 / np.maximum(deg, 1))[dst].astype(np.float32)


def pad_nodes(num_nodes: int, tile: int = TILE) -> int:
    return max(((num_nodes + tile - 1) // tile) * tile, tile)
