"""Node arrays split into shards for the halo-sharded path.

Port of ``shard_node_array`` from ``sldm_gnn_tpu/parallel/halo_model.py``:
the one helper the per-shard layers (:mod:`.halo_fused`) need on the host.

Left for the slice that ports the collectives: ``HaloDims``,
``HaloSageClassifier``, ``build_halo_step_fns`` and
``train_halo_classifier``, which run the halo exchange and sum the
parameter gradients across shards.
"""

from __future__ import annotations

import numpy as np


def shard_node_array(arr: np.ndarray, ep: int, n_local: int) -> np.ndarray:
    """``[N, ...]`` host array -> ``[ep, n_local, ...]`` stacked shards
    (zero-padded past N): the inverse of ``stack.reshape(ep * n_local,
    ...)[:N]``."""
    arr = np.asarray(arr)
    pad = ep * n_local - arr.shape[0]
    if pad < 0:
        raise ValueError(f"array rows {arr.shape[0]} exceed ep*n_local={ep * n_local}")
    if pad:
        arr = np.concatenate([arr, np.zeros((pad,) + arr.shape[1:], arr.dtype)])
    return arr.reshape((ep, n_local) + arr.shape[1:])
