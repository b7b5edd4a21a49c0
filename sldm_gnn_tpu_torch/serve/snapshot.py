"""Model snapshot I/O without JAX.

Reads and writes the JAX package's snapshot (``sldm_gnn_tpu/train/
snapshot.py``, ``format_version`` 1): a pickle of ``{params, config,
norm_stat_dict, train_prior, loss_info, map_embeddings, map_centroids}``
holding numpy arrays, ``params`` being the JAX param tree. A snapshot
written by the JAX package loads here unchanged; convert its params with
:func:`sldm_gnn_tpu_torch.interop.params_to_state_dict`.

Unpickling is restricted to builtins, numpy and flax's ``FrozenDict``
(read back as a plain dict): a snapshot holds nothing else, and nothing
else may run while it loads.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from ..models.grusage import GruSageConfig

_SAFE_BUILTINS = {"dict", "list", "tuple", "set", "frozenset", "int", "float",
                  "complex", "bool", "str", "bytes", "bytearray", "slice", "range"}


# other globals a snapshot may name: what numpy arrays, dtypes and scalars
# pickle as (numpy 1 and 2), bytes under pickle protocol 2, OrderedDict
_SAFE_GLOBALS = {("numpy", "ndarray"), ("numpy", "dtype"),
                 ("numpy.core.multiarray", "_reconstruct"),
                 ("numpy._core.multiarray", "_reconstruct"),
                 ("numpy.core.multiarray", "scalar"), ("numpy._core.multiarray", "scalar"),
                 ("numpy.core.numeric", "_frombuffer"), ("numpy._core.numeric", "_frombuffer"),
                 ("_codecs", "encode"), ("collections", "OrderedDict")}


class _SnapshotUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if (module == "builtins" and name in _SAFE_BUILTINS) or (module, name) in _SAFE_GLOBALS:
            return super().find_class(module, name)
        if (module, name) == ("flax.core.frozen_dict", "FrozenDict"):
            return dict
        raise pickle.UnpicklingError(f"snapshot refers to {module}.{name}, which it may not")


def save_snapshot(path: Path | str, *, params: dict, config: GruSageConfig,
                  norm_stat_dict: dict | None = None,
                  train_prior: float | None = None, loss_info: dict | None = None,
                  map_embeddings: np.ndarray | None = None,
                  map_centroids: np.ndarray | None = None) -> None:
    """Write a ``format_version`` 1 snapshot (``params``: a JAX param tree
    of numpy arrays, e.g. from :func:`~sldm_gnn_tpu_torch.interop.
    state_dict_to_params`)."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    payload = {
        "params": params,
        "config": config.to_dict(),
        "norm_stat_dict": norm_stat_dict,
        "train_prior": train_prior,
        "loss_info": loss_info,
        "map_embeddings": None if map_embeddings is None else np.asarray(map_embeddings),
        "map_centroids": None if map_centroids is None else np.asarray(map_centroids),
        "format_version": 1,
    }
    with open(p, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)


def load_snapshot(path: Path | str) -> dict:
    p = Path(path)
    if not p.is_file():
        raise FileNotFoundError(f"snapshot not found: {p}")
    with open(p, "rb") as f:
        snap = _SnapshotUnpickler(f).load()
    for key in ("params", "config"):
        if key not in snap:
            raise ValueError(f"snapshot at {p} missing required key '{key}'")
    version = snap.get("format_version", 1)
    if version != 1:
        raise ValueError(f"snapshot at {p} has format_version {version}; this reads 1")
    for key in ("norm_stat_dict", "train_prior", "loss_info", "map_embeddings",
                "map_centroids"):
        snap.setdefault(key, None)
    snap["config"] = GruSageConfig.from_dict(snap["config"])
    return snap
