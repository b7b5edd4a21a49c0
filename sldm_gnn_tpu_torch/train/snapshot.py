"""Snapshot of a trained model, in the JAX package's layout.

Port of the save side of ``sldm_gnn_tpu/train/snapshot.py`` (:39): the
parameters as a JAX param tree (:func:`~sldm_gnn_tpu_torch.interop.
state_dict_to_params`), without the map encoder's weights unless asked
(:32), and the map embeddings baked by :meth:`GruSage.encode_map` with
their centroids, so serving needs neither the encoder nor the map graph.
The file is written by :func:`sldm_gnn_tpu_torch.serve.snapshot.
save_snapshot`; the JAX package's ``load_snapshot`` and the port's
``InferenceEngine`` both read it.
"""

from __future__ import annotations

from pathlib import Path

import torch

from ..interop import state_dict_to_params
from ..models.grusage import GruSage
from ..models.map_modules import MapData
from ..serve.snapshot import save_snapshot as _write


def save_snapshot(path: Path | str, model: GruSage, *, map_data: MapData | None = None,
                  norm_stat_dict: dict | None = None, train_prior: float | None = None,
                  loss_info: dict | None = None, keep_map_encoder: bool = False) -> None:
    """Write ``model`` to ``path``. A map model needs ``map_data``: its
    embeddings are computed once here, in eval mode, and baked in."""
    params = state_dict_to_params(model)
    if not keep_map_encoder:
        params.pop("map_encoder", None)
    emb = cen = None
    if model.cfg.map_included:
        if map_data is None:
            raise ValueError("a map model's snapshot needs map_data to bake its embeddings")
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                dev = next(model.parameters()).device
                md = map_data.to(dev)
                emb = model.encode_map(md).cpu().numpy()
                cen = md.centroids.float().cpu().numpy()
        finally:
            model.train(was_training)
    _write(path, params=params, config=model.cfg, norm_stat_dict=norm_stat_dict,
           train_prior=train_prior, loss_info=loss_info, map_embeddings=emb,
           map_centroids=cen)
