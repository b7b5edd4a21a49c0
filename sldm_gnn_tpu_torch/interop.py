"""Parameters between the JAX package and the port.

The JAX package's param tree (nested dicts of numpy arrays, as a snapshot
stores it) becomes the port's ``state_dict`` and back:

  * Dense ``kernel [in, out]``   <-> Linear ``weight [out, in]``;
  * LayerNorm ``scale``          <-> ``weight``;
  * Embed ``embedding``          <-> ``weight``;
  * GRU leaves (``gru.w_ih0 [D, 3H]`` ...) keep the JAX layout, which is
    the layout of the port's GRU ops.

The same holds for ``BlockedSageClassifier``'s tree (``sage/conv{i}/lin_l``,
``lin_r``, ``sage/norm{i}``, ``head``): its fused paths read the Linear
and LayerNorm parameters directly, so one tree serves every mode.

Leaves under ``map_encoder`` move too. A snapshot strips them unless
asked to keep them (``train/snapshot.py``), and a model built for serving
has no encoder: :func:`map_feat_dim` says which to build.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

def _flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, name + "."))
        else:
            out[name] = np.asarray(v)
    return out


def params_to_state_dict(params: dict) -> dict[str, torch.Tensor]:
    """JAX param tree -> the port's ``state_dict`` (CPU tensors)."""
    sd = {}
    for name, a in _flatten(params).items():
        stem, leaf = name.rsplit(".", 1)
        if leaf == "kernel":
            sd[f"{stem}.weight"] = torch.from_numpy(np.array(a.T))
        elif leaf in ("scale", "embedding"):
            sd[f"{stem}.weight"] = torch.from_numpy(np.array(a))
        else:
            sd[name] = torch.from_numpy(np.array(a))
    return sd


def map_feat_dim(params: dict, lane_embed_dim: int) -> int | None:
    """Width of ``MapData.feats`` that the tree's map encoder takes, or None
    when the tree has no encoder (a snapshot's default)."""
    enc = params.get("map_encoder")
    if not enc:
        return None
    return int(np.asarray(enc["sage"]["conv0"]["lin_r"]["kernel"]).shape[0]) - lane_embed_dim


def state_dict_to_params(model: nn.Module) -> dict:
    """The port's parameters -> a JAX param tree of numpy arrays (the
    inverse of :func:`params_to_state_dict`)."""
    kinds = {name: type(m) for name, m in model.named_modules()}
    tree: dict = {}
    for name, t in model.state_dict().items():
        stem, leaf = name.rsplit(".", 1)
        a = t.detach().cpu().numpy()
        kind = kinds.get(stem)
        if leaf == "weight" and kind is nn.Linear:
            leaf, a = "kernel", np.ascontiguousarray(a.T)
        elif leaf == "weight" and kind is nn.LayerNorm:
            leaf = "scale"
        elif leaf == "weight" and kind is nn.Embedding:
            leaf = "embedding"
        node = tree
        for part in stem.split("."):
            node = node.setdefault(part, {})
        node[leaf] = a
    return tree
