"""Multi-label classification losses with padded-graph masking.

Port of ``sldm_gnn_tpu/train/losses.py`` (``bce_with_logits_pos_weight``
:32, ``focal_bce_loss`` :42, ``masked_graph_loss`` :66):

  * BCE with logits and ``pos_weight``, elementwise
    ``w*y*softplus(-x) + (1-y)*softplus(x)`` (torch's
    ``BCEWithLogitsLoss(pos_weight=w)``);
  * focal BCE: plain BCE weighted by ``alpha_t * (1 - p_t)**gamma``;

both averaged over the valid graphs of a static-capacity batch only (the
mask divides by the count of valid elements).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _stable_bce_elems(logits: torch.Tensor, targets: torch.Tensor,
                      pos_weight: float | torch.Tensor | None) -> torch.Tensor:
    # log sigmoid(x) = -softplus(-x); log(1 - sigmoid(x)) = -softplus(x)
    pos_term = F.softplus(-logits)
    neg_term = F.softplus(logits)
    if pos_weight is None:
        return targets * pos_term + (1.0 - targets) * neg_term
    return pos_weight * targets * pos_term + (1.0 - targets) * neg_term


def _masked_mean(elems: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    if mask is None:
        return elems.mean()
    w = mask.to(elems.dtype)
    while w.dim() < elems.dim():
        w = w[..., None]
    w = w.expand_as(elems)
    return (elems * w).sum() / w.sum().clamp_min(1.0)


def bce_with_logits_pos_weight(logits: torch.Tensor, targets: torch.Tensor,
                               pos_weight: float | torch.Tensor = 1.0,
                               mask: torch.Tensor | None = None) -> torch.Tensor:
    return _masked_mean(_stable_bce_elems(logits, targets, pos_weight), mask)


def focal_bce_loss(logits: torch.Tensor, targets: torch.Tensor, alpha: float = 0.75,
                   gamma: float = 2.0, mask: torch.Tensor | None = None) -> torch.Tensor:
    bce = _stable_bce_elems(logits, targets, None)
    p = torch.sigmoid(logits)
    p_t = p * targets + (1.0 - p) * (1.0 - targets)
    alpha_t = alpha * targets + (1.0 - alpha) * (1.0 - targets)
    return _masked_mean(alpha_t * (1.0 - p_t) ** gamma * bce, mask)


def masked_graph_loss(logits: torch.Tensor, targets: torch.Tensor,
                      graph_mask: torch.Tensor, *, loss_type: str = "bce",
                      pos_weight: float = 1.0, focal_alpha: float = 0.75,
                      focal_gamma: float = 2.0) -> torch.Tensor:
    """Batch loss over ``[G, L]`` logits with padded-graph masking."""
    if loss_type == "bce":
        return bce_with_logits_pos_weight(logits, targets, pos_weight, mask=graph_mask)
    if loss_type == "focal":
        return focal_bce_loss(logits, targets, focal_alpha, focal_gamma, mask=graph_mask)
    raise ValueError(f"unknown loss_type {loss_type}")
