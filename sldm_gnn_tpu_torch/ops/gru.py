"""GRU temporal encoder: the plain float32 scan over frames.

Port of ``sldm_gnn_tpu/ops/gru.py`` (the ``gru_impl='scan'`` path). Gate
order and math are torch's ``nn.GRU`` (r, z, n):

    r  = sigmoid(x W_ir + b_ir + h W_hr + b_hr)
    z  = sigmoid(x W_iz + b_iz + h W_hz + b_hz)
    n  = tanh  (x W_in + b_in + r * (h W_hn + b_hn))
    h' = (1 - z) * n + z * h

Weights keep the JAX package's layout (``w_ih0 [D, 3H]``, pre-transposed
for ``x @ w``), so parameters move between the packages unchanged. The
JAX package runs this scan through XLA (no Pallas kernel), so it stays
plain PyTorch here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class GRUParams(NamedTuple):
    """Per-layer GRU parameters; layer 0 separate, layers 1.. stacked
    (``w_ih`` etc. have a leading ``L-1`` axis, possibly 0)."""

    w_ih0: torch.Tensor  # [input_size, 3H]
    w_hh0: torch.Tensor  # [H, 3H]
    b_ih0: torch.Tensor  # [3H]
    b_hh0: torch.Tensor  # [3H]
    w_ih: torch.Tensor  # [L-1, H, 3H]
    w_hh: torch.Tensor  # [L-1, H, 3H]
    b_ih: torch.Tensor  # [L-1, 3H]
    b_hh: torch.Tensor  # [L-1, 3H]

    def layers(self) -> list[tuple[torch.Tensor, ...]]:
        """``(w_ih, b_ih, w_hh, b_hh)`` of every layer, bottom first."""
        out = [(self.w_ih0, self.b_ih0, self.w_hh0, self.b_hh0)]
        for l in range(self.w_ih.shape[0]):
            out.append((self.w_ih[l], self.b_ih[l], self.w_hh[l], self.b_hh[l]))
        return out


def gru_cell(xp: torch.Tensor, hproj: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """One step from the input projection ``xp [B, 3H]`` (bias included),
    the hidden projection ``hproj [B, 3H]`` (bias included) and the carry
    ``h [B, H]``."""
    xr, xz, xn = xp.chunk(3, dim=-1)
    hr, hz, hn = hproj.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


def _gru_layer(x: torch.Tensor, w_ih, b_ih, w_hh, b_hh):
    hidden = w_hh.shape[0]
    xproj = torch.matmul(x, w_ih) + b_ih  # [B, T, 3H], one GEMM
    h = x.new_zeros((x.shape[0], hidden))
    hs = []
    for t in range(x.shape[1]):
        h = gru_cell(xproj[:, t], h @ w_hh + b_hh, h)
        hs.append(h)
    return torch.stack(hs, dim=1), h


def gru_forward(params: GRUParams, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Multi-layer GRU over ``x [B, T, D]``: ``(outputs [B, T, H], h_last
    [B, H])``, ``h_last`` being the top layer's final state."""
    out = x
    h = None
    for w_ih, b_ih, w_hh, b_hh in params.layers():
        out, h = _gru_layer(out, w_ih, b_ih, w_hh, b_hh)
    return out, h
