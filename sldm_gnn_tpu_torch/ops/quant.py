"""Symmetric int8 quantization, in plain PyTorch.

Port of the XLA functions of ``sldm_gnn_tpu/ops/quant.py``:
per-row (:func:`quantize_rows_xla`) and per-tensor
(:func:`quantize_tensor_xla`) absmax quantization to [-127, 127], rounding
half to even as XLA does, and :func:`dequantize_rows`. Not ported: the
Pallas kernel ``quantize_rows_pallas`` and ``int8_matmul``.
"""

from __future__ import annotations

import torch


def quantize_rows_xla(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row absmax int8 quantization: ``(q [n, d] int8, scale [n, 1] f32)``."""
    absmax = x.abs().amax(dim=1, keepdim=True)
    scale = torch.clamp_min(absmax / 127.0, 1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def dequantize_rows(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    return q.float() * scales


def quantize_tensor_xla(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor absmax int8 quantization: ``(q [n, d] int8, scale [1] f32)``."""
    absmax = x.abs().amax()
    scale = torch.clamp_min(absmax / 127.0, 1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.reshape(1).float()
