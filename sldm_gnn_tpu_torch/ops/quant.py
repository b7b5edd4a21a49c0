"""Symmetric int8 quantization: the XLA functions in plain PyTorch, and the
per-row quantizer ``csrc/quant_rows.cu`` with its plain version.

Port of ``sldm_gnn_tpu/ops/quant.py``: per-row (:func:`quantize_rows_xla`,
:func:`quantize_rows`) and per-tensor (:func:`quantize_tensor_xla`)
absmax quantization to [-127, 127], rounding half to even as XLA does,
:func:`dequantize_rows` and :func:`int8_matmul`.

:func:`quantize_rows` also rounds stochastically, ``floor(x / s + u)``
with ``u`` uniform in [0, 1). The TPU kernel draws ``u`` from the TPU's
own generator; here it comes from a counter-based hash of (seed, row,
column) (:func:`uniform_hash`), which the kernel and the plain version
compute alike, so the two are bit-equal. The TPU's bits cannot be
matched: the two packages agree in distribution only.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


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


def int8_matmul(qx: torch.Tensor, sx: torch.Tensor, qw: torch.Tensor,
                sw: torch.Tensor) -> torch.Tensor:
    """``x @ w`` from int8 operands (``qw``/``sw`` quantized per output
    channel, the rows of w.T): exact integer sums, then one f32 rescale.
    The sums are taken in f64, exact below 2^53 (the card has no int32
    product in PyTorch)."""
    acc = qx.double() @ qw.double().T
    return acc.float() * sx * sw.T


# ------------------------------------------------------------ the kernel


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h * c mod 2^32`` for int64 ``h`` in [0, 2^32), in two 16-bit
    halves of ``c`` so that no int64 product overflows."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer, on int64 tensors holding uint32 values."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def uniform_hash(seed: int, n: int, d: int, device=None) -> torch.Tensor:
    """``u [n, d]`` f32 in [0, 1): the top 23 bits of
    ``fmix32(fmix32(seed ^ fmix32(row)) + column * 0x9E3779B9)`` as the
    mantissa of a float in [1, 2), minus 1 (``_quant_kernel``'s
    construction). ``csrc/quant_rows.cu`` computes the same bits."""
    rows = torch.arange(n, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(d, dtype=torch.int64, device=device)[None, :]
    h = _fmix32(_fmix32(rows) ^ (seed & _M32))
    h = _fmix32((h + _mul32(cols, 0x9E3779B9)) & _M32)
    mant = ((h >> 9) | 0x3F800000).to(torch.int32)
    return mant.view(torch.float32) - 1.0


def _check_rows(x: torch.Tensor) -> None:
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"quantize_rows takes [n, D] float32, got {tuple(x.shape)} {x.dtype}")


def quantize_rows_plain(x: torch.Tensor, *, stochastic: bool = False,
                        seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``csrc/quant_rows.cu``: per-row absmax
    scales, ``q = clamp(rint(x / s))`` (half to even) or, stochastic,
    ``clamp(floor(x / s + u))`` with :func:`uniform_hash`'s ``u``."""
    _check_rows(x)
    absmax = x.abs().amax(dim=1, keepdim=True)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which can differ in the last bit
    scale = torch.clamp_min(absmax / torch.full_like(absmax, 127.0), 1e-12)
    scaled = x / scale
    if stochastic:
        scaled = torch.floor(scaled + uniform_hash(seed, *x.shape, device=x.device))
    else:
        scaled = torch.round(scaled)
    return torch.clamp(scaled, -127, 127).to(torch.int8), scale


def quantize_rows(x: torch.Tensor, *, stochastic: bool = False,
                  seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`quantize_rows_plain`'s function, the counterpart of
    ``quantize_rows_pallas``: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. ``x [n, D]`` f32; returns ``(q [n, D] int8,
    scale [n, 1] f32)``."""
    if x.device.type == "cpu":
        return quantize_rows_plain(x, stochastic=stochastic, seed=seed)
    _check_rows(x)
    if x.device.type != "cuda" or not x.is_contiguous():
        raise ValueError(f"quantize_rows runs on contiguous CUDA or CPU tensors, got {x.device}")
    n, d = x.shape
    q = torch.empty((n, d), dtype=torch.int8, device=x.device)
    scale = torch.empty((n, 1), dtype=torch.float32, device=x.device)
    from . import _build

    lib = _build.load()
    with torch.cuda.device(x.device):
        code = lib.quant_rows_launch(x.data_ptr(), n, d, int(stochastic), seed & _M32,
                                     q.data_ptr(), scale.data_ptr(),
                                     torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, f"quantize_rows kernel (rows={n}, D={d})")
    quantize_rows.launches += 1
    return q, scale


quantize_rows.launches = 0
