"""Fused GRU forward with bf16 operands: the CUDA kernel ``csrc/gru_fwd.cu``
and its plain PyTorch version.

Port of the forward half of ``sldm_gnn_tpu/ops/gru_pallas.py`` v2
(``_fwd2_kernel`` :246, ``_run_fwd2`` :400, ``gru_last_pallas`` :477,
``gru_seq_pallas`` :544, ``gru_last_forward`` :591), the
``gru_impl='pallas'`` path. Numerics follow the TPU kernel: x, W_ih and
W_hh rounded to bf16, f32 sums and gate math, the carry rounded to bf16
after every step. Against the f32 scan (:mod:`.gru`) that is ~1e-2
relative after 100 frames, the JAX package's v2 contract.

:func:`gru_fwd` runs the kernel on CUDA tensors and :func:`gru_fwd_plain`
on CPU tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import torch

from .gru import GRUParams, gru_cell


def _check(x, w_ih, b_ih, w_hh, b_hh):
    if x.dim() != 3:
        raise ValueError(f"x must be [N, T, D], got {tuple(x.shape)}")
    H = w_hh.shape[0]
    D = x.shape[2]
    if tuple(w_ih.shape) != (D, 3 * H) or tuple(w_hh.shape) != (H, 3 * H):
        raise ValueError(
            f"weights must be w_ih [{D}, {3 * H}] and w_hh [{H}, {3 * H}], got "
            f"{tuple(w_ih.shape)} and {tuple(w_hh.shape)}")
    if tuple(b_ih.shape) != (3 * H,) or tuple(b_hh.shape) != (3 * H,):
        raise ValueError("biases must be [3H]")


def gru_fwd_plain(x: torch.Tensor, w_ih: torch.Tensor, b_ih: torch.Tensor,
                  w_hh: torch.Tensor, b_hh: torch.Tensor, *,
                  seq: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel, step by step.

    ``x [N, T, D]`` f32 (any strides), ``w_ih [D, 3H]``, ``w_hh [H, 3H]``
    (JAX layout), ``b_ih``/``b_hh [3H]``. Returns ``h_last [N, H]`` f32, or
    with ``seq=True`` the whole ``hs [T, N, H]`` in bf16.
    """
    _check(x, w_ih, b_ih, w_hh, b_hh)
    N, T, _ = x.shape
    H = w_hh.shape[0]
    xb = x.float().to(torch.bfloat16).float()
    wih = w_ih.to(torch.bfloat16).float()
    whh = w_hh.to(torch.bfloat16).float()
    xproj = torch.matmul(xb, wih) + b_ih.float()  # [N, T, 3H]
    h = x.new_zeros((N, H), dtype=torch.float32)
    hs = []
    for t in range(T):
        h = gru_cell(xproj[:, t], h @ whh + b_hh.float(), h)
        h = h.to(torch.bfloat16).float()
        if seq:
            hs.append(h.to(torch.bfloat16))
    if seq:
        return torch.stack(hs) if hs else x.new_zeros((0, N, H), dtype=torch.bfloat16)
    return h


def gru_fwd(x: torch.Tensor, w_ih: torch.Tensor, b_ih: torch.Tensor,
            w_hh: torch.Tensor, b_hh: torch.Tensor, *,
            seq: bool = False) -> torch.Tensor:
    """:func:`gru_fwd_plain`'s function: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors. ``x`` may be any strided f32 view
    whose last dimension is contiguous (the next layer of a stack passes
    the ``[T, N, H]`` output transposed, without a copy)."""
    if x.device.type == "cpu":
        return gru_fwd_plain(x, w_ih, b_ih, w_hh, b_hh, seq=seq)
    if x.device.type != "cuda":
        raise ValueError(f"gru_fwd runs on CUDA or CPU tensors, got {x.device}")
    _check(x, w_ih, b_ih, w_hh, b_hh)
    N, T, D = x.shape
    H = w_hh.shape[0]
    dev = x.device
    if x.dtype != torch.float32:
        raise ValueError(f"x must be float32, got {x.dtype}")
    if x.stride(2) != 1:
        x = x.contiguous()
    w_ih_b = w_ih.to(dev, torch.bfloat16).contiguous()
    w_hh_b = w_hh.to(dev, torch.bfloat16).contiguous()
    b_ih_f = b_ih.to(dev, torch.float32).contiguous()
    b_hh_f = b_hh.to(dev, torch.float32).contiguous()
    if seq:
        out = torch.empty((T, N, H), device=dev, dtype=torch.bfloat16)
    else:
        out = torch.empty((N, H), device=dev, dtype=torch.float32)
    if N == 0 or T == 0:
        return out.zero_()
    from . import _build

    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.gru_fwd_launch(
            x.data_ptr(), x.stride(0), x.stride(1), N, T, D, H,
            w_ih_b.data_ptr(), b_ih_f.data_ptr(), w_hh_b.data_ptr(),
            b_hh_f.data_ptr(),
            None if seq else out.data_ptr(), out.data_ptr() if seq else None,
            stream)
    _build.check(lib, code, f"gru_fwd kernel (N={N}, T={T}, D={D}, H={H})")
    gru_fwd.launches += 1
    return out


gru_fwd.launches = 0


def gru_last_forward(params: GRUParams, x: torch.Tensor) -> torch.Tensor:
    """``h_last [N, H]`` of a GRU stack through :func:`gru_fwd`: lower
    layers emit their whole sequence (bf16 ``[T, N, H]``), which the next
    layer reads transposed; the top layer emits only its final state."""
    layers = params.layers()
    out = x
    for w_ih, b_ih, w_hh, b_hh in layers[:-1]:
        hs = gru_fwd(out, w_ih, b_ih, w_hh, b_hh, seq=True)
        out = hs.float().transpose(0, 1)  # [N, T, H] view, last dim contiguous
    w_ih, b_ih, w_hh, b_hh = layers[-1]
    return gru_fwd(out, w_ih, b_ih, w_hh, b_hh)
