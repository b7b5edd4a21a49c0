"""Fused GRU kernels, forward and backward: the bf16 CUDA kernels
``csrc/gru_fwd.cu``, ``csrc/gru_bwd.cu`` and ``csrc/gru_bwd_sg.cu``, the f32
v1 scan ``csrc/gru_scan.cu``, and their plain PyTorch versions.

Port of ``sldm_gnn_tpu/ops/gru_pallas.py`` v2 and v3 (``gru_last_pallas``
:477, ``gru_seq_pallas`` :544, ``gru_last_forward`` :591,
``gru_last_sg_pallas`` :840, ``gru_seq_sg_pallas`` :888), the
``gru_impl='pallas'`` and ``'pallas_sg'`` paths:

  * :func:`gru_fwd` (``_fwd2_kernel``): ``h_last`` or the bf16 ``hs``;
  * :func:`gru_fwd_sg` (``_fwd3_kernel``): ``hs`` plus the packed bf16
    gates ``r|z|n|hn``, with ``hs`` bit-equal to :func:`gru_fwd`'s;
  * :func:`gru_bwd` (``_bwd2_kernel``): BPTT recomputing the gates from hs;
  * :func:`gru_bwd_sg` (``_bwd3_kernel``): BPTT reading the stored gates.

Numerics follow the TPU kernels: x, W_ih and W_hh rounded to bf16, f32
sums and gate math, the carry rounded to bf16 after every step; in the
backward an f32 dh carry and dxp/dhp rounded to bf16 before each product.
Against the f32 scan (:mod:`.gru`) that is ~1e-2 relative after 100
frames, the JAX package's v2 contract.

The v1 scan (``_fwd_kernel``/``_bwd_kernel``, ``gru_scan_pallas`` :176 and
``gru_forward_pallas`` :196) is f32 throughout: :func:`gru_scan_fwd` runs
the recurrence over precomputed input projections ``xproj [T, B, 3H]``,
:func:`gru_scan_bwd` its BPTT recomputing the gates from ``hs[t-1]``,
:class:`GruScanFn` wires them into autograd, and :func:`gru_forward_v1`
chains layers as ``gru_forward_pallas`` does (the input projection is one
``torch.matmul`` outside the kernel, whose autograd gives ``dx`` and
``dW_ih``).

Each wrapper runs its kernel on CUDA tensors and its plain version on CPU
tensors; it never falls back from one to the other. :class:`GruLastFn`
and :class:`GruSeqFn` wire the kernels into autograd; they skip ``dx``
when the input needs no gradient (GruSage's ``with_dx=False``).
"""

from __future__ import annotations

import torch

from .gru import GRUParams


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


def _gates_math(xp: torch.Tensor, hproj: torch.Tensor):
    """(r, z, n, hn) in f32 from the input projection and the hidden
    projection, biases included (:func:`~.gru.gru_cell`'s math)."""
    xr, xz, xn = xp.chunk(3, dim=-1)
    hr, hz, hn = hproj.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return r, z, n, hn


def _carry(z: torch.Tensor, n: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The next carry ``(1 - z) * n + z * h``, evaluated as the fused
    multiply-add ``fma(1 - z, n, z * h)`` (as XLA lowers the TPU kernel's
    expression, and as the CUDA kernel writes it; ``addcmul`` fuses on the
    CPU), then rounded to bf16."""
    return torch.addcmul(z * h, 1.0 - z, n).to(torch.bfloat16).float()


def _fwd_plain(x, w_ih, b_ih, w_hh, b_hh, *, keep_hs: bool, keep_gates: bool):
    """The forward kernels' arithmetic, step by step: ``(h_last [N, H] f32,
    hs [T, N, H] bf16 or None, gates [T, N, 4H] bf16 or None)``."""
    _check(x, w_ih, b_ih, w_hh, b_hh)
    N, T, _ = x.shape
    H = w_hh.shape[0]
    xb = x.float().to(torch.bfloat16).float()
    wih = w_ih.to(torch.bfloat16).float()
    whh = w_hh.to(torch.bfloat16).float()
    xproj = torch.matmul(xb, wih) + b_ih.float()  # [N, T, 3H]
    h = x.new_zeros((N, H), dtype=torch.float32)
    hs = x.new_empty((T, N, H), dtype=torch.bfloat16) if keep_hs else None
    gates = x.new_empty((T, N, 4 * H), dtype=torch.bfloat16) if keep_gates else None
    for t in range(T):
        r, z, n, hn = _gates_math(xproj[:, t], h @ whh + b_hh.float())
        h = _carry(z, n, h)
        if keep_hs:
            hs[t] = h.to(torch.bfloat16)
        if keep_gates:
            gates[t] = torch.cat([r, z, n, hn], dim=1).to(torch.bfloat16)
    return h, hs, gates


def gru_fwd_plain(x: torch.Tensor, w_ih: torch.Tensor, b_ih: torch.Tensor,
                  w_hh: torch.Tensor, b_hh: torch.Tensor, *,
                  seq: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel, step by step.

    ``x [N, T, D]`` f32 (any strides), ``w_ih [D, 3H]``, ``w_hh [H, 3H]``
    (JAX layout), ``b_ih``/``b_hh [3H]``. Returns ``h_last [N, H]`` f32, or
    with ``seq=True`` the whole ``hs [T, N, H]`` in bf16.
    """
    h, hs, _ = _fwd_plain(x, w_ih, b_ih, w_hh, b_hh, keep_hs=seq, keep_gates=False)
    return hs if seq else h


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
    w_ih_b, b_ih_f, w_hh_b, b_hh_f = _weights(dev, w_ih, b_ih, w_hh, b_hh)
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


def gru_fwd_sg_plain(x: torch.Tensor, w_ih: torch.Tensor, b_ih: torch.Tensor,
                     w_hh: torch.Tensor, b_hh: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the store-gates forward, step by step:
    ``(hs [T, N, H] bf16, gates [T, N, 4H] bf16 = r|z|n|hn)``, ``hn`` being
    the n gate's hidden projection with its bias. ``hs`` is
    :func:`gru_fwd_plain`'s ``seq=True`` output, bit for bit."""
    _, hs, gates = _fwd_plain(x, w_ih, b_ih, w_hh, b_hh, keep_hs=True, keep_gates=True)
    return hs, gates


def gru_fwd_sg(x: torch.Tensor, w_ih: torch.Tensor, b_ih: torch.Tensor,
               w_hh: torch.Tensor, b_hh: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`gru_fwd_sg_plain`'s function: the store-gates instance of the
    ``csrc/gru_fwd.cu`` kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if x.device.type == "cpu":
        return gru_fwd_sg_plain(x, w_ih, b_ih, w_hh, b_hh)
    if x.device.type != "cuda":
        raise ValueError(f"gru_fwd_sg runs on CUDA or CPU tensors, got {x.device}")
    _check(x, w_ih, b_ih, w_hh, b_hh)
    if x.dtype != torch.float32:
        raise ValueError(f"x must be float32, got {x.dtype}")
    N, T, D = x.shape
    H = w_hh.shape[0]
    dev = x.device
    if x.stride(2) != 1:
        x = x.contiguous()
    w_ih_b, b_ih_f, w_hh_b, b_hh_f = _weights(dev, w_ih, b_ih, w_hh, b_hh)
    hs = torch.empty((T, N, H), device=dev, dtype=torch.bfloat16)
    gates = torch.empty((T, N, 4 * H), device=dev, dtype=torch.bfloat16)
    if N == 0 or T == 0:
        return hs, gates
    from . import _build

    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.gru_fwd_sg_launch(
            x.data_ptr(), x.stride(0), x.stride(1), N, T, D, H,
            w_ih_b.data_ptr(), b_ih_f.data_ptr(), w_hh_b.data_ptr(), b_hh_f.data_ptr(),
            hs.data_ptr(), gates.data_ptr(), stream)
    _build.check(lib, code, f"gru_fwd_sg kernel (N={N}, T={T}, D={D}, H={H})")
    gru_fwd_sg.launches += 1
    return hs, gates


gru_fwd_sg.launches = 0


# The forward kernels a width can run, by the code csrc/gru_fwd.cu's
# ``route`` gives it: the tensor-core kernel, the FMA kernel, or neither
# (the weights do not fit one block's shared memory).
FWD_ROUTES = {1: "tensor cores", 0: "FMA", -1: "none (shared memory)"}


def gru_fwd_route(d: int, h: int) -> int:
    """Which kernel :func:`gru_fwd` and :func:`gru_fwd_sg` launch for input
    width ``d`` and hidden width ``h`` (a key of ``FWD_ROUTES``), as the
    library's ``gru_fwd_route`` reports it for the current card. The rule
    lives only there (``route`` in ``csrc/gru_fwd.cu``), so this builds the
    library and needs the card."""
    import ctypes

    from . import _build

    lib = _build.load()
    out = ctypes.c_int(0)
    _build.check(lib, lib.gru_fwd_route(d, h, ctypes.byref(out)), "gru_fwd_route")
    return out.value


def _weights(dev, w_ih, b_ih, w_hh, b_hh):
    return (w_ih.to(dev, torch.bfloat16).contiguous(), b_ih.to(dev, torch.float32).contiguous(),
            w_hh.to(dev, torch.bfloat16).contiguous(), b_hh.to(dev, torch.float32).contiguous())


def _bptt_plain(x, hs, gates_at, whh, wih, g, seq_cot, with_dx):
    """The backward of both TPU kernels, step by step in plain PyTorch;
    ``gates_at(t, hprev)`` gives ``(r, z, n, hn)`` at frame ``t``."""
    N, T, D = x.shape
    H = whh.shape[0]
    xb = x.float().to(torch.bfloat16).float()
    ones = xb.new_ones((N, 1))
    dwih = xb.new_zeros((D + 1, 3 * H))  # last row: db_ih
    dwhh = xb.new_zeros((H + 1, 3 * H))  # last row: db_hh
    dx = xb.new_zeros((N, T, D)) if with_dx else None
    dh = xb.new_zeros((N, H)) if seq_cot else g.float()
    for t in reversed(range(T)):
        hprev = hs[t - 1].float() if t > 0 else xb.new_zeros((N, H))
        r, z, n, hn = gates_at(t, hprev)
        if seq_cot:
            dh = dh + g[:, t].float()
        dn = dh * (1.0 - z)
        dz = dh * (hprev - n)
        dh_direct = dh * z
        dn_pre = dn * (1.0 - n * n)
        dr = dn_pre * hn
        dhn = dn_pre * r
        dr_pre = dr * r * (1.0 - r)
        dz_pre = dz * z * (1.0 - z)
        dxp = torch.cat([dr_pre, dz_pre, dn_pre], dim=1).to(torch.bfloat16).float()
        dhp = torch.cat([dr_pre, dz_pre, dhn], dim=1).to(torch.bfloat16).float()
        if with_dx:
            dx[:, t] = dxp @ wih.T
        dwih += torch.cat([xb[:, t], ones], dim=1).T @ dxp
        dwhh += torch.cat([hprev, ones], dim=1).T @ dhp
        dh = dh_direct + dhp @ whh.T
    return dx, dwih[:D], dwih[D], dwhh[:H], dwhh[H]


def gru_bwd_plain(x: torch.Tensor, hs: torch.Tensor, w_ih: torch.Tensor,
                  b_ih: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                  g: torch.Tensor, *, seq_cot: bool = False, with_dx: bool = True):
    """Plain PyTorch version of the v2 backward: reverse BPTT over ``x [N,
    T, D]`` and the forward's ``hs [T, N, H]`` bf16, recomputing the gates
    of every frame from ``hs[t-1]`` as the forward did. ``g`` is the
    cotangent of ``h_last [N, H]``, or with ``seq_cot`` of every frame
    ``[N, T, H]``. Returns ``(dx [N, T, D] or None, dW_ih [D, 3H], db_ih,
    dW_hh [H, 3H], db_hh)`` in f32."""
    _check(x, w_ih, b_ih, w_hh, b_hh)
    xb = x.float().to(torch.bfloat16).float()
    wih = w_ih.to(torch.bfloat16).float()
    whh = w_hh.to(torch.bfloat16).float()

    def gates_at(t, hprev):
        return _gates_math(xb[:, t] @ wih + b_ih.float(), hprev @ whh + b_hh.float())

    return _bptt_plain(x, hs, gates_at, whh, wih, g, seq_cot, with_dx)


def gru_bwd_sg_plain(x: torch.Tensor, hs: torch.Tensor, gates: torch.Tensor,
                     w_ih: torch.Tensor, w_hh: torch.Tensor, g: torch.Tensor, *,
                     seq_cot: bool = False, with_dx: bool = True):
    """Plain PyTorch version of the store-gates backward: as
    :func:`gru_bwd_plain`, with the gates read from ``gates [T, N, 4H]``
    bf16 instead of recomputed."""
    H = w_hh.shape[0]
    wih = w_ih.to(torch.bfloat16).float()
    whh = w_hh.to(torch.bfloat16).float()

    def gates_at(t, hprev):
        return gates[t].float().split(H, dim=1)

    return _bptt_plain(x, hs, gates_at, whh, wih, g, seq_cot, with_dx)


def _bwd_cuda(name, grid_fn, launch_fn, x, hs, g, seq_cot, with_dx, w_ih, w_hh,
              extra_ptrs):
    """Shared launch of the two backward kernels: validates, asks the library
    for the workspace its route needs at this shape, allocates it and the
    packed result, launches, and splits."""
    if x.dtype != torch.float32 or x.dim() != 3:
        raise ValueError(f"x must be float32 [N, T, D], got {x.dtype} {tuple(x.shape)}")
    N, T, D = x.shape
    H = w_hh.shape[0]
    dev = x.device
    if tuple(hs.shape) != (T, N, H) or hs.dtype != torch.bfloat16 or hs.device != dev:
        raise ValueError(f"hs must be bf16 [{T}, {N}, {H}] on {dev}")
    want = (N, T, H) if seq_cot else (N, H)
    if tuple(g.shape) != want:
        raise ValueError(f"cotangent must be {want}, got {tuple(g.shape)}")
    if x.stride(2) != 1:
        x = x.contiguous()
    hs = hs.contiguous()
    g = g.to(dev, torch.float32)
    if g.stride(-1) != 1:
        g = g.contiguous()
    g_sn, g_st = (g.stride(0), g.stride(1)) if seq_cot else (g.stride(0), 0)
    rows = (H + 1) + (D + 1)
    out = torch.zeros((rows, 3 * H), device=dev, dtype=torch.float32)
    dx = torch.zeros((N, T, D), device=dev, dtype=torch.float32) if with_dx else None
    if N > 0 and T > 0:
        import ctypes

        from . import _build

        lib = _build.load()
        nbytes = ctypes.c_int64(0)
        with torch.cuda.device(dev):
            code = getattr(lib, grid_fn)(N, T, D, H, ctypes.byref(nbytes))
            _build.check(lib, code, f"{name} grid (N={N}, T={T}, D={D}, H={H})")
            ws = torch.empty(nbytes.value, device=dev, dtype=torch.uint8)
            stream = torch.cuda.current_stream(dev).cuda_stream
            w_ih_b = w_ih.to(dev, torch.bfloat16).contiguous()
            w_hh_b = w_hh.to(dev, torch.bfloat16).contiguous()
            code = getattr(lib, launch_fn)(
                x.data_ptr(), x.stride(0), x.stride(1), hs.data_ptr(),
                *extra_ptrs(w_ih_b, w_hh_b, g, g_sn, g_st, int(seq_cot), N, T, D, H),
                dx.data_ptr() if with_dx else None, ws.data_ptr(), nbytes.value,
                out.data_ptr(), stream)
        _build.check(lib, code, f"{name} kernel (N={N}, T={T}, D={D}, H={H})")
    return dx, out[H + 1:H + 1 + D], out[H + 1 + D], out[:H], out[H]


def gru_bwd(x: torch.Tensor, hs: torch.Tensor, w_ih: torch.Tensor, b_ih: torch.Tensor,
            w_hh: torch.Tensor, b_hh: torch.Tensor, g: torch.Tensor, *,
            seq_cot: bool = False, with_dx: bool = True):
    """:func:`gru_bwd_plain`'s function: the ``csrc/gru_bwd.cu`` kernels for
    CUDA tensors, the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return gru_bwd_plain(x, hs, w_ih, b_ih, w_hh, b_hh, g, seq_cot=seq_cot,
                             with_dx=with_dx)
    if x.device.type != "cuda":
        raise ValueError(f"gru_bwd runs on CUDA or CPU tensors, got {x.device}")
    _check(x, w_ih, b_ih, w_hh, b_hh)
    dev = x.device
    b_ih_f = b_ih.to(dev, torch.float32).contiguous()
    b_hh_f = b_hh.to(dev, torch.float32).contiguous()

    def ptrs(w_ih_b, w_hh_b, g, g_sn, g_st, seq, N, T, D, H):
        return (g.data_ptr(), g_sn, g_st, seq, N, T, D, H, w_ih_b.data_ptr(),
                b_ih_f.data_ptr(), w_hh_b.data_ptr(), b_hh_f.data_ptr())

    res = _bwd_cuda("gru_bwd", "gru_bwd_grid", "gru_bwd_launch", x, hs, g, seq_cot,
                    with_dx, w_ih, w_hh, ptrs)
    if x.shape[0] > 0 and x.shape[1] > 0:
        gru_bwd.launches += 1
    return res


gru_bwd.launches = 0


def gru_bwd_sg(x: torch.Tensor, hs: torch.Tensor, gates: torch.Tensor,
               w_ih: torch.Tensor, w_hh: torch.Tensor, g: torch.Tensor, *,
               seq_cot: bool = False, with_dx: bool = True):
    """:func:`gru_bwd_sg_plain`'s function: the ``csrc/gru_bwd_sg.cu``
    kernels for CUDA tensors, the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return gru_bwd_sg_plain(x, hs, gates, w_ih, w_hh, g, seq_cot=seq_cot,
                                with_dx=with_dx)
    if x.device.type != "cuda":
        raise ValueError(f"gru_bwd_sg runs on CUDA or CPU tensors, got {x.device}")
    N, T = x.shape[:2]
    H = w_hh.shape[0]
    if tuple(gates.shape) != (T, N, 4 * H) or gates.dtype != torch.bfloat16:
        raise ValueError(f"gates must be bf16 [{T}, {N}, {4 * H}]")
    gates = gates.contiguous()

    def ptrs(w_ih_b, w_hh_b, g, g_sn, g_st, seq, N, T, D, H):
        return (gates.data_ptr(), g.data_ptr(), g_sn, g_st, seq, N, T, D, H,
                w_ih_b.data_ptr(), w_hh_b.data_ptr())

    res = _bwd_cuda("gru_bwd_sg", "gru_bwd_sg_grid", "gru_bwd_sg_launch", x, hs, g,
                    seq_cot, with_dx, w_ih, w_hh, ptrs)
    if N > 0 and T > 0:
        gru_bwd_sg.launches += 1
    return res


gru_bwd_sg.launches = 0


def gru_bwd_route(d: int, h: int, *, stored: bool = False) -> int:
    """Which kernels :func:`gru_bwd` (or with ``stored`` :func:`gru_bwd_sg`)
    launch for input width ``d`` and hidden width ``h`` (a key of
    ``FWD_ROUTES``), as the library's ``gru_bwd_route`` /
    ``gru_bwd_sg_route`` report it for the current card (``bwd_route`` in
    ``csrc/gru_bwd.cuh``). Builds the library and needs the card."""
    import ctypes

    from . import _build

    lib = _build.load()
    out = ctypes.c_int(0)
    fn = "gru_bwd_sg_route" if stored else "gru_bwd_route"
    _build.check(lib, getattr(lib, fn)(d, h, ctypes.byref(out)), fn)
    return out.value


def _fn_forward(ctx, x, w_ih, b_ih, w_hh, b_hh, store_gates):
    """Forward of one GRU layer for autograd: ``hs [T, N, H]`` bf16, saving
    ``x`` and ``hs`` (plus the gates for the store-gates pair)."""
    if store_gates:
        hs, gates = gru_fwd_sg(x, w_ih, b_ih, w_hh, b_hh)
        ctx.save_for_backward(x, hs, gates, w_ih, b_ih, w_hh, b_hh)
    else:
        hs = gru_fwd(x, w_ih, b_ih, w_hh, b_hh, seq=True)
        ctx.save_for_backward(x, hs, w_ih, b_ih, w_hh, b_hh)
    ctx.store_gates = store_gates
    return hs


def _fn_backward(ctx, g, seq_cot):
    with_dx = ctx.needs_input_grad[0]
    if ctx.store_gates:
        x, hs, gates, w_ih, b_ih, w_hh, b_hh = ctx.saved_tensors
        grads = gru_bwd_sg(x, hs, gates, w_ih, w_hh, g, seq_cot=seq_cot, with_dx=with_dx)
    else:
        x, hs, w_ih, b_ih, w_hh, b_hh = ctx.saved_tensors
        grads = gru_bwd(x, hs, w_ih, b_ih, w_hh, b_hh, g, seq_cot=seq_cot, with_dx=with_dx)
    return (*grads, None)


class GruLastFn(torch.autograd.Function):
    """``h_last [N, H]`` f32 of one layer over ``x [N, T, D]``
    (``gru_last_pallas``, or with ``store_gates`` ``gru_last_sg_pallas``):
    the cotangent seeds the dh carry at the last frame."""

    @staticmethod
    def forward(ctx, x, w_ih, b_ih, w_hh, b_hh, store_gates):
        return _fn_forward(ctx, x, w_ih, b_ih, w_hh, b_hh, store_gates)[-1].float()

    @staticmethod
    def backward(ctx, g):
        return _fn_backward(ctx, g, seq_cot=False)


class GruSeqFn(torch.autograd.Function):
    """``hs [N, T, H]`` f32 of one layer, a view with the last dimension
    contiguous (``gru_seq_pallas``, or with ``store_gates``
    ``gru_seq_sg_pallas``): the per-frame cotangent joins the dh carry at
    every frame."""

    @staticmethod
    def forward(ctx, x, w_ih, b_ih, w_hh, b_hh, store_gates):
        return _fn_forward(ctx, x, w_ih, b_ih, w_hh, b_hh, store_gates).float().transpose(0, 1)

    @staticmethod
    def backward(ctx, g):
        return _fn_backward(ctx, g, seq_cot=True)


def gru_last_forward(params: GRUParams, x: torch.Tensor, *,
                     store_gates: bool = False) -> torch.Tensor:
    """``h_last [N, H]`` of a GRU stack: lower layers emit their whole
    sequence, which the next layer reads transposed; the top layer emits
    only its final state. When autograd needs a gradient, each layer runs
    through :class:`GruSeqFn` / :class:`GruLastFn` (``store_gates``: the v3
    store-gates pair, ``gru_pallas.py:591``); otherwise through
    :func:`gru_fwd` alone, which writes no gates."""
    layers = params.layers()
    train = torch.is_grad_enabled() and (
        x.requires_grad or any(p.requires_grad for layer in layers for p in layer))
    out = x
    if not train:
        for w_ih, b_ih, w_hh, b_hh in layers[:-1]:
            hs = gru_fwd(out, w_ih, b_ih, w_hh, b_hh, seq=True)
            out = hs.float().transpose(0, 1)  # [N, T, H] view, last dim contiguous
        return gru_fwd(out, *layers[-1])
    for layer in layers[:-1]:
        out = GruSeqFn.apply(out, *layer, store_gates)
    return GruLastFn.apply(out, *layers[-1], store_gates)


# ------------------------------------------------------------ the v1 scan (f32)

# The widest H each v1 kernel takes on an H100: its f32 W_hh, each gate
# padded to H rounded up to 16, and its narrowest tile of 16 rows (the
# forward's carry; the backward's hprev and dhp) must fit one block's 227
# KB of shared memory (128 both); chip_smoke.py probes both.
SCAN_WIDEST_H = {"forward": 128, "backward": 128}


def gru_scan_bwd_rows(h: int) -> int:
    """The row tile :func:`gru_scan_bwd`'s kernel takes at hidden width
    ``h``, 0 where ``h`` is wider than it takes, as the library's
    ``gru_scan_bwd_rows`` reports it (``bwd_rows`` in ``csrc/gru_scan.cu``,
    by shared memory). Builds the library and needs the card."""
    import ctypes

    from . import _build

    lib = _build.load()
    out = ctypes.c_int(0)
    _build.check(lib, lib.gru_scan_bwd_rows(h, ctypes.byref(out)), "gru_scan_bwd_rows")
    return out.value


def _check_scan(xproj, w_hh, b_hh):
    if xproj.dim() != 3:
        raise ValueError(f"xproj must be [T, B, 3H], got {tuple(xproj.shape)}")
    H = w_hh.shape[0]
    if tuple(w_hh.shape) != (H, 3 * H) or tuple(b_hh.shape) != (3 * H,) \
            or xproj.shape[2] != 3 * H:
        raise ValueError(f"w_hh must be [H, 3H], b_hh [3H] and xproj [T, B, 3H], got "
                         f"{tuple(w_hh.shape)}, {tuple(b_hh.shape)}, {tuple(xproj.shape)}")


def _scan_gates(xp, h, w_hh, b_hh):
    """(r, z, n, hn) of one step in f32: ``hn`` is the n gate's hidden
    projection, bias included."""
    hr, hz, hn = (h @ w_hh + b_hh).chunk(3, dim=-1)
    xr, xz, xn = xp.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    return r, z, torch.tanh(xn + r * hn), hn


def gru_scan_fwd_plain(xproj: torch.Tensor, w_hh: torch.Tensor,
                       b_hh: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the v1 forward kernel: ``hs [T, B, H]`` f32
    from ``xproj [T, B, 3H]`` (``x @ w_ih + b_ih``), ``w_hh [H, 3H]``,
    ``b_hh [3H]``, with ``h_0 = 0``."""
    _check_scan(xproj, w_hh, b_hh)
    T, B, _ = xproj.shape
    H = w_hh.shape[0]
    xp, w, b = xproj.float(), w_hh.float(), b_hh.float()
    h = xp.new_zeros((B, H))
    hs = xp.new_empty((T, B, H))
    for t in range(T):
        _, z, n, _ = _scan_gates(xp[t], h, w, b)
        h = (1.0 - z) * n + z * h
        hs[t] = h
    return hs


def gru_scan_bwd_plain(xproj: torch.Tensor, hs: torch.Tensor, w_hh: torch.Tensor,
                       b_hh: torch.Tensor, g: torch.Tensor):
    """Plain PyTorch version of the v1 backward kernel (``_bwd_kernel``):
    reverse BPTT over the forward's ``hs [T, B, H]`` and the cotangent ``g
    [T, B, H]``, recomputing every step's gates from ``hs[t-1]``. Returns
    ``(dxproj [T, B, 3H], dW_hh [H, 3H], db_hh [3H])`` in f32."""
    _check_scan(xproj, w_hh, b_hh)
    T, B, _ = xproj.shape
    H = w_hh.shape[0]
    xp, w, b = xproj.float(), w_hh.float(), b_hh.float()
    dxproj = xp.new_empty(xp.shape)
    dw = xp.new_zeros((H, 3 * H))
    db = xp.new_zeros(3 * H)
    dh = xp.new_zeros((B, H))
    for t in reversed(range(T)):
        hprev = hs[t - 1].float() if t > 0 else xp.new_zeros((B, H))
        r, z, n, hn = _scan_gates(xp[t], hprev, w, b)
        d = dh + g[t].float()
        dn = d * (1.0 - z)
        dz = d * (hprev - n)
        dn_pre = dn * (1.0 - n * n)
        dr_pre = dn_pre * hn * r * (1.0 - r)
        dz_pre = dz * z * (1.0 - z)
        dxproj[t] = torch.cat([dr_pre, dz_pre, dn_pre], dim=1)
        dhp = torch.cat([dr_pre, dz_pre, dn_pre * r], dim=1)
        dw += hprev.T @ dhp
        db += dhp.sum(0)
        dh = d * z + dhp @ w.T
    return dxproj, dw, db


_SLDM_ERR_SMEM = 100001  # csrc/common.cuh


def _scan_failed(lib, code, what, H):
    from . import _build

    if code == _SLDM_ERR_SMEM:
        raise ValueError(
            f"{what}: H={H} needs more shared memory or registers than a block may use "
            f"(widest H on an H100: forward {SCAN_WIDEST_H['forward']}, backward "
            f"{SCAN_WIDEST_H['backward']})")
    _build.check(lib, code, what)


def _scan_args(xproj, w_hh, b_hh):
    if xproj.device.type != "cuda" or xproj.dtype != torch.float32:
        raise ValueError(f"the v1 scan runs on float32 CUDA or CPU tensors, got "
                         f"{xproj.dtype} on {xproj.device}")
    if xproj.stride(2) != 1:
        xproj = xproj.contiguous()
    dev = xproj.device
    return (xproj, w_hh.to(dev, torch.float32).contiguous(),
            b_hh.to(dev, torch.float32).contiguous())


def gru_scan_fwd(xproj: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor) -> torch.Tensor:
    """:func:`gru_scan_fwd_plain`'s function: the ``csrc/gru_scan.cu``
    forward kernel for CUDA tensors, the plain version for CPU tensors.
    ``xproj`` may be any strided view whose last dimension is contiguous."""
    if xproj.device.type == "cpu":
        return gru_scan_fwd_plain(xproj, w_hh, b_hh)
    _check_scan(xproj, w_hh, b_hh)
    xproj, w, b = _scan_args(xproj, w_hh, b_hh)
    T, B, _ = xproj.shape
    H = w.shape[0]
    hs = torch.empty((T, B, H), device=xproj.device, dtype=torch.float32)
    if T == 0 or B == 0:
        return hs
    from . import _build

    lib = _build.load()
    with torch.cuda.device(xproj.device):
        code = lib.gru_scan_fwd_launch(
            xproj.data_ptr(), xproj.stride(0), xproj.stride(1), w.data_ptr(), b.data_ptr(),
            T, B, H, hs.data_ptr(), torch.cuda.current_stream(xproj.device).cuda_stream)
    _scan_failed(lib, code, f"gru_scan_fwd kernel (T={T}, B={B}, H={H})", H)
    gru_scan_fwd.launches += 1
    return hs


gru_scan_fwd.launches = 0


def gru_scan_bwd(xproj: torch.Tensor, hs: torch.Tensor, w_hh: torch.Tensor,
                 b_hh: torch.Tensor, g: torch.Tensor):
    """:func:`gru_scan_bwd_plain`'s function: the ``csrc/gru_scan.cu``
    backward kernel (a persistent grid on the tensor cores in 3xTF32, each
    block's dW_hh | db_hh in registers and written once a tile of rows,
    the blocks' partials summed in block order by a second kernel) for
    CUDA tensors, the plain version for CPU tensors."""
    if xproj.device.type == "cpu":
        return gru_scan_bwd_plain(xproj, hs, w_hh, b_hh, g)
    _check_scan(xproj, w_hh, b_hh)
    xproj, w, b = _scan_args(xproj, w_hh, b_hh)
    T, B, _ = xproj.shape
    H = w.shape[0]
    dev = xproj.device
    if tuple(hs.shape) != (T, B, H) or hs.dtype != torch.float32 or hs.device != dev:
        raise ValueError(f"hs must be float32 [{T}, {B}, {H}] on {dev}")
    if tuple(g.shape) != (T, B, H):
        raise ValueError(f"the cotangent must be [{T}, {B}, {H}], got {tuple(g.shape)}")
    hs = hs.contiguous()
    g = g.to(dev, torch.float32)
    if g.stride(2) != 1:
        g = g.contiguous()
    dxproj = torch.empty((T, B, 3 * H), device=dev, dtype=torch.float32)
    out = torch.zeros((H + 1, 3 * H), device=dev, dtype=torch.float32)
    if T > 0 and B > 0:
        import ctypes

        from . import _build

        lib = _build.load()
        blocks = ctypes.c_int(0)
        with torch.cuda.device(dev):
            code = lib.gru_scan_bwd_grid(B, H, ctypes.byref(blocks))
            _scan_failed(lib, code, f"gru_scan_bwd grid (B={B}, H={H})", H)
            partial = torch.empty((blocks.value, H + 1, 3 * H), device=dev,
                                  dtype=torch.float32)
            code = lib.gru_scan_bwd_launch(
                xproj.data_ptr(), xproj.stride(0), xproj.stride(1), hs.data_ptr(),
                w.data_ptr(), b.data_ptr(), g.data_ptr(), g.stride(0), g.stride(1), T, B, H,
                dxproj.data_ptr(), partial.data_ptr(), blocks.value, out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        _scan_failed(lib, code, f"gru_scan_bwd kernel (T={T}, B={B}, H={H})", H)
        gru_scan_bwd.launches += 1
    return dxproj, out[:H], out[H]


gru_scan_bwd.launches = 0


class GruScanFn(torch.autograd.Function):
    """``hs [T, B, H]`` of one layer from ``xproj [T, B, 3H]`` (the custom VJP
    of ``gru_scan_pallas``): forward :func:`gru_scan_fwd`, backward
    :func:`gru_scan_bwd`."""

    @staticmethod
    def forward(ctx, xproj, w_hh, b_hh):
        hs = gru_scan_fwd(xproj, w_hh, b_hh)
        ctx.save_for_backward(xproj, hs, w_hh, b_hh)
        return hs

    @staticmethod
    def backward(ctx, g):
        xproj, hs, w_hh, b_hh = ctx.saved_tensors
        dxproj, dw, db = gru_scan_bwd(xproj, hs, w_hh, b_hh, g)
        return dxproj, dw.to(w_hh.dtype), db.to(b_hh.dtype)


def gru_scan(xproj: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor) -> torch.Tensor:
    """Differentiable v1 scan: ``hs [T, B, H]`` from ``xproj [T, B, 3H]``."""
    return GruScanFn.apply(xproj, w_hh, b_hh)


def gru_forward_v1(params: GRUParams, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``gru_forward_pallas``: a GRU stack over ``x [B, T, D]`` through the
    v1 scan, ``(outputs [B, T, H], h_last [B, H])``. Each layer's input
    projection is one f32 ``torch.matmul`` (TF32 stays off, PyTorch's
    default, so xproj is f32); its gradient comes from autograd, as the
    XLA einsum's does in JAX."""
    out = x
    for w_ih, b_ih, w_hh, b_hh in params.layers():
        xproj = torch.matmul(out, w_ih) + b_ih  # [B, T, 3H]
        out = gru_scan(xproj.transpose(0, 1), w_hh, b_hh).transpose(0, 1)
    return out, out[:, -1, :]
