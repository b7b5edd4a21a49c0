"""Fused banded SAGE layer: the CUDA kernels ``csrc/sage_fused_fwd.cu``
and ``csrc/sage_fused_bwd.cu``, their plain versions, and the autograd.

Port of ``sldm_gnn_tpu/ops/sage_fused.py``. One layer

    out = act( LN?( rs * (sum_s A[b, s] @ x[bo[b] + s]) @ Wl + x @ Wr + b ) )

runs as one forward kernel (:func:`banded_sage_fwd`, with the LayerNorm
epilogue emitting ``xhat`` and ``rstd``), and its backward as one reverse
aggregation ``t = A^T g~`` that goes on to ``dx = t @ Wl^T + g~ @ Wr^T``
in the same kernel, then a weight-gradient kernel ``dWl = x^T t``, ``dWr
= x^T g~`` over t written once in bf16 (:func:`banded_sage_bwd`;
:func:`banded_sage_ln_bwd` first turns the raw gradient into ``dy`` with a
row-wise prologue kernel). The forward's aggregate never leaves the
card's shared memory.

Roundings, the TPU kernels' own: the tiles (exact for counts up to 127),
x, the aggregate before ``@ Wl``, ``g~``, ``dy`` and the weights are
rounded to bf16, products summed in f32, LayerNorm statistics in f32. The
plain versions (``*_plain``) repeat them; the f32 twins (the ``use_pallas
= False`` paths) do not. The reverse scale (1/deg, times ``rstd`` under
LN) folds into the tiles' columns, as the TPU kernels fold it
(``sage_fused.py:407-409, 763-767``).

``cmap`` layouts (:mod:`.spmm_cmap`) run through the same kernels and
plain versions, their slots reading ``woff[b // k] + cmap[b, s]``. The
forward's ``ypre=(rg_b, m_b)`` option adds the halo overlap's compact
output ``y_pre_c [m_b, K*T, H]`` f32 (:mod:`..parallel.halo_fused`): the
pre-LN, pre-activation ``y`` of each group ``g`` with ``rg_b[g] > 0``, at
slot ``rg_b[g]``; the other slots stay zero. The kernels take the narrow
layout only, as the TPU kernels do; a ``wide`` reverse layout takes the
backward through :func:`~.spmm_banded.spmm_banded` and dense products, as
in the JAX package (``sage_fused.py:622, 1007``).
"""

from __future__ import annotations

import torch

from .spmm_banded import (
    BF16,
    BandedBlocks,
    bf16r,
    check_cuda_layout,
    cmap_args,
    gather_slots,
    require_narrow,
    scale_ptr,
    slot_aggregate,
    spmm_banded_xla,
)


def _act(y: torch.Tensor, slope: float | None) -> torch.Tensor:
    return y if slope is None else torch.where(y > 0, y, slope * y)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` at the promoted dtype (JAX promotes mixed operands)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def _ln_fwd_xla(y, gamma, beta, eps):
    """f32 LayerNorm over the last axis; returns (z, xhat, rstd [N, 1])."""
    y32 = y.float()
    mu = y32.mean(-1, keepdim=True)
    xc = y32 - mu
    var = (xc * xc).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = xc * rstd
    return xhat * gamma.float() + beta.float(), xhat, rstd


def _ln_bwd_prologue(g, xhat, rstd, gamma, beta, slope):
    """(dL/dout, LN residuals) -> (dL/dy_pre, dgamma, dbeta), the JAX
    package's XLA prologue: ``g~ = g * act'(gamma * xhat + beta)``,
    ``dy = rstd * (g~ gamma - mean(g~ gamma) - xhat mean(g~ gamma xhat))``."""
    xhat32 = xhat.float()
    gamma32 = gamma.float()
    if slope is not None:
        z = xhat32 * gamma32 + beta.float()
        g = torch.where(z > 0, g, torch.tensor(slope, dtype=g.dtype, device=g.device) * g)
    gf = g.float()
    dgamma = (gf * xhat32).sum(0).to(gamma.dtype)
    dbeta = gf.sum(0).to(beta.dtype)
    gz = gf * gamma32
    m1 = gz.mean(-1, keepdim=True)
    m2 = (gz * xhat32).mean(-1, keepdim=True)
    dy = (gz - m1 - xhat32 * m2) * rstd
    return dy, dgamma, dbeta


# ------------------------------------------------------------ plain versions


def expand_resid(resid, blocks: BandedBlocks) -> torch.Tensor:
    """Compact residual ``(r_c [m, K*T, C], rg [steps])`` -> ``[N, C]`` f32
    rows, zero where a group has no slot (a select, not a multiply: a stale
    slot may hold anything)."""
    r_c, rg = resid
    rows = r_c[rg.long()].reshape(-1, r_c.shape[-1]).float()
    live = (rg > 0).repeat_interleave(blocks.k * blocks.tile)[:, None]
    return torch.where(live, rows, torch.zeros((), device=rows.device))


def _slot_scale(cs: torch.Tensor, blocks: BandedBlocks) -> torch.Tensor:
    """Per-source-row scale ``[N, 1]`` -> ``[NB, S_SPAN, 1, T]`` (the
    columns of each slot's tile)."""
    return gather_slots(cs, blocks)[..., 0][:, :, None, :]


def ypre_slots(y: torch.Tensor, rg_b: torch.Tensor, m_b: int, kt: int) -> torch.Tensor:
    """``y [N, H]`` -> ``y_pre_c [m_b, kt, H]`` f32: the rows of each group
    ``g`` (``kt`` rows) with ``rg_b[g] > 0`` at slot ``rg_b[g]``, zeros
    elsewhere."""
    h = y.shape[1]
    out = torch.zeros((m_b, kt, h), dtype=torch.float32, device=y.device)
    live = rg_b > 0
    out[rg_b[live].long()] = y.float().reshape(-1, kt, h)[live]
    return out


def banded_sage_fwd_plain(x, wl, wr, bias, blocks: BandedBlocks, *,
                          negative_slope: float | None = None, resid=None, ln=None,
                          eps: float = 1e-5, ypre=None):
    """Plain PyTorch version of ``csrc/sage_fused_fwd.cu``. Returns ``out``
    at x's dtype, or with ``ln=(gamma, beta)`` ``(out, xhat, rstd [N, 1])``;
    ``ypre=(rg_b, m_b)`` appends ``y_pre_c`` (:func:`ypre_slots` of the
    post-bias ``y``)."""
    require_narrow(blocks)
    if blocks.col_scale is not None:
        raise ValueError("pass the forward layout (row_scale form)")
    agg = slot_aggregate(bf16r(blocks.a.float()), bf16r(x.float()), blocks)
    if blocks.row_scale is not None:
        agg = agg * blocks.row_scale
    if resid is not None:
        agg = agg + expand_resid(resid, blocks)
    y = bf16r(agg) @ bf16r(wl.float()) + bf16r(x.float()) @ bf16r(wr.float())
    if bias is not None:
        y = y + bias.float()
    extra = () if ypre is None else (ypre_slots(y, ypre[0], ypre[1], blocks.k * blocks.tile),)
    if ln is None:
        out = _act(y, negative_slope).to(x.dtype)
        return (out, *extra) if extra else out
    z, xhat, rstd = _ln_fwd_xla(y, *ln, eps)
    return (_act(z, negative_slope).to(x.dtype), xhat.to(x.dtype), rstd, *extra)


def banded_sage_bwd_plain(gq, wl, wr, blocks_rev: BandedBlocks, *, x=None, resid=None):
    """Plain PyTorch version of ``csrc/sage_fused_bwd.cu`` on the
    activation-masked gradient ``gq``: ``(dx, dWl, dWr)`` with ``x``, else
    ``(t, dx)`` with ``t = A^T gq``."""
    require_narrow(blocks_rev)
    if blocks_rev.row_scale is not None:
        raise ValueError("pass the reverse layout (col_scale form)")
    a = bf16r(blocks_rev.a.float())
    if blocks_rev.col_scale is not None:
        a = bf16r(a * _slot_scale(bf16r(blocks_rev.col_scale), blocks_rev))
    acc = slot_aggregate(a, bf16r(gq.float()), blocks_rev)
    if resid is not None:
        acc = acc + expand_resid(resid, blocks_rev)
    tb = bf16r(acc)
    go = bf16r(gq.float())
    dx = (tb @ bf16r(wl.float()).T + go @ bf16r(wr.float()).T).to(gq.dtype)
    if x is None:
        return acc.to(gq.dtype), dx
    xb = bf16r(x.float())
    return dx, xb.T @ tb, xb.T @ go


def _dy_unscaled(g, xhat, gamma, beta, slope):
    """(dy / rstd, g~) in f32 from the raw gradient, as the TPU LN kernel
    derives them per window row."""
    xh = xhat.float()
    gf = g.float()
    if slope is not None:
        z = xh * gamma.float() + beta.float()
        gf = torch.where(z > 0, gf, slope * gf)
    gz = gf * gamma.float()
    m1 = gz.mean(-1, keepdim=True)
    m2 = (gz * xh).mean(-1, keepdim=True)
    return gz - m1 - xh * m2, gf


def banded_sage_ln_bwd_plain(g, xhat, rstd, wl, wr, gamma, beta, blocks_rev: BandedBlocks,
                             x, *, negative_slope: float | None, resid=None):
    """Plain PyTorch version of the LN backward (the prologue kernel and the
    reverse kernel of ``csrc/sage_fused_bwd.cu``): ``(dx, dWl, dWr, dstats
    = [dgamma; dbeta; db; 0])``."""
    require_narrow(blocks_rev)
    dyu, gt = _dy_unscaled(g, xhat, gamma, beta, negative_slope)
    cs = rstd.float()
    if blocks_rev.col_scale is not None:
        cs = cs * blocks_rev.col_scale
    a = bf16r(blocks_rev.a.float() * _slot_scale(cs, blocks_rev))
    acc = slot_aggregate(a, bf16r(dyu), blocks_rev)
    if resid is not None:
        acc = acc + expand_resid(resid, blocks_rev)
    dyo = dyu * rstd
    tb, yo, xb = bf16r(acc), bf16r(dyo), bf16r(x.float())
    dx = (tb @ bf16r(wl.float()).T + yo @ bf16r(wr.float()).T).to(x.dtype)
    xh = xhat.float()
    dstats = torch.stack([(gt * xh).sum(0), gt.sum(0), dyo.sum(0), torch.zeros_like(gt[0])])
    return dx, xb.T @ tb, xb.T @ yo, dstats


# ------------------------------------------------------------ the kernels


def _weights_bf16(dev, *ws):
    return [w.to(dev, BF16).contiguous() for w in ws]


def _f32(dev, v):
    return None if v is None else v.to(dev, torch.float32).contiguous()


def _resid_args(resid, blocks: BandedBlocks, width: int, dev):
    """(r_c, rg, r_c is bf16) for a launch; (None, None, 0) without."""
    if resid is None:
        return None, None, 0
    r_c, rg = resid
    kt = blocks.k * blocks.tile
    if r_c.dim() != 3 or r_c.shape[1:] != (kt, width) or r_c.dtype not in (torch.float32, BF16):
        raise ValueError(f"resid slots must be [m, {kt}, {width}] f32 or bf16, got "
                         f"{tuple(r_c.shape)} {r_c.dtype}")
    if rg.numel() != blocks.num_dst_blocks // blocks.k:
        raise ValueError("resid group map must have one entry per group of k blocks")
    return r_c.to(dev).contiguous(), rg.to(dev, torch.int32).contiguous(), int(r_c.dtype == BF16)


def _ptr(t):
    return None if t is None else t.data_ptr()


def banded_sage_fwd(x, wl, wr, bias, blocks: BandedBlocks, *,
                    negative_slope: float | None = None, resid=None, ln=None,
                    eps: float = 1e-5, ypre=None):
    """:func:`banded_sage_fwd_plain`'s function: the ``csrc/sage_fused_fwd.cu``
    kernel for CUDA tensors, the plain version for CPU tensors.
    ``negative_slope``: None = no activation, 0.0 = ReLU, else LeakyReLU;
    ``resid=(r_c, rg)``: the compact residual aggregate
    (:mod:`.banded_residual`), added to the rows of groups with ``rg > 0``;
    ``ypre=(rg_b [NB / K] int32, m_b)``: also return ``y_pre_c [m_b, K*T,
    H]`` f32, the post-bias ``y`` of the groups with ``rg_b > 0`` at their
    slots (the kernel writes those slots, the wrapper zeroes the rest)."""
    if x.device.type == "cpu":
        return banded_sage_fwd_plain(x, wl, wr, bias, blocks, negative_slope=negative_slope,
                                     resid=resid, ln=ln, eps=eps, ypre=ypre)
    check_cuda_layout("banded_sage_fwd", x, blocks)
    if blocks.col_scale is not None:
        raise ValueError("banded_sage_fwd: pass the forward layout (row_scale form)")
    n, d = x.shape
    h = wl.shape[1]
    if tuple(wl.shape) != (d, h) or tuple(wr.shape) != (d, h) or h > 128:
        raise ValueError(f"banded_sage_fwd: weights must be [{d}, H<=128], got "
                         f"{tuple(wl.shape)} and {tuple(wr.shape)}")
    dev = x.device
    wl_b, wr_b = _weights_bf16(dev, wl, wr)
    bias_f = _f32(dev, bias)
    gamma_f, beta_f = (None, None) if ln is None else (_f32(dev, ln[0]), _f32(dev, ln[1]))
    r_c, rg, r_bf16 = _resid_args(resid, blocks, d, dev)
    bo = blocks.bo.to(torch.int32).contiguous()
    out = torch.empty((n, h), device=dev, dtype=x.dtype)
    xhat = torch.empty((n, h), device=dev, dtype=x.dtype) if ln is not None else None
    rstd = torch.empty((n, 1), device=dev, dtype=torch.float32) if ln is not None else None
    y_pre = rg_b = None
    if ypre is not None:
        rg_b, m_b = ypre
        if rg_b.numel() != blocks.num_dst_blocks // blocks.k or m_b < 1:
            raise ValueError("banded_sage_fwd: ypre's group map must have one entry per "
                             "group of k blocks, and m_b >= 1")
        rg_b = rg_b.to(dev, torch.int32).contiguous()
        y_pre = torch.zeros((m_b, blocks.k * blocks.tile, h), device=dev, dtype=torch.float32)
    from . import _build

    lib = _build.load()
    with torch.cuda.device(dev):
        code = lib.sage_fwd_launch(
            blocks.a.data_ptr(), int(blocks.a.dtype == torch.float32), bo.data_ptr(),
            *cmap_args(blocks), scale_ptr(blocks.row_scale, n, dev), blocks.num_dst_blocks, blocks.s_span,
            blocks.tile, blocks.k, x.data_ptr(), int(x.dtype == BF16), d, h,
            wl_b.data_ptr(), wr_b.data_ptr(), _ptr(bias_f), _ptr(gamma_f), _ptr(beta_f),
            float(eps), int(negative_slope is not None),
            float(negative_slope or 0.0), _ptr(r_c), r_bf16, _ptr(rg),
            out.data_ptr(), _ptr(xhat), _ptr(rstd), _ptr(y_pre), _ptr(rg_b),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, f"banded_sage_fwd kernel (nb={blocks.num_dst_blocks}, D={d}, H={h})")
    banded_sage_fwd.launches += 1
    outs = (out,) if ln is None else (out, xhat, rstd)
    outs += () if y_pre is None else (y_pre,)
    return outs if len(outs) > 1 else out


banded_sage_fwd.launches = 0


def _bwd_launch(lib, dev, blocks_rev, rows, own, rstd, wl, wr, x, resid, dx_dtype, t_out):
    """The reverse kernel of ``csrc/sage_fused_bwd.cu`` (shared by the plain
    and the LN backward), then with ``x`` its weight-gradient kernel:
    returns ``(dx, dWl, dWr)`` with ``x``, else ``(t_out, dx)``."""
    import ctypes

    from . import _build

    n, h = rows.shape
    d = wl.shape[0]
    wlt, wrt = _weights_bf16(dev, wl.T, wr.T)
    r_c, rg, r_bf16 = _resid_args(resid, blocks_rev, h, dev)
    bo = blocks_rev.bo.to(torch.int32).contiguous()
    dx = torch.empty((n, d), device=dev, dtype=dx_dtype)
    p = 0
    if x is not None:
        parts = ctypes.c_int(0)
        _build.check(lib, lib.sage_dw_parts(n, ctypes.byref(parts)), f"sage_dw parts (rows={n})")
        p = parts.value
        # t in bf16 for the weight-gradient kernel
        t_out = torch.empty((n, h), device=dev, dtype=BF16)
        partial = torch.empty((p, 2, d, h), device=dev, dtype=torch.float32)
        dw = torch.empty((2, d, h), device=dev, dtype=torch.float32)
    else:
        partial = dw = None
    code = lib.sage_bwd_launch(
        blocks_rev.a.data_ptr(), int(blocks_rev.a.dtype == torch.float32), bo.data_ptr(),
        *cmap_args(blocks_rev), scale_ptr(blocks_rev.col_scale, n, dev), _ptr(rstd), blocks_rev.num_dst_blocks,
        blocks_rev.s_span, blocks_rev.tile, blocks_rev.k,
        rows.data_ptr(), int(rows.dtype == BF16), own.data_ptr(), int(own.dtype == BF16), h,
        wlt.data_ptr(), wrt.data_ptr(), d, _ptr(r_c), r_bf16, _ptr(rg),
        _ptr(x), int(x is not None and x.dtype == BF16),
        dx.data_ptr(), int(dx_dtype == BF16), _ptr(t_out), int(t_out is not None and
                                                                t_out.dtype == BF16),
        _ptr(partial), p, _ptr(dw), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, f"sage_bwd kernel (nb={blocks_rev.num_dst_blocks}, D={d}, H={h})")
    if x is None:
        return t_out, dx
    return dx, dw[0], dw[1]


def _check_rows(name, v, blocks, width, dev):
    if v.shape != (blocks.num_dst_blocks * blocks.tile, width) or v.device != dev \
            or v.dtype not in (torch.float32, BF16) or not v.is_contiguous():
        raise ValueError(f"{name}: must be contiguous float32/bfloat16 "
                         f"[{blocks.num_dst_blocks * blocks.tile}, {width}] on {dev}, got "
                         f"{tuple(v.shape)} {v.dtype} {v.device}")


def banded_sage_bwd(gq, wl, wr, blocks_rev: BandedBlocks, *, x=None, resid=None):
    """:func:`banded_sage_bwd_plain`'s function: the reverse kernel of
    ``csrc/sage_fused_bwd.cu`` for CUDA tensors, the plain version for CPU
    tensors. ``gq`` is the activation-masked gradient, unscaled;
    ``blocks_rev`` the reverse layout, whose 1/deg column scale folds into
    the tiles."""
    if gq.device.type == "cpu":
        return banded_sage_bwd_plain(gq, wl, wr, blocks_rev, x=x, resid=resid)
    check_cuda_layout("banded_sage_bwd", gq, blocks_rev)
    if blocks_rev.row_scale is not None:
        raise ValueError("banded_sage_bwd: pass the reverse layout (col_scale form)")
    dev = gq.device
    n, h = gq.shape
    d = wl.shape[0]
    if tuple(wl.shape) != (d, h) or tuple(wr.shape) != (d, h) or d > 128:
        raise ValueError(f"banded_sage_bwd: weights must be [D<=128, {h}]")
    if x is not None:
        _check_rows("banded_sage_bwd x", x, blocks_rev, d, dev)
    t_out = None if x is not None else torch.empty_like(gq)
    from . import _build

    lib = _build.load()
    with torch.cuda.device(dev):
        res = _bwd_launch(lib, dev, blocks_rev, gq, gq, None, wl, wr, x, resid, gq.dtype,
                          t_out)
    banded_sage_bwd.launches += 1
    return res


banded_sage_bwd.launches = 0


def banded_sage_ln_bwd(g, xhat, rstd, wl, wr, gamma, beta, blocks_rev: BandedBlocks, x, *,
                       negative_slope: float | None, resid=None):
    """:func:`banded_sage_ln_bwd_plain`'s function: for CUDA tensors the
    prologue kernel (``dy / rstd`` and ``dy`` in bf16, and the ordered
    column sums dgamma, dbeta, db) then the reverse kernel of
    ``csrc/sage_fused_bwd.cu``; the plain version for CPU tensors.
    ``resid``: the compact reverse residual of the complete ``dy``."""
    if g.device.type == "cpu":
        return banded_sage_ln_bwd_plain(g, xhat, rstd, wl, wr, gamma, beta, blocks_rev, x,
                                        negative_slope=negative_slope, resid=resid)
    check_cuda_layout("banded_sage_ln_bwd", g, blocks_rev)
    if blocks_rev.row_scale is not None:
        raise ValueError("banded_sage_ln_bwd: pass the reverse layout (col_scale form)")
    dev = g.device
    n, h = g.shape
    d = wl.shape[0]
    if tuple(wl.shape) != (d, h) or tuple(wr.shape) != (d, h) or d > 128:
        raise ValueError(f"banded_sage_ln_bwd: weights must be [D<=128, {h}]")
    _check_rows("banded_sage_ln_bwd xhat", xhat, blocks_rev, h, dev)
    _check_rows("banded_sage_ln_bwd x", x, blocks_rev, d, dev)
    if rstd.shape != (n, 1) or rstd.dtype != torch.float32 or not rstd.is_contiguous():
        raise ValueError(f"banded_sage_ln_bwd: rstd must be contiguous float32 [{n}, 1]")
    gamma_f, beta_f = _f32(dev, gamma), _f32(dev, beta)
    nb = blocks_rev.num_dst_blocks
    dyu = torch.empty((n, h), device=dev, dtype=BF16)
    dyo = torch.empty((n, h), device=dev, dtype=BF16)
    stats_part = torch.empty((nb, 3, h), device=dev, dtype=torch.float32)
    dstats = torch.zeros((4, h), device=dev, dtype=torch.float32)
    from . import _build

    lib = _build.load()
    with torch.cuda.device(dev):
        code = lib.ln_bwd_prologue_launch(
            nb, blocks_rev.tile, g.data_ptr(), int(g.dtype == BF16), xhat.data_ptr(),
            int(xhat.dtype == BF16), rstd.data_ptr(), gamma_f.data_ptr(), beta_f.data_ptr(), h,
            int(negative_slope is not None), float(negative_slope or 0.0),
            dyu.data_ptr(), dyo.data_ptr(), stats_part.data_ptr(), dstats.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, code, f"ln_bwd prologue kernel (nb={nb}, H={h})")
        dx, dwl, dwr = _bwd_launch(lib, dev, blocks_rev, dyu, dyo, rstd, wl, wr, x, resid,
                                   x.dtype, None)
    banded_sage_ln_bwd.launches += 1
    return dx, dwl, dwr, dstats


banded_sage_ln_bwd.launches = 0


# ------------------------------------------------------------ autograd


def _expand_compact(out: torch.Tensor, r: torch.Tensor, rg: torch.Tensor) -> torch.Tensor:
    """Add each group's compact residual slot to the full output (a gather
    by the group -> slot map; residual-free groups read the zeros slot)."""
    n_pad, d = out.shape
    return out + r[rg.long()].reshape(n_pad, d).to(out.dtype)


def _fused_fwd_impl(x, wl, wr, bias, blocks, use_pallas, slope, resid=None, ln=None, eps=1e-5,
                    ypre=None):
    """The layer's forward; with ``ln`` it returns ``(out, xhat, rstd)``,
    and with ``ypre=(rg_b, m_b)`` ``y_pre_c`` after those. ``resid=(r, rg)``:
    the compact residual ``r [m, K*T, D]`` f32 added to the aggregate of the
    groups with ``rg > 0`` (a ``BandedResidualLayout``'s, or the halo
    layers' boundary and interior overflow)."""
    if use_pallas:
        rs = None if resid is None else (resid[0].to(x.dtype), resid[1])
        return banded_sage_fwd(x, wl, wr, bias, blocks, negative_slope=slope, resid=rs, ln=ln,
                               eps=eps, ypre=ypre)
    agg = spmm_banded_xla(x, blocks)
    if resid is not None:
        agg = _expand_compact(agg, *resid)
    y = _mm(agg, wl) + _mm(x, wr)
    if bias is not None:
        y = y + bias
    extra = () if ypre is None else (ypre_slots(y, ypre[0], ypre[1], blocks.k * blocks.tile),)
    if ln is None:
        out = _act(y, slope).to(x.dtype)
        return (out, *extra) if extra else out
    z, xhat, rstd = _ln_fwd_xla(y, *ln, eps)
    return (_act(z, slope).to(x.dtype), xhat.to(x.dtype), rstd, *extra)


def _layout_resid(x, resid):
    """A ``BandedResidualLayout``'s compact forward residual and its group
    map, or None."""
    return None if resid is None else (resid.compact_fwd(x), resid.rg_fwd)


def _xla_t(gq, blocks_rev, resid):
    """The f32 twin's ``t = A^T gq``, plus the compact reverse residual."""
    t = spmm_banded_xla(gq, blocks_rev)
    return t if resid is None else _expand_compact(t, resid.compact_rev(gq), resid.rg_rev)


def _unfused_t(gq, blocks_rev, use_pallas, resid):
    """``t = A^T gq`` where the fused reverse kernel does not run (a
    ``wide`` reverse layout, or the twin): the SpMM kernel without a
    residual (JAX ``sage_fused.py:630-633``), else the twin (the residual
    layer's, ``banded_residual.py:420-421``)."""
    if use_pallas and resid is None:
        from .spmm_banded import spmm_banded

        return spmm_banded(gq.contiguous(), blocks_rev)
    return _xla_t(gq, blocks_rev, resid)


def xla_grads(gq, x, wl, wr, t):
    """dx, dWl, dWr of the unfused backward from ``t = A^T gq``, products of
    the storage dtype summed in f32."""
    f32 = torch.float32
    dx = (t.float() @ wl.T.to(t.dtype).to(f32) + gq.float() @ wr.T.to(gq.dtype).to(f32))
    xt = x.T.float()
    return (dx.to(x.dtype), (xt @ t.to(x.dtype).float()).to(wl.dtype),
            (xt @ gq.to(x.dtype).float()).to(wr.dtype))


def mask_act(g, y, slope):
    """The gradient through the activation, from its output (leaky/relu keep
    the sign)."""
    if slope is None:
        return g
    return torch.where(y > 0, g, torch.tensor(slope, dtype=g.dtype, device=g.device) * g)


class _BandedSageFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wl, wr, bias, blocks_fwd, blocks_rev, use_pallas, slope, resid):
        y = _fused_fwd_impl(x, wl, wr, bias, blocks_fwd, use_pallas, slope,
                            _layout_resid(x, resid))
        ctx.save_for_backward(x, wl, wr, y if slope is not None else None)
        ctx.blocks_rev, ctx.use_pallas, ctx.slope, ctx.resid = blocks_rev, use_pallas, slope, resid
        ctx.bias_dtype = None if bias is None else bias.dtype
        return y

    @staticmethod
    def backward(ctx, g):
        x, wl, wr, y = ctx.saved_tensors
        resid = ctx.resid
        g = mask_act(g, y, ctx.slope)
        gq = g.to(x.dtype).contiguous()
        if ctx.use_pallas and not ctx.blocks_rev.wide:
            rs = None if resid is None else (resid.compact_rev(gq).to(gq.dtype), resid.rg_rev)
            dx, dwl, dwr = banded_sage_bwd(gq, wl, wr, ctx.blocks_rev, x=x, resid=rs)
            dx, dwl, dwr = dx.to(x.dtype), dwl.to(wl.dtype), dwr.to(wr.dtype)
        else:
            dx, dwl, dwr = xla_grads(gq, x, wl, wr,
                                     _unfused_t(gq, ctx.blocks_rev, ctx.use_pallas, resid))
        db = None if ctx.bias_dtype is None else g.sum(0).to(ctx.bias_dtype)
        return dx, dwl, dwr, db, None, None, None, None, None


def banded_sage_apply(x, wl, wr, bias, blocks_fwd: BandedBlocks, blocks_rev: BandedBlocks,
                      use_pallas: bool, negative_slope: float | None = None, resid=None):
    """Differentiable fused SAGE layer ``act(A x Wl + x Wr + bias)``
    (``bias`` may be None); the backward is one reverse aggregation.
    ``resid``: a ``BandedResidualLayout`` (see ``ops/banded_residual``)
    whose residual edges are added inside the fused kernels."""
    return _BandedSageFn.apply(x, wl, wr, bias, blocks_fwd, blocks_rev, use_pallas,
                               negative_slope, resid)


def ln_grads_out(dx, dwl, dwr, dstats, x, wl, wr, bias_dtype, gamma, beta):
    """The kernel path's LN-layer gradients at the parameters' dtypes."""
    db = None if bias_dtype is None else dstats[2].to(bias_dtype)
    return (dx.to(x.dtype), dwl.to(wl.dtype), dwr.to(wr.dtype), db,
            dstats[0].to(gamma.dtype), dstats[1].to(beta.dtype))


class _BandedSageLnFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wl, wr, bias, gamma, beta, blocks_fwd, blocks_rev, use_pallas, slope,
                eps, resid):
        out, xhat, rstd = _fused_fwd_impl(x, wl, wr, bias, blocks_fwd, use_pallas, slope,
                                          _layout_resid(x, resid),
                                          ln=(gamma, beta), eps=eps)
        ctx.save_for_backward(x, wl, wr, gamma, beta, xhat, rstd)
        ctx.blocks_rev, ctx.use_pallas, ctx.slope, ctx.resid = blocks_rev, use_pallas, slope, resid
        ctx.bias_dtype = None if bias is None else bias.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        x, wl, wr, gamma, beta, xhat, rstd = ctx.saved_tensors
        resid = ctx.resid
        if ctx.use_pallas and not ctx.blocks_rev.wide:
            rs = None
            if resid is not None:
                # dy of the few residual rows only, on the host side of the kernel
                rows = resid.r_dst.long()
                dy_r, _, _ = _ln_bwd_prologue(g[rows], xhat[rows], rstd[rows], gamma, beta,
                                              ctx.slope)
                rs = (resid.compact_rev(dy_r, gathered=True).to(x.dtype), resid.rg_rev)
            grads = ln_grads_out(*banded_sage_ln_bwd(
                g.to(x.dtype).contiguous(), xhat, rstd, wl, wr, gamma, beta, ctx.blocks_rev, x,
                negative_slope=ctx.slope, resid=rs), x, wl, wr, ctx.bias_dtype, gamma, beta)
        else:
            dy, dgamma, dbeta = _ln_bwd_prologue(g, xhat, rstd, gamma, beta, ctx.slope)
            gq = dy.to(x.dtype)
            dx, dwl, dwr = xla_grads(gq, x, wl, wr,
                                     _unfused_t(gq, ctx.blocks_rev, ctx.use_pallas, resid))
            db = None if ctx.bias_dtype is None else dy.sum(0).to(ctx.bias_dtype)
            grads = (dx, dwl, dwr, db, dgamma, dbeta)
        return (*grads, None, None, None, None, None, None)


def banded_sage_ln_apply(x, wl, wr, bias, gamma, beta, blocks_fwd: BandedBlocks,
                         blocks_rev: BandedBlocks, use_pallas: bool,
                         negative_slope: float | None = None, eps: float = 1e-5, resid=None):
    """Differentiable SAGE layer with its LayerNorm and activation,
    ``act(LN(A x Wl + x Wr + bias; gamma, beta, eps))``, one fused kernel
    each way (the forward saves xhat and rstd, not the pre-activation);
    ``resid`` as in :func:`banded_sage_apply`."""
    return _BandedSageLnFn.apply(x, wl, wr, bias, gamma, beta, blocks_fwd, blocks_rev,
                                 use_pallas, negative_slope, eps, resid)
