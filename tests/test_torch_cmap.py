"""The port's cmap (column-tile-indirect) banded tier (ops/spmm_cmap and the
cmap slots of ops/spmm_banded, sage_fused and banded_residual) against the
JAX package's (sldm_gnn_tpu/ops/spmm_cmap.py) on the CPU, at
tests/test_spmm_cmap.py's sizes and bounds, inputs made with numpy from a
seed:

  * the layouts equal the JAX builder's, cmap included (automatic and fixed
    c, with and without count_cap);
  * the f32 twins give the exact mean and its transpose at 1e-5;
  * the plain versions of csrc/spmm_banded.cu (both directions) and of the
    fused forward, backward and LN backward agree with the JAX kernels in
    interpret mode at test_spmm_cmap.py's bounds (2e-2, 3e-2 forward and
    5e-2 of max|g| on the gradients), and within 1e-2 of max|out|;
  * count_cap spills the multiplicity and the mean stays exact;
  * BlockedSageClassifier runs every mode on a cmap layout, held to the JAX
    model at 2e-4 / 2e-5.

The CUDA kernels run only on the card (chip_smoke.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sldm_gnn_tpu.models.blocked_sage import BlockedSageClassifier as JClassifier
from sldm_gnn_tpu.ops import banded_residual as jbr
from sldm_gnn_tpu.ops import sage_fused as jsf
from sldm_gnn_tpu.ops import spmm_banded as jsb
from sldm_gnn_tpu.ops.spmm_cmap import prepare_cmap_residual_mean_aggregate as jax_prepare

from sldm_gnn_tpu_torch.interop import params_to_state_dict
from sldm_gnn_tpu_torch.models.blocked_sage import BlockedSageClassifier
from sldm_gnn_tpu_torch.ops import banded_residual as tbr
from sldm_gnn_tpu_torch.ops import sage_fused as tsf
from sldm_gnn_tpu_torch.ops import spmm_banded as tsb
from sldm_gnn_tpu_torch.ops.spmm_cmap import prepare_cmap_residual_mean_aggregate

# plain kernel versions vs the interpret kernels, max|err| / max|out|: the
# same bf16 roundings, f32 sums in another order (tests/test_torch_banded.py)
KERNEL_REL = 1e-2
# ragged shapes of chip_smoke.py's sweep of the tensor-core kernels on a
# cmap layout: tile 64 beside the suite's 32, widths that are not multiples
# of 16 or 8, D != H (nodes, tile, D, H)
SWEEP = {"t64-d40-h4": (1024, 64, 40, 4), "t32-d4-h40": (512, 32, 4, 40)}
BLOCK_FIELDS = ("a", "bo", "woff", "off", "cmap", "row_scale", "col_scale")
RESID_FIELDS = ("r_src", "r_row_fwd", "r_w", "r_dst", "r_row_rev", "r_w_rev", "rg_fwd",
                "rg_rev")


def _low_degree_graph(rng, n=1024, deg=3, tile=32):
    """tests/test_spmm_cmap.py's generator: each destination block draws its
    sources from 4 preferred tiles scattered over +-8 tiles."""
    dst = np.repeat(np.arange(n, dtype=np.int64), deg)
    nb = n // tile
    prefs = np.clip(np.arange(nb)[:, None] + rng.integers(-8, 9, (nb, 4)), 0, nb - 1)
    pick = prefs[dst // tile, rng.integers(0, 4, len(dst))]
    src = np.clip(pick * tile + rng.integers(0, tile, len(dst)), 0, n - 1)
    return src.astype(np.int64), dst


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-12)


def _prepare(rng, n=512, tile=32, **kw):
    src, dst = _low_degree_graph(rng, n=n, tile=tile)
    kw = dict(tile=tile, k=2, range_budget=24, resid_frac=0.02) | kw
    tl, n_pad = prepare_cmap_residual_mean_aggregate(src, dst, n, **kw)
    jl, jn = jax_prepare(src, dst, n, **kw)
    assert n_pad == jn
    return src, dst, tl, jax.tree.map(jnp.asarray, jl), n_pad


def _dense_mean(src, dst, x, n):
    deg = np.bincount(dst, minlength=n)
    out = np.zeros((n, x.shape[1]), np.float32)
    np.add.at(out, dst, x[src] / np.maximum(deg, 1)[dst, None])
    return out


@pytest.mark.parametrize("kw", [dict(), dict(c=3, resid_frac=0.1), dict(count_cap=7),
                                dict(n=1024, k=4, range_budget=32, resid_frac=0.005)])
def test_layouts_equal_jax(rng, kw):
    _, _, tl, jl, _ = _prepare(rng, **kw)
    for side in ("banded_fwd", "banded_rev"):
        tb, jb = getattr(tl, side), getattr(jl, side)
        assert (tb.tile, tb.wsz, tb.k, tb.s_span) == (jb.tile, jb.wsz, jb.k, jb.s_span), side
        for f in BLOCK_FIELDS:
            a, b = getattr(tb, f), getattr(jb, f)
            assert (a is None) == (b is None), (side, f)
            if a is not None:
                assert a.numpy().dtype == np.asarray(b).dtype, (side, f)
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{side}.{f}")
    for f in RESID_FIELDS:
        np.testing.assert_array_equal(getattr(tl, f).numpy(), np.asarray(getattr(jl, f)),
                                      err_msg=f)
    assert (tl.n_pad, tl.m_fwd, tl.m_rev) == (jl.n_pad, jl.m_fwd, jl.m_rev)
    assert tl.resid_frac == pytest.approx(float(jl.resid_frac))


def test_cmap_slots_are_scattered_and_few(rng):
    """On the scattered generator the kept tile set is small and not a band:
    far fewer slots than the contiguous span, and cmap differs from the
    band's off + s in most blocks (so the cases below exercise cmap)."""
    n, tile = 1024, 32
    src, dst, tl, _, n_pad = _prepare(rng, n=n, tile=tile)
    db, sb = dst // tile, src // tile
    bo = np.zeros(n_pad // tile, np.int64)
    hi = np.zeros_like(bo)
    np.minimum.at(bo, db, sb)
    np.maximum.at(hi, db, sb)
    forced_span = int((hi - bo + 1).max())
    fwd = tl.banded_fwd
    assert fwd.s_span <= 6 < forced_span
    band = fwd.off.long()[:, None] + torch.arange(fwd.s_span)[None, :]
    differs = (fwd.cmap.long().reshape(-1, fwd.s_span) != band).any(dim=1)
    assert differs.float().mean() > 0.5


@pytest.mark.parametrize("n", [1024, 512])
def test_exact_mean_and_transpose(rng, n):
    """The f32 twin over the cmap layout plus the residual is the exact
    mean (1e-5), and its autograd the exact transpose (1e-5)."""
    src, dst, tl, _, n_pad = _prepare(rng, n=n)
    x = rng.standard_normal((n_pad, 16)).astype(np.float32)
    x[n:] = 0.0
    xt = _t(x).requires_grad_()
    out = tbr.spmm_banded_residual_apply(xt, tl, False)
    np.testing.assert_allclose(out.detach().numpy()[:n], _dense_mean(src, dst, x[:n], n),
                               rtol=1e-5, atol=1e-5)
    c = rng.standard_normal((n_pad, 16)).astype(np.float32)
    (g,) = torch.autograd.grad((out * _t(c)).sum(), [xt])
    deg = np.bincount(dst, minlength=n_pad)
    want = np.zeros((n_pad, 16), np.float32)
    np.add.at(want, src, c[dst] / np.maximum(deg, 1)[dst, None])
    np.testing.assert_allclose(g.numpy(), want, rtol=1e-5, atol=1e-5)


_SPMM_CASES = [("banded_fwd", None), ("banded_rev", None), ("banded_fwd", "t64-d40-h4"),
               ("banded_rev", "t64-d40-h4"), ("banded_fwd", "t32-d4-h40")]


@pytest.mark.parametrize("direction,shape", _SPMM_CASES,
                         ids=[c[0] + (f"-{c[1]}" if c[1] else "") for c in _SPMM_CASES])
@pytest.mark.parametrize("xdt", [np.float32, "bf16"])
def test_spmm_banded_plain_matches_pallas(rng, direction, shape, xdt):
    n, tile, d, _ = SWEEP[shape] if shape else (512, 32, 16, 16)
    _, _, tl, jl, n_pad = _prepare(rng, n=n, tile=tile)
    x = rng.standard_normal((n_pad, d)).astype(np.float32)
    xt, xj = _t(x), jnp.asarray(x)
    if xdt == "bf16":
        xt, xj = xt.to(torch.bfloat16), xj.astype(jnp.bfloat16)
    tb, jb = getattr(tl, direction), getattr(jl, direction)
    got = tsb.spmm_banded(xt, tb)
    assert got.dtype == xt.dtype
    want = np.asarray(jsb.spmm_banded_pallas(xj, jb, interpret=True), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2, atol=2e-2)
    assert _rel(got.float().numpy(), want) < KERNEL_REL
    # and the f32 twins agree with each other
    np.testing.assert_allclose(tsb.spmm_banded_xla(_t(x), tb).numpy(),
                               np.asarray(jsb.spmm_banded_xla(jnp.asarray(x), jb)),
                               rtol=1e-5, atol=1e-5)


def _fused_args(rng, n_pad, d=12, h=16):
    return dict(x=rng.standard_normal((n_pad, d)).astype(np.float32),
                wl=rng.standard_normal((d, h)).astype(np.float32) * 0.2,
                wr=rng.standard_normal((d, h)).astype(np.float32) * 0.2,
                b=rng.standard_normal((h,)).astype(np.float32) * 0.1,
                gamma=rng.standard_normal((h,)).astype(np.float32) * 0.3 + 1.0,
                beta=rng.standard_normal((h,)).astype(np.float32) * 0.1)


@pytest.mark.parametrize("mode", ["fused", "fused_ln"])
def test_fused_layers_match_interpret_kernels(rng, mode):
    """The fused SAGE and SAGE+LN layers over the cmap layout through the
    kernels' plain versions, forward and the gradients of a sum of squares,
    against the JAX custom VJPs over the interpreted kernels
    (test_spmm_cmap.py's 3e-2 and 5e-2 of max|g|)."""
    _, _, tl, jl, n_pad = _prepare(rng)
    a = _fused_args(rng, n_pad)
    names = ("x", "wl", "wr", "b") + (("gamma", "beta") if mode == "fused_ln" else ())
    ts = [_t(a[k]).requires_grad_() for k in names]
    js = [jnp.asarray(a[k]) for k in names]
    if mode == "fused":
        tf = lambda *v: tbr.banded_residual_sage_apply(*v, tl, True, 0.1)
        jf = lambda *v: jbr.banded_residual_sage_apply(*v, jl, True, 0.1, True)
    else:
        tf = lambda *v: tbr.banded_residual_sage_ln_apply(*v, tl, True, 0.1, 1e-5)
        jf = lambda *v: jbr.banded_residual_sage_ln_apply(*v, jl, True, 0.1, 1e-5, True)
    out = tf(*ts)
    (out ** 2).sum().backward()
    want = np.asarray(jf(*js))
    gj = jax.grad(lambda *v: jnp.sum(jf(*v) ** 2), argnums=tuple(range(len(js))))(*js)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=3e-2, atol=3e-2)
    assert _rel(out.detach().numpy(), want) < KERNEL_REL
    for t, w, name in zip(ts, gj, names):
        w = np.asarray(w)
        assert np.abs(t.grad.numpy() - w).max() / (np.abs(w).max() + 1e-9) < 5e-2, name


_FUSED_CASES = [(True, None), (False, None), (True, "t64-d40-h4"), (False, "t64-d40-h4"),
                (True, "t32-d4-h40")]


@pytest.mark.parametrize("with_x,shape", _FUSED_CASES,
                         ids=[str(c[0]) + (f"-{c[1]}" if c[1] else "") for c in _FUSED_CASES])
def test_fused_kernels_plain_match_pallas(rng, with_x, shape):
    """Each fused kernel's plain version on the cmap layouts against its
    Pallas kernel in interpret mode, with the compact residual: the forward
    (with LN), the backward (with and without x) and the LN backward."""
    n, tile, d, h = SWEEP[shape] if shape else (512, 32, 12, 16)
    _, _, tl, jl, n_pad = _prepare(rng, n=n, tile=tile)
    a = _fused_args(rng, n_pad, d=d, h=h)
    x, g = jnp.asarray(a["x"]), jnp.asarray(rng.standard_normal((n_pad, h)).astype(np.float32))
    ln = (jnp.asarray(a["gamma"]), jnp.asarray(a["beta"]))
    w = [jnp.asarray(a[k]) for k in ("wl", "wr", "b")]
    wt = [_t(a[k]) for k in ("wl", "wr", "b")]
    r_f = jbr.residual_fwd_compact(x, jl).astype(jnp.float32)
    want = jsf.banded_sage_fwd_pallas(x, *w, jl.banded_fwd, negative_slope=0.1,
                                      resid=(r_f, jl.rg_fwd), ln=ln, interpret=True)
    got = tsf.banded_sage_fwd(_t(a["x"]), *wt, tl.banded_fwd, negative_slope=0.1,
                              resid=(_t(np.asarray(r_f)), tl.rg_fwd),
                              ln=(_t(a["gamma"]), _t(a["beta"])))
    for u, v in zip(got, want):
        assert _rel(u.numpy(), v) < KERNEL_REL
    r_r = jbr.residual_rev_compact(g, jl)
    want = jsf.banded_sage_bwd_pallas(g, w[0], w[1], jl.banded_rev, x=x if with_x else None,
                                      resid=(r_r, jl.rg_rev), interpret=True)
    got = tsf.banded_sage_bwd(_t(np.asarray(g)), wt[0], wt[1], tl.banded_rev,
                              x=_t(a["x"]) if with_x else None,
                              resid=(_t(np.asarray(r_r)), tl.rg_rev))
    for u, v in zip(got, want):
        assert u.shape == v.shape and _rel(u.numpy(), v) < KERNEL_REL
    if not with_x:
        return
    _, xhat, rstd = jsf.banded_sage_fwd_pallas(x, *w, jl.banded_fwd, negative_slope=0.1,
                                               ln=ln, interpret=True)
    want = jsf.banded_sage_ln_bwd_pallas(g, xhat, rstd, w[0], w[1], *ln, jl.banded_rev, x,
                                         negative_slope=0.1, interpret=True)
    got = tsf.banded_sage_ln_bwd(_t(np.asarray(g)), _t(np.asarray(xhat)), _t(np.asarray(rstd)),
                                 wt[0], wt[1], _t(a["gamma"]), _t(a["beta"]), tl.banded_rev,
                                 _t(a["x"]), negative_slope=0.1)
    for u, v, name in zip(got, want, ("dx", "dwl", "dwr", "dstats")):
        assert u.shape == v.shape and _rel(u.numpy(), v) < KERNEL_REL, name


def test_count_cap_spills_multiplicity(rng):
    n, tile = 256, 32
    src, dst = _low_degree_graph(rng, n=n, tile=tile)
    src = np.concatenate([src, np.full(12, int(src[0]), np.int64)])
    dst = np.concatenate([dst, np.full(12, int(dst[0]), np.int64)])
    kw = dict(tile=tile, k=2, range_budget=24, resid_frac=0.05, count_cap=7)
    tl, n_pad = prepare_cmap_residual_mean_aggregate(src, dst, n, **kw)
    jl, _ = jax_prepare(src, dst, n, **kw)
    assert int(tl.banded_fwd.a.max()) <= 7
    np.testing.assert_array_equal(tl.r_src.numpy(), np.asarray(jl.r_src))
    x = rng.standard_normal((n_pad, 8)).astype(np.float32)
    x[n:] = 0.0
    out = tbr.spmm_banded_residual_apply(_t(x), tl, False)
    np.testing.assert_allclose(out.numpy()[:n], _dense_mean(src, dst, x[:n], n), rtol=1e-5,
                               atol=1e-5)


def test_int8_kernel_and_bad_cmaps_refuse(rng):
    """The int8 banded kernel keeps to the contiguous band (the JAX package
    asserts so); a builder given impossible limits raises."""
    _, _, tl, _, n_pad = _prepare(rng)
    xq = torch.zeros((n_pad, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="cmap"):
        tsb.spmm_banded_int8(xq, torch.ones(1), tl.banded_fwd)
    src, dst = _low_degree_graph(rng, n=512, tile=32)
    with pytest.raises(ValueError, match="residual fraction"):
        prepare_cmap_residual_mean_aggregate(src, dst, 512, tile=32, k=2, c=1,
                                             range_budget=24, resid_frac=0.001)


@pytest.mark.parametrize("mode", ["unfused", "fused", "fused_ln"])
def test_classifier_matches_jax_on_cmap_layout(rng, mode):
    """BlockedSageClassifier over the cmap BandedResidualLayout: the JAX
    model's logits (f32 paths, 2e-4 / 2e-5), and the kernel path (plain
    versions) within 5e-2 of max|logit| of them."""
    modes = {"unfused": {}, "fused": dict(fused=True), "fused_ln": dict(fused=True,
                                                                         fused_ln=True)}
    n = 512
    src, dst, tl, jl, n_pad = _prepare(rng, n=n)
    x = np.zeros((n_pad, 12), np.float32)
    x[:n] = rng.standard_normal((n, 12))
    jm = JClassifier((16, 16), 3, negative_slope=0.1, use_pallas=False, **modes[mode])
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jl, None, n_pad)["params"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jl, None, n_pad))
    for use_pallas in (False, True):
        tm = BlockedSageClassifier((16, 16), 3, in_features=12, negative_slope=0.1,
                                   use_pallas=use_pallas, **modes[mode])
        tm.load_state_dict(params_to_state_dict(params))
        with torch.no_grad():
            got = tm(_t(x), tl, None, n_pad).numpy()
        if use_pallas:
            assert _rel(got, want) < 5e-2
        else:
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
