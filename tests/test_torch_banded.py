"""The port's banded ops (sldm_gnn_tpu_torch.ops.spmm_banded, sage_fused,
banded_residual) against the JAX package's on the CPU, at the small sizes
of tests/test_spmm_banded.py, test_banded_residual.py and
test_sage_fused.py, inputs made with numpy from a seed:

  * the layouts equal the JAX builders' bit for bit (numpy paths, under
    100k edges);
  * the f32 twins (``use_pallas=False``) agree with JAX's within the JAX
    package's own bounds;
  * each kernel's plain version agrees with the JAX Pallas kernel run in
    interpret mode (same roundings; only the order of f32 sums differs).

The CUDA kernels run only on the card, where chip_smoke.py holds each one
against these plain versions."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sldm_gnn_tpu.ops import banded_residual as jbr
from sldm_gnn_tpu.ops import sage_fused as jsf
from sldm_gnn_tpu.ops import spmm_banded as jsb

from sldm_gnn_tpu_torch.graph import csr as tcsr
from sldm_gnn_tpu_torch.ops import banded_residual as tbr
from sldm_gnn_tpu_torch.ops import sage_fused as tsf
from sldm_gnn_tpu_torch.ops import spmm_banded as tsb

# f32 twins: the JAX package's bounds for its XLA paths (test_sage_fused.py
# :50 forward 1e-5, :72-73 VJP 2e-4, :210-211 LN VJP 2e-3; the LN forward
# against its composition 1e-4, :193; test_spmm_banded.py:41 the
# aggregation's gradient 1e-4)
FWD_TOL = 1e-5
LN_FWD_TOL = 1e-4
VJP_TOL = 2e-4
LN_VJP_TOL = 2e-3
AGG_GRAD_TOL = 1e-4
# plain kernel versions vs the Pallas kernels in interpret mode: the same
# bf16 roundings, f32 sums in another order. An order difference can flip
# one bf16 rounding of an intermediate (the aggregate before @ Wl, t before
# dx and dW): 2^-8 = 3.9e-3 relative of that value. 1e-2 of the output's
# max|value| bounds a few such flips and is tighter than the JAX contract
# for the kernels (3e-2, test_sage_fused.py:54).
KERNEL_REL = 1e-2

N, TILE, K, D, H = 2000, 64, 4, 16, 24
# ragged shapes (tile, D, H) of chip_smoke.py's sweep of the tensor-core
# kernels (spmm_banded, the fused forward and backward): tiles 32 and 128
# beside the suite's 64; widths that are not multiples of 16 or 8, D != H,
# the widest
SWEEP = {"t32-d40-h4": (32, 40, 4), "t128-d4-h40": (128, 4, 40),
         "t128-d128-h96": (128, 128, 96)}


def _banded_graph(rng, n=N, deg=6, reach=90):
    dst = np.repeat(np.arange(n, dtype=np.int64), deg)
    src = np.clip(dst + rng.integers(-reach, reach + 1, n * deg), 0, n - 1)
    return src, dst


def _near_banded_graph(rng, n=N, deg=6, reach=80, n_outliers=25):
    dst = np.repeat(np.arange(n, dtype=np.int64), deg)
    src = np.clip(dst + rng.integers(-reach, reach + 1, n * deg), 0, n - 1)
    o_dst = rng.integers(0, n, n_outliers)
    o_src = (o_dst + n // 2) % n
    return np.concatenate([src, o_dst]), np.concatenate([dst, o_src])


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_blocks_equal(tb, jb):
    for f in ("a", "bo", "woff", "off"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)),
                                      err_msg=f)
        assert getattr(tb, f).numpy().dtype == np.asarray(getattr(jb, f)).dtype, f
    assert (tb.wsz, tb.k, tb.tile, tb.s_span) == (jb.wsz, jb.k, jb.tile, jb.s_span)
    for f in ("row_scale", "col_scale"):
        a, b = getattr(tb, f), getattr(jb, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-12)


def _setup(rng, *, d=D, h=H, tile=TILE):
    src, dst = _banded_graph(rng)
    fwd, rev, n_pad = tsb.prepare_banded_mean_aggregate(src, dst, N, tile=tile, k=K)
    jf, jr, _ = jsb.prepare_banded_mean_aggregate(src, dst, N, tile=tile, k=K)
    jf, jr = jax.tree.map(jnp.asarray, (jf, jr))
    return fwd, rev, jf, jr, _setup_arrays(n_pad, d, h)


def _resid_setup(rng, *, d=D, h=H, tile=TILE):
    src, dst = _near_banded_graph(rng)
    span = max(3, 4 * TILE // tile)  # the suite's band in tiles of this size (tile 128: 3)
    lay, n_pad = tbr.prepare_banded_residual_mean_aggregate(src, dst, N, tile=tile, k=K,
                                                            span=span)
    jl, _ = jbr.prepare_banded_residual_mean_aggregate(src, dst, N, tile=tile, k=K, span=span)
    return lay, jax.tree.map(jnp.asarray, jl), _setup_arrays(n_pad, d, h)


def _setup_arrays(n_pad, d, h):
    r2 = np.random.default_rng(5)
    return dict(
        x=r2.standard_normal((n_pad, d)).astype(np.float32),
        wl=(r2.standard_normal((d, h)) * 0.2).astype(np.float32),
        wr=(r2.standard_normal((d, h)) * 0.2).astype(np.float32),
        b=(r2.standard_normal(h) * 0.1).astype(np.float32),
        gamma=(1.0 + 0.2 * r2.standard_normal(h)).astype(np.float32),
        beta=(0.1 * r2.standard_normal(h)).astype(np.float32),
        t=r2.standard_normal((n_pad, h)).astype(np.float32),
    )


# ------------------------------------------------------------ layouts


@pytest.mark.parametrize("dtype", [np.int8, np.float32])
def test_banded_layouts_equal_jax(rng, dtype):
    src, dst = _banded_graph(rng)
    tf, tr, tn = tsb.prepare_banded_mean_aggregate(src, dst, N, tile=TILE, k=K, dtype=dtype)
    jf, jr, jn = jsb.prepare_banded_mean_aggregate(src, dst, N, tile=TILE, k=K, dtype=dtype)
    assert tn == jn
    _assert_blocks_equal(tf, jf)
    _assert_blocks_equal(tr, jr)
    assert tsb.int4_count_safe(tf) == jsb.int4_count_safe(jf)


def test_banded_counts_forced_minimums_equal_jax(rng):
    src, dst = _banded_graph(rng, n=3000, deg=4, reach=100)
    kw = dict(tile=TILE, k=K, s_span_min=9, wsz_min=14)
    _assert_blocks_equal(tsb.build_banded_counts(src, dst, 3000, **kw),
                         jsb.build_banded_counts(src, dst, 3000, **kw))


def test_banded_tail_rebase_equals_jax(rng):
    """The clamped slot base of tail blocks (test_spmm_banded.py:66)."""
    n, tile = 1024, 64
    dst = np.concatenate([np.zeros(400, np.int64), np.arange(n - 3 * tile, n, dtype=np.int64)])
    src = np.concatenate([rng.integers(0, 6 * tile, 400).astype(np.int64),
                          np.arange(n - 3 * tile, n, dtype=np.int64)])
    tf, tr, _ = tsb.prepare_banded_mean_aggregate(src, dst, n, tile=tile, k=2)
    jf, jr, _ = jsb.prepare_banded_mean_aggregate(src, dst, n, tile=tile, k=2)
    assert tf.s_span == 6
    _assert_blocks_equal(tf, jf)
    _assert_blocks_equal(tr, jr)


@pytest.mark.parametrize("span,count_cap", [(4, None), (None, None), (4, 7)])
def test_residual_layout_equals_jax(rng, span, count_cap):
    src, dst = _near_banded_graph(rng)
    if count_cap is not None:
        src = np.concatenate([src, np.full(12, 100), np.full(9, 700)])
        dst = np.concatenate([dst, np.full(12, 103), np.full(9, 698)])
    tl, tn = tbr.prepare_banded_residual_mean_aggregate(src, dst, N, tile=TILE, k=K,
                                                        span=span, resid_frac=0.01,
                                                        count_cap=count_cap)
    jl, jn = jbr.prepare_banded_residual_mean_aggregate(src, dst, N, tile=TILE, k=K,
                                                        span=span, resid_frac=0.01,
                                                        count_cap=count_cap)
    assert tn == jn and len(tl.r_src) > 0
    _assert_blocks_equal(tl.banded_fwd, jl.banded_fwd)
    _assert_blocks_equal(tl.banded_rev, jl.banded_rev)
    for f in ("r_src", "r_row_fwd", "r_w", "r_dst", "r_row_rev", "r_w_rev", "rg_fwd", "rg_rev"):
        np.testing.assert_array_equal(getattr(tl, f).numpy(), np.asarray(getattr(jl, f)),
                                      err_msg=f)
        assert getattr(tl, f).numpy().dtype == np.asarray(getattr(jl, f)).dtype, f
    assert (tl.n_pad, tl.m_fwd, tl.m_rev, tl.resid_frac) == (jl.n_pad, jl.m_fwd, jl.m_rev,
                                                              jl.resid_frac)


def test_window_choice_equals_jax(rng):
    n, tile = 512, 32
    dst = np.zeros(64, np.int64)
    src = np.concatenate([[0], rng.integers(n - 64, n, 63)]).astype(np.int64)
    for span in (1, 2, 3):
        np.testing.assert_array_equal(
            tbr.split_banded_residual(src, dst, n // tile, tile=tile, span=span),
            jbr.split_banded_residual(src, dst, n // tile, tile=tile, span=span))


def test_builders_reject_what_jax_rejects(rng):
    n = 4096
    src = rng.integers(0, n, 20000).astype(np.int64)
    dst = rng.integers(0, n, 20000).astype(np.int64)
    with pytest.raises(ValueError, match="span"):
        tsb.build_banded_blocks(src, dst, n, tile=64, max_span=4)
    with pytest.raises(ValueError, match="not near-banded"):
        tbr.prepare_banded_residual_mean_aggregate(rng.integers(0, 1024, 8192),
                                                   rng.integers(0, 1024, 8192), 1024,
                                                   tile=32, max_span=4)
    with pytest.raises(ValueError, match="out of range"):
        tcsr.check_edge_range(np.array([0, 5]), np.array([1, 2]), 5)
    assert tcsr.pad_nodes(1, 64) == 64 and tcsr.pad_nodes(130, 64) == 192


# ------------------------------------------------------------ f32 twins


@pytest.mark.parametrize("dtype", [np.int8, np.float32])
def test_spmm_banded_xla_matches_jax(rng, dtype):
    src, dst = _banded_graph(rng)
    tf, tr, n_pad = tsb.prepare_banded_mean_aggregate(src, dst, N, tile=TILE, k=K, dtype=dtype)
    jf, jr, _ = jsb.prepare_banded_mean_aggregate(src, dst, N, tile=TILE, k=K, dtype=dtype)
    jf, jr = jax.tree.map(jnp.asarray, (jf, jr))
    a = _setup_arrays(n_pad, D, H)
    np.testing.assert_allclose(tsb.spmm_banded_xla(_t(a["x"]), tf).numpy(),
                               np.asarray(jsb.spmm_banded_xla(jnp.asarray(a["x"]), jf)),
                               rtol=FWD_TOL, atol=FWD_TOL)
    t = a["t"][:, :D]
    xt = _t(a["x"]).requires_grad_()
    (tsb.spmm_banded_apply(xt, tf, tr, False) * _t(t)).sum().backward()
    gj = jax.grad(lambda x: jnp.sum(jsb.spmm_banded_apply(x, jf, jr, False) * t))(
        jnp.asarray(a["x"]))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj), rtol=AGG_GRAD_TOL,
                               atol=AGG_GRAD_TOL)


def _grads_t(fn, arrs, names):
    ts = [_t(arrs[n]).requires_grad_() for n in names]
    fn(*ts).backward()
    return [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("slope", [None, 0.0, 0.1])
@pytest.mark.parametrize("bias", [True, False])
def test_fused_xla_forward_matches_jax(rng, slope, bias):
    fwd, rev, jf, jr, a = _setup(rng)
    b = a["b"] if bias else None
    got = tsf.banded_sage_apply(_t(a["x"]), _t(a["wl"]), _t(a["wr"]),
                                None if b is None else _t(b), fwd, rev, False, slope)
    want = jsf.banded_sage_apply(jnp.asarray(a["x"]), jnp.asarray(a["wl"]),
                                 jnp.asarray(a["wr"]), None if b is None else jnp.asarray(b),
                                 jf, jr, False, slope)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=FWD_TOL,
                               atol=FWD_TOL)


@pytest.mark.parametrize("slope", [None, 0.1])
def test_fused_xla_vjp_matches_jax(rng, slope):
    fwd, rev, jf, jr, a = _setup(rng)
    names = ("x", "wl", "wr", "b")
    got = _grads_t(lambda x, wl, wr, b: (tsf.banded_sage_apply(
        x, wl, wr, b, fwd, rev, False, slope) * _t(a["t"])).sum(), a, names)
    want = jax.grad(lambda x, wl, wr, b: jnp.sum(jsf.banded_sage_apply(
        x, wl, wr, b, jf, jr, False, slope) * a["t"]), argnums=(0, 1, 2, 3))(
        *[jnp.asarray(a[n]) for n in names])
    for g, w, n in zip(got, want, names):
        np.testing.assert_allclose(g, np.asarray(w), rtol=VJP_TOL, atol=VJP_TOL, err_msg=n)


@pytest.mark.parametrize("slope", [0.0, 0.1])
def test_ln_fused_xla_matches_jax(rng, slope):
    fwd, rev, jf, jr, a = _setup(rng)
    names = ("x", "wl", "wr", "b", "gamma", "beta")
    out = tsf.banded_sage_ln_apply(*[_t(a[n]) for n in names], fwd, rev, False, slope)
    want = jsf.banded_sage_ln_apply(*[jnp.asarray(a[n]) for n in names], jf, jr, False, slope)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=LN_FWD_TOL, atol=LN_FWD_TOL)
    got = _grads_t(lambda *v: (tsf.banded_sage_ln_apply(*v, fwd, rev, False, slope)
                               * _t(a["t"])).sum(), a, names)
    want_g = jax.grad(lambda *v: jnp.sum(jsf.banded_sage_ln_apply(
        *v, jf, jr, False, slope) * a["t"]), argnums=tuple(range(6)))(
        *[jnp.asarray(a[n]) for n in names])
    for g, w, n in zip(got, want_g, names):
        np.testing.assert_allclose(g, np.asarray(w), rtol=LN_VJP_TOL, atol=LN_VJP_TOL,
                                   err_msg=n)


def test_residual_aggregation_matches_jax(rng):
    lay, jl, a = _resid_setup(rng)
    x, t = a["x"], a["t"][:, :D]
    np.testing.assert_array_equal(tbr.residual_fwd_compact(_t(x), lay)[0].numpy(), 0.0)
    xt = _t(x).requires_grad_()
    out = tbr.spmm_banded_residual_apply(xt, lay, False)
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jbr.spmm_banded_residual_apply(jnp.asarray(x), jl,
                                                                         False)),
                               rtol=FWD_TOL, atol=FWD_TOL)
    (out * _t(t)).sum().backward()
    gj = jax.grad(lambda v: jnp.sum(jbr.spmm_banded_residual_apply(v, jl, False) * t))(
        jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj), rtol=AGG_GRAD_TOL,
                               atol=AGG_GRAD_TOL)


@pytest.mark.parametrize("slope", [None, 0.0])
def test_residual_fused_xla_matches_jax(rng, slope):
    lay, jl, a = _resid_setup(rng)
    names = ("x", "wl", "wr", "b")
    out = tbr.banded_residual_sage_apply(*[_t(a[n]) for n in names], lay, False, slope)
    want = jbr.banded_residual_sage_apply(*[jnp.asarray(a[n]) for n in names], jl, False, slope)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=FWD_TOL, atol=FWD_TOL)
    got = _grads_t(lambda *v: (tbr.banded_residual_sage_apply(*v, lay, False, slope)
                               * _t(a["t"])).sum(), a, names)
    want_g = jax.grad(lambda *v: jnp.sum(jbr.banded_residual_sage_apply(
        *v, jl, False, slope) * a["t"]), argnums=(0, 1, 2, 3))(
        *[jnp.asarray(a[n]) for n in names])
    for g, w, n in zip(got, want_g, names):
        np.testing.assert_allclose(g, np.asarray(w), rtol=VJP_TOL, atol=VJP_TOL, err_msg=n)


@pytest.mark.parametrize("slope", [0.0, 0.1])
def test_residual_ln_xla_matches_jax(rng, slope):
    lay, jl, a = _resid_setup(rng)
    names = ("x", "wl", "wr", "b", "gamma", "beta")
    out = tbr.banded_residual_sage_ln_apply(*[_t(a[n]) for n in names], lay, False, slope)
    want = jbr.banded_residual_sage_ln_apply(*[jnp.asarray(a[n]) for n in names], jl, False,
                                             slope)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=LN_FWD_TOL, atol=LN_FWD_TOL)
    got = _grads_t(lambda *v: (tbr.banded_residual_sage_ln_apply(*v, lay, False, slope)
                               * _t(a["t"])).sum(), a, names)
    want_g = jax.grad(lambda *v: jnp.sum(jbr.banded_residual_sage_ln_apply(
        *v, jl, False, slope) * a["t"]), argnums=tuple(range(6)))(
        *[jnp.asarray(a[n]) for n in names])
    for g, w, n in zip(got, want_g, names):
        np.testing.assert_allclose(g, np.asarray(w), rtol=LN_VJP_TOL, atol=LN_VJP_TOL,
                                   err_msg=n)


# ------------------------------------------------------------ plain kernels


_SPMM_CASES = [("fwd", np.int8, None), ("rev", np.int8, None), ("fwd", np.float32, None),
               ("fwd", np.int8, "t32-d40-h4"), ("rev", np.int8, "t128-d4-h40"),
               ("fwd", np.float32, "t128-d128-h96"), ("rev", np.float32, "t32-d40-h4")]


@pytest.mark.parametrize("direction,dtype,shape", _SPMM_CASES,
                         ids=[f"{c[0]}-{np.dtype(c[1]).name}" + (f"-{c[2]}" if c[2] else "")
                              for c in _SPMM_CASES])
@pytest.mark.parametrize("xdt", [np.float32, "bf16"])
def test_spmm_banded_plain_matches_pallas(rng, direction, dtype, shape, xdt):
    tile, d, _ = SWEEP[shape] if shape else (TILE, D, H)
    src, dst = _banded_graph(rng)
    tf, tr, n_pad = tsb.prepare_banded_mean_aggregate(src, dst, N, tile=tile, k=K, dtype=dtype)
    jf, jr, _ = jsb.prepare_banded_mean_aggregate(src, dst, N, tile=tile, k=K, dtype=dtype)
    tb, jb = (tf, jf) if direction == "fwd" else (tr, jr)
    x = _setup_arrays(n_pad, d, H)["x"]
    xt, xj = _t(x), jnp.asarray(x)
    if xdt == "bf16":
        xt, xj = xt.to(torch.bfloat16), xj.astype(jnp.bfloat16)
    got = tsb.spmm_banded(xt, tb)
    assert got.dtype == xt.dtype
    want = jsb.spmm_banded_pallas(xj, jax.tree.map(jnp.asarray, jb), interpret=True)
    assert _max_rel(got.float().numpy(), np.asarray(want, np.float32)) < KERNEL_REL


_FWD_CASES = [(None, True, False, None), (0.1, False, False, None), (0.0, True, True, None),
              (0.1, True, True, None),
              (None, True, False, "t32-d40-h4"), (0.1, True, True, "t32-d40-h4"),
              (0.0, False, False, "t128-d4-h40"), (0.0, True, True, "t128-d4-h40"),
              (None, True, False, "t128-d128-h96"), (0.1, False, True, "t128-d128-h96")]


@pytest.mark.parametrize("slope,bias,ln,shape", _FWD_CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}" + (f"-{c[3]}" if c[3] else "")
                              for c in _FWD_CASES])
def test_fused_fwd_plain_matches_pallas(rng, slope, bias, ln, shape):
    tile, d, h = SWEEP[shape] if shape else (TILE, D, H)
    fwd, _, jf, _, a = _setup(rng, d=d, h=h, tile=tile)
    b = a["b"] if bias else None
    lnt = (_t(a["gamma"]), _t(a["beta"])) if ln else None
    lnj = (jnp.asarray(a["gamma"]), jnp.asarray(a["beta"])) if ln else None
    got = tsf.banded_sage_fwd(_t(a["x"]), _t(a["wl"]), _t(a["wr"]),
                              None if b is None else _t(b), fwd, negative_slope=slope, ln=lnt)
    want = jsf.banded_sage_fwd_pallas(jnp.asarray(a["x"]), jnp.asarray(a["wl"]),
                                      jnp.asarray(a["wr"]), None if b is None else jnp.asarray(b),
                                      jf, negative_slope=slope, ln=lnj, interpret=True)
    got = got if ln else (got,)
    want = want if ln else (want,)
    for g, w in zip(got, want):
        assert g.shape == w.shape and _max_rel(g.numpy(), w) < KERNEL_REL


_FWD_RESID_CASES = [(False, np.float32, None), (False, "bf16", None), (True, np.float32, None),
                    (True, "bf16", None),
                    (False, "bf16", "t32-d40-h4"), (True, np.float32, "t32-d40-h4"),
                    (True, "bf16", "t128-d4-h40"), (False, np.float32, "t128-d4-h40"),
                    (True, "bf16", "t128-d128-h96"), (False, np.float32, "t128-d128-h96")]


@pytest.mark.parametrize("ln,xdt,shape", _FWD_RESID_CASES,
                         ids=[f"{c[0]}-{'bf16' if c[1] == 'bf16' else 'float32'}"
                              + (f"-{c[2]}" if c[2] else "") for c in _FWD_RESID_CASES])
def test_fused_fwd_plain_with_residual_matches_pallas(rng, xdt, ln, shape):
    tile, d, h = SWEEP[shape] if shape else (TILE, D, H)
    lay, jl, a = _resid_setup(rng, d=d, h=h, tile=tile)
    x = jnp.asarray(a["x"])
    r = jbr.residual_fwd_compact(x, jl)
    if xdt == "bf16":
        x, r = x.astype(jnp.bfloat16), r.astype(jnp.bfloat16)
    else:
        r = r.astype(jnp.float32)
    xt, rt = _t(np.asarray(x.astype(jnp.float32))), _t(np.asarray(r.astype(jnp.float32)))
    if xdt == "bf16":
        xt, rt = xt.to(torch.bfloat16), rt.to(torch.bfloat16)
    lnt = (_t(a["gamma"]), _t(a["beta"])) if ln else None
    lnj = (jnp.asarray(a["gamma"]), jnp.asarray(a["beta"])) if ln else None
    got = tsf.banded_sage_fwd(xt, _t(a["wl"]), _t(a["wr"]), _t(a["b"]), lay.banded_fwd,
                              negative_slope=0.0, resid=(rt, lay.rg_fwd), ln=lnt)
    want = jsf.banded_sage_fwd_pallas(x, jnp.asarray(a["wl"]), jnp.asarray(a["wr"]),
                                      jnp.asarray(a["b"]), jl.banded_fwd, negative_slope=0.0,
                                      resid=(r, jl.rg_fwd), ln=lnj, interpret=True)
    got = got if ln else (got,)
    want = want if ln else (want,)
    for g, w in zip(got, want):
        assert g.dtype == (torch.float32 if g.shape[1] == 1 else xt.dtype)
        assert _max_rel(g.float().numpy(), np.asarray(w, np.float32)) < KERNEL_REL


_BWD_CASES = [(False, None), (True, None), (False, "t32-d40-h4"), (False, "t128-d4-h40"),
              (False, "t128-d128-h96"), (True, "t32-d40-h4")]


@pytest.mark.parametrize("with_x", [True, False])
@pytest.mark.parametrize("resid,shape", _BWD_CASES,
                         ids=[str(c[0]) + (f"-{c[1]}" if c[1] else "") for c in _BWD_CASES])
def test_fused_bwd_plain_matches_pallas(rng, with_x, resid, shape):
    tile, d, h = SWEEP[shape] if shape else (TILE, D, H)
    if resid:
        lay, jl, a = _resid_setup(rng, d=d, h=h, tile=tile)
        rev, jrev = lay.banded_rev, jl.banded_rev
        tr = jbr.residual_rev_compact(jnp.asarray(a["t"]), jl)
        rt, rj = (_t(np.asarray(tr)), lay.rg_rev), (tr, jl.rg_rev)
    else:
        _, rev, _, jrev, a = _setup(rng, d=d, h=h, tile=tile)
        rt = rj = None
    gq = a["t"]
    got = tsf.banded_sage_bwd(_t(gq), _t(a["wl"]), _t(a["wr"]), rev,
                              x=_t(a["x"]) if with_x else None, resid=rt)
    want = jsf.banded_sage_bwd_pallas(jnp.asarray(gq), jnp.asarray(a["wl"]),
                                      jnp.asarray(a["wr"]), jrev,
                                      x=jnp.asarray(a["x"]) if with_x else None, resid=rj,
                                      interpret=True)
    assert len(got) == len(want) == (3 if with_x else 2)
    for g, w in zip(got, want):
        assert g.shape == w.shape and _max_rel(g.numpy(), w) < KERNEL_REL


_LN_BWD_CASES = [(0.0, False, None), (0.1, False, None), (None, False, None), (0.0, True, None),
                 (0.1, False, "t32-d40-h4"), (0.0, False, "t128-d4-h40"),
                 (None, False, "t128-d128-h96"), (0.0, True, "t32-d40-h4")]


@pytest.mark.parametrize("slope,resid,shape", _LN_BWD_CASES,
                         ids=[f"{c[0]}-{c[1]}" + (f"-{c[2]}" if c[2] else "")
                              for c in _LN_BWD_CASES])
def test_ln_bwd_plain_matches_pallas(rng, slope, resid, shape):
    tile, d, h = SWEEP[shape] if shape else (TILE, D, H)
    if resid:
        lay, jl, a = _resid_setup(rng, d=d, h=h, tile=tile)
        rev, jrev, fwd_j = lay.banded_rev, jl.banded_rev, jl.banded_fwd
    else:
        _, rev, fwd_j, jrev, a = _setup(rng, d=d, h=h, tile=tile)
    ln = (jnp.asarray(a["gamma"]), jnp.asarray(a["beta"]))
    _, xhat, rstd = jsf.banded_sage_fwd_pallas(
        jnp.asarray(a["x"]), jnp.asarray(a["wl"]), jnp.asarray(a["wr"]), jnp.asarray(a["b"]),
        fwd_j, negative_slope=slope, ln=ln, interpret=True)
    g = a["t"]
    if resid:
        rows = jl.r_dst
        dy_r, _, _ = jsf._ln_bwd_prologue(jnp.asarray(g)[rows], xhat[rows], rstd[rows], *ln,
                                          slope)
        kt = jl.group_rows
        t_r = jax.ops.segment_sum(dy_r * jl.r_w_rev[:, None], jl.r_row_rev,
                                  num_segments=jl.m_rev * kt).reshape(jl.m_rev, kt, h)
        rj, rt = (t_r, jl.rg_rev), (_t(np.asarray(t_r)), lay.rg_rev)
    else:
        rj = rt = None
    got = tsf.banded_sage_ln_bwd(_t(g), _t(np.asarray(xhat)), _t(np.asarray(rstd)),
                                 _t(a["wl"]), _t(a["wr"]), _t(a["gamma"]), _t(a["beta"]), rev,
                                 _t(a["x"]), negative_slope=slope, resid=rt)
    want = jsf.banded_sage_ln_bwd_pallas(jnp.asarray(g), xhat, rstd, jnp.asarray(a["wl"]),
                                         jnp.asarray(a["wr"]), *ln, jrev, jnp.asarray(a["x"]),
                                         negative_slope=slope, resid=rj, interpret=True)
    for g_, w, name in zip(got, want, ("dx", "dwl", "dwr", "dstats")):
        assert g_.shape == w.shape, name
        assert _max_rel(g_.numpy(), w) < KERNEL_REL, name


def test_kernel_path_matches_pallas_end_to_end(rng):
    """banded_sage_apply(use_pallas=True) on CPU tensors (plain versions)
    against the JAX custom VJP over the interpreted kernels: forward and
    every gradient of a sum-of-squares loss."""
    fwd, rev, jf, jr, a = _setup(rng, d=16, h=16)
    names = ("x", "wl", "wr", "b")
    ts = [_t(a[n]).requires_grad_() for n in names]
    y = tsf.banded_sage_apply(*ts, fwd, rev, True, 0.0)
    (y ** 2).sum().backward()
    js = [jnp.asarray(t.detach().numpy()) for t in ts]
    yj, gj = jax.value_and_grad(lambda *v: jnp.sum(jsf.banded_sage_apply(
        *v, jf, jr, True, 0.0, True) ** 2), argnums=(0, 1, 2, 3))(*js)
    assert abs((y ** 2).sum().item() - float(yj)) / abs(float(yj)) < KERNEL_REL
    for t, w, n in zip(ts, gj, names):
        assert _max_rel(t.grad.numpy(), w) < KERNEL_REL, n


def test_cpu_wrappers_run_plain_versions_without_counting(rng):
    fwd, rev, _, _, a = _setup(rng)
    x = _t(a["x"])
    before = (tsb.spmm_banded.launches, tsf.banded_sage_fwd.launches,
              tsf.banded_sage_bwd.launches, tsf.banded_sage_ln_bwd.launches)
    assert torch.equal(tsb.spmm_banded(x, fwd), tsb.spmm_banded_plain(x, fwd))
    assert torch.equal(tsf.banded_sage_fwd(x, _t(a["wl"]), _t(a["wr"]), None, fwd),
                       tsf.banded_sage_fwd_plain(x, _t(a["wl"]), _t(a["wr"]), None, fwd))
    assert (tsb.spmm_banded.launches, tsf.banded_sage_fwd.launches,
            tsf.banded_sage_bwd.launches, tsf.banded_sage_ln_bwd.launches) == before


def test_layouts_left_out_raise(rng):
    """``wide`` layouts (``widen_banded``) run the aggregation, bit-equal to
    the narrow layout's; the fused kernels refuse them (ValueError) and
    cmap layouts stay narrow, as the JAX package asserts
    (``sage_fused.py:192``, ``spmm_banded.py:101``). ``cmap`` slots are
    ported (tests/test_torch_cmap.py): a cmap that names each block's own
    band (``off[b] + s``) reads the contiguous layout's tiles, bit for
    bit."""
    import dataclasses

    fwd, rev, _, _, a = _setup(rng)
    x = _t(a["x"])
    wide = tsb.widen_banded(fwd)
    for fn in (tsb.spmm_banded_xla, tsb.spmm_banded_plain, tsb.spmm_banded):
        assert torch.equal(fn(x, wide), fn(x, fwd))
    with pytest.raises(ValueError):
        tsf.banded_sage_fwd(x, _t(a["wl"]), _t(a["wr"]), None, wide)
    band = (fwd.off.long()[:, None] + torch.arange(fwd.s_span)[None, :]).to(torch.int32)
    cmap = dataclasses.replace(fwd, cmap=band.reshape(-1).contiguous())
    with pytest.raises(ValueError):
        tsb.widen_banded(cmap)
    for fn in (tsb.spmm_banded_xla, tsb.spmm_banded_plain, tsb.spmm_banded):
        assert torch.equal(fn(x, cmap), fn(x, fwd))
    assert torch.equal(tsf.banded_sage_fwd(x, _t(a["wl"]), _t(a["wr"]), None, cmap),
                       tsf.banded_sage_fwd(x, _t(a["wl"]), _t(a["wr"]), None, fwd))
