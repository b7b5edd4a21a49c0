"""The port's banded row-gather SpMM (sldm_gnn_tpu_torch.ops.spmm_gather)
against the JAX package's on the CPU, at the sizes of
tests/test_spmm_gather.py, inputs from numpy with a seed: the layouts equal
the JAX builder's bit for bit, the plain version of csrc/spmm_gather.cu
agrees with the JAX Pallas kernel in interpret mode (which the JAX package
keeps off on the TPU, where it runs the XLA form), and the residual
aggregation and its gradient agree with JAX's."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sldm_gnn_tpu.ops import spmm_gather as jsg

from sldm_gnn_tpu_torch.ops import spmm_gather as tsg

KERNEL_REL = 1e-5  # plain vs interpret kernel: the same f32 products, sums in another order
RTOL, ATOL = 1e-5, 1e-5  # the JAX tests' bounds (test_spmm_gather.py:41, :55, :71)
BLOCK_FIELDS = ("codes", "mult", "bo", "woff", "off", "row_scale", "col_scale")
RESID_FIELDS = ("r_src", "r_row_fwd", "r_w", "r_dst", "r_row_rev", "r_w_rev", "rg_fwd", "rg_rev")


def _city_like(rng, n=3000, reach=150, skew=0.005, skew_extra=12):
    deg = rng.poisson(3, n) + 1
    deg[rng.random(n) < skew] += skew_extra
    dst = np.repeat(np.arange(n), deg)
    src = np.clip(dst + rng.integers(-reach, reach + 1, len(dst)), 0, n - 1)
    return src, dst


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-12)


def _assert_layout_equal(t, j):
    for tb, jb in ((t.gather_fwd, j.gather_fwd), (t.gather_rev, j.gather_rev)):
        for f in BLOCK_FIELDS:
            a, b = getattr(tb, f), getattr(jb, f)
            assert (a is None) == (b is None), f
            if a is not None:
                assert a.numpy().dtype == np.asarray(b).dtype, f
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
        assert (tb.tile, tb.wsz, tb.k, tb.r) == (jb.tile, jb.wsz, jb.k, jb.r)
    for f in RESID_FIELDS:
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)),
                                      err_msg=f)
    assert (t.n_pad, t.m_fwd, t.m_rev, t.resid_frac) == (j.n_pad, j.m_fwd, j.m_rev,
                                                          j.resid_frac)


@pytest.mark.parametrize("kw", [dict(tile=64, k=2), dict(tile=64, k=2, r=8, resid_frac=0.1),
                                dict(tile=32, k=2, resid_frac=0.05)])
def test_layouts_equal_jax(rng, kw):
    src, dst = _city_like(rng, n=2000)
    tl, tn = tsg.prepare_gather_residual_mean_aggregate(src, dst, 2000, **kw)
    jl, jn = jsg.prepare_gather_residual_mean_aggregate(src, dst, 2000, **kw)
    assert tn == jn
    _assert_layout_equal(tl, jl)


def test_multigraph_layout_equals_jax(rng):
    """Duplicate (src, dst) pairs fold into mult (test_spmm_gather.py:74)."""
    n = 256
    base_src, base_dst = rng.integers(0, n, 600), rng.integers(0, n, 600)
    src = np.concatenate([base_src, base_src[:100]])
    dst = np.concatenate([base_dst, base_dst[:100]])
    src = np.clip(dst + (src - dst) % 80 - 40, 0, n - 1)
    tl, _ = tsg.prepare_gather_residual_mean_aggregate(src, dst, n, tile=32, k=2)
    jl, _ = jsg.prepare_gather_residual_mean_aggregate(src, dst, n, tile=32, k=2)
    _assert_layout_equal(tl, jl)
    assert float(tl.gather_fwd.mult.max()) > 1


@pytest.mark.parametrize("xdt", [np.float32, "bf16"])
def test_plain_matches_pallas_and_xla(rng, xdt):
    src, dst = _city_like(rng, n=1500)
    tl, n_pad = tsg.prepare_gather_residual_mean_aggregate(src, dst, 1500, tile=64, k=2)
    jl, _ = jsg.prepare_gather_residual_mean_aggregate(src, dst, 1500, tile=64, k=2)
    fwd = jax.tree.map(jnp.asarray, jl.gather_fwd)
    x = rng.standard_normal((n_pad, 16)).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    if xdt == "bf16":
        xt, xj = xt.to(torch.bfloat16), xj.astype(jnp.bfloat16)
    got = tsg.spmm_gather(xt, tl.gather_fwd)
    assert got.dtype == xt.dtype
    want = np.asarray(jsg.spmm_gather_pallas(xj, fwd, interpret=True), np.float32)
    # bf16 out: both round the f32 sum to bf16 once (one ulp apart at most)
    assert _max_rel(got.float().numpy(), want) < (KERNEL_REL if xdt != "bf16" else 2.0 ** -8)
    got_x = tsg.spmm_gather_xla(xt, tl.gather_fwd)
    want_x = np.asarray(jsg.spmm_gather_xla(xj, fwd), np.float32)
    assert _max_rel(got_x.float().numpy(), want_x) < (KERNEL_REL if xdt != "bf16" else 2.0 ** -8)


# (tile, slot cap r, D, x dtype): the card sweep's ragged shapes, with slot
# counts that are not a multiple of the kernel's 4-slot unroll and widths
# that are not a multiple of its 16-byte loads (8 bf16 or 4 f32 columns),
# but for bf16 at D 40 (the vector loads below the widest row)
RAGGED = [(32, 3, 1, np.float32), (32, 9, 7, np.float32), (32, 13, 127, np.float32),
          (64, 9, 40, "bf16"), (32, 5, 127, "bf16")]


@pytest.mark.parametrize("tile,r,d,xdt", RAGGED,
                         ids=[f"T{t}-R{r}-D{d}-{'bf16' if x == 'bf16' else 'f32'}"
                              for t, r, d, x in RAGGED])
def test_plain_matches_pallas_at_ragged_shapes(rng, tile, r, d, xdt):
    """The plain version against the JAX interpret kernel and the XLA form
    on both layouts (the reverse one with its column scale folded into x,
    as the dispatch does), with one non-finite x row."""
    src, dst = _city_like(rng, n=1200)
    kw = dict(tile=tile, k=2, r=r, resid_frac=0.25)
    tl, n_pad = tsg.prepare_gather_residual_mean_aggregate(src, dst, 1200, **kw)
    jl, _ = jsg.prepare_gather_residual_mean_aggregate(src, dst, 1200, **kw)
    assert tl.gather_fwd.r == r
    x = rng.standard_normal((n_pad, d)).astype(np.float32)
    x[0] = np.inf  # the first window's base row, where padding slots point (times 0)
    for tb, jb in ((tl.gather_fwd, jl.gather_fwd), (tl.gather_rev, jl.gather_rev)):
        xs = x if jb.col_scale is None else x * np.asarray(jb.col_scale)
        jb = jax.tree.map(jnp.asarray, dataclasses.replace(jb, col_scale=None))
        tb = dataclasses.replace(tb, col_scale=None)
        xt, xj = torch.from_numpy(xs), jnp.asarray(xs)
        if xdt == "bf16":
            xt, xj = xt.to(torch.bfloat16), xj.astype(jnp.bfloat16)
        got = tsg.spmm_gather(xt, tb).float().numpy()
        bound = KERNEL_REL if xdt != "bf16" else 2.0 ** -8
        for want in (jsg.spmm_gather_pallas(xj, jb, interpret=True), jsg.spmm_gather_xla(xj, jb)):
            want = np.asarray(want, np.float32)
            np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
            fin = np.isfinite(want)
            assert _max_rel(got[fin], want[fin]) < bound
        assert not np.isfinite(got).all()


def test_plain_adds_in_slot_order(rng):
    """The plain version's sum, slot by slot from 0 in f32 (the kernel's
    order), written out with numpy."""
    src, dst = _city_like(rng, n=1000)
    tl, n_pad = tsg.prepare_gather_residual_mean_aggregate(src, dst, 1000, tile=64, k=2)
    b = tl.gather_fwd
    x = rng.standard_normal((n_pad, 8)).astype(np.float32)
    got = tsg.spmm_gather_plain(torch.from_numpy(x), b).numpy()
    nb, t, r = b.num_dst_blocks, b.tile, b.r
    base = np.repeat(b.woff.numpy().astype(np.int64), b.k)[:nb] * t
    codes = b.codes.numpy()[:, : r * t, 0].reshape(nb, r, t) + base[:, None, None]
    mult = b.mult.numpy().reshape(nb, r, t)
    acc = np.zeros((nb, t, 8), np.float32)
    for j in range(r):
        acc = acc + mult[:, j, :, None] * x[codes[:, j]]
    want = acc.reshape(-1, 8) * b.row_scale.numpy()
    np.testing.assert_array_equal(got, want)


def test_residual_aggregation_and_grad_match_jax(rng):
    src, dst = _city_like(rng, n=1000)
    tl, n_pad = tsg.prepare_gather_residual_mean_aggregate(src, dst, 1000, tile=64, k=2)
    jl, _ = jsg.prepare_gather_residual_mean_aggregate(src, dst, 1000, tile=64, k=2)
    jlj = jax.tree.map(jnp.asarray, jl)
    x = rng.standard_normal((n_pad, 8)).astype(np.float32)
    g = rng.standard_normal((n_pad, 8)).astype(np.float32)
    want, vjp = jax.vjp(lambda v: jsg.spmm_gather_residual_apply(v, jlj, False), jnp.asarray(x))
    want_g = vjp(jnp.asarray(g))[0]
    # the JAX kernel path, as the JAX package would run it with the kernel on
    flag = jsg._PALLAS_GATHER_ENABLED
    jsg._PALLAS_GATHER_ENABLED = True
    try:
        jsg_pallas = jsg.spmm_gather_pallas
        jsg.spmm_gather_pallas = lambda x_, b_: jsg_pallas(x_, b_, interpret=True)
        want_k, vjp_k = jax.vjp(lambda v: jsg.spmm_gather_residual_apply(v, jlj, True),
                                jnp.asarray(x))
        want_kg = vjp_k(jnp.asarray(g))[0]
    finally:
        jsg._PALLAS_GATHER_ENABLED = flag
        jsg.spmm_gather_pallas = jsg_pallas
    for use_pallas, w, wg in ((False, want, want_g), (True, want_k, want_kg)):
        xt = torch.from_numpy(x).requires_grad_()
        out = tsg.spmm_gather_residual_apply(xt, tl, use_pallas)
        (out * torch.from_numpy(g)).sum().backward()
        np.testing.assert_allclose(out.detach().numpy(), w, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(xt.grad.numpy(), wg, rtol=RTOL, atol=ATOL)


def test_wrapper_contracts(rng):
    src, dst = _city_like(rng, n=1000)
    tl, n_pad = tsg.prepare_gather_residual_mean_aggregate(src, dst, 1000, tile=64, k=2)
    x = torch.from_numpy(rng.standard_normal((n_pad, 4)).astype(np.float32))
    with pytest.raises(ValueError, match="forward layout"):
        tsg.spmm_gather(x, tl.gather_rev)
    with pytest.raises(ValueError, match="rows"):
        tsg.spmm_gather(x[:-64], tl.gather_fwd)
    before = tsg.spmm_gather.launches
    assert torch.equal(tsg.spmm_gather(x, tl.gather_fwd), tsg.spmm_gather_plain(x, tl.gather_fwd))
    assert tsg.spmm_gather.launches == before
    moved = tl.to("cpu")
    assert moved.gather_fwd.r == tl.gather_fwd.r and moved.steps == tl.steps
    with pytest.raises(ValueError):
        tsg.prepare_gather_residual_mean_aggregate(rng.integers(0, 4000, 12000),
                                                   rng.integers(0, 4000, 12000), 4000,
                                                   tile=64, k=2, max_span=4)
