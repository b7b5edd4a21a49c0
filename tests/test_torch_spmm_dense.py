"""The port's dense-tile and hybrid SpMM (sldm_gnn_tpu_torch.ops.spmm_dense,
spmm_hybrid) against the JAX package's on the CPU, at the small sizes of
tests/test_spmm_dense.py and test_spmm_hybrid.py, inputs from numpy with a
seed: the layouts equal the JAX builders' bit for bit, the plain version of
csrc/spmm_dense.cu agrees with the JAX Pallas kernel in interpret mode, the
reference paths and gradients agree with JAX's, and the automatic layout
choice picks what JAX picks."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sldm_gnn_tpu.graph.csr import mean_weights
from sldm_gnn_tpu.ops import spmm as jspmm
from sldm_gnn_tpu.ops import spmm_dense as jsd
from sldm_gnn_tpu.ops import spmm_hybrid as jsh

from sldm_gnn_tpu_torch.ops import banded_residual as tbr
from sldm_gnn_tpu_torch.ops import spmm_banded as tsb
from sldm_gnn_tpu_torch.ops import spmm_dense as tsd
from sldm_gnn_tpu_torch.ops import spmm_hybrid as tsh

# plain version vs interpret kernel: the same bf16 roundings, f32 sums in
# another order
KERNEL_REL = 1e-5
# reference paths and custom VJPs: test_spmm_hybrid.py:45-50's bounds
RTOL, ATOL = 1e-4, 1e-5


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-12)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _assert_dense_equal(t, j):
    if t is None or j is None:
        assert t is None and j is None
        return
    ja = np.asarray(j.a)
    if str(ja.dtype) == "bfloat16":
        assert t.a.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.a.float().numpy(), ja.astype(np.float32))
    else:
        assert t.a.numpy().dtype == ja.dtype
        np.testing.assert_array_equal(t.a.numpy(), ja)
    np.testing.assert_array_equal(t.src_blk.numpy(), np.asarray(j.src_blk))
    assert t.src_blk.numpy().dtype == np.asarray(j.src_blk).dtype and t.tile == j.tile
    for f in ("row_scale", "col_scale"):
        a, b = getattr(t, f), getattr(j, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)


def _assert_onehot_equal(t, j):
    if t is None or j is None:
        assert t is None and j is None
        return
    for f in ("block_meta", "src_local", "dst_local", "weight", "edge_id"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)), err_msg=f)
    assert (t.tile, t.step_chunks) == (j.tile, j.step_chunks)


def _assert_hybrid_equal(t, j):
    _assert_dense_equal(t.dense_fwd, j.dense_fwd)
    _assert_dense_equal(t.dense_rev, j.dense_rev)
    _assert_onehot_equal(t.onehot_fwd, j.onehot_fwd)
    _assert_onehot_equal(t.onehot_rev, j.onehot_rev)
    assert (t.n_pad, t.dense_k, t.k_per_step, t.dense_frac) == (
        j.n_pad, j.dense_k, j.k_per_step, j.dense_frac)


def skewed_graph(rng, n=640, core_blocks=2, tile=64, e_core=6000, e_strag=1500):
    """test_spmm_hybrid.py's graph: a dense core and uniform stragglers."""
    core = rng.integers(0, core_blocks * tile, (e_core, 2))
    strag = rng.integers(0, n, (e_strag, 2))
    edges = np.concatenate([core, strag])
    return edges[:, 0].astype(np.int64), edges[:, 1].astype(np.int64)


# ------------------------------------------------------------ dense


@pytest.mark.parametrize("dtype,pad", [(np.float32, 1), (np.int8, 1), (np.int8, 4),
                                       (np.float32, 3)])
def test_dense_layouts_equal_jax(rng, dtype, pad):
    src, dst = rng.integers(0, 900, 7000), rng.integers(0, 900, 7000)
    tf, tr, tn = tsd.prepare_dense_mean_aggregate(src, dst, 900, tile=64, dtype=dtype,
                                                  pad_blocks_to=pad)
    jf, jr, jn = jsd.prepare_dense_mean_aggregate(src, dst, 900, tile=64, dtype=dtype,
                                                  pad_blocks_to=pad)
    assert tn == jn
    _assert_dense_equal(tf, jf)
    _assert_dense_equal(tr, jr)


def test_dense_builder_edge_cases_equal_jax(rng):
    w = np.array([0.5, 0.25, 0.125, 1.0], np.float32)  # duplicates sum
    for src, dst, weight, n, tile in [
        (np.array([1, 1, 1, 5]), np.array([3, 3, 3, 3]), w, 40, 8),
        (np.zeros(0, np.int64), np.zeros(0, np.int64), None, 50, 16),
    ]:
        _assert_dense_equal(tsd.build_dense_blocks(src, dst, n, weight=weight, tile=tile),
                            jsd.build_dense_blocks(src, dst, n, weight=weight, tile=tile))
    with pytest.raises(ValueError, match="overflows int8"):
        tsd.prepare_dense_mean_aggregate(np.full(130, 3), np.full(130, 5), 40, tile=32,
                                         dtype=np.int8)


@pytest.mark.parametrize("dtype", [np.float32, np.int8, "bf16"])
@pytest.mark.parametrize("direction", ["fwd", "rev"])
def test_dense_plain_matches_pallas(rng, dtype, direction):
    n, e, d, tile = 320, 3000, 32, 64
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    kw = dict(tile=tile, dtype=np.float32 if dtype == "bf16" else dtype, pad_blocks_to=2)
    tf, tr, n_pad = tsd.prepare_dense_mean_aggregate(src, dst, n, **kw)
    jf, jr, _ = jsd.prepare_dense_mean_aggregate(src, dst, n, **kw)
    tb, jb = (tf, jf) if direction == "fwd" else (tr, jr)
    jb = jax.tree.map(jnp.asarray, jb)
    if dtype == "bf16":
        tb = tsd.DenseBlocks(a=tb.a.to(torch.bfloat16), src_blk=tb.src_blk, tile=tile)
        jb = jsd.DenseBlocks(a=jb.a.astype(jnp.bfloat16), src_blk=jb.src_blk, tile=tile)
    x = rng.standard_normal((n_pad, d)).astype(np.float32)
    want = jsd.spmm_dense_pallas(jnp.asarray(x), jb, interpret=True, step_blocks=2)
    got = tsd.spmm_dense(torch.from_numpy(x), tb, step_blocks=2)
    assert _max_rel(got.numpy(), want) < KERNEL_REL
    # bf16 x: both round the f32 sum to bf16 once (one ulp apart at most)
    want16 = jsd.spmm_dense_pallas(jnp.asarray(x).astype(jnp.bfloat16), jb, interpret=True)
    got16 = tsd.spmm_dense(torch.from_numpy(x).to(torch.bfloat16), tb)
    assert got16.dtype == torch.bfloat16
    assert _max_rel(_np(got16), np.asarray(want16, np.float32)) < 2.0 ** -8
    with pytest.raises(ValueError, match="step_blocks"):
        tsd.spmm_dense(torch.from_numpy(x), tb, step_blocks=tb.num_dst_blocks + 1)


@pytest.mark.parametrize("dtype", [np.float32, np.int8])
def test_dense_apply_and_grad_match_jax(rng, dtype):
    n, e, d = 300, 4000, 16
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    tf, tr, n_pad = tsd.prepare_dense_mean_aggregate(src, dst, n, tile=64, dtype=dtype)
    jf, jr, _ = jax.tree.map(jnp.asarray, jsd.prepare_dense_mean_aggregate(
        src, dst, n, tile=64, dtype=dtype)[:2]) + (None,)
    x = rng.standard_normal((n_pad, d)).astype(np.float32)
    t = rng.standard_normal((n_pad, d)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    out = tsd.spmm_dense_apply(xt, tf, tr, False)
    (out * torch.from_numpy(t)).sum().backward()
    want, vjp = jax.vjp(lambda v: jsd.spmm_dense_apply(v, jf, jr, False), jnp.asarray(x))
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), vjp(jnp.asarray(t))[0], rtol=RTOL, atol=ATOL)
    # the kernel path's gradient: the plain version on the reverse layout
    # against the interpret kernel on it
    xk = torch.from_numpy(x).requires_grad_()
    (tsd.spmm_dense_apply(xk, tf, tr, True) * torch.from_numpy(t)).sum().backward()
    want_k = jsd.spmm_dense_pallas(jnp.asarray(t), jr, interpret=True)
    assert _max_rel(xk.grad.numpy(), want_k) < KERNEL_REL


def _jax_blocks(tb):
    """The same layout as the JAX package's DenseBlocks."""
    conv = lambda t: None if t is None else jnp.asarray(_np(t)).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else _np(t).dtype)
    return jsd.DenseBlocks(a=conv(tb.a), src_blk=conv(tb.src_blk), row_scale=conv(tb.row_scale),
                           col_scale=conv(tb.col_scale), tile=tb.tile)


def _hold_dense_cases(rng, tb, d):
    """The plain version against the interpret kernel on one layout: f32 x
    at KERNEL_REL and bf16 x at 2^-8 (each rounds its f32 sum to bf16 once),
    with the layout's row scale and without one (a random one where the
    layout has none)."""
    n_pad = tb.num_dst_blocks * tb.tile
    rs = torch.from_numpy(rng.uniform(0.25, 1.0, (n_pad, 1)).astype(np.float32))
    with_rs = tb if tb.row_scale is not None else dataclasses.replace(tb, row_scale=rs)
    x = rng.standard_normal((n_pad, d)).astype(np.float32)
    for lay in (with_rs, dataclasses.replace(tb, row_scale=None)):
        jb = _jax_blocks(lay)
        want = jsd.spmm_dense_pallas(jnp.asarray(x), jb, interpret=True)
        assert _max_rel(tsd.spmm_dense(torch.from_numpy(x), lay).numpy(), want) < KERNEL_REL
        want16 = jsd.spmm_dense_pallas(jnp.asarray(x).astype(jnp.bfloat16), jb, interpret=True)
        got16 = tsd.spmm_dense(torch.from_numpy(x).to(torch.bfloat16), lay)
        assert got16.dtype == torch.bfloat16
        assert _max_rel(_np(got16), np.asarray(want16, np.float32)) < 2.0 ** -8


@pytest.mark.parametrize("tile,d", [(32, 4), (64, 40), (128, 96), (32, 128)])
@pytest.mark.parametrize("kind", ["int8", "f32", "bf16"])
@pytest.mark.parametrize("direction", ["fwd", "rev"])
def test_dense_plain_matches_pallas_ragged(rng, tile, d, kind, direction):
    """The card sweep's ragged shapes (chip_smoke.py's dense sweep): tiles
    32-128, widths that are not multiples of 16, every tile type, both
    directions (the reverse layout's column scale applied to x first)."""
    n = 2 * tile + tile // 2 + 3  # three blocks, the last one ragged
    src, dst = rng.integers(0, n, 12 * n), rng.integers(0, n, 12 * n)
    dtype = np.int8 if kind == "int8" else np.float32
    fwd, rev, _ = tsd.prepare_dense_mean_aggregate(src, dst, n, tile=tile, dtype=dtype)
    tb = fwd if direction == "fwd" else rev
    if kind == "bf16":
        tb = dataclasses.replace(tb, a=tb.a.to(torch.bfloat16))
    _hold_dense_cases(rng, tb, d)


def test_dense_plain_matches_pallas_past_64_slots(rng):
    """One destination block fed by 70 source blocks (tile 32): more slots
    than the kernels' table of cmap slots holds."""
    tile, nsrc = 32, 70
    n = (nsrc + 1) * tile
    src = np.concatenate([np.arange(1, nsrc + 1) * tile + rng.integers(0, tile, nsrc),
                          rng.integers(0, n, 200)])
    dst = np.concatenate([rng.integers(0, tile, nsrc), rng.integers(0, n, 200)])
    fwd, _, _ = tsd.prepare_dense_mean_aggregate(src, dst, n, tile=tile, dtype=np.int8)
    assert fwd.s_max >= nsrc
    _hold_dense_cases(rng, fwd, 40)


# ------------------------------------------------------------ hybrid


@pytest.mark.parametrize("dtype,dense_k,k_per_step", [(np.float32, 1, 1), (np.float32, 2, 2),
                                                      (np.int8, 2, 1)])
def test_hybrid_layouts_and_aggregation_match_jax(rng, dtype, dense_k, k_per_step):
    n, tile, d = 640, 64, 32
    src, dst = skewed_graph(rng, n=n, tile=tile)
    kw = dict(tile=tile, dense_k=dense_k, k_per_step=k_per_step, min_pair_edges=tile // 2,
              dense_dtype=dtype)
    tl, tn = tsh.prepare_hybrid_mean_aggregate(src, dst, n, **kw)
    jl, jn = jsh.prepare_hybrid_mean_aggregate(src, dst, n, **kw)
    assert tn == jn and tl.dense_fwd is not None and tl.onehot_fwd is not None
    _assert_hybrid_equal(tl, jl)

    jlj = jax.tree.map(jnp.asarray, jl)
    x = rng.standard_normal((tn, d)).astype(np.float32)
    t = rng.standard_normal((tn, d)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    out = tsh.spmm_hybrid_apply(xt, tl, False)
    (out * torch.from_numpy(t)).sum().backward()
    want, vjp = jax.vjp(lambda v: jsh.spmm_hybrid_apply(v, jlj, False), jnp.asarray(x))
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), vjp(jnp.asarray(t))[0], rtol=RTOL, atol=ATOL)
    # the kernel path (plain versions): both halves' interpret kernels
    got = tsh.spmm_hybrid_apply(torch.from_numpy(x), tl, True)
    want_k = (jsd.spmm_dense_pallas(jnp.asarray(x), jlj.dense_fwd, interpret=True,
                                    step_blocks=dense_k)
              + jspmm.spmm_pallas(jnp.asarray(x), jlj.onehot_fwd, tn, interpret=True,
                                  k_per_step=k_per_step))
    assert _max_rel(got.numpy(), want_k) < KERNEL_REL


def test_hybrid_degenerate_splits_and_bf16_tiles_equal_jax(rng):
    """test_spmm_hybrid.py:56-73: a pure dense and a pure one-hot split;
    and the bf16 weight tiles of the dense half."""
    src, dst = rng.integers(0, 64, 5000), rng.integers(0, 64, 5000)
    src2, dst2 = rng.integers(0, 640, 50), rng.integers(0, 640, 50)
    for s, d, kw in [(src, dst, {}), (src2, dst2, {}),
                     (src, dst, dict(dense_dtype=torch.bfloat16)),
                     (np.zeros(0, np.int64), np.zeros(0, np.int64), {})]:
        tl, tn = tsh.prepare_hybrid_mean_aggregate(s, d, 640, tile=64, **kw)
        jkw = {k: (jnp.bfloat16 if v is torch.bfloat16 else v) for k, v in kw.items()}
        jl, jn = jsh.prepare_hybrid_mean_aggregate(s, d, 640, tile=64, **jkw)
        assert tn == jn
        _assert_hybrid_equal(tl, jl)
        x = rng.standard_normal((tn, 8)).astype(np.float32)
        got = tsh.spmm_hybrid_apply(torch.from_numpy(x), tl, False)
        want = jsh.spmm_hybrid_apply(jnp.asarray(x), jax.tree.map(jnp.asarray, jl), False)
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), rtol=RTOL,
                                   atol=ATOL)
    hl, _ = tsh.prepare_hybrid_mean_aggregate(src, dst, 640, tile=64)
    hl2, _ = tsh.prepare_hybrid_mean_aggregate(src2, dst2, 640, tile=64)
    assert hl.onehot_fwd is None and hl2.dense_fwd is None


def test_hybrid_budget_cap_and_tile_bytes_equal_jax(rng):
    src, dst = skewed_graph(rng)
    for budget in (2e5, 1e6, 4e9):
        np.testing.assert_array_equal(
            tsh.select_dense_edges(src, dst, 10, tile=64, min_pair_edges=8,
                                   max_pairs_per_block=max(int(budget // 1e5), 1)),
            jsh.select_dense_edges(src, dst, 10, tile=64, min_pair_edges=8,
                                   max_pairs_per_block=max(int(budget // 1e5), 1)))
        tl, _ = tsh.prepare_hybrid_mean_aggregate(src, dst, 640, tile=64, a_budget_bytes=budget,
                                                  dense_dtype=np.int8)
        jl, _ = jsh.prepare_hybrid_mean_aggregate(src, dst, 640, tile=64, a_budget_bytes=budget,
                                                  dense_dtype=np.int8)
        _assert_hybrid_equal(tl, jl)
    for itemsize in (1, 2):
        assert tsh.dense_tile_bytes(src, dst, 640, tile=64, dense_k=2, itemsize=itemsize) == \
            jsh.dense_tile_bytes(src, dst, 640, tile=64, dense_k=2, itemsize=itemsize)


def _banded_graph(rng, n=2000, deg=6, reach=90):
    dst = np.repeat(np.arange(n, dtype=np.int64), deg)
    return np.clip(dst + rng.integers(-reach, reach + 1, n * deg), 0, n - 1), dst


@pytest.mark.parametrize("case", ["banded", "residual", "dense", "dense_bf16", "hybrid"])
def test_auto_layout_picks_what_jax_picks(rng, case):
    n, tile = 2000, 64
    kw = dict(tile=tile)
    if case == "banded":
        src, dst = _banded_graph(rng)
    elif case == "residual":
        src, dst = _banded_graph(rng)
        src, dst = np.concatenate([src, [5, 9]]), np.concatenate([dst, [1990, 1995]])
    elif case in ("dense", "dense_bf16"):
        src, dst = rng.integers(0, n, 30000), rng.integers(0, n, 30000)
        if case == "dense_bf16":  # 130 duplicate edges overflow int8 counts
            src, dst = np.concatenate([src, np.full(130, 7)]), np.concatenate([dst, np.full(130, 9)])
    else:
        src, dst = skewed_graph(rng, n=n, tile=tile)
        kw.update(a_budget_bytes=3e5, min_pair_edges=16)
    tf, tr, tn = tsh.prepare_auto_mean_aggregate(src, dst, n, **kw)
    jf, jr, jn = jsh.prepare_auto_mean_aggregate(src, dst, n, **kw)
    assert tn == jn
    assert type(tf).__name__ == type(jf).__name__ and (tr is None) == (jr is None)
    if isinstance(tf, tsd.DenseBlocks):
        _assert_dense_equal(tf, jf)
        _assert_dense_equal(tr, jr)
        assert tf.a.dtype == (torch.bfloat16 if case == "dense_bf16" else torch.int8)
    elif isinstance(tf, tsh.HybridLayout):
        _assert_hybrid_equal(tf, jf)
    elif isinstance(tf, tbr.BandedResidualLayout):
        assert len(tf.r_src) == len(jf.r_src) > 0
    else:
        assert isinstance(tf, tsb.BandedBlocks) and tf.s_span == jf.s_span
        np.testing.assert_array_equal(tf.a.numpy(), np.asarray(jf.a))
    # reorder=True: the same permutation (RCM on the residual and hybrid
    # graphs; None where the graph is banded already or not bandable) and
    # the same layout kind
    *tl, tperm = tsh.prepare_auto_mean_aggregate(src, dst, n, reorder=True, **kw)
    *jl, jperm = jsh.prepare_auto_mean_aggregate(src, dst, n, reorder=True, **kw)
    assert (tperm is None) == (jperm is None) and tl[2] == jl[2]
    if tperm is not None:
        np.testing.assert_array_equal(tperm, jperm)
    assert type(tl[0]).__name__ == type(jl[0]).__name__
