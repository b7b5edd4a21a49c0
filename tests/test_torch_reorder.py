"""The port's node reordering (sldm_gnn_tpu_torch.graph.reorder) against the
JAX package's on the CPU, on the graphs of tests/test_reorder.py: every
permutation equal, the span it reaches equal, and
prepare_auto_mean_aggregate(reorder=True)'s permutation and layouts equal
to the JAX package's, with the aggregation through the permutation equal
to the aggregation in the original ids."""

import numpy as np
import pytest
import torch

from sldm_gnn_tpu.graph import reorder as jro
from sldm_gnn_tpu.ops import spmm_hybrid as jsh

from sldm_gnn_tpu_torch.graph import reorder as tro
from sldm_gnn_tpu_torch.graph.csr import mean_weights
from sldm_gnn_tpu_torch.ops import spmm as tspmm
from sldm_gnn_tpu_torch.ops import spmm_banded as tsb
from sldm_gnn_tpu_torch.ops import spmm_hybrid as tsh


def shuffled_local_graph(n, deg, reach, seed=0):
    """A banded graph whose node ids have been scrambled (file order)."""
    rng = np.random.default_rng(seed)
    dst = np.repeat(np.arange(n, dtype=np.int64), deg)
    src = np.clip(dst + rng.integers(-reach, reach + 1, n * deg), 0, n - 1)
    scramble = rng.permutation(n)
    return scramble[src], scramble[dst]


def _radius_graph(n, seed=7):
    from scipy.spatial import cKDTree

    coords = np.random.default_rng(seed).uniform(0, 100, (n, 2))
    pairs = cKDTree(coords).query_pairs(3.0, output_type="ndarray")
    src = np.concatenate([pairs[:, 0], pairs[:, 1]]).astype(np.int64)
    dst = np.concatenate([pairs[:, 1], pairs[:, 0]]).astype(np.int64)
    return src, dst, coords


@pytest.mark.parametrize("n,deg,reach,seed", [(1024, 6, 40, 0), (512, 5, 30, 3),
                                              (768, 4, 24, 11)])
def test_cuthill_mckee_and_rcm_equal_jax(n, deg, reach, seed):
    src, dst = shuffled_local_graph(n, deg, reach, seed)
    got, want = tro.cuthill_mckee(src, dst, n), jro.cuthill_mckee(src, dst, n)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tro.rcm_order(src, dst, n), jro.rcm_order(src, dst, n))
    s2, d2 = tro.relabel_edges(src, dst, tro.rcm_order(src, dst, n))
    assert tro.source_span_tiles(s2, d2, n, 32) <= 8  # RCM recovers a tight band


def test_disconnected_and_isolated_equal_jax():
    src = np.array([0, 1, 5, 6], np.int64)
    dst = np.array([1, 2, 6, 7], np.int64)
    perm = tro.cuthill_mckee(src, dst, 10)
    assert sorted(perm.tolist()) == list(range(10))
    np.testing.assert_array_equal(perm, jro.cuthill_mckee(src, dst, 10))


@pytest.mark.parametrize("bits", [24, 16])
def test_hilbert_equals_jax(bits):
    src, dst, coords = _radius_graph(2048)
    perm = tro.hilbert_order(coords, bits=bits)
    np.testing.assert_array_equal(perm, jro.hilbert_order(coords, bits=bits))
    s2, d2 = tro.relabel_edges(src, dst, perm)
    assert tro.source_span_tiles(s2, d2, 2048, 32) < tro.source_span_tiles(src, dst, 2048, 32)
    with pytest.raises(ValueError, match="coordinates"):
        tro.hilbert_order(coords[:, :1])


def test_span_invert_relabel_equal_jax():
    n = 1000
    src, dst = shuffled_local_graph(n, 4, 30, seed=5)
    for tile in (32, 64, 128):
        assert tro.source_span_tiles(src, dst, n, tile) == jro.source_span_tiles(src, dst, n, tile)
    assert tro.source_span_tiles(src[:0], dst[:0], n) == jro.source_span_tiles(src[:0], dst[:0], n)
    perm = np.random.default_rng(1).permutation(n)
    np.testing.assert_array_equal(tro.invert_perm(perm), jro.invert_perm(perm))
    for a, b in zip(tro.relabel_edges(src, dst, perm), jro.relabel_edges(src, dst, perm)):
        np.testing.assert_array_equal(a, b)


def test_reorder_for_banding_equals_jax():
    n = 1024
    src, dst = shuffled_local_graph(n, 6, 40)
    np.testing.assert_array_equal(tro.reorder_for_banding(src, dst, n, tile=32),
                                  jro.reorder_for_banding(src, dst, n, tile=32))
    # with coordinates both candidates are tried and the tighter span wins
    s3, d3, coords = _radius_graph(2048)
    np.testing.assert_array_equal(
        tro.reorder_for_banding(s3, d3, 2048, tile=32, coords=coords),
        jro.reorder_for_banding(s3, d3, 2048, tile=32, coords=coords))
    # already banded: no permutation
    dst2 = np.repeat(np.arange(512, dtype=np.int64), 4)
    src2 = np.clip(dst2 + np.random.default_rng(17).integers(-16, 17, len(dst2)), 0, 511)
    assert tro.reorder_for_banding(src2, dst2, 512, tile=32) is None
    # an expander is not bandable, in both packages
    rng = np.random.default_rng(19)
    src4, dst4 = rng.integers(0, n, 8 * n), rng.integers(0, n, 8 * n)
    for mod in (tro, jro):
        with pytest.raises(ValueError, match="not bandable"):
            mod.reorder_for_banding(src4, dst4, n, tile=32, max_span=4)


def test_streaming_hilbert_equals_jax():
    """tests/test_reorder.py's resolution case: a scrambled 1-D stream."""
    n = 200_000
    rng = np.random.default_rng(3)
    scramble = rng.permutation(n)
    xy = np.stack([np.arange(n, dtype=np.float64), np.zeros(n)], axis=1)

    def order_at(mod, bits):
        sh = mod.StreamingHilbert(n, bits=bits)
        sh.observe_bounds(xy)
        for s in range(0, n, 50_000):
            sh.add_keys(scramble[s:s + 50_000], xy[s:s + 50_000])
        return sh.order()

    perm = order_at(tro, 24)
    np.testing.assert_array_equal(perm, scramble)
    np.testing.assert_array_equal(perm, order_at(jro, 24))
    coarse = order_at(tro, 16)
    assert not np.array_equal(coarse, scramble)
    np.testing.assert_array_equal(coarse, order_at(jro, 16))
    with pytest.raises(ValueError, match="no coordinates"):
        tro.StreamingHilbert(4).order()


def _assert_banded_equal(t, j):
    for f in ("a", "bo", "woff", "off", "row_scale", "col_scale"):
        tv, jv = getattr(t, f), getattr(j, f)
        if jv is None:
            assert tv is None, f
        else:
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv), err_msg=f)
    assert (t.tile, t.wsz, t.k) == (j.tile, j.wsz, j.k)


@pytest.mark.parametrize("case", ["shuffled", "banded"])
def test_auto_reorder_equals_jax(case):
    """prepare_auto_mean_aggregate(reorder=True): the same permutation and
    banded layouts as the JAX package; the mean aggregation in the new ids,
    mapped back, equals the aggregation in the original ids."""
    n, d = 768, 16
    if case == "shuffled":
        src, dst = shuffled_local_graph(n, deg=4, reach=24, seed=11)
    else:
        dst = np.repeat(np.arange(n, dtype=np.int64), 4)
        src = np.clip(dst + np.random.default_rng(17).integers(-16, 17, len(dst)), 0, n - 1)
    tf, tr, tn, tperm = tsh.prepare_auto_mean_aggregate(src, dst, n, tile=32, reorder=True)
    jf, jr, jn, jperm = jsh.prepare_auto_mean_aggregate(src, dst, n, tile=32, reorder=True)
    assert tn == jn and (tperm is None) == (jperm is None) == (case == "banded")
    if tperm is not None:
        np.testing.assert_array_equal(tperm, jperm)
    assert isinstance(tf, tsb.BandedBlocks)
    _assert_banded_equal(tf, jf)
    _assert_banded_equal(tr, jr)

    perm = np.arange(n) if tperm is None else tperm
    x = np.random.default_rng(13).standard_normal((n, d)).astype(np.float32)
    xp = np.zeros((tn, d), np.float32)
    xp[:n] = x[perm]
    agg = tsb.spmm_banded_apply(torch.from_numpy(xp), tf, tr, False).numpy()[:n]
    ref = tspmm.spmm_xla(torch.from_numpy(x), torch.from_numpy(src), torch.from_numpy(dst),
                         torch.from_numpy(mean_weights(dst, n)), n).numpy()
    np.testing.assert_allclose(agg[tro.invert_perm(perm)], ref, rtol=1e-5, atol=1e-5)
