"""The port's ops (sldm_gnn_tpu_torch.ops) against the JAX package's on the
CPU: the f32 GRU scan, the plain versions of the GRU-forward and KNN
kernels (the JAX Pallas kernels run in interpret mode), and the segment
ops. The CUDA kernels themselves run only on the card (chip_smoke.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sldm_gnn_tpu.ops import segment as jseg
from sldm_gnn_tpu.ops.gru import gru_forward as jax_gru_forward
from sldm_gnn_tpu.ops.gru import init_gru_params
from sldm_gnn_tpu.ops.gru_pallas import (gru_last_forward as jax_gru_last_forward,
                                         gru_last_pallas, gru_seq_pallas)
from sldm_gnn_tpu.ops.knn import knn_topk as jax_knn_topk
from sldm_gnn_tpu.ops.knn_pallas import knn_topk_pallas

from sldm_gnn_tpu_torch.ops import _build, gru_cuda
from sldm_gnn_tpu_torch.ops import knn as knn_ops
from sldm_gnn_tpu_torch.ops import segment as tseg
from sldm_gnn_tpu_torch.ops.gru import GRUParams, gru_forward

# The plain bf16 GRU and the JAX v2 kernel (interpret mode) both sum exact
# bf16 products in f32 and round the carry to bf16 every step; they differ
# only in summation order, which can flip one bf16 rounding (2^-8
# relative, <= 3.9e-3 for |h| < 1) that then propagates through later
# steps. 1e-2 absolute allows a few such flips over 12 frames; it is
# tighter than the JAX package's 3e-2 contract against the f32 scan.
BF16_GRU_ATOL = 1e-2


def _t(a):
    return torch.from_numpy(np.array(a))


def _gru_params_t(p) -> GRUParams:
    return GRUParams(*[_t(a) for a in p])


@pytest.mark.parametrize("layers", [1, 2])
def test_gru_scan_matches_jax(rng, layers):
    B, T, D, H = 9, 12, 6, 16
    params = init_gru_params(jax.random.PRNGKey(layers), D, H, layers)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    out_j, h_j = jax_gru_forward(params, jnp.asarray(x))
    out_t, h_t = gru_forward(_gru_params_t(params), _t(x))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [37, 16])
def test_gru_plain_bf16_matches_pallas_last(rng, n):
    T, D, H = 12, 6, 16
    p = init_gru_params(jax.random.PRNGKey(3), D, H, 1)
    x = rng.standard_normal((n, T, D)).astype(np.float32)
    want = gru_last_pallas(jnp.asarray(x), p.w_ih0, p.b_ih0, p.w_hh0, p.b_hh0, 1024, True)
    got = gru_cuda.gru_fwd(_t(x), _t(p.w_ih0), _t(p.b_ih0), _t(p.w_hh0), _t(p.b_hh0))
    assert got.dtype == torch.float32 and got.shape == (n, H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=BF16_GRU_ATOL)
    # the carry is a bf16 value at every step
    assert torch.equal(got, got.to(torch.bfloat16).float())


def test_gru_plain_bf16_matches_pallas_seq(rng):
    N, T, D, H = 21, 10, 6, 16
    p = init_gru_params(jax.random.PRNGKey(4), D, H, 1)
    x = rng.standard_normal((N, T, D)).astype(np.float32)
    want = gru_seq_pallas(jnp.asarray(x), p.w_ih0, p.b_ih0, p.w_hh0, p.b_hh0, 1024, True)
    hs = gru_cuda.gru_fwd(_t(x), _t(p.w_ih0), _t(p.b_ih0), _t(p.w_hh0), _t(p.b_hh0),
                          seq=True)
    assert hs.dtype == torch.bfloat16 and hs.shape == (T, N, H)
    np.testing.assert_allclose(hs.float().transpose(0, 1).numpy(), np.asarray(want),
                               rtol=0, atol=BF16_GRU_ATOL)


def test_gru_plain_bf16_stack_matches_pallas(rng):
    N, T, D, H = 19, 8, 5, 12
    params = init_gru_params(jax.random.PRNGKey(5), D, H, 2)
    x = rng.standard_normal((N, T, D)).astype(np.float32)
    want = jax_gru_last_forward(params, jnp.asarray(x), interpret=True)
    got = gru_cuda.gru_last_forward(_gru_params_t(params), _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=BF16_GRU_ATOL)
    # and within the JAX package's bf16 contract of the f32 scan
    _, h32 = gru_forward(_gru_params_t(params), _t(x))
    np.testing.assert_allclose(got.numpy(), h32.numpy(), rtol=3e-2, atol=3e-2)


def test_gru_wrapper_rejects_other_devices_and_shapes():
    x = torch.zeros((4, 3, 2), device="meta")
    w = [torch.zeros(s, device="meta") for s in ((2, 12), (12,), (4, 12), (12,))]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        gru_cuda.gru_fwd(x, *w)
    xc = torch.zeros((4, 3, 2))
    with pytest.raises(ValueError, match="weights"):
        gru_cuda.gru_fwd(xc, torch.zeros(3, 12), torch.zeros(12), torch.zeros(4, 12),
                         torch.zeros(12))


def _knn_inputs(rng, V, S, scale=100.0):
    pts = (rng.standard_normal((V, 2)) * scale).astype(np.float32)
    cents = (rng.standard_normal((S, 2)) * scale).astype(np.float32)
    return pts, cents


@pytest.mark.parametrize("V,S,K", [(333, 1000, 5), (7, 57, 5), (64, 300, 17)])
def test_knn_plain_matches_pallas_and_topk(rng, V, S, K):
    pts, cents = _knn_inputs(rng, V, S)
    cents[S // 2] = cents[3]
    cents[S - 1] = cents[3]  # duplicate centroids: lowest-index tie rule
    pts[: V // 3] = cents[3] + rng.standard_normal((V // 3, 2)).astype(np.float32) * 1e-3
    d_pl, i_pl = knn_topk_pallas(jnp.asarray(pts), jnp.asarray(cents), K, interpret=True)
    d_tk, i_tk = jax_knn_topk(jnp.asarray(pts), jnp.asarray(cents), K)
    d, i = knn_ops.knn_topk_fused(_t(pts), _t(cents), K)
    assert i.dtype == torch.int32 and d.dtype == torch.float32
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_pl))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_tk))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_pl), rtol=1e-6, atol=0)
    # the topk path of the port (square-rooted keys) against lax.top_k
    d2, i2 = knn_ops.knn_topk(_t(pts), _t(cents), K)
    np.testing.assert_array_equal(i2.numpy(), np.asarray(i_tk))
    np.testing.assert_allclose(d2.numpy(), np.asarray(d_tk), rtol=1e-6, atol=1e-6)


def test_knn_exact_ties_pick_lowest_index():
    cents = torch.tensor([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [0.0, -1.0], [5.0, 5.0]])
    pts = torch.zeros((2, 2))
    d, i = knn_ops.knn_topk_fused(pts, cents, 4)
    assert i.tolist() == [[0, 1, 2, 3], [0, 1, 2, 3]]
    assert torch.equal(d, torch.ones((2, 4)))
    d, i = knn_ops.knn_topk(pts, cents, 3)
    assert i.tolist() == [[0, 1, 2], [0, 1, 2]]


def test_knn_rejects_k_above_cap(rng):
    pts, cents = _knn_inputs(rng, 5, 200)
    with pytest.raises(ValueError):
        knn_ops.knn_topk_fused(_t(pts), _t(cents), knn_ops.KNN_MAX_K + 1)
    with pytest.raises(ValueError):
        knn_ops.knn_topk_fused(_t(pts), _t(cents[:4]), 5)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        knn_ops.knn_topk_fused(torch.zeros((3, 2), device="meta"),
                               torch.zeros((8, 2), device="meta"), 2)


def _segment_inputs(rng):
    N, E, G, D = 13, 20, 4, 5
    x = rng.standard_normal((N, D)).astype(np.float32)
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N, E).astype(np.int32)
    emask = rng.random(E) < 0.7
    dst[~emask] = N  # padding edges point out of range
    node_graph = rng.integers(0, G, N).astype(np.int32)
    nmask = rng.random(N) < 0.8
    node_graph[~nmask] = G
    node_graph[node_graph == 2] = G  # graph 2 empty
    nmask &= node_graph < G
    return x, src, dst, emask, node_graph, nmask, N, G


def test_masked_mean_aggregate_matches_jax(rng):
    x, src, dst, emask, _, _, N, _ = _segment_inputs(rng)
    want = jseg.masked_mean_aggregate(jnp.asarray(x), jnp.asarray(src), jnp.asarray(dst),
                                      jnp.asarray(emask), N)
    got = tseg.masked_mean_aggregate(_t(x), _t(src).long(), _t(dst).long(), _t(emask), N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("pool", ["mean", "max"])
def test_global_pools_match_jax(rng, pool):
    x, _, _, _, node_graph, nmask, _, G = _segment_inputs(rng)
    jf = jseg.global_mean_pool if pool == "mean" else jseg.global_max_pool
    tf = tseg.global_mean_pool if pool == "mean" else tseg.global_max_pool
    want = jf(jnp.asarray(x), jnp.asarray(node_graph), jnp.asarray(nmask), G)
    got = tf(_t(x), _t(node_graph).long(), _t(nmask), G)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert torch.all(got[2] == 0)  # empty graph -> 0


def test_build_library_name_tracks_sources():
    p1 = _build.library_path()
    assert p1 == _build.library_path()
    assert p1.parent == _build.BUILD_DIR and p1.name.startswith("libsldm_kernels_")
    names = {p.name for p in _build.CSRC.glob("*.cu")}
    assert {"gru_fwd.cu", "knn_topk.cu"} <= names
