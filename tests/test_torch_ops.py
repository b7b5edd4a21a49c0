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


# beside the first three: one point; S below one warp's width with k = S;
# S and V about 32 (the lanes of the CUDA kernel's warp); k past 32 (its
# one-thread route)
@pytest.mark.parametrize("V,S,K", [(333, 1000, 5), (7, 57, 5), (64, 300, 17), (1, 20, 20),
                                   (1, 1000, 5), (31, 5, 5), (33, 100, 32), (32, 65, 33)])
def test_knn_plain_matches_pallas_and_topk(rng, V, S, K):
    pts, cents = _knn_inputs(rng, V, S)
    cents[S // 2] = cents[3]
    cents[S - 1] = cents[3]  # duplicate centroids: lowest-index tie rule
    cents[3 + 32::32] = cents[3]  # and copies 32 apart (one lane of the CUDA kernel each)
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


# ---- the GRU backward (v2 recompute, v3 store-gates) and the v3 forward ----
#
# The port's autograd Functions on CPU tensors run the plain versions of
# the three training kernels; the JAX side runs gru_last_pallas /
# gru_seq_pallas / gru_last_sg_pallas / gru_seq_sg_pallas in interpret
# mode (rb=16: three row blocks over N=40, the last one ragged). Both
# round dxp/dhp to bf16 before every product and sum in f32; they differ in
# summation order, which can flip a bf16 rounding of a dxp/dhp value (or of
# an hs value in the forward). Over 12 frames that stays far inside
# 1e-2 * max|g|, the bound here (observed: <= 2.3e-4 * max|g|).
GRAD_RTOL = 1e-2
N_B, T_B, D_B, H_B = 40, 12, 6, 32


def _bwd_case(rng, seed, n=N_B, h=H_B):
    p = init_gru_params(jax.random.PRNGKey(seed), D_B, h, 1)
    x = rng.standard_normal((n, T_B, D_B)).astype(np.float32)
    return p, x


# row counts around the kernels' row tiles (one row; 63, 65 about 64) and
# hidden widths that are not multiples of 8 (20) or of 2 (33)
BWD_SHAPES = [(N_B, H_B), (1, H_B), (63, H_B), (65, H_B), (N_B, 20), (N_B, 33)]


@pytest.mark.parametrize("n,h", BWD_SHAPES, ids=[f"N{n}-H{h}" for n, h in BWD_SHAPES])
@pytest.mark.parametrize("with_dx", [False, True])
@pytest.mark.parametrize("form", ["last", "seq"])
@pytest.mark.parametrize("store_gates", [False, True])
def test_gru_backward_plain_matches_pallas(rng, form, store_gates, with_dx, n, h):
    from sldm_gnn_tpu.ops.gru_pallas import gru_last_sg_pallas, gru_seq_sg_pallas

    p, x = _bwd_case(rng, 7, n, h)
    jfn = {("last", False): gru_last_pallas, ("last", True): gru_last_sg_pallas,
           ("seq", False): gru_seq_pallas, ("seq", True): gru_seq_sg_pallas}[form, store_gates]
    cot = rng.standard_normal((n, T_B, h) if form == "seq" else (n, h)
                              ).astype(np.float32)
    args = (jnp.asarray(x), p.w_ih0, p.b_ih0, p.w_hh0, p.b_hh0)
    out_j, vjp = jax.vjp(lambda *a: jfn(*a, 16, True, with_dx), *args)
    grads_j = vjp(jnp.asarray(cot))

    ts = [_t(a).requires_grad_() for a in (x, p.w_ih0, p.b_ih0, p.w_hh0, p.b_hh0)]
    ts[0].requires_grad_(with_dx)
    fn = gru_cuda.GruSeqFn if form == "seq" else gru_cuda.GruLastFn
    out = fn.apply(*ts, store_gates)
    (out * _t(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), rtol=0,
                               atol=BF16_GRU_ATOL)
    names = ("dx", "dW_ih", "db_ih", "dW_hh", "db_hh")
    for t, gj, name in zip(ts, grads_j, names):
        gj = np.asarray(gj)
        if name == "dx" and not with_dx:
            assert t.grad is None  # skipped, as with_dx=False skips it
            continue
        np.testing.assert_allclose(t.grad.numpy(), gj, rtol=0,
                                   atol=GRAD_RTOL * np.abs(gj).max(), err_msg=name)


def test_gru_bwd_plain_skips_dx_without_changing_param_grads(rng):
    """with_dx=False leaves the parameter gradients bit-equal (the JAX
    package's claim, tests/test_gru_pallas.py:249), for both backwards."""
    p, x = _bwd_case(rng, 8)
    w = [_t(a) for a in (p.w_ih0, p.b_ih0, p.w_hh0, p.b_hh0)]
    g = torch.from_numpy(rng.standard_normal((N_B, H_B)).astype(np.float32))
    hs, gates = gru_cuda.gru_fwd_sg(_t(x), *w)
    on = gru_cuda.gru_bwd(_t(x), hs, *w, g, with_dx=True)
    off = gru_cuda.gru_bwd(_t(x), hs, *w, g, with_dx=False)
    on_sg = gru_cuda.gru_bwd_sg(_t(x), hs, gates, w[0], w[2], g, with_dx=True)
    off_sg = gru_cuda.gru_bwd_sg(_t(x), hs, gates, w[0], w[2], g, with_dx=False)
    assert off[0] is None and off_sg[0] is None
    assert on[0].shape == (N_B, T_B, D_B) and on[0].abs().max() > 0
    for a, b in list(zip(on[1:], off[1:])) + list(zip(on_sg[1:], off_sg[1:])):
        assert torch.equal(a, b)


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """Spacing of bf16 values at |v| (8 significant bits)."""
    _, e = np.frexp(np.abs(v).astype(np.float32))
    return np.ldexp(np.float32(1.0), e - 8).astype(np.float32)


def test_gru_fwd_sg_plain_matches_run_fwd3(rng):
    from sldm_gnn_tpu.ops.gru_pallas import _run_fwd3

    p, x = _bwd_case(rng, 9)
    w = [_t(a) for a in (p.w_ih0, p.b_ih0, p.w_hh0, p.b_hh0)]
    hs, gates = gru_cuda.gru_fwd_sg(_t(x), *w)
    assert hs.dtype == gates.dtype == torch.bfloat16
    assert hs.shape == (T_B, N_B, H_B) and gates.shape == (T_B, N_B, 4 * H_B)
    # the v3 forward's hs is the v2 forward's, bit for bit
    assert torch.equal(hs, gru_cuda.gru_fwd(_t(x), *w, seq=True))
    xt = jnp.pad(jnp.moveaxis(jnp.asarray(x), 1, 0), ((0, 0), (0, 48 - N_B), (0, 0)))
    hs_j, gates_j = _run_fwd3(xt, p.w_ih0.astype(jnp.bfloat16), p.b_ih0,
                              p.w_hh0.astype(jnp.bfloat16), p.b_hh0, rb=16, interpret=True)
    hs_j = np.asarray(hs_j[:, :N_B].astype(jnp.float32))
    gates_j = np.asarray(gates_j[:, :N_B].astype(jnp.float32))
    # XLA's dot sums in another order than torch's matmul, which can flip
    # the rounding of a value that cancels to ~1e-5 (one element of 15360
    # here): each value within one bf16 ulp, almost all bit-equal
    for got, want in ((hs.float().numpy(), hs_j), (gates.float().numpy(), gates_j)):
        diff = np.abs(got - want)
        assert (diff <= _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))).all()
        assert (diff > 0).mean() < 1e-3


def test_store_gates_only_when_a_gradient_is_needed(rng, monkeypatch):
    """Without a gradient (eval, serving) the store-gates path runs the
    plain forward and writes no gates; with one it runs the store-gates
    forward and its backward, and never the plain forward."""
    p, x = _bwd_case(rng, 10)
    ws = [_t(a).requires_grad_() for a in (p.w_ih0, p.w_hh0, p.b_ih0, p.b_hh0)]
    z = torch.zeros
    params = GRUParams(*ws, z(0, H_B, 3 * H_B), z(0, H_B, 3 * H_B), z(0, 3 * H_B),
                       z(0, 3 * H_B))

    def refuse(*a, **k):
        raise AssertionError("called")

    with monkeypatch.context() as m, torch.no_grad():
        m.setattr(gru_cuda, "gru_fwd_sg", refuse)
        h_eval = gru_cuda.gru_last_forward(params, _t(x), store_gates=True)
    with monkeypatch.context() as m:
        m.setattr(gru_cuda, "gru_fwd", refuse)
        m.setattr(gru_cuda, "gru_bwd", refuse)
        h = gru_cuda.gru_last_forward(params, _t(x), store_gates=True)
        h.sum().backward()
    assert torch.equal(h.detach(), h_eval)
    assert all(w.grad is not None and w.grad.abs().max() > 0 for w in ws)


# ------------------------------------------------------------ the forward kernels' widths


@pytest.mark.parametrize("n", [1, 32, 65])
@pytest.mark.parametrize("h", [16, 33, 40, 128])
@pytest.mark.parametrize("d", [6, 128])
def test_gru_fwd_plain_matches_pallas_at_kernel_widths(rng, n, h, d):
    """The plain versions of both forward instances against the Pallas
    kernels in interpret mode at the widths the tensor-core kernel pads (H
    to a multiple of 32, D to 16; an odd H, whose outputs it stores element
    by element) and the row counts around its 64-row tile: h_last and hs (gru_last_pallas, gru_seq_pallas) and the
    store-gates hs and gates (_run_fwd3), whose hs is the plain instance's
    bit for bit."""
    from sldm_gnn_tpu.ops.gru_pallas import _run_fwd3

    T = 6
    p = init_gru_params(jax.random.PRNGKey(h + d), d, h, 1)
    x = rng.standard_normal((n, T, d)).astype(np.float32)
    w = [_t(a) for a in (p.w_ih0, p.b_ih0, p.w_hh0, p.b_hh0)]
    jw = (p.w_ih0, p.b_ih0, p.w_hh0, p.b_hh0)
    got = gru_cuda.gru_fwd_plain(_t(x), *w)
    want = gru_last_pallas(jnp.asarray(x), *jw, 1024, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=BF16_GRU_ATOL)
    hs = gru_cuda.gru_fwd_plain(_t(x), *w, seq=True)
    want_hs = gru_seq_pallas(jnp.asarray(x), *jw, 1024, True)
    np.testing.assert_allclose(hs.float().transpose(0, 1).numpy(), np.asarray(want_hs),
                               rtol=0, atol=BF16_GRU_ATOL)
    hs_sg, gates = gru_cuda.gru_fwd_sg_plain(_t(x), *w)
    assert torch.equal(hs_sg, hs) and gates.shape == (T, n, 4 * h)
    n_pad = -(-n // 16) * 16
    xt = jnp.pad(jnp.moveaxis(jnp.asarray(x), 1, 0), ((0, 0), (0, n_pad - n), (0, 0)))
    hs_j, gates_j = _run_fwd3(xt, p.w_ih0.astype(jnp.bfloat16), p.b_ih0,
                              p.w_hh0.astype(jnp.bfloat16), p.b_hh0, rb=16, interpret=True)
    for a, b in ((hs_sg, hs_j), (gates, gates_j)):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b[:, :n].astype(jnp.float32)),
                                   rtol=0, atol=BF16_GRU_ATOL)


@pytest.mark.parametrize("h,mult,d", [(40, 16, 6), (40, 32, 128), (100, 32, 6), (96, 32, 96)])
def test_gru_padded_units_stay_zero(rng, h, mult, d):
    """H padded to a multiple of 16 (the wgmma depth) or 32 (the tensor-core
    kernel's four warpgroups of whole 8-unit tiles) with zero weights and zero
    biases: the first H units come out as without the padding (the zero terms
    add exact zeros), and a padded unit is exactly 0 at every step (r = z =
    1/2, n = tanh(0) = 0), its stored gates 1/2, 1/2, 0 and hn 0."""
    n, T, hp = 33, 8, -(-h // mult) * mult
    b = 1.0 / h ** 0.5
    u = lambda *s: torch.from_numpy(rng.uniform(-b, b, s).astype(np.float32))
    w_ih, b_ih, w_hh, b_hh = u(d, 3 * h), u(3 * h), u(h, 3 * h), u(3 * h)

    def pad_gates(w):
        out = torch.zeros(w.shape[:-1] + (3 * hp,))
        for g in range(3):
            out[..., g * hp:g * hp + h] = w[..., g * h:(g + 1) * h]
        return out

    p_hh = torch.zeros((hp, 3 * hp))
    p_hh[:h] = pad_gates(w_hh)
    padded = (pad_gates(w_ih), pad_gates(b_ih), p_hh, pad_gates(b_hh))
    x = torch.from_numpy(rng.standard_normal((n, T, d)).astype(np.float32))
    hs = gru_cuda.gru_fwd_plain(x, w_ih, b_ih, w_hh, b_hh, seq=True)
    hs_p, gates_p = gru_cuda.gru_fwd_sg_plain(x, *padded)
    assert torch.equal(hs_p[..., :h], hs)
    assert torch.equal(hs_p[..., h:], torch.zeros_like(hs_p[..., h:]))
    pads = [gates_p[..., g * hp + h:(g + 1) * hp].float() for g in range(4)]
    for got, want in zip(pads, (0.5, 0.5, 0.0, 0.0)):
        assert torch.equal(got, torch.full_like(got, want))
    assert torch.equal(gru_cuda.gru_fwd_plain(x, *padded)[:, :h],
                       gru_cuda.gru_fwd_plain(x, w_ih, b_ih, w_hh, b_hh))

