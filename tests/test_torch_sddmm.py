"""The port's SDDMM (sldm_gnn_tpu_torch.ops.sddmm) against the JAX package's
on the CPU, at the sizes of tests/test_sddmm.py, inputs made with numpy
from a seed:

  * prepare_sddmm's layouts equal the JAX builder's slot for slot (its
    numpy path, and its native library at 100k edges and more);
  * the plain version of csrc/sddmm.cu within 1e-3 of sddmm_pallas in
    interpret mode (the JAX test's bound: the TPU kernel's dot runs at
    DEFAULT precision) and within 1e-5 of sddmm_xla;
  * sddmm_apply's gradients against jax.grad of the JAX sddmm_apply at
    tests/test_sddmm.py:72's rtol 1e-4 / atol 1e-5, and with use_pallas
    against the JAX backward through the interpret one-hot kernel;
  * the edge-attention composition of tests/test_sddmm.py:76-112.

The CUDA kernel runs only on the card, where chip_smoke.py holds it
against this plain version."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sldm_gnn_tpu.graph import csr as jcsr
from sldm_gnn_tpu.ops import sddmm as jsd
from sldm_gnn_tpu.ops import spmm as jspmm

from sldm_gnn_tpu_torch.graph import csr as tcsr
from sldm_gnn_tpu_torch.ops import sddmm as tsd
from sldm_gnn_tpu_torch.ops import spmm as tspmm

FIELDS = ("block_meta", "src_local", "dst_local", "weight", "edge_id")


def _assert_layout_equal(t, j):
    for f in FIELDS:
        got, want = getattr(t, f).numpy(), np.asarray(getattr(j, f))
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert (t.tile, t.step_chunks) == (j.tile, j.step_chunks)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("n,e", [(50, 250), (300, 1200), (20000, 120_000)])
def test_prepare_sddmm_equals_jax(rng, n, e):
    dst = rng.integers(0, n, e)
    src = np.clip(dst + rng.integers(-300, 301, e), 0, n - 1)
    tf, tr, tn = tsd.prepare_sddmm(src, dst, n)
    jf, jr, jn = jsd.prepare_sddmm(src, dst, n)
    assert tn == jn
    _assert_layout_equal(tf, jf)
    _assert_layout_equal(tr, jr)
    assert float(tf.weight.sum()) == e  # unit weights, one live slot an edge


def test_sddmm_xla_matches_jax_and_naive(rng):
    n, e, d = 60, 300, 16
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = rng.standard_normal((n, d)).astype(np.float32)
    got = tsd.sddmm_xla(_t(x), _t(y), _t(src), _t(dst)).numpy()
    want = np.asarray(jsd.sddmm_xla(jnp.asarray(x), jnp.asarray(y), jnp.asarray(src),
                                    jnp.asarray(dst)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    naive = np.array([x[dst[i]] @ y[src[i]] for i in range(e)], np.float32)
    np.testing.assert_allclose(got, naive, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", [128, 40])
def test_plain_matches_pallas_interpret(rng, d):
    n, e = 300, 1200
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    n_pad = tcsr.pad_nodes(n)
    x = rng.standard_normal((n_pad, d)).astype(np.float32)
    y = rng.standard_normal((n_pad, d)).astype(np.float32)
    tb, jb = tcsr.block_edges(src, dst, n_pad), jcsr.block_edges(src, dst, n_pad)
    chunks = tsd.sddmm(_t(x), _t(y), tb)
    assert chunks.dtype == torch.float32 and tuple(chunks.shape) == tuple(jb.weight.shape)
    assert (chunks.numpy()[np.asarray(jb.weight) == 0] == 0).all()
    jchunks = jsd.sddmm_pallas(jnp.asarray(x), jnp.asarray(y), jb, interpret=True)
    np.testing.assert_allclose(chunks.numpy(), np.asarray(jchunks), rtol=1e-3, atol=1e-3)
    got = tsd.chunk_scores_to_edge_order(chunks, tb, e).numpy()
    want = np.asarray(jsd.sddmm_xla(jnp.asarray(x), jnp.asarray(y), jnp.asarray(src),
                                    jnp.asarray(dst)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the chunk-layout reference path agrees too
    got2 = tsd._sddmm_chunk_xla(_t(x), _t(y), tb)
    want2 = np.asarray(jsd._sddmm_chunk_xla(jnp.asarray(x), jnp.asarray(y), jb))
    np.testing.assert_allclose(got2.numpy(), want2, rtol=1e-5, atol=1e-5)


def test_plain_sums_in_the_kernels_order(rng):
    """Lane sums over the column groups, then the xor tree: computed here
    slot by slot in numpy f32 with the same order, bit for bit."""
    n, e, d = 130, 400, 70
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    n_pad = tcsr.pad_nodes(n)
    x = rng.standard_normal((n_pad, d)).astype(np.float32)
    y = rng.standard_normal((n_pad, d)).astype(np.float32)
    tb = tcsr.block_edges(src, dst, n_pad, edge_chunk=64)
    got = tsd.sddmm_plain(_t(x), _t(y), tb).numpy().reshape(-1)
    gs, gd, w = (t.numpy() for t in tspmm.global_edges(tb))
    for s in np.nonzero(w)[0][:60]:
        lanes = np.zeros(32, np.float32)
        for c in range(d):
            lanes[c % 32] = np.float32(lanes[c % 32] + np.float32(x[gd[s], c] * y[gs[s], c]))
        for off in (16, 8, 4, 2, 1):
            lanes = (lanes[:off] + lanes[off:2 * off]).astype(np.float32)
        assert got[s] == lanes[0]


def test_chunk_scores_to_edge_order_equals_jax(rng):
    n, e = 200, 900
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    tf, _, _ = tsd.prepare_sddmm(src, dst, n)
    jf, _, _ = jsd.prepare_sddmm(src, dst, n)
    scores = rng.standard_normal(tuple(tf.weight.shape)).astype(np.float32)
    got = tsd.chunk_scores_to_edge_order(_t(scores), tf, e).numpy()
    want = np.asarray(jsd.chunk_scores_to_edge_order(jnp.asarray(scores), jf, e))
    np.testing.assert_array_equal(got, want)


def _grad_case(rng):
    n, e, d = 50, 250, 8
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    tf, tr, n_pad = tsd.prepare_sddmm(src, dst, n)
    jf, jr, _ = jsd.prepare_sddmm(src, dst, n)
    x = rng.standard_normal((n_pad, d)).astype(np.float32)
    y = rng.standard_normal((n_pad, d)).astype(np.float32)
    coef = rng.standard_normal(e).astype(np.float32)
    return src, dst, e, n_pad, (tf, tr), (jf, jr), x, y, coef


def _port_grads(x, y, tf, tr, n_pad, use_pallas, e, coef):
    xt, yt = _t(x).requires_grad_(), _t(y).requires_grad_()
    s = tsd.sddmm_apply(xt, yt, tf, tr, n_pad, use_pallas, e)
    s.retain_grad()
    loss = (torch.tanh(s) * _t(coef)).sum()
    loss.backward()
    return loss.item(), xt.grad.numpy(), yt.grad.numpy(), s


def test_sddmm_apply_grads_match_jax(rng):
    src, dst, e, n_pad, (tf, tr), (jf, jr), x, y, coef = _grad_case(rng)
    loss, gx, gy, _ = _port_grads(x, y, tf, tr, n_pad, False, e, coef)

    def loss_custom(x, y):
        return jnp.sum(jnp.tanh(jsd.sddmm_apply(x, y, jf, jr, n_pad, False, e)) * coef)

    jx, jy = jnp.asarray(x), jnp.asarray(y)
    np.testing.assert_allclose(loss, float(loss_custom(jx, jy)), rtol=1e-5)
    wx, wy = jax.grad(loss_custom, argnums=(0, 1))(jx, jy)
    np.testing.assert_allclose(gx, np.asarray(wx), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gy, np.asarray(wy), rtol=1e-4, atol=1e-5)


def test_sddmm_apply_kernel_path_matches_jax_interpret(rng):
    """use_pallas: the forward through sddmm's plain version, the backward
    through the one-hot kernel's plain version at DEFAULT precision (bf16 g
    and y), against the JAX backward (_sddmm_bwd) run through the
    interpret one-hot kernel."""
    src, dst, e, n_pad, (tf, tr), (jf, jr), x, y, coef = _grad_case(rng)
    _, gx, gy, s = _port_grads(x, y, tf, tr, n_pad, True, e, coef)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(jsd.sddmm_apply(
        jx, jy, jf, jr, n_pad, False, e)), rtol=1e-5, atol=1e-5)
    g = s.grad.numpy()  # the cotangent the backward was given

    def agg(v, lay):
        w = jnp.where(lay.weight != 0, jnp.asarray(g)[lay.edge_id], 0.0)
        return np.asarray(jspmm.spmm_pallas(v, jax.tree.map(jnp.asarray, jsd._with_weight(lay, w)),
                                            n_pad, interpret=True))

    wx, wy = agg(jy, jf), agg(jx, jr)
    for got, want in ((gx, wx), (gy, wy)):
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-5


def test_with_weight_keeps_the_plan(rng):
    src, dst, e, n_pad, (tf, _), _, _, _, _ = _grad_case(rng)
    plan = tspmm.onehot_plan(tf, n_pad)
    w = torch.where(tf.weight != 0, torch.full_like(tf.weight, 0.5), 0.0)
    moved = tsd._with_weight(tf, w)
    assert torch.equal(moved.weight, w) and moved.edge_id is tf.edge_id
    assert tspmm.onehot_plan(moved, n_pad) is plan
    fresh = tsd._with_weight(tcsr.block_edges(src, dst, n_pad), w)
    assert "_onehot_plan" not in fresh.__dict__


def test_contracts_raise_and_cpu_launches_nothing(rng):
    n, e, d = 140, 500, 8
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    tf, _, n_pad = tsd.prepare_sddmm(src, dst, n)
    x = torch.from_numpy(rng.standard_normal((n_pad, d)).astype(np.float32))
    for fn in (tsd.sddmm, tsd.sddmm_plain):
        with pytest.raises(ValueError, match="float32"):
            fn(x.to(torch.bfloat16), x, tf)
        with pytest.raises(ValueError, match="float32"):
            fn(x, x[:, :4], tf)
        with pytest.raises(ValueError, match="multiple"):
            fn(x[:100], x[:100], tf)
    before = tsd.sddmm.launches
    assert torch.equal(tsd.sddmm(x, x, tf), tsd.sddmm_plain(x, x, tf))
    assert tsd.sddmm.launches == before


@pytest.mark.parametrize("use_pallas", [False, True])
def test_edge_attention_composition(rng, use_pallas):
    """SDDMM scores -> per-destination softmax -> weighted SpMM equals a
    dense masked attention (tests/test_sddmm.py:76-112, its tolerance);
    the scores through sddmm_apply on the blocked layouts."""
    n, d = 12, 4
    src, dst = np.nonzero(~np.eye(n, dtype=bool))
    keep = rng.random(len(src)) < 0.4
    src, dst = src[keep].astype(np.int64), dst[keep].astype(np.int64)
    e = len(src)
    x = rng.standard_normal((n, d)).astype(np.float32)
    tf, tr, n_pad = tsd.prepare_sddmm(src, dst, n)
    xp = np.zeros((n_pad, d), np.float32)
    xp[:n] = x
    scores = tsd.sddmm_apply(_t(xp), _t(xp), tf, tr, n_pad, use_pallas, e)
    np.testing.assert_allclose(
        scores.numpy(), tsd.sddmm_xla(_t(x), _t(x), _t(src), _t(dst)).numpy(),
        rtol=1e-5, atol=1e-5)
    scores = scores.numpy()
    alpha = np.zeros(e, np.float32)
    for i in range(n):
        m = dst == i
        if m.any():
            ex = np.exp(scores[m] - scores[m].max())
            alpha[m] = ex / ex.sum()
    out = tspmm.spmm_xla(_t(x), _t(src), _t(dst), _t(alpha), n).numpy()

    att = np.full((n, n), -np.inf, np.float32)
    att[dst, src] = scores
    with np.errstate(over="ignore"):
        w = np.exp(att - att.max(axis=1, keepdims=True))
    w[np.isnan(w)] = 0.0
    denom = w.sum(axis=1, keepdims=True)
    w = np.divide(w, denom, out=np.zeros_like(w), where=denom > 0)
    np.testing.assert_allclose(out, w @ x, rtol=1e-4, atol=1e-5)
