"""The port's BlockedSageClassifier (sldm_gnn_tpu_torch.models.blocked_sage)
against the JAX package's on the CPU, at the small sizes of
tests/test_blocked_sage.py and test_banded_residual.py: the same graph,
features and labels from numpy, the JAX parameters carried across by
sldm_gnn_tpu_torch.interop, over every layout (banded, banded-residual,
one-hot, dense f32 and int8, hybrid, gather), unfused, fused and fused with
LayerNorm (which fall back to the unfused path where the layout cannot
fuse), and with int8 features. With ``use_pallas=True`` the port runs the
kernels' plain versions on CPU tensors."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from sldm_gnn_tpu.models.blocked_sage import BlockedSageClassifier as JClassifier
from sldm_gnn_tpu.ops.banded_residual import (
    prepare_banded_residual_mean_aggregate as jax_prepare_resid)
from sldm_gnn_tpu.ops.spmm import prepare_mean_aggregate as jax_prepare_onehot
from sldm_gnn_tpu.ops.spmm_banded import prepare_banded_mean_aggregate as jax_prepare_banded
from sldm_gnn_tpu.ops.spmm_dense import prepare_dense_mean_aggregate as jax_prepare_dense
from sldm_gnn_tpu.ops.spmm_gather import (
    prepare_gather_residual_mean_aggregate as jax_prepare_gather)
from sldm_gnn_tpu.ops.spmm_hybrid import prepare_hybrid_mean_aggregate as jax_prepare_hybrid

from sldm_gnn_tpu_torch.interop import params_to_state_dict, state_dict_to_params
from sldm_gnn_tpu_torch.models.blocked_sage import BlockedSageBlock, BlockedSageClassifier
from sldm_gnn_tpu_torch.models.blocks import SageBlock
from sldm_gnn_tpu_torch.ops.banded_residual import prepare_banded_residual_mean_aggregate
from sldm_gnn_tpu_torch.ops.spmm import prepare_mean_aggregate
from sldm_gnn_tpu_torch.ops.spmm_banded import prepare_banded_mean_aggregate
from sldm_gnn_tpu_torch.ops.spmm_dense import prepare_dense_mean_aggregate
from sldm_gnn_tpu_torch.ops.spmm_gather import prepare_gather_residual_mean_aggregate
from sldm_gnn_tpu_torch.ops.spmm_hybrid import prepare_hybrid_mean_aggregate

# the JAX package's bounds for BlockedSageBlock against the segment-op
# SageBlock (tests/test_blocked_sage.py:37-38), for logits and for one Adam
# step's parameters
RTOL, ATOL = 2e-4, 2e-5
# the kernel path (bf16 operands, f32 sums) against the f32 model: the
# JAX package's bf16-storage bound for the fused layer (test_sage_fused.py
# :127), max error over max|logit|; for the input gradient the same bound
# on the norm of the error over the gradient's norm, since a bf16 rounding
# can flip the sign of a near-zero pre-activation and with it that unit's
# derivative (1 against the slope), which moves a few entries by O(1) of
# their row but the norm by little
BF16_REL = 5e-2

N, TILE, K, D, HIDDEN, CLASSES, SLOPE = 1200, 64, 4, 12, (16, 16), 3, 0.1
MODES = {"unfused": dict(), "fused": dict(fused=True),
         "fused_ln": dict(fused=True, fused_ln=True), "ln_unfused": dict(fused_ln=True)}


def _graph(rng):
    """A near-banded graph: a local band and a few long-range edges."""
    dst = np.repeat(np.arange(N, dtype=np.int64), 4)
    src = np.clip(dst + rng.integers(-60, 61, len(dst)), 0, N - 1)
    o_dst = rng.integers(0, N, 15)
    return np.concatenate([src, o_dst]), np.concatenate([dst, (o_dst + N // 2) % N])


LAYOUTS = ["banded", "residual", "onehot", "onehot_k2", "dense", "dense_int8", "hybrid",
           "gather"]


def _layouts(rng, layout):
    """(port layout pair, JAX layout pair, n_pad, src, dst) for ``layout``."""
    src, dst = _graph(rng)
    if layout == "banded":
        src, dst = src[:-15], dst[:-15]
        tf, tr, n_pad = prepare_banded_mean_aggregate(src, dst, N, tile=TILE, k=K)
        jf, jr, _ = jax_prepare_banded(src, dst, N, tile=TILE, k=K)
        return (tf, tr), jax.tree.map(jnp.asarray, (jf, jr)), n_pad, src, dst
    if layout == "residual":
        tl, n_pad = prepare_banded_residual_mean_aggregate(src, dst, N, tile=TILE, k=K, span=3)
        jl, _ = jax_prepare_resid(src, dst, N, tile=TILE, k=K, span=3)
        assert len(tl.r_src) > 0
        return (tl, None), (jax.tree.map(jnp.asarray, jl), None), n_pad, src, dst
    if layout.startswith("onehot"):
        kw = dict(tile=TILE, edge_chunk=64, step_chunks=2 if layout == "onehot_k2" else 1)
        tf, tr, n_pad = prepare_mean_aggregate(src, dst, N, **kw)
        jf, jr, _ = jax_prepare_onehot(src, dst, N, **kw)
    elif layout.startswith("dense"):
        kw = dict(tile=TILE, dtype=np.int8 if layout == "dense_int8" else np.float32)
        tf, tr, n_pad = prepare_dense_mean_aggregate(src, dst, N, **kw)
        jf, jr, _ = jax_prepare_dense(src, dst, N, **kw)
    else:
        prep = dict(hybrid=(prepare_hybrid_mean_aggregate, jax_prepare_hybrid),
                    gather=(prepare_gather_residual_mean_aggregate, jax_prepare_gather))[layout]
        kw = dict(tile=TILE) if layout == "hybrid" else dict(tile=TILE, k=K)
        tl, n_pad = prep[0](src, dst, N, **kw)
        jl, _ = prep[1](src, dst, N, **kw)
        if layout == "hybrid":
            assert tl.dense_fwd is not None and tl.onehot_fwd is not None
        else:
            assert len(tl.r_src) > 0
        return (tl, None), (jax.tree.map(jnp.asarray, jl), None), n_pad, src, dst
    return (tf, tr), jax.tree.map(jnp.asarray, (jf, jr)), n_pad, src, dst


def _k_per_step(layout):
    return dict(k_per_step=2) if layout == "onehot_k2" else {}


def _data(n_pad):
    r2 = np.random.default_rng(3)
    x = np.zeros((n_pad, D), np.float32)
    x[:N] = r2.standard_normal((N, D))
    y = r2.integers(0, CLASSES, N)
    x[np.arange(N), y] += 1.0
    return x, y


def _models(mode, n_pad, jlay, use_pallas=False, **kw):
    x, _ = _data(n_pad)
    jm = JClassifier(HIDDEN, CLASSES, negative_slope=SLOPE, use_pallas=False, **MODES[mode],
                     **kw)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), *jlay, n_pad)["params"]
    tm = BlockedSageClassifier(HIDDEN, CLASSES, in_features=D, negative_slope=SLOPE,
                               use_pallas=use_pallas, **MODES[mode], **kw)
    tm.load_state_dict(params_to_state_dict(params))
    return jm, params, tm


def _assert_tree_close(got: dict, want: dict, rtol=RTOL, atol=ATOL):
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=rtol, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("layout,mode", [(lay, m) for lay in ("banded", "residual")
                                         for m in MODES]
                         + [(lay, m) for lay in LAYOUTS[2:] for m in ("unfused", "fused_ln")])
def test_logits_and_adam_step_match_jax(rng, layout, mode):
    tlay, jlay, n_pad, _, _ = _layouts(rng, layout)
    jm, params, tm = _models(mode, n_pad, jlay, **_k_per_step(layout))
    x, y = _data(n_pad)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), *jlay, n_pad))
    got = tm(torch.from_numpy(x), *tlay, n_pad)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=ATOL)

    def jloss(p):
        logits = jm.apply({"params": p}, jnp.asarray(x), *jlay, n_pad)[:N]
        return -jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * jax.nn.one_hot(y, CLASSES), 1))

    opt = optax.adam(1e-2)
    g = jax.grad(jloss)(params)
    upd, _ = opt.update(g, opt.init(params))
    want_p = optax.apply_updates(params, upd)

    topt = torch.optim.Adam(tm.parameters(), lr=1e-2)
    loss = torch.nn.functional.cross_entropy(got[:N], torch.from_numpy(y))
    np.testing.assert_allclose(loss.item(), float(jloss(params)), rtol=RTOL)
    loss.backward()
    topt.step()
    _assert_tree_close(state_dict_to_params(tm), want_p)


@pytest.mark.parametrize("layout,mode", [(lay, m) for lay in ("banded", "residual")
                                         for m in ("unfused", "fused", "fused_ln")]
                         + [(lay, "unfused") for lay in LAYOUTS[2:]] + [("hybrid", "fused")])
def test_kernel_path_close_to_jax_f32(rng, layout, mode):
    """use_pallas=True (the kernels' plain versions on CPU tensors, bf16
    operands; the gather kernel's in f32) against the JAX f32 model, logits
    and input gradients."""
    tlay, jlay, n_pad, _, _ = _layouts(rng, layout)
    jm, params, tm = _models(mode, n_pad, jlay, use_pallas=True, **_k_per_step(layout))
    x, _ = _data(n_pad)
    xt = torch.from_numpy(x).requires_grad_()
    got = tm(xt, *tlay, n_pad)
    (got ** 2).sum().backward()
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), *jlay, n_pad))
    gx = np.asarray(jax.grad(lambda v: jnp.sum(
        jm.apply({"params": params}, v, *jlay, n_pad) ** 2))(jnp.asarray(x)))
    got = got.detach().numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < BF16_REL
    assert np.linalg.norm(xt.grad.numpy() - gx) / np.linalg.norm(gx) < BF16_REL


def test_interop_round_trips_the_classifier_tree(rng):
    _, jlay, n_pad, _, _ = _layouts(rng, "banded")
    _, params, tm = _models("fused_ln", n_pad, jlay)
    back = state_dict_to_params(tm)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(
        jax.tree.map(np.asarray, params))
    _assert_tree_close(back, params, rtol=0, atol=0)
    assert set(back) == {"sage", "head"}
    assert set(back["sage"]["conv0"]["lin_r"]) == {"kernel"}


def test_unfused_block_matches_segment_sage_block(rng):
    """conv -> LayerNorm -> activation over the banded layout equals the
    segment-op SageBlock (models/blocks.py) with the same weights."""
    (tf, tr), _, n_pad, src, dst = _layouts(rng, "banded")
    x, _ = _data(n_pad)
    seg = SageBlock(D, HIDDEN, negative_slope=SLOPE)
    blk = BlockedSageBlock(D, HIDDEN, negative_slope=SLOPE, use_pallas=False)
    blk.load_state_dict(seg.state_dict())
    xt = torch.from_numpy(x)
    want = seg(xt, torch.from_numpy(src), torch.from_numpy(dst),
               torch.ones(len(src), dtype=torch.bool), n_pad)
    got = blk(xt, tf, tr, n_pad)
    np.testing.assert_allclose(got[:N].detach().numpy(), want[:N].detach().numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("layout", ["banded", "residual", "onehot_k2", "hybrid"])
def test_classifier_trains_through_the_kernel_path(rng, layout):
    tlay, _, n_pad, _, _ = _layouts(rng, layout)
    x, y = _data(n_pad)
    torch.manual_seed(0)
    model = BlockedSageClassifier(HIDDEN, CLASSES, in_features=D, negative_slope=SLOPE,
                                  fused=True, fused_ln=True, **_k_per_step(layout))
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    losses = []
    for _ in range(20):
        opt.zero_grad()
        loss = torch.nn.functional.cross_entropy(model(xt, *tlay, n_pad)[:N], yt)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert np.isfinite(losses).all() and losses[-1] < 0.8 * losses[0], losses


def test_left_out_options_raise(rng):
    """No option is left out any more. ``wide`` banded layouts run every
    mode, the fused ones taking the unfused path as in the JAX package
    (tests/test_torch_banded_wide.py holds them against it); unfused, their
    logits are the narrow layouts', bit for bit. ``cmap`` slots run every
    mode (tests/test_torch_cmap.py): cmaps that name each block's own band
    give the contiguous layouts' logits, bit for bit."""
    from sldm_gnn_tpu_torch.ops.spmm_banded import widen_banded

    (tf, tr), _, n_pad, _, _ = _layouts(rng, "banded")
    x = torch.from_numpy(_data(n_pad)[0])

    def as_cmap(b):
        band = (b.off.long()[:, None] + torch.arange(b.s_span)[None, :]).to(torch.int32)
        return dataclasses.replace(b, cmap=band.reshape(-1).contiguous())

    for mode in ("unfused", "fused", "fused_ln"):
        model = BlockedSageClassifier(HIDDEN, CLASSES, in_features=D, **MODES[mode])
        with torch.no_grad():
            got = model(x, widen_banded(tf), widen_banded(tr), n_pad)
            assert torch.isfinite(got).all(), mode
            if mode == "unfused":
                assert torch.equal(got, model(x, tf, tr, n_pad))
        with torch.no_grad():
            assert torch.equal(model(x, as_cmap(tf), as_cmap(tr), n_pad),
                               model(x, tf, tr, n_pad)), mode


@pytest.mark.parametrize("use_pallas", [False, True])
def test_int8_features_match_jax(rng, use_pallas):
    """int8_features=True against the JAX model's int8 path (use_pallas=False:
    the dequantized features aggregated in f32) at 2e-4, and within 5e-2 of
    max|logit| of the f32 path (tests/test_blocked_sage.py:125-147). The
    port's use_pallas=True runs the int8 kernel's plain version (exact
    integer sums, then the scales)."""
    tlay, jlay, n_pad, _, _ = _layouts(rng, "banded")
    x, _ = _data(n_pad)
    for mode in ("unfused", "fused_ln"):
        jm8, params, tm8 = _models(mode, n_pad, jlay, use_pallas=use_pallas, int8_features=True)
        want = np.asarray(jm8.apply({"params": params}, jnp.asarray(x), *jlay, n_pad))
        with torch.no_grad():
            got = tm8(torch.from_numpy(x), *tlay, n_pad).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        jm32 = JClassifier(HIDDEN, CLASSES, negative_slope=SLOPE, use_pallas=False,
                           **MODES[mode])
        f32 = np.asarray(jm32.apply({"params": params}, jnp.asarray(x), *jlay, n_pad))
        assert np.abs(got - f32).max() / np.abs(f32).max() < 5e-2
        assert not tm8.sage.fused_ln  # int8 takes the unfused LayerNorm


def test_int8_features_need_a_banded_layout(rng):
    for layout in ("residual", "onehot", "dense_int8"):
        tlay, _, n_pad, _, _ = _layouts(rng, layout)
        x = torch.from_numpy(_data(n_pad)[0])
        model = BlockedSageClassifier(HIDDEN, CLASSES, in_features=D, int8_features=True)
        with pytest.raises(TypeError, match="BandedBlocks"):
            model(x, *tlay, n_pad)


def test_k_per_step_must_match_the_layout(rng):
    """The one-hot kernel's contract: k_per_step must divide the layout's
    step_chunks (a ValueError, as in JAX), on the kernel path and its
    backward."""
    tlay, _, n_pad, _, _ = _layouts(rng, "onehot_k2")
    x = torch.from_numpy(_data(n_pad)[0])
    for k, ok in ((1, True), (2, True), (4, False)):
        model = BlockedSageClassifier(HIDDEN, CLASSES, in_features=D, k_per_step=k)
        if ok:
            assert torch.isfinite(model(x, *tlay, n_pad)).all()
        else:
            with pytest.raises(ValueError, match="cannot run at k_per_step=4"):
                model(x, *tlay, n_pad)
