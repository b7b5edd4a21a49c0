"""The port's BlockedSageClassifier (sldm_gnn_tpu_torch.models.blocked_sage)
against the JAX package's on the CPU, at the small sizes of
tests/test_blocked_sage.py and test_banded_residual.py: the same graph,
features and labels from numpy, the JAX parameters carried across by
sldm_gnn_tpu_torch.interop, over the banded and the banded-residual
layouts, unfused, fused and fused with LayerNorm. With ``use_pallas=True``
the port runs the kernels' plain versions on CPU tensors."""

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

from sldm_gnn_tpu_torch.interop import params_to_state_dict, state_dict_to_params
from sldm_gnn_tpu_torch.models.blocked_sage import BlockedSageBlock, BlockedSageClassifier
from sldm_gnn_tpu_torch.models.blocks import SageBlock
from sldm_gnn_tpu_torch.ops.banded_residual import prepare_banded_residual_mean_aggregate
from sldm_gnn_tpu_torch.ops.spmm_banded import prepare_banded_mean_aggregate

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


def _layouts(rng, layout):
    src, dst = _graph(rng)
    if layout == "banded":
        src, dst = src[:-15], dst[:-15]
        tf, tr, n_pad = prepare_banded_mean_aggregate(src, dst, N, tile=TILE, k=K)
        jf, jr, _ = jax_prepare_banded(src, dst, N, tile=TILE, k=K)
        return (tf, tr), jax.tree.map(jnp.asarray, (jf, jr)), n_pad, src, dst
    tl, n_pad = prepare_banded_residual_mean_aggregate(src, dst, N, tile=TILE, k=K, span=3)
    jl, _ = jax_prepare_resid(src, dst, N, tile=TILE, k=K, span=3)
    assert len(tl.r_src) > 0
    return (tl, None), (jax.tree.map(jnp.asarray, jl), None), n_pad, src, dst


def _data(n_pad):
    r2 = np.random.default_rng(3)
    x = np.zeros((n_pad, D), np.float32)
    x[:N] = r2.standard_normal((N, D))
    y = r2.integers(0, CLASSES, N)
    x[np.arange(N), y] += 1.0
    return x, y


def _models(mode, n_pad, jlay, use_pallas=False):
    x, _ = _data(n_pad)
    jm = JClassifier(HIDDEN, CLASSES, negative_slope=SLOPE, use_pallas=False, **MODES[mode])
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), *jlay, n_pad)["params"]
    tm = BlockedSageClassifier(HIDDEN, CLASSES, in_features=D, negative_slope=SLOPE,
                               use_pallas=use_pallas, **MODES[mode])
    tm.load_state_dict(params_to_state_dict(params))
    return jm, params, tm


def _assert_tree_close(got: dict, want: dict, rtol=RTOL, atol=ATOL):
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=rtol, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("layout", ["banded", "residual"])
def test_logits_and_adam_step_match_jax(rng, layout, mode):
    tlay, jlay, n_pad, _, _ = _layouts(rng, layout)
    jm, params, tm = _models(mode, n_pad, jlay)
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


@pytest.mark.parametrize("mode", ["unfused", "fused", "fused_ln"])
@pytest.mark.parametrize("layout", ["banded", "residual"])
def test_kernel_path_close_to_jax_f32(rng, layout, mode):
    """use_pallas=True (the kernels' plain versions on CPU tensors, bf16
    operands) against the JAX f32 model, logits and input gradients."""
    tlay, jlay, n_pad, _, _ = _layouts(rng, layout)
    jm, params, tm = _models(mode, n_pad, jlay, use_pallas=True)
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


@pytest.mark.parametrize("layout", ["banded", "residual"])
def test_classifier_trains_through_the_kernel_path(rng, layout):
    tlay, _, n_pad, _, _ = _layouts(rng, layout)
    x, y = _data(n_pad)
    torch.manual_seed(0)
    model = BlockedSageClassifier(HIDDEN, CLASSES, in_features=D, negative_slope=SLOPE,
                                  fused=True, fused_ln=True)
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
    (tf, tr), _, n_pad, src, dst = _layouts(rng, "banded")
    x = torch.from_numpy(_data(n_pad)[0])
    with pytest.raises(NotImplementedError):
        BlockedSageClassifier(HIDDEN, CLASSES, in_features=D, int8_features=True)
    model = BlockedSageClassifier(HIDDEN, CLASSES, in_features=D, fused=True)
    onehot_f, onehot_r, _ = jax_prepare_onehot(src, dst, N)
    for lay in (onehot_f, dataclasses.replace(tf, wide=True),
                dataclasses.replace(tf, cmap=torch.zeros(tf.num_dst_blocks * tf.s_span,
                                                         dtype=torch.int32))):
        with pytest.raises(NotImplementedError):
            model(x, lay, tr, n_pad)
