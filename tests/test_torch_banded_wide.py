"""The port's ``wide`` banded layouts (``widen_banded``, the slot axis folded
into the tiles' columns) against the JAX package's on the CPU, at the sizes
of tests/test_spmm_banded.py, inputs made with numpy from a seed:

  * the layouts equal the JAX package's bit for bit;
  * the f32 twin agrees with JAX's, and the kernel's plain version with the
    Pallas kernel's ``wide`` branch run in interpret mode, and is bit-equal
    to the narrow layout's plain version;
  * ``spmm_banded_apply``'s gradients and ``BlockedSageClassifier`` (which
    takes wide layouts unfused, as the JAX model does) agree with JAX's.

The CUDA kernel reads the wide tiles in place; chip_smoke.py holds it
bit-equal to the narrow kernel on the card."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from sldm_gnn_tpu.models.blocked_sage import BlockedSageClassifier as JClassifier
from sldm_gnn_tpu.ops import spmm_banded as jsb

from sldm_gnn_tpu_torch.interop import params_to_state_dict, state_dict_to_params
from sldm_gnn_tpu_torch.models.blocked_sage import BlockedSageClassifier
from sldm_gnn_tpu_torch.ops import spmm_banded as tsb

# tests/test_spmm_banded.py:28-34's graph and sizes
N, TILE, K, D = 3000, 64, 4, 16
# the twin against JAX's twin (the JAX package's own wide-vs-narrow bound,
# test_spmm_banded.py:117) and the aggregation's gradient (:41)
TWIN_TOL = 1e-6
GRAD_TOL = 1e-4
# the plain version against the Pallas kernel in interpret mode: PERF.md
# §2's banded bound, 1e-2 of max|out| (bf16 operands, f32 sums in another
# order)
KERNEL_REL = 1e-2
# the classifier against the JAX model (tests/test_blocked_sage.py:37-38)
RTOL, ATOL = 2e-4, 2e-5
HIDDEN, CLASSES, SLOPE, CN = (16, 16), 3, 0.1, 1200


def _graph(seed, n=N, deg=8, reach=100):
    rng = np.random.default_rng(seed)
    dst = np.repeat(np.arange(n, dtype=np.int64), deg)
    src = np.clip(dst + rng.integers(-reach, reach + 1, n * deg), 0, n - 1)
    return src, dst


def _layouts(dtype, seed=0, n=N, **kw):
    src, dst = _graph(seed, n=n, **kw)
    t = tsb.prepare_banded_mean_aggregate(src, dst, n, tile=TILE, k=K, dtype=dtype, wide=True)
    j = jsb.prepare_banded_mean_aggregate(src, dst, n, tile=TILE, k=K, dtype=dtype, wide=True)
    return t, j, src, dst


def _x(n_pad, seed=1, d=D):
    return np.random.default_rng(seed).standard_normal((n_pad, d)).astype(np.float32)


@pytest.mark.parametrize("dtype", [np.int8, np.float32])
def test_wide_layouts_equal_jax(dtype):
    (tf, tr, tn), (jf, jr, jn), _, _ = _layouts(dtype)
    assert tn == jn
    for tb, jb in ((tf, jf), (tr, jr)):
        assert tb.wide and jb.wide
        for f in ("a", "bo", "woff", "off", "row_scale", "col_scale"):
            tv, jv = getattr(tb, f), getattr(jb, f)
            if jv is None:
                assert tv is None, f
                continue
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv), err_msg=f)
            assert tv.numpy().dtype == np.asarray(jv).dtype, f
        assert (tb.wsz, tb.k, tb.tile, tb.s_span) == (jb.wsz, jb.k, jb.tile, jb.s_span)
    narrow = tsb.prepare_banded_mean_aggregate(*_graph(0), N, tile=TILE, k=K, dtype=dtype)[0]
    again = tsb.widen_banded(narrow)
    assert torch.equal(again.a, tf.a) and tsb.widen_banded(again) is again
    assert torch.equal(tsb.slot_tiles(tf), narrow.a)


@pytest.mark.parametrize("dtype", [np.int8, np.float32])
def test_wide_twin_matches_jax(dtype):
    (tf, tr, n_pad), (jf, jr, _), _, _ = _layouts(dtype)
    x = _x(n_pad)
    for tb, jb in ((tf, jf), (tr, jr)):
        want = np.asarray(jsb.spmm_banded_xla(jnp.asarray(x), jax.tree.map(jnp.asarray, jb)))
        got = tsb.spmm_banded_xla(torch.from_numpy(x), tb).numpy()
        np.testing.assert_allclose(got, want, rtol=TWIN_TOL, atol=TWIN_TOL)


@pytest.mark.parametrize("dtype", [np.int8, np.float32])
@pytest.mark.parametrize("direction", ["forward", "reverse"])
def test_wide_plain_matches_pallas_and_narrow(dtype, direction):
    """The plain version on the wide layout against the Pallas kernel's wide
    branch (interpret mode), and bit for bit against the narrow layout's
    plain version; both directions (the reverse one scales x's rows)."""
    (tf, tr, n_pad), (jf, jr, _), src, dst = _layouts(dtype)
    narrow = tsb.prepare_banded_mean_aggregate(src, dst, N, tile=TILE, k=K, dtype=dtype)
    tb, jb, nb = (tf, jf, narrow[0]) if direction == "forward" else (tr, jr, narrow[1])
    x = _x(n_pad, seed=2)
    want = np.asarray(jsb.spmm_banded_pallas(jnp.asarray(x), jax.tree.map(jnp.asarray, jb),
                                             interpret=True))
    xt = torch.from_numpy(x)
    got = tsb.spmm_banded_plain(xt, tb)
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err < KERNEL_REL, err
    assert torch.equal(got, tsb.spmm_banded_plain(xt, nb))
    assert torch.equal(tsb.spmm_banded(xt, tb), got)
    xb = xt.to(torch.bfloat16)
    assert torch.equal(tsb.spmm_banded_plain(xb, tb), tsb.spmm_banded_plain(xb, nb))


def test_wide_tail_block_rebase():
    """tests/test_spmm_banded.py:87-118's layout (a 6-tile span and
    rebased tail blocks) widened: equal to JAX's, and the plain version
    within the kernel bound of the Pallas kernel."""
    n, tile = 1024, 64
    rng = np.random.default_rng(5)
    dst = np.concatenate([np.zeros(400, np.int64), np.arange(n - 3 * tile, n, dtype=np.int64)])
    src = np.concatenate([rng.integers(0, 6 * tile, 400).astype(np.int64),
                          np.arange(n - 3 * tile, n, dtype=np.int64)])
    tf, _, n_pad = tsb.prepare_banded_mean_aggregate(src, dst, n, tile=tile, k=2, wide=True)
    jf, _, _ = jsb.prepare_banded_mean_aggregate(src, dst, n, tile=tile, k=2, wide=True)
    assert tf.s_span == 6
    np.testing.assert_array_equal(tf.a.numpy(), np.asarray(jf.a))
    x = _x(n_pad, seed=3, d=8)
    want = np.asarray(jsb.spmm_banded_pallas(jnp.asarray(x), jax.tree.map(jnp.asarray, jf),
                                             interpret=True))
    got = tsb.spmm_banded_plain(torch.from_numpy(x), tf).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < KERNEL_REL


def test_wide_apply_gradients_match_jax():
    """``spmm_banded_apply`` on wide layouts: the twin's gradient against
    JAX's twin, and the kernel path's (the plain version on the reverse
    layout) against the Pallas kernel on JAX's reverse layout."""
    (tf, tr, n_pad), (jf, jr, _), _, _ = _layouts(np.int8)
    fj, rj = jax.tree.map(jnp.asarray, (jf, jr))
    x, t = _x(n_pad, seed=4), _x(n_pad, seed=5)
    want = np.asarray(jax.grad(lambda v: jnp.sum(jsb.spmm_banded_apply(v, fj, rj, False)
                                                 * jnp.asarray(t)))(jnp.asarray(x)))
    for use_pallas in (False, True):
        xt = torch.from_numpy(x).requires_grad_()
        (tsb.spmm_banded_apply(xt, tf, tr, use_pallas) * torch.from_numpy(t)).sum().backward()
        got = xt.grad.numpy()
        if use_pallas:
            ref = np.asarray(jsb.spmm_banded_pallas(jnp.asarray(t), rj, interpret=True))
            assert np.abs(got - ref).max() / np.abs(ref).max() < KERNEL_REL
        else:
            np.testing.assert_allclose(got, want, rtol=GRAD_TOL, atol=GRAD_TOL)


def _cls_data(n_pad):
    r2 = np.random.default_rng(3)
    x = np.zeros((n_pad, 12), np.float32)
    x[:CN] = r2.standard_normal((CN, 12))
    y = r2.integers(0, CLASSES, CN)
    x[np.arange(CN), y] += 1.0
    return x, y


@pytest.mark.parametrize("mode", ["unfused", "fused"])
def test_classifier_on_wide_layouts_matches_jax(mode):
    """BlockedSageClassifier on wide layouts (``fused=True`` takes the
    unfused path, as in JAX): logits and one Adam step at the JAX
    package's bounds."""
    (tf, tr, n_pad), (jf, jr, _), _, _ = _layouts(np.int8, seed=6, n=CN, deg=4, reach=60)
    jlay = jax.tree.map(jnp.asarray, (jf, jr))
    x, y = _cls_data(n_pad)
    kw = dict(fused=True) if mode == "fused" else {}
    jm = JClassifier(HIDDEN, CLASSES, negative_slope=SLOPE, use_pallas=False, **kw)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), *jlay, n_pad)["params"]
    tm = BlockedSageClassifier(HIDDEN, CLASSES, in_features=12, negative_slope=SLOPE,
                               use_pallas=False, **kw)
    tm.load_state_dict(params_to_state_dict(params))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), *jlay, n_pad))
    got = tm(torch.from_numpy(x), tf, tr, n_pad)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=ATOL)

    def jloss(p):
        logits = jm.apply({"params": p}, jnp.asarray(x), *jlay, n_pad)[:CN]
        return -jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * jax.nn.one_hot(y, CLASSES), 1))

    opt = optax.adam(1e-2)
    upd, _ = opt.update(jax.grad(jloss)(params), opt.init(params))
    want_p = optax.apply_updates(params, upd)
    topt = torch.optim.Adam(tm.parameters(), lr=1e-2)
    loss = torch.nn.functional.cross_entropy(got[:CN], torch.from_numpy(y))
    np.testing.assert_allclose(loss.item(), float(jloss(params)), rtol=RTOL)
    loss.backward()
    topt.step()
    flat_g = jax.tree_util.tree_flatten_with_path(state_dict_to_params(tm))[0]
    flat_w = jax.tree_util.tree_flatten_with_path(want_p)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=RTOL, atol=ATOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_classifier_kernel_path_on_wide_equals_narrow():
    """With ``use_pallas=True`` (the plain versions on CPU tensors) the
    unfused classifier's logits and input gradient on wide layouts are the
    narrow layouts', bit for bit."""
    src, dst = _graph(7, n=CN, deg=4, reach=60)
    narrow = tsb.prepare_banded_mean_aggregate(src, dst, CN, tile=TILE, k=K)
    wide = tsb.prepare_banded_mean_aggregate(src, dst, CN, tile=TILE, k=K, wide=True)
    x, _ = _cls_data(narrow[2])
    torch.manual_seed(0)
    tm = BlockedSageClassifier(HIDDEN, CLASSES, in_features=12, negative_slope=SLOPE)
    outs = []
    for fwd, rev, n_pad in (narrow, wide):
        xt = torch.from_numpy(x).requires_grad_()
        logits = tm(xt, fwd, rev, n_pad)
        (logits ** 2).sum().backward()
        outs.append((logits.detach(), xt.grad))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
