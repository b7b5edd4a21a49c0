"""The port's halo planners and per-shard fused SAGE layers
(sldm_gnn_tpu_torch.parallel.halo, halo_fused) against the JAX package's on
the CPU, at the sizes of tests/test_halo_fused.py and test_halo_overlap.py,
inputs made with numpy from a seed:

  * every array of the planners equals JAX's (ep 2 and 4, and a tight span
    that spills interior overflow into the compact residual);
  * the four layers on one shard (the halo table built on the host from
    ``send_idx``) agree with JAX's: the twins at the bound of
    test_overlap_xla_exact_vs_fused, the kernel paths (the kernels' plain
    versions) against the Pallas kernels in interpret mode;
  * the fused forward's ``ypre`` output agrees with the Pallas kernel's;
  * the shards of a plan, run in turn and put back in global order, give
    the one-device layer's output, and their partial gradients sum to its
    gradients.

The exchange and the cross-shard gradient sum are not ported yet; the
tests do both on the host."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sldm_gnn_tpu.ops import sage_fused as jsf
from sldm_gnn_tpu.parallel import halo as jhalo
from sldm_gnn_tpu.parallel import halo_fused as jhf

from sldm_gnn_tpu_torch.ops import banded_residual as tbr
from sldm_gnn_tpu_torch.ops import sage_fused as tsf
from sldm_gnn_tpu_torch.parallel import halo as thalo
from sldm_gnn_tpu_torch.parallel import halo_fused as thf
from sldm_gnn_tpu_torch.parallel.halo_model import shard_node_array

# the twins against JAX's twins, and overlap against non-overlap: the bound
# of tests/test_halo_overlap.py:218 (test_overlap_xla_exact_vs_fused)
TWIN_TOL = 2e-5
# the kernel paths against JAX's Pallas kernels in interpret mode: the
# output and each gradient within 1e-2 of its max|value| (JAX's own
# kernel-vs-twin bounds are 3e-2 elementwise and 5e-2 of max|g|,
# tests/test_halo_overlap.py:170-178). Both sides round the same operands
# to bf16 and sum in f32 in other orders; an order difference can flip one
# bf16 rounding of an intermediate (the aggregate before @ Wl), 2^-8 of
# it, which 1e-2 of the largest value bounds
KERNEL_OUT_REL = 1e-2
KERNEL_GRAD_REL = 1e-2
# y_pre_c (f32, post-bias, pre-LN) against the Pallas kernel's
YPRE_REL = 1e-2
# the shards put back together against the one-device layer (twins, f32)
GLOBAL_TOL = 1e-5
SLOPE, EPS = 0.1, 1e-5
LAYERS = {"fused": (thf.halo_fused_sage, jhf.halo_fused_sage, False),
          "fused_ln": (thf.halo_fused_sage_ln, jhf.halo_fused_sage_ln, True),
          "fused_ov": (thf.halo_fused_sage_ov, jhf.halo_fused_sage_ov, False),
          "fused_ln_ov": (thf.halo_fused_sage_ln_ov, jhf.halo_fused_sage_ln_ov, True)}


def local_graph(n, deg, reach, seed=0):
    rng = np.random.default_rng(seed)
    dst = np.repeat(np.arange(n, dtype=np.int64), deg)
    src = np.clip(dst + rng.integers(-reach, reach + 1, n * deg), 0, n - 1)
    return src, dst


def tight_span_graph():
    """tests/test_halo_fused.py:200-213: a narrow band plus long-range
    interior edges that a span of 2 tiles spills into the residual."""
    src, dst = local_graph(96, 4, reach=3, seed=2)
    src = np.concatenate([src, np.array([10, 11, 9, 58, 59], np.int64)])
    dst = np.concatenate([dst, np.array([1, 2, 3, 49, 50], np.int64)])
    return src, dst


def _eq(t, j, what):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    np.testing.assert_array_equal(t, j, err_msg=what)
    assert t.dtype == j.dtype, what


def _blocks_eq(tb, jb, what):
    for f in ("a", "bo", "woff", "off", "row_scale", "col_scale"):
        if getattr(jb, f) is None:
            assert getattr(tb, f) is None, f"{what}.{f}"
        else:
            _eq(getattr(tb, f), getattr(jb, f), f"{what}.{f}")
    assert (tb.wsz, tb.k, tb.tile, tb.s_span, tb.wide) == (jb.wsz, jb.k, jb.tile, jb.s_span,
                                                           jb.wide), what


PLAN_CASES = {"ep2": (512, 4, 40, 2, dict(tile=64, banded_k=2)),
              "ep4": (512, 4, 40, 4, dict(tile=32, banded_k=2)),
              "tight_span": (96, None, None, 8, dict(tile=4, banded_k=2, span=2,
                                                     resid_frac=0.05))}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_planners_equal_jax(case):
    n, deg, reach, ep, kw = PLAN_CASES[case]
    src, dst = tight_span_graph() if deg is None else local_graph(n, deg, reach, seed=2)
    tp, tn = thalo.plan_halo_partition(src, dst, n, ep)
    jp, jn = jhalo.plan_halo_partition(src, dst, n, ep)
    assert tn == jn
    for f in ("send_idx", "src_local", "dst_local", "weight"):
        _eq(getattr(tp, f), getattr(jp, f), f)
    ts, js = thalo.split_halo_plan(tp, tn), jhalo.split_halo_plan(jp, jn)
    for f in ("send_idx", "int_src", "int_dst", "int_w", "hal_src", "hal_dst", "hal_w"):
        _eq(getattr(ts, f), getattr(js, f), f)
    tile, k = kw["tile"], kw["banded_k"]
    n_pad_local = ((tn + tile - 1) // tile) * tile
    if deg is not None:
        tib = thalo.plan_banded_interior(ts, dst, tn, n_pad_local, tile=tile, banded_k=k,
                                         banded_max_span=16)
        jib = jhalo.plan_banded_interior(js, dst, jn, n_pad_local, tile=tile, banded_k=k,
                                         banded_max_span=16)
        _blocks_eq(tib[0], jib[0], "int_fwd")
        _blocks_eq(tib[1], jib[1], "int_rev")
        assert tib[2] == jib[2]

    tf = thf.plan_halo_fused(src, dst, n, ep, **kw)
    jf = jhf.plan_halo_fused(src, dst, n, ep, **kw)
    _eq(tf.send_idx, jf.send_idx, "send_idx")
    assert (tf.n_local, tf.n_pad_local) == (jf.n_local, jf.n_pad_local)
    _blocks_eq(tf.int_fwd, jf.int_fwd, "int_fwd")
    _blocks_eq(tf.int_rev, jf.int_rev, "int_rev")
    for f in jf.bnd.__dataclass_fields__:
        tv, jv = getattr(tf.bnd, f), getattr(jf.bnd, f)
        if isinstance(jv, int):
            assert tv == jv, f
        else:
            _eq(tv, jv, f)
    if case == "tight_span":
        assert (tf.bnd.i_w_f.numpy() > 0).any(), "interior overflow not engaged"


def _one_shard(p=0, ep=2, n=512, deg=4, reach=40, d=16, h=24, tile=64, seed=0):
    """Shard p's layouts and inputs for both packages (tests/test_halo_fused.py
    :97-120): the halo table gathered on the host from send_idx."""
    rng = np.random.default_rng(seed)
    src, dst = local_graph(n, deg, reach, seed=2)
    tplan = thf.plan_halo_fused(src, dst, n, ep, tile=tile, banded_k=2)
    jplan = jhf.plan_halo_fused(src, dst, n, ep, tile=tile, banded_k=2)
    x_global = rng.standard_normal((n, d)).astype(np.float32)
    stacks = shard_node_array(x_global, ep, tplan.n_local)
    send = tplan.send_idx.numpy()
    halo = np.stack([stacks[q][send[q, p]] for q in range(ep)]).reshape(-1, d)
    xp = np.zeros((tplan.n_pad_local, d), np.float32)
    xp[: tplan.n_local] = stacks[p]
    params = dict(wl=rng.standard_normal((d, h)).astype(np.float32) * 0.2,
                  wr=rng.standard_normal((d, h)).astype(np.float32) * 0.2,
                  b=rng.standard_normal((h,)).astype(np.float32) * 0.1,
                  gamma=rng.standard_normal((h,)).astype(np.float32) * 0.3 + 1.0,
                  beta=rng.standard_normal((h,)).astype(np.float32) * 0.1)
    unstack = lambda t: jax.tree.map(lambda a: jnp.asarray(a[p]), t)
    jlay = (unstack(jplan.int_fwd), unstack(jplan.int_rev), unstack(jplan.bnd))
    return tplan, tplan.shard(p), jlay, xp, halo, params


def _run_port(fn, ln, lay, xp, halo, prm, use_pallas):
    names = ["x", "halo", "wl", "wr", "b"] + (["gamma", "beta"] if ln else [])
    vals = [xp, halo] + [prm[k] for k in names[2:]]
    ts = [torch.from_numpy(v).requires_grad_() for v in vals]
    extra = (EPS,) if ln else ()
    out = fn(*ts, *lay, use_pallas, SLOPE, *extra)
    (out ** 2).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _run_jax(fn, ln, lay, xp, halo, prm, use_pallas):
    names = ["wl", "wr", "b"] + (["gamma", "beta"] if ln else [])
    vals = [jnp.asarray(v) for v in [xp, halo] + [prm[k] for k in names]]
    extra = (EPS,) if ln else ()

    def f(*a):
        return fn(*a, *lay, use_pallas, SLOPE, *extra, use_pallas)

    out = f(*vals)
    grads = jax.grad(lambda *a: jnp.sum(f(*a) ** 2), argnums=tuple(range(len(vals))))(*vals)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("layer", list(LAYERS))
def test_layer_twin_matches_jax(layer):
    tfn, jfn, ln = LAYERS[layer]
    _, tlay, jlay, xp, halo, prm = _one_shard()
    out_t, g_t = _run_port(tfn, ln, tlay, xp, halo, prm, False)
    out_j, g_j = _run_jax(jfn, ln, jlay, xp, halo, prm, False)
    np.testing.assert_allclose(out_t, out_j, rtol=TWIN_TOL, atol=TWIN_TOL)
    for a, b, i in zip(g_t, g_j, range(len(g_j))):
        np.testing.assert_allclose(a, b, rtol=TWIN_TOL, atol=TWIN_TOL, err_msg=f"grad {i}")


@pytest.mark.parametrize("ln", [False, True])
def test_overlap_equals_non_overlap(ln):
    """The port's overlap layer against its non-overlap layer (twins): the
    same layer, restructured."""
    plain_fn, ov_fn = ((thf.halo_fused_sage_ln, thf.halo_fused_sage_ln_ov) if ln
                       else (thf.halo_fused_sage, thf.halo_fused_sage_ov))
    _, tlay, _, xp, halo, prm = _one_shard(p=1)
    out_a, g_a = _run_port(plain_fn, ln, tlay, xp, halo, prm, False)
    out_b, g_b = _run_port(ov_fn, ln, tlay, xp, halo, prm, False)
    np.testing.assert_allclose(out_b, out_a, rtol=TWIN_TOL, atol=TWIN_TOL)
    for a, b in zip(g_b, g_a):
        np.testing.assert_allclose(a, b, rtol=TWIN_TOL, atol=TWIN_TOL)


@pytest.mark.parametrize("layer", list(LAYERS))
def test_layer_kernel_path_matches_jax_interpret(layer):
    """``use_pallas=True``: the port's plain kernel versions against JAX's
    Pallas kernels in interpret mode, output and every gradient."""
    tfn, jfn, ln = LAYERS[layer]
    _, tlay, jlay, xp, halo, prm = _one_shard()
    out_t, g_t = _run_port(tfn, ln, tlay, xp, halo, prm, True)
    out_j, g_j = _run_jax(jfn, ln, jlay, xp, halo, prm, True)
    err = np.abs(out_t - out_j).max() / np.abs(out_j).max()
    assert err < KERNEL_OUT_REL, err
    for i, (a, b) in enumerate(zip(g_t, g_j)):
        rel = np.abs(a - b).max() / (np.abs(b).max() + 1e-9)
        assert rel < KERNEL_GRAD_REL, (i, rel)


@pytest.mark.parametrize("ln", [False, True])
def test_ypre_matches_pallas(ln):
    """The fused forward's ``y_pre_c`` slots >= 1 (the plain version) against
    ``banded_sage_fwd_pallas(..., ypre=...)`` in interpret mode, with the
    overlap layer's interior-overflow residual; and the output beside it."""
    _, (tf, _, tb), (jf, _, jb), xp, halo, prm = _one_shard(p=1)
    r_t = thf.io_fwd_compact(torch.from_numpy(xp), tb)
    r_j = jhf.io_fwd_compact(jnp.asarray(xp), jb)
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=1e-6, atol=1e-6)
    kw_t = dict(negative_slope=SLOPE, resid=(r_t, tb.rg_io), ypre=(tb.rg_b, tb.m_b))
    kw_j = dict(negative_slope=SLOPE, resid=(r_j, jb.rg_io), ypre=(jb.rg_b, jb.m_b))
    if ln:
        kw_t["ln"] = (torch.from_numpy(prm["gamma"]), torch.from_numpy(prm["beta"]))
        kw_j["ln"] = (jnp.asarray(prm["gamma"]), jnp.asarray(prm["beta"]))
    w_t = [torch.from_numpy(prm[k]) for k in ("wl", "wr", "b")]
    w_j = [jnp.asarray(prm[k]) for k in ("wl", "wr", "b")]
    got = tsf.banded_sage_fwd(torch.from_numpy(xp), *w_t, tf, **kw_t)
    want = jsf.banded_sage_fwd_pallas(jnp.asarray(xp), *w_j, jf, interpret=True, **kw_j)
    assert len(got) == len(want) == (4 if ln else 2)
    yp_t, yp_j = got[-1].numpy(), np.asarray(want[-1])
    assert yp_t.shape == yp_j.shape == (tb.m_b, tb.kt, prm["wl"].shape[1])
    live = int(tb.rg_b.max())
    assert live >= 1, "the shard has no boundary group"
    err = np.abs(yp_t[1:live + 1] - yp_j[1:live + 1]).max() / np.abs(yp_j[1:live + 1]).max()
    assert err < YPRE_REL, err
    assert not yp_t[0].any() and not yp_t[live + 1:].any()
    out_err = np.abs(got[0].numpy() - np.asarray(want[0])).max() / np.abs(want[0]).max()
    assert out_err < KERNEL_OUT_REL, out_err
    plain = tsf.banded_sage_fwd_plain(torch.from_numpy(xp), *w_t, tf, **kw_t)
    assert all(torch.equal(a, b) for a, b in zip(got, plain))


@pytest.mark.parametrize("ln", [False, True])
def test_shards_assemble_to_the_one_device_layer(ln):
    """An ep=2 plan's shards run in turn (the halo gathered on the host, as
    the exchange will deliver it), put back in global order, against the
    port's one-device layer on the whole graph (twins): the output, x's
    gradient (each shard's dx plus the dhalo rows sent back to their
    owners), and the parameter gradients as sums of the shards' partial
    ones."""
    n, ep, d, h, tile = 512, 2, 16, 24, 64
    rng = np.random.default_rng(11)
    src, dst = local_graph(n, 4, 40, seed=3)
    plan = thf.plan_halo_fused(src, dst, n, ep, tile=tile, banded_k=2)
    x = rng.standard_normal((n, d)).astype(np.float32)
    cot = rng.standard_normal((n, h)).astype(np.float32)
    prm = {k: torch.from_numpy(v) for k, v in dict(
        wl=rng.standard_normal((d, h)).astype(np.float32) * 0.2,
        wr=rng.standard_normal((d, h)).astype(np.float32) * 0.2,
        b=rng.standard_normal((h,)).astype(np.float32) * 0.1,
        gamma=rng.standard_normal((h,)).astype(np.float32) * 0.3 + 1.0,
        beta=rng.standard_normal((h,)).astype(np.float32) * 0.1).items()}
    names = ["wl", "wr", "b"] + (["gamma", "beta"] if ln else [])
    fn = thf.halo_fused_sage_ln_ov if ln else thf.halo_fused_sage_ov

    stacks = shard_node_array(x, ep, plan.n_local)
    cots = shard_node_array(cot, ep, plan.n_local)
    send = plan.send_idx.numpy()
    hm = send.shape[2]
    out = np.zeros((ep, plan.n_local, h), np.float32)
    dx = np.zeros((ep, plan.n_local, d), np.float32)
    dparams = {k: torch.zeros_like(prm[k]) for k in names}
    for p in range(ep):
        xp = torch.zeros((plan.n_pad_local, d))
        xp[: plan.n_local] = torch.from_numpy(stacks[p])
        halo = torch.from_numpy(np.stack([stacks[q][send[q, p]] for q in range(ep)])
                                .reshape(-1, d))
        xp.requires_grad_()
        halo.requires_grad_()
        ps = {k: prm[k].clone().requires_grad_() for k in names}
        extra = (EPS,) if ln else ()
        y = fn(xp, halo, *[ps[k] for k in names], *plan.shard(p), False, SLOPE, *extra)
        g = torch.zeros_like(y)
        g[: plan.n_local] = torch.from_numpy(cots[p])
        (y * g).sum().backward()
        out[p] = y[: plan.n_local].detach().numpy()
        dx[p] += xp.grad[: plan.n_local].numpy()
        dh = halo.grad.numpy().reshape(ep, hm, d)
        for q in range(ep):  # the reverse exchange: dhalo rows back to their owner q
            np.add.at(dx[q], send[q, p], dh[q])
        for k in names:
            dparams[k] += ps[k].grad

    layout, n_pad = tbr.prepare_banded_residual_mean_aggregate(src, dst, n, tile=tile, k=2)
    xg = torch.zeros((n_pad, d))
    xg[:n] = torch.from_numpy(x)
    xg.requires_grad_()
    ps = {k: prm[k].clone().requires_grad_() for k in names}
    if ln:
        y = tbr.banded_residual_sage_ln_apply(xg, ps["wl"], ps["wr"], ps["b"], ps["gamma"],
                                              ps["beta"], layout, False, SLOPE, EPS)
    else:
        y = tbr.banded_residual_sage_apply(xg, ps["wl"], ps["wr"], ps["b"], layout, False,
                                           SLOPE)
    g = torch.zeros_like(y)
    g[:n] = torch.from_numpy(cot)
    (y * g).sum().backward()
    np.testing.assert_allclose(out.reshape(-1, h)[:n], y[:n].detach().numpy(),
                               rtol=GLOBAL_TOL, atol=GLOBAL_TOL)
    np.testing.assert_allclose(dx.reshape(-1, d)[:n], xg.grad[:n].numpy(),
                               rtol=GLOBAL_TOL, atol=GLOBAL_TOL)
    for k in names:
        np.testing.assert_allclose(dparams[k].numpy(), ps[k].grad.numpy(),
                                   rtol=GLOBAL_TOL, atol=GLOBAL_TOL, err_msg=k)
