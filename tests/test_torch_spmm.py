"""The port's blocked (one-hot) layout and SpMM (sldm_gnn_tpu_torch.graph.csr,
ops.spmm) against the JAX package's on the CPU, at the small sizes of
tests/test_spmm.py, inputs made with numpy from a seed:

  * the layouts equal the JAX builder's bit for bit: its numpy path under
    100k edges, and its native library above;
  * the plain version of csrc/spmm_onehot.cu agrees with the JAX Pallas
    kernel run in interpret mode, at DEFAULT and HIGHEST precision;
  * spmm_apply's gradient agrees with the JAX custom VJP.

The CUDA kernel runs only on the card, where chip_smoke.py holds it
against this plain version."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sldm_gnn_tpu.graph import csr as jcsr
from sldm_gnn_tpu.ops import spmm as jspmm

from sldm_gnn_tpu_torch.graph import csr as tcsr
from sldm_gnn_tpu_torch.ops import spmm as tspmm

# the plain version against the interpret kernel: the same products (bf16
# roundings at DEFAULT, f32 at HIGHEST), f32 sums in another order
KERNEL_REL = 1e-5
# the reference path and the custom VJP: test_spmm.py:110's bounds
RTOL, ATOL = 1e-4, 1e-5
FIELDS = ("block_meta", "src_local", "dst_local", "weight", "edge_id")


def _assert_layout_equal(t, j):
    for f in FIELDS:
        got, want = getattr(t, f).numpy(), np.asarray(getattr(j, f))
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert (t.tile, t.step_chunks, t.num_chunks) == (j.tile, j.step_chunks, j.num_chunks)


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-12)


def _local_graph(rng, n, e, reach):
    dst = rng.integers(0, n, e)
    return np.clip(dst + rng.integers(-reach, reach + 1, e), 0, n - 1), dst


@pytest.mark.parametrize("tile,step_chunks", [(128, 1), (128, 2), (256, 1), (256, 2)])
def test_mean_layouts_equal_jax(rng, tile, step_chunks):
    src, dst = _local_graph(rng, 1500, 9000, 200)
    tf, tr, tn = tspmm.prepare_mean_aggregate(src, dst, 1500, step_chunks=step_chunks,
                                              tile=tile, edge_chunk=128)
    jf, jr, jn = jspmm.prepare_mean_aggregate(src, dst, 1500, step_chunks=step_chunks,
                                              tile=tile, edge_chunk=128)
    assert tn == jn
    _assert_layout_equal(tf, jf)
    _assert_layout_equal(tr, jr)


def test_layout_equals_jax_native_builder(rng):
    """At 100k edges and more the JAX builder runs native/libgraphbuild.so."""
    src, dst = _local_graph(rng, 20000, 120_000, 300)
    w = rng.random(len(src)).astype(np.float32)
    n_pad = tcsr.pad_nodes(20000, 512)
    kw = dict(weight=w, tile=512, edge_chunk=512, step_chunks=2)
    _assert_layout_equal(tcsr.block_edges(src, dst, n_pad, **kw),
                         jcsr.block_edges(src, dst, n_pad, **kw))


def test_layout_edge_cases_equal_jax(rng):
    n_pad = 3 * 128
    cases = [(rng.integers(0, n_pad, 50), rng.integers(0, 128, 50)),  # one dst block
             (np.zeros(0, np.int64), np.zeros(0, np.int64))]          # no edges
    for src, dst in cases:
        for sc in (1, 3):
            _assert_layout_equal(tcsr.block_edges(src, dst, n_pad, step_chunks=sc),
                                 jcsr.block_edges(src, dst, n_pad, step_chunks=sc))
    assert tcsr.auto_edge_chunk(10 ** 8) == jcsr.auto_edge_chunk(10 ** 8) == 2048
    with pytest.raises(ValueError, match="out of range"):
        tcsr.block_edges(np.array([0, 400]), np.array([1, 2]), n_pad)


@pytest.mark.parametrize("precision", ["default", "highest"])
@pytest.mark.parametrize("tile,step_chunks", [(128, 1), (256, 2)])
def test_plain_matches_pallas(rng, precision, tile, step_chunks):
    n, e, d = 700, 5000, 32
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    w = rng.random(e).astype(np.float32)
    n_pad = tcsr.pad_nodes(n, tile)
    kw = dict(weight=w, tile=tile, edge_chunk=128, step_chunks=step_chunks)
    tb, jb = tcsr.block_edges(src, dst, n_pad, **kw), jcsr.block_edges(src, dst, n_pad, **kw)
    x = rng.standard_normal((n_pad, d)).astype(np.float32)
    jp = jax.lax.Precision.HIGHEST if precision == "highest" else jax.lax.Precision.DEFAULT
    want = jspmm.spmm_pallas(jnp.asarray(x), jax.tree.map(jnp.asarray, jb), n_pad,
                             interpret=True, precision=jp, k_per_step=step_chunks)
    got = tspmm.spmm_onehot(torch.from_numpy(x), tb, precision=precision,
                            k_per_step=step_chunks)
    assert got.dtype == torch.float32 and got.shape == (n_pad, d)
    assert _max_rel(got.numpy(), want) < KERNEL_REL


def test_plain_bf16_matches_pallas(rng):
    n, e, d = 500, 3000, 16
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    tf, _, n_pad = tspmm.prepare_mean_aggregate(src, dst, n)
    jf, _, _ = jspmm.prepare_mean_aggregate(src, dst, n)
    x = rng.standard_normal((n_pad, d)).astype(np.float32)
    want = jspmm.spmm_pallas(jnp.asarray(x).astype(jnp.bfloat16), jax.tree.map(jnp.asarray, jf),
                             n_pad, interpret=True)
    got = tspmm.spmm_onehot(torch.from_numpy(x).to(torch.bfloat16), tf)
    assert got.dtype == torch.bfloat16
    # both round the f32 sum to bf16 once; a sum-order difference can flip
    # that rounding: one bf16 ulp, 2^-8 relative
    assert _max_rel(got.float().numpy(), np.asarray(want, np.float32)) < 2.0 ** -8


def test_empty_dst_blocks_come_out_zero(rng):
    """tests/test_spmm.py:62-77: blocks with only dummy chunks give zeros."""
    n_pad, d = 3 * 128, 8
    src, dst = rng.integers(0, n_pad, 50), rng.integers(0, 128, 50)
    tb = tcsr.block_edges(src, dst, n_pad)
    jb = jcsr.block_edges(src, dst, n_pad)
    x = rng.standard_normal((n_pad, d)).astype(np.float32)
    got = tspmm.spmm_onehot(torch.from_numpy(x), tb, precision="highest").numpy()
    want = np.asarray(jspmm.spmm_pallas(jnp.asarray(x), jb, n_pad, interpret=True,
                                        precision=jax.lax.Precision.HIGHEST))
    np.testing.assert_array_equal(got[128:], 0.0)
    assert _max_rel(got, want) < KERNEL_REL
    plan_ptr, perm = tspmm.onehot_plan(tb, n_pad)
    assert plan_ptr[-1].item() == perm.numel() == 50
    assert (plan_ptr[129:] == 50).all()


def test_step_and_precision_contracts_raise(rng):
    src, dst = rng.integers(0, 300, 900), rng.integers(0, 300, 900)
    n_pad = tcsr.pad_nodes(300)
    x = torch.from_numpy(rng.standard_normal((n_pad, 4)).astype(np.float32))
    b1 = tcsr.block_edges(src, dst, n_pad, edge_chunk=64, step_chunks=1)
    b2 = tcsr.block_edges(src, dst, n_pad, edge_chunk=64, step_chunks=2)
    jb2 = jcsr.block_edges(src, dst, n_pad, edge_chunk=64, step_chunks=2)
    for fn in (tspmm.spmm_onehot, tspmm.spmm_onehot_plain):
        with pytest.raises(ValueError, match="step_chunks=2 cannot run at k_per_step=4"):
            fn(x, b2, k_per_step=4)
        with pytest.raises(ValueError, match="HIGHEST"):
            fn(x.to(torch.bfloat16), b1, precision="highest")
        if b1.num_chunks % 2:
            with pytest.raises(ValueError, match="not divisible"):
                fn(x, b1, k_per_step=2)
    with pytest.raises(ValueError, match="cannot run"):  # the JAX contract it keeps
        jspmm.spmm_pallas(jnp.asarray(x.numpy()), jb2, n_pad, interpret=True, k_per_step=4)
    before = tspmm.spmm_onehot.launches
    assert torch.equal(tspmm.spmm_onehot(x, b2, k_per_step=2), tspmm.spmm_onehot_plain(x, b2))
    assert tspmm.spmm_onehot.launches == before  # CPU tensors launch nothing


def test_xla_path_and_grad_match_jax(rng):
    n, e, d = 90, 600, 12
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    tf, tr, n_pad = tspmm.prepare_mean_aggregate(src, dst, n)
    jf, jr, _ = jspmm.prepare_mean_aggregate(src, dst, n)
    x = rng.standard_normal((n_pad, d)).astype(np.float32)
    t = rng.standard_normal((n_pad, d)).astype(np.float32)
    for use_pallas in (False, True):
        xt = torch.from_numpy(x).requires_grad_()
        out = tspmm.spmm_apply(xt, tf, tr, n_pad, use_pallas)
        (out * torch.from_numpy(t)).sum().backward()
        want, vjp = jax.vjp(lambda v: jspmm.spmm_apply(v, jf, jr, n_pad, False), jnp.asarray(x))
        got, got_g, want_g = out.detach().numpy(), xt.grad.numpy(), vjp(jnp.asarray(t))[0]
        if use_pallas:
            # x and the weights rounded to bf16 (2^-9 relative each)
            assert _max_rel(got, want) < 2.0 ** -7 and _max_rel(got_g, want_g) < 2.0 ** -7
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(got_g, want_g, rtol=RTOL, atol=ATOL)
    # spmm_xla itself against the JAX reference, at another node count
    got = tspmm.spmm_xla(torch.from_numpy(x), torch.from_numpy(src), torch.from_numpy(dst),
                         torch.from_numpy(tcsr.mean_weights(dst, n)), n)
    want = jspmm.spmm_xla(jnp.asarray(x), jnp.asarray(src), jnp.asarray(dst),
                          jnp.asarray(jcsr.mean_weights(dst, n)), n)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_kernel_path_grad_matches_pallas_vjp(rng):
    """spmm_apply(use_pallas=True)'s gradient (the plain version on the
    reverse layout) against the JAX custom VJP through the interpret kernel."""
    n, e, d = 300, 2000, 16
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    tf, tr, n_pad = tspmm.prepare_mean_aggregate(src, dst, n, step_chunks=2)
    jf, jr, _ = jspmm.prepare_mean_aggregate(src, dst, n, step_chunks=2)
    x = rng.standard_normal((n_pad, d)).astype(np.float32)
    t = rng.standard_normal((n_pad, d)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    (tspmm.spmm_apply(xt, tf, tr, n_pad, True, 2) * torch.from_numpy(t)).sum().backward()
    want = jspmm.spmm_pallas(jnp.asarray(t), jax.tree.map(jnp.asarray, jr), n_pad,
                             interpret=True, k_per_step=2)
    assert _max_rel(xt.grad.numpy(), want) < KERNEL_REL


def test_layout_moves_and_keeps_its_fields(rng):
    src, dst = rng.integers(0, 200, 500), rng.integers(0, 200, 500)
    b = tcsr.block_edges(src, dst, 256, step_chunks=2)
    moved = b.to("cpu")
    assert dataclasses.asdict(moved).keys() == dataclasses.asdict(b).keys()
    assert (moved.tile, moved.step_chunks, moved.edge_chunk) == (128, 2, 256)
