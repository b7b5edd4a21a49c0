"""The port's blocked (one-hot) layout and SpMM (sldm_gnn_tpu_torch.graph.csr,
ops.spmm) against the JAX package's on the CPU, at the small sizes of
tests/test_spmm.py, inputs made with numpy from a seed:

  * the layouts equal the JAX builder's bit for bit: its numpy path under
    100k edges, and its native library above;
  * the plain version of csrc/spmm_onehot.cu agrees with the JAX Pallas
    kernel run in interpret mode, at DEFAULT and HIGHEST precision;
  * spmm_apply's gradient agrees with the JAX custom VJP;
  * the plain versions of csrc/spmm_onehot_int8.cu (per-row and
    per-tensor int8 x) agree with spmm_pallas_int8 and spmm_pallas_int8_pt
    in interpret mode within 1e-5 of max|out|, at k_per_step 1 and 2
    (tests/test_spmm.py:296-385), and keep their contracts.

The CUDA kernels run only on the card, where chip_smoke.py holds them
against these plain versions."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sldm_gnn_tpu.graph import csr as jcsr
from sldm_gnn_tpu.ops import quant as jquant
from sldm_gnn_tpu.ops import spmm as jspmm

from sldm_gnn_tpu_torch.graph import csr as tcsr
from sldm_gnn_tpu_torch.ops import quant as tquant
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
    plan_ptr, perm, src_row = tspmm.onehot_plan(tb, n_pad)
    assert plan_ptr[-1].item() == perm.numel() == src_row.numel() == 50
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


# ------------------------------------------------------------ the slot-ordered plain version


def _ragged_case(rng, tile=128, zero_frac=0.0):
    """A one-hot layout with empty rows (no edge lands on rows 600 on), a
    row of 40 live slots (past a warp's 32) and one of 230, the rest
    random; a `zero_frac` share of the edges weighs 0 (padding-like slots
    that are not live)."""
    n, e = 700, 3000
    dst = np.concatenate([rng.integers(0, 600, e), np.full(40, 5), np.full(230, 300)])
    src = rng.integers(0, n, len(dst))
    w = (rng.random(len(dst)) + 0.1).astype(np.float32)
    w[rng.random(len(dst)) < zero_frac] = 0.0
    n_pad = tcsr.pad_nodes(n, tile)
    kw = dict(weight=w, tile=tile, edge_chunk=64, step_chunks=2)
    tb, jb = tcsr.block_edges(src, dst, n_pad, **kw), jcsr.block_edges(src, dst, n_pad, **kw)
    return tb, jb, n_pad


def _index_add_sum(x, blocked, precision):
    """The plain version before it summed in slot order: every slot's
    product scattered by index_add_ (on the CPU, in slot order too)."""
    src, dst, w = tspmm.global_edges(blocked)
    xs = x.float()
    if precision == "default":
        xs, w = tspmm.bf16r(xs), tspmm.bf16r(w)
    return xs.new_zeros(x.shape).index_add_(0, dst, xs[src] * w[:, None]).to(x.dtype)


@pytest.mark.parametrize("precision", ["default", "highest"])
@pytest.mark.parametrize("d", [1, 40])
def test_slot_ordered_plain_matches_pallas_on_ragged_rows(rng, precision, d):
    tb, jb, n_pad = _ragged_case(rng)
    counts = torch.bincount(tspmm.global_edges(tb)[1][tb.weight.reshape(-1) != 0],
                            minlength=n_pad)
    assert counts[5] == counts.max() - 190 and counts[300] > 200 and (counts[600:] == 0).all()
    x = rng.standard_normal((n_pad, d)).astype(np.float32)
    jp = jax.lax.Precision.HIGHEST if precision == "highest" else jax.lax.Precision.DEFAULT
    want = jspmm.spmm_pallas(jnp.asarray(x), jax.tree.map(jnp.asarray, jb), n_pad,
                             interpret=True, precision=jp, k_per_step=2)
    got = tspmm.spmm_onehot_plain(torch.from_numpy(x), tb, precision=precision, k_per_step=2)
    np.testing.assert_array_equal(got[600:].numpy(), 0.0)
    assert _max_rel(got.numpy(), want) < KERNEL_REL


@pytest.mark.parametrize("precision,dtype", [("default", torch.float32),
                                             ("default", torch.bfloat16),
                                             ("highest", torch.float32)])
def test_slot_ordered_plain_is_bit_equal_to_index_add(rng, precision, dtype):
    tb, _, n_pad = _ragged_case(rng, zero_frac=0.2)
    x = torch.from_numpy(rng.standard_normal((n_pad, 40)).astype(np.float32)).to(dtype)
    got = tspmm.spmm_onehot_plain(x, tb, precision=precision)
    assert got.dtype == dtype
    assert torch.equal(got, _index_add_sum(x, tb, precision))


def test_plain_reads_x_only_at_live_slots(rng):
    """An infinite x row gives non-finite sums only on the rows whose live
    slots read it; the zero-weight slots that point at it do not."""
    tb, _, n_pad = _ragged_case(rng, zero_frac=0.2)
    src, dst, w = tspmm.global_edges(tb)
    bad = int(src[w == 0][0])
    x = torch.from_numpy(rng.standard_normal((n_pad, 8)).astype(np.float32))
    x[bad] = float("inf")
    got = tspmm.spmm_onehot_plain(x, tb, precision="highest")
    reads = torch.zeros(n_pad, dtype=torch.bool)
    reads[dst[(w != 0) & (src == bad)]] = True
    assert torch.equal(~torch.isfinite(got).all(1), reads)


def test_plan_src_rows_equal_a_numpy_reference(rng):
    tb, _, n_pad = _ragged_case(rng, tile=64, zero_frac=0.2)
    row_ptr, perm, src_row = tspmm.onehot_plan(tb, n_pad)
    assert row_ptr.dtype == perm.dtype == src_row.dtype == torch.int32
    meta, w = tb.block_meta.numpy(), tb.weight.numpy()
    src = (meta[:, 1:2] * tb.tile + tb.src_local.numpy()).reshape(-1)
    dst = (meta[:, 0:1] * tb.tile + tb.dst_local.numpy()).reshape(-1)
    live = np.nonzero(w.reshape(-1) != 0)[0]
    order = live[np.argsort(dst[live], kind="stable")]
    np.testing.assert_array_equal(perm.numpy(), order)
    np.testing.assert_array_equal(src_row.numpy(), src[order])
    np.testing.assert_array_equal(row_ptr.numpy(),
                                  np.concatenate([[0], np.cumsum(np.bincount(dst[live],
                                                                             minlength=n_pad))]))


def test_plan_carries_no_weight(rng):
    """The plan of the structural layout, shared through sddmm._with_weight
    with other weights (some live slots 0), gives each weight set's own
    sums: those of the JAX kernel on the same weights."""
    from sldm_gnn_tpu.ops import sddmm as jsd
    from sldm_gnn_tpu_torch.ops import sddmm as tsd

    n = 300
    src, dst = rng.integers(0, n, 2000), rng.integers(0, n, 2000)
    tf, _, n_pad = tsd.prepare_sddmm(src, dst, n)
    jf, _, _ = jsd.prepare_sddmm(src, dst, n)
    plan = tspmm.onehot_plan(tf, n_pad)
    x = rng.standard_normal((n_pad, 16)).astype(np.float32)
    for _ in range(2):
        g = rng.standard_normal(tf.weight.shape).astype(np.float32)
        g[rng.random(g.shape) < 0.1] = 0.0
        g = np.where(tf.weight.numpy() != 0, g, 0.0).astype(np.float32)
        moved = tsd._with_weight(tf, torch.from_numpy(g))
        got = tspmm.spmm_onehot_plain(torch.from_numpy(x), moved, precision="highest")
        assert tspmm.onehot_plan(moved, n_pad) is plan
        want = jspmm.spmm_pallas(jnp.asarray(x), jax.tree.map(jnp.asarray,
                                                               jsd._with_weight(jf, g)),
                                 n_pad, interpret=True, precision=jax.lax.Precision.HIGHEST)
        assert _max_rel(got.numpy(), want) < KERNEL_REL
        assert torch.equal(got, _index_add_sum(torch.from_numpy(x), moved, "highest"))


def test_layout_moves_and_keeps_its_fields(rng):
    src, dst = rng.integers(0, 200, 500), rng.integers(0, 200, 500)
    b = tcsr.block_edges(src, dst, 256, step_chunks=2)
    moved = b.to("cpu")
    assert dataclasses.asdict(moved).keys() == dataclasses.asdict(b).keys()
    assert (moved.tile, moved.step_chunks, moved.edge_chunk) == (128, 2, 256)


# ------------------------------------------------------------ int8 x


def _int8_case(rng, per_row, n, e, d, step_chunks):
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    n_pad = tcsr.pad_nodes(n)
    w = tcsr.mean_weights(dst, n_pad)
    kw = dict(weight=w, step_chunks=step_chunks)
    tb, jb = tcsr.block_edges(src, dst, n_pad, **kw), jcsr.block_edges(src, dst, n_pad, **kw)
    x = rng.standard_normal((n_pad, d)).astype(np.float32)
    quant = jquant.quantize_rows_xla if per_row else jquant.quantize_tensor_xla
    xq, scales = (np.array(a) for a in quant(jnp.asarray(x)))
    return (src, dst, w, n_pad, x), tb, jb, xq, scales


@pytest.mark.parametrize("per_row", [True, False], ids=["per_row", "per_tensor"])
@pytest.mark.parametrize("k_per_step", [1, 2])
def test_int8_plain_matches_pallas(rng, per_row, k_per_step):
    """tests/test_spmm.py:296-385's sizes: the plain version against the
    interpret kernel (the same bf16-rounded weights and exact int8 values,
    f32 sums in another order), and both against the dequantized
    reference at the JAX tests' 5e-2."""
    n, e, d = (250, 2000, 128) if k_per_step == 1 else (200, 1200, 64)
    (src, dst, w, n_pad, x), tb, jb, xq, scales = _int8_case(rng, per_row, n, e, d, k_per_step)
    jfn = jspmm.spmm_pallas_int8 if per_row else jspmm.spmm_pallas_int8_pt
    tfn = tspmm.spmm_int8 if per_row else tspmm.spmm_int8_pt
    want = np.asarray(jfn(jnp.asarray(xq), jnp.asarray(scales), jax.tree.map(jnp.asarray, jb),
                          n_pad, interpret=True, k_per_step=k_per_step))
    got = tfn(torch.from_numpy(xq), torch.from_numpy(scales), tb, n_pad, k_per_step=k_per_step)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n_pad, d)
    assert _max_rel(got.numpy(), want) < KERNEL_REL
    deq = xq.astype(np.float32) * (scales if per_row else scales[0])
    ref = np.zeros((n_pad, d), np.float32)
    np.add.at(ref, dst, deq[src] * w[:, None])
    np.testing.assert_allclose(got.numpy(), ref, rtol=5e-2, atol=5e-3)


@pytest.mark.parametrize("per_row", [True, False], ids=["per_row", "per_tensor"])
def test_int8_rounding_is_the_kernels(rng, per_row):
    """The per-row weight is bf16(w * xs[src]), not w times a rounded x:
    the plain version equals that sum computed here in f64 to f32 rounding,
    and the bf16 output is its rounding."""
    (src, dst, w, n_pad, x), tb, _, xq, scales = _int8_case(rng, per_row, 300, 2500, 32, 1)
    xq_t, sc_t = torch.from_numpy(xq), torch.from_numpy(scales)
    fn = tspmm.spmm_int8_plain if per_row else tspmm.spmm_int8_pt_plain
    got = fn(xq_t, sc_t, tb, n_pad)
    wr = (torch.from_numpy(w) * (sc_t[torch.from_numpy(src), 0] if per_row else 1.0))
    wr = wr.to(torch.bfloat16).double().numpy()
    ref = np.zeros((n_pad, xq.shape[1]), np.float64)
    np.add.at(ref, dst, xq[src].astype(np.float64) * wr[:, None])
    if not per_row:
        ref = ref * np.float64(scales[0])
    assert _max_rel(got.numpy(), ref) < KERNEL_REL
    got16 = fn(xq_t, sc_t, tb, n_pad, out_dtype=torch.bfloat16)
    assert got16.dtype == torch.bfloat16 and torch.equal(got16, got.to(torch.bfloat16))


def test_int8_contracts_raise(rng):
    (src, dst, w, n_pad, x), b1, jb1, xq, xs = _int8_case(rng, True, 300, 900, 8, 1)
    b2 = tcsr.block_edges(src, dst, n_pad, weight=w, step_chunks=2)
    xq_t, xs_t = torch.from_numpy(xq), torch.from_numpy(xs)
    scale = torch.ones(1)
    for fn in (tspmm.spmm_int8, tspmm.spmm_int8_plain):
        with pytest.raises(ValueError, match="int8 x"):
            fn(xq_t.float(), xs_t, b1, n_pad)
        with pytest.raises(ValueError, match="per-row scales"):
            fn(xq_t, xs_t[:, 0], b1, n_pad)
        with pytest.raises(ValueError, match="cannot run at k_per_step=4"):
            fn(xq_t, xs_t, b2, n_pad, k_per_step=4)
        if b1.num_chunks % 2:
            with pytest.raises(ValueError, match="not divisible"):
                fn(xq_t, xs_t, b1, n_pad, k_per_step=2)
    for fn in (tspmm.spmm_int8_pt, tspmm.spmm_int8_pt_plain):
        with pytest.raises(ValueError, match="per-tensor scales"):
            fn(xq_t, xs_t, b1, n_pad)
        with pytest.raises(ValueError, match="int8 x"):
            fn(xq_t.to(torch.int16), scale, b1, n_pad)
        with pytest.raises(ValueError, match="out_dtype"):
            fn(xq_t, scale, b1, n_pad, out_dtype=torch.float16)
    # the JAX kernels' own contracts, which these mirror
    jb = jax.tree.map(jnp.asarray, jb1)
    with pytest.raises(AssertionError):
        jspmm.spmm_pallas_int8(jnp.asarray(xq, jnp.float32), jnp.asarray(xs), jb, n_pad,
                               interpret=True)
    with pytest.raises(AssertionError):
        jspmm.spmm_pallas_int8(jnp.asarray(xq), jnp.asarray(xs[:, 0]), jb, n_pad,
                               interpret=True)
    with pytest.raises(AssertionError):
        jspmm.spmm_pallas_int8_pt(jnp.asarray(xq), jnp.asarray(xs), jb, n_pad, interpret=True)
    before = (tspmm.spmm_int8.launches, tspmm.spmm_int8_pt.launches)
    assert torch.equal(tspmm.spmm_int8(xq_t, xs_t, b2, n_pad, k_per_step=2),
                       tspmm.spmm_int8_plain(xq_t, xs_t, b2, n_pad))
    assert (tspmm.spmm_int8.launches, tspmm.spmm_int8_pt.launches) == before


def test_int8_with_the_ports_quantizers(rng):
    """quantize_rows -> spmm_int8 and quantize_tensor_xla -> spmm_int8_pt,
    the port end to end, against the JAX pipeline in interpret mode."""
    n, e, d = 260, 2100, 48
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    tf, _, n_pad = tspmm.prepare_mean_aggregate(src, dst, n, step_chunks=2)
    jf, _, _ = jspmm.prepare_mean_aggregate(src, dst, n, step_chunks=2)
    jf = jax.tree.map(jnp.asarray, jf)
    x = rng.standard_normal((n_pad, d)).astype(np.float32)
    xq, xs = tquant.quantize_rows(torch.from_numpy(x))
    jq, js = jquant.quantize_rows_pallas(jnp.asarray(x), block_rows=128, interpret=True)
    got = tspmm.spmm_int8(xq, xs, tf, n_pad, k_per_step=2).numpy()
    want = np.asarray(jspmm.spmm_pallas_int8(jq, js, jf, n_pad, interpret=True, k_per_step=2))
    # ties of the two quantizers may land one step apart (test_quant.py:33)
    assert _max_rel(got, want) < 1e-2
    pq, ps = tquant.quantize_tensor_xla(torch.from_numpy(x))
    jpq, jps = jquant.quantize_tensor_xla(jnp.asarray(x))
    got = tspmm.spmm_int8_pt(pq, ps, tf, n_pad, k_per_step=2).numpy()
    want = np.asarray(jspmm.spmm_pallas_int8_pt(jpq, jps, jf, n_pad, interpret=True,
                                                k_per_step=2))
    assert _max_rel(got, want) < KERNEL_REL
