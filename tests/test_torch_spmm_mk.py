"""The port's megakernel SpMM (ops/spmm_mk) against the JAX package's
(sldm_gnn_tpu/ops/spmm_mk.py) on the CPU, at tests/test_spmm.py's sizes,
inputs made with numpy from a seed:

  * to_megakernel_layout's arrays equal the JAX builder's (tile 128 and
    256, the empty graph);
  * the plain version of csrc/spmm_mk.cu at fast=False agrees with the JAX
    kernel in interpret mode within 1e-5 of max|out| (f32 products, sums
    in another order), and with the naive weighted sum at test_spmm.py's
    1e-4 / 1e-3;
  * at fast=True it agrees with an independent numpy reference of the TPU
    kernel's roundings (bf16 weights, each chunk's A summed in f32 and
    rounded to bf16, bf16 x, f32 sums) within 1e-5 of max|out|, and with
    the JAX interpret kernel within 1e-5 of max|out| (same roundings);
  * the kernel's plan, walked in its order, gives the plain version's bits.

The CUDA kernel runs only on the card (chip_smoke.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sldm_gnn_tpu.graph import csr as jcsr
from sldm_gnn_tpu.ops import spmm_mk as jmk

from sldm_gnn_tpu_torch.graph import csr as tcsr
from sldm_gnn_tpu_torch.ops import spmm_mk as tmk

FIELDS = ("chunk_ptr", "sblk", "srcdst", "weight")
# plain version vs the interpret kernel: the same products, f32 sums in
# another order
KERNEL_REL = 1e-5


def _graph(rng, n, e, tile=128, edge_chunk=None, dup=0):
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    if dup:  # repeat some (src, dst) pairs so that chunks merge duplicates
        src = np.concatenate([src, src[:dup]])
        dst = np.concatenate([dst, dst[:dup]])
    w = rng.random(len(src)).astype(np.float32)
    n_pad = tcsr.pad_nodes(n, tile)
    kw = dict(weight=w, tile=tile)
    if edge_chunk:
        kw["edge_chunk"] = edge_chunk
    return src, dst, w, n_pad, tcsr.block_edges(src, dst, n_pad, **kw), \
        jcsr.block_edges(src, dst, n_pad, **kw)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-12)


def _naive(x, src, dst, w, n_pad):
    out = np.zeros((n_pad, x.shape[1]), np.float64)
    np.add.at(out, dst, x[src].astype(np.float64) * w[:, None])
    return out


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("n,e,tile,ec", [(300, 1500, 128, None), (500, 1500, 256, 512),
                                         (700, 4000, 128, 256)])
def test_layout_equals_jax(rng, n, e, tile, ec):
    *_, n_pad, tb, jb = _graph(rng, n, e, tile, ec)
    got, want = tmk.to_megakernel_layout(tb, n_pad), jmk.to_megakernel_layout(jb, n_pad)
    assert got.tile == want.tile == tile and got.num_chunks == want.num_chunks
    for f in FIELDS:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)


def test_empty_graph_layout_and_zeros(rng):
    n_pad = tcsr.pad_nodes(200)
    z = np.zeros(0, np.int64)
    got = tmk.to_megakernel_layout(tcsr.block_edges(z, z, n_pad), n_pad)
    want = jmk.to_megakernel_layout(jcsr.block_edges(z, z, n_pad), n_pad)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    x = torch.from_numpy(rng.standard_normal((n_pad, 8)).astype(np.float32))
    for fast in (False, True):
        out = tmk.spmm_mk(x, got, n_pad, fast=fast)
        assert out.shape == x.shape and not out.any()


@pytest.mark.parametrize("n,e,d,tile,ec", [(300, 1500, 128, 128, None),
                                           (500, 1500, 16, 256, 512),
                                           (400, 3000, 24, 128, 256)])
def test_f32_matches_interpret_kernel(rng, n, e, d, tile, ec):
    src, dst, w, n_pad, tb, jb = _graph(rng, n, e, tile, ec, dup=e // 10)
    x = rng.standard_normal((n_pad, d)).astype(np.float32)
    mk = tmk.to_megakernel_layout(tb, n_pad)
    got = tmk.spmm_mk(torch.from_numpy(x), mk, n_pad, fast=False).numpy()
    jl = jax.tree.map(jnp.asarray, jmk.to_megakernel_layout(jb, n_pad))
    want = np.asarray(jmk.spmm_pallas_mk(jnp.asarray(x), jl, n_pad, fast=False,
                                         interpret=True))
    assert _rel(got, want) < KERNEL_REL
    np.testing.assert_allclose(got, _naive(x, src, dst, w, n_pad), rtol=1e-4, atol=1e-3)


def _fast_reference(x, mk):
    """The TPU kernel's fast arithmetic in numpy, chunk by chunk: dense A_c
    of bf16 weights summed in f32, rounded to bf16, times bf16 x."""
    ptr, sblk = mk.chunk_ptr.numpy(), mk.sblk.numpy()
    sd, w = mk.srcdst.numpy()[:, 0], mk.weight.numpy()[:, 0]
    tile, ec = mk.tile, mk.edge_chunk
    xb = _bf16(x).astype(np.float64)
    out = np.zeros(x.shape, np.float64)
    for b in range(len(ptr) - 1):
        for c in range(ptr[b], ptr[b + 1]):
            a = np.zeros((tile, tile), np.float32)
            np.add.at(a, (sd[c, ec:], sd[c, :ec]), _bf16(w[c]))
            out[b * tile:(b + 1) * tile] += _bf16(a) @ xb[sblk[c] * tile:(sblk[c] + 1) * tile]
    return out


@pytest.mark.parametrize("n,e,d,tile,ec", [(300, 1500, 128, 128, None),
                                           (500, 1500, 16, 256, 512)])
def test_fast_matches_bf16_reference_and_interpret_kernel(rng, n, e, d, tile, ec):
    src, dst, w, n_pad, tb, jb = _graph(rng, n, e, tile, ec, dup=e // 10)
    x = rng.standard_normal((n_pad, d)).astype(np.float32)
    mk = tmk.to_megakernel_layout(tb, n_pad)
    got = tmk.spmm_mk(torch.from_numpy(x), mk, n_pad, fast=True).numpy()
    assert _rel(got, _fast_reference(x, mk)) < KERNEL_REL
    jl = jax.tree.map(jnp.asarray, jmk.to_megakernel_layout(jb, n_pad))
    want = np.asarray(jmk.spmm_pallas_mk(jnp.asarray(x), jl, n_pad, fast=True,
                                         interpret=True))
    assert _rel(got, want) < KERNEL_REL
    # bf16 x: the output keeps x's dtype
    xb = torch.from_numpy(x).to(torch.bfloat16)
    out_b = tmk.spmm_mk(xb, mk, n_pad, fast=True)
    assert out_b.dtype == torch.bfloat16


@pytest.mark.parametrize("fast", [False, True])
def test_plan_walk_is_the_plain_version(rng, fast):
    """The plan the kernel walks (groups of live slots by destination row,
    chunk and local source; each group's weights summed in slot order, then
    its products added in group order) gives the plain version's bits."""
    _, _, _, n_pad, tb, _ = _graph(rng, 400, 3000, 128, 256, dup=300)
    mk = tmk.to_megakernel_layout(tb, n_pad)
    x = torch.from_numpy(rng.standard_normal((n_pad, 16)).astype(np.float32))
    row_ptr, grp_src, grp_ptr, perm = (t.long() for t in tmk.mk_plan(mk, n_pad))
    w = mk.weight.reshape(-1)[perm]
    if fast:
        w = w.to(torch.bfloat16).float()
    counts = grp_ptr[1:] - grp_ptr[:-1]
    grp = torch.repeat_interleave(torch.arange(counts.numel()), counts)
    a = torch.zeros(counts.numel()).index_add_(0, grp, w)
    xs = x
    if fast:
        a, xs = a.to(torch.bfloat16).float(), x.to(torch.bfloat16).float()
    rows = torch.repeat_interleave(torch.arange(n_pad), row_ptr[1:] - row_ptr[:-1])
    walked = torch.zeros_like(x).index_add_(0, rows, a[:, None] * xs[grp_src])
    assert torch.equal(walked, tmk.spmm_mk_plain(x, mk, n_pad, fast=fast))
    assert (mk.weight.reshape(-1)[perm] != 0).all()
    assert int(grp_ptr[-1]) == int((mk.weight != 0).sum())


def test_refuses_mismatched_x(rng):
    *_, n_pad, tb, _ = _graph(rng, 300, 1500)
    mk = tmk.to_megakernel_layout(tb, n_pad)
    with pytest.raises(ValueError, match="multiple"):
        tmk.spmm_mk(torch.zeros(n_pad + 1, 8), mk, n_pad)
    with pytest.raises(ValueError, match="destination blocks"):
        tmk.spmm_mk(torch.zeros(n_pad + 128, 8), mk, n_pad)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tmk.spmm_mk(torch.zeros(n_pad, 8, dtype=torch.float64), mk, n_pad)
