"""The rest of the port's GruSage against the JAX package's on the CPU, with
the JAX params carried across by sldm_gnn_tpu_torch.interop:

  * dense-aligned batches (graph/batching.pad_and_batch_aligned,
    PaddedGraphBatch.adj, the adj path of SageConv and SageBlock, the dense
    pools): the batch equals the JAX builder's; the aligned logits and
    gradients equal the flat batch's at 2e-5
    (tests/test_model_parity.py:262's bound), and the JAX dense model's at
    2e-4;
  * the dense map adjacency (dense_map_adj, MapData.adj): equal to JAX's,
    and the encoder's output and gradients match its edge path at
    1e-5 / 1e-6 (tests/test_model_parity.py:358);
  * compute_dtype='bfloat16': f32 params and logits, within 0.1 / 0.05 of
    the f32 model (tests/test_model_parity.py:237-259) and of the JAX bf16
    model on the same weights;
  * sage_type='attention' (models/attention.py): edge softmax and
    AttentionConv against the JAX functions, and GruSage's logits against
    JAX at 2e-4, its param tree carried both ways."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sldm_gnn_tpu.graph.batching import BatchDims as JBatchDims
from sldm_gnn_tpu.graph.batching import pad_and_batch as jax_pad_and_batch
from sldm_gnn_tpu.graph.batching import pad_and_batch_aligned as jax_pad_and_batch_aligned
from sldm_gnn_tpu.graph.containers import GraphArrays as JGraphArrays
from sldm_gnn_tpu.models import GruSage as JGruSage
from sldm_gnn_tpu.models import GruSageConfig as JGruSageConfig
from sldm_gnn_tpu.models.attention import AttentionConv as JAttentionConv
from sldm_gnn_tpu.models.attention import edge_softmax as jax_edge_softmax
from sldm_gnn_tpu.models.map_modules import MapData as JMapData
from sldm_gnn_tpu.models.map_modules import MapEncoder as JMapEncoder
from sldm_gnn_tpu.models.map_modules import dense_map_adj as jax_dense_map_adj
from sldm_gnn_tpu.ops import segment as jseg

from sldm_gnn_tpu_torch.graph.batching import BatchDims, pad_and_batch, pad_and_batch_aligned
from sldm_gnn_tpu_torch.graph.containers import GraphArrays
from sldm_gnn_tpu_torch.interop import params_to_state_dict, state_dict_to_params
from sldm_gnn_tpu_torch.models.attention import AttentionConv, edge_softmax
from sldm_gnn_tpu_torch.models.grusage import GruSage, GruSageConfig
from sldm_gnn_tpu_torch.models.map_modules import MapData, MapEncoder, dense_map_adj
from sldm_gnn_tpu_torch.ops import segment as tseg

F, L, VMAX = 5, 3, 8
# aligned vs flat: the same f32 math, sums in another order
# (tests/test_model_parity.py:262)
DENSE_TOL = 2e-5
# the port against the JAX model in f32 (tests/test_model_parity.py:197)
F32_TOL = 2e-4
# bf16 against f32 (tests/test_model_parity.py:259): rtol, atol
BF16_RTOL, BF16_ATOL = 0.1, 0.05


def _graphs(rng, n=6):
    gs = []
    for _ in range(n):
        v = int(rng.integers(2, 7))
        x = rng.standard_normal((v, F, 6)).astype(np.float32)
        ne = int(rng.integers(1, v * v))
        gs.append(dict(
            x=x, xsttype=rng.integers(0, 5, v).astype(np.int32),
            xdims=rng.uniform(1, 3, (v, 2)).astype(np.float32),
            edge_index=np.stack([rng.integers(0, v, ne), rng.integers(0, v, ne)]).astype(np.int32),
            edge_attr=np.zeros((ne, 4), np.float32),
            y=(rng.random(L) < 0.5).astype(np.float32), pos_raw=x[:, :, :2] * 10))
    return gs


def _cfg(**kw):
    base = dict(frames_num=F, gru_hidden_size=8, fc1dims=(8,), sage_hidden_dims=(8, 8),
                fc2dims=(8,), out_dim=L, dropout=None, negative_slope=0.1)
    return base | kw


def _port(params, map_feat_dim=None, **kw):
    tm = GruSage(GruSageConfig(**_cfg(**kw)), map_feat_dim=map_feat_dim)
    tm.load_state_dict(params_to_state_dict(jax.tree.map(np.asarray, params)))
    return tm.eval()


def _jax_batches(gs, g=6):
    flat = jax.tree.map(jnp.asarray, jax_pad_and_batch(
        [JGraphArrays(**d) for d in gs], JBatchDims(48, 256, g, F, L)))
    dense = jax.tree.map(jnp.asarray, jax_pad_and_batch_aligned(
        [JGraphArrays(**d) for d in gs], VMAX, num_frames=F, num_labels=L, graph_capacity=g))
    return flat, dense


def _port_batches(gs, g=6):
    flat = pad_and_batch([GraphArrays(**d) for d in gs], BatchDims(48, 256, g, F, L))
    dense = pad_and_batch_aligned([GraphArrays(**d) for d in gs], VMAX, num_frames=F,
                                  num_labels=L, graph_capacity=g)
    return flat, dense


@pytest.mark.parametrize("g", [None, 8])
def test_aligned_batch_equals_jax(rng, g):
    gs = _graphs(rng)
    want = jax_pad_and_batch_aligned([JGraphArrays(**d) for d in gs], VMAX, num_frames=F,
                                     num_labels=L, graph_capacity=g)
    got = pad_and_batch_aligned([GraphArrays(**d) for d in gs], VMAX, num_frames=F,
                                num_labels=L, graph_capacity=g)
    for f in dataclasses.fields(got):
        np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                      np.asarray(getattr(want, f.name)), err_msg=f.name)
    assert got.adj.shape == (g or len(gs), VMAX, VMAX)
    with pytest.raises(ValueError, match="vmax"):
        pad_and_batch_aligned([GraphArrays(**d) for d in gs], 3, num_frames=F, num_labels=L)


@pytest.mark.parametrize("pooling", ["double", "mean", "max"])
@pytest.mark.parametrize("sage_type", ["sage", "attention"])
def test_aligned_logits_and_grads_match_flat(rng, pooling, sage_type):
    """The same model on the aligned batch and on the flat one: logits and
    every parameter gradient at 2e-5 (the attention block keeps the edge
    path on both, as in JAX); the aligned logits against JAX's at 2e-4."""
    gs = _graphs(rng)
    jflat, jdense = _jax_batches(gs)
    tflat, tdense = _port_batches(gs)
    kw = dict(global_pooling=pooling, sage_type=sage_type, attention_qk_dim=4)
    jm = JGruSage(JGruSageConfig(**_cfg(**kw)))
    params = jm.init(jax.random.PRNGKey(0), jflat)["params"]
    tm = _port(params, **kw)

    def run(batch):
        out = tm(batch)
        sel = batch.graph_mask
        return out, torch.autograd.grad((out[sel] ** 2).sum(), list(tm.parameters()))

    lf, gf = run(tflat)
    ld, gd = run(tdense)
    np.testing.assert_allclose(ld.detach().numpy(), lf.detach().numpy(), rtol=DENSE_TOL,
                               atol=DENSE_TOL)
    for (name, _), a, b in zip(tm.named_parameters(), gd, gf):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=DENSE_TOL, atol=DENSE_TOL,
                                   err_msg=name)
    want = np.asarray(jm.apply({"params": params}, jdense))
    np.testing.assert_allclose(ld.detach().numpy(), want, rtol=F32_TOL, atol=F32_TOL)


def test_dense_pools_match_jax(rng):
    g, vmax, c = 4, 5, 3
    x = rng.standard_normal((g * vmax, c)).astype(np.float32)
    mask = rng.random(g * vmax) < 0.6
    mask[vmax:2 * vmax] = False  # an empty graph pools to 0
    for jf, tf in ((jseg.dense_mean_pool, tseg.dense_mean_pool),
                   (jseg.dense_max_pool, tseg.dense_max_pool)):
        want = np.asarray(jf(jnp.asarray(x), jnp.asarray(mask), g, vmax))
        got = tf(torch.from_numpy(x), torch.from_numpy(mask), g, vmax).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        assert not got[1].any()


def _map_data(rng, S=60):
    es = rng.integers(0, S, 140).astype(np.int32)
    ed = rng.integers(0, S, 140).astype(np.int32)
    es[10], ed[10] = es[11], ed[11]  # a duplicate edge: multiplicity counts
    mask = np.ones(140, bool)
    mask[-15:] = False  # padding edges dropped
    return dict(feats=rng.standard_normal((S, 9)).astype(np.float32),
                lane_type_cats=rng.integers(0, 3, S).astype(np.int32), edge_src=es,
                edge_dst=ed, centroids=rng.standard_normal((S, 2)).astype(np.float32) * 5,
                edge_mask=mask)


def test_dense_map_adj_matches_jax_and_edge_encoder(rng):
    """dense_map_adj equals JAX's; the encoder with MapData.adj matches its
    edge path (outputs at 1e-5 / 1e-6, gradients at 1e-5) and JAX's dense
    encoder at 1e-5."""
    d = _map_data(rng)
    jmd = JMapData(**{k: jnp.asarray(v) for k, v in d.items()})
    tmd = MapData(**{k: torch.from_numpy(v) for k, v in d.items()}).to("cpu")
    adj = dense_map_adj(tmd)
    np.testing.assert_array_equal(adj, jax_dense_map_adj(jmd))
    tdense = dataclasses.replace(tmd, adj=torch.from_numpy(adj))
    enc = JMapEncoder(num_lane_types=3, sage_hidden_dims=(8, 8))
    vs = enc.init({"params": jax.random.PRNGKey(0)}, jmd, train=False)
    want = np.asarray(enc.apply(vs, dataclasses.replace(jmd, adj=jnp.asarray(adj)), train=False))
    tenc = MapEncoder(3, 9, 2, (8, 8))
    tenc.load_state_dict(params_to_state_dict(jax.tree.map(np.asarray, vs["params"])))
    tenc.eval()

    def run(md):
        out = tenc(md)
        return out, torch.autograd.grad((out ** 2).sum(), list(tenc.parameters()))

    o0, g0 = run(tmd)
    o1, g1 = run(tdense)
    np.testing.assert_allclose(o1.detach().numpy(), o0.detach().numpy(), rtol=1e-5, atol=1e-6)
    for a, b in zip(g1, g0):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(o1.detach().numpy(), want, rtol=1e-5, atol=1e-5)


def test_grusage_with_dense_map_matches_jax(rng):
    """A live-map GruSage on the aligned batch with MapData.adj: logits
    against the JAX model on the same inputs at 2e-4."""
    d = _map_data(rng, S=30)
    gs = _graphs(rng)
    _, jdense = _jax_batches(gs)
    _, tdense = _port_batches(gs)
    jmd = JMapData(**{k: jnp.asarray(v) for k, v in d.items()})
    jmd = dataclasses.replace(jmd, adj=jnp.asarray(jax_dense_map_adj(jmd)))
    tmd = MapData(**{k: torch.from_numpy(v) for k, v in d.items()}).to("cpu")
    tmd = dataclasses.replace(tmd, adj=torch.from_numpy(dense_map_adj(tmd)))
    kw = dict(map_included=True, num_lane_types=3)
    jm = JGruSage(JGruSageConfig(**_cfg(**kw)))
    params = jm.init(jax.random.PRNGKey(1), jdense, map_data=jmd)["params"]
    want = np.asarray(jm.apply({"params": params}, jdense, map_data=jmd))
    tm = _port(params, map_feat_dim=9, **kw)
    with torch.no_grad():
        got = tm(tdense, map_data=tmd).numpy()
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("sage_type", ["sage", "attention"])
@pytest.mark.parametrize("aligned", [False, True])
def test_bf16_compute_mode(rng, sage_type, aligned):
    """compute_dtype='bfloat16': parameters stay f32, the logits are f32 and
    within 0.1 / 0.05 of the f32 model on the same weights, and of the JAX
    bf16 model."""
    gs = _graphs(rng, 5)
    jflat, jdense = _jax_batches(gs)
    tflat, tdense = _port_batches(gs)
    jb, tb = (jdense, tdense) if aligned else (jflat, tflat)
    kw = dict(sage_type=sage_type, attention_qk_dim=4)
    jm32 = JGruSage(JGruSageConfig(**_cfg(**kw)))
    params = jm32.init(jax.random.PRNGKey(0), jb)["params"]
    want16 = np.asarray(JGruSage(JGruSageConfig(**_cfg(compute_dtype="bfloat16", **kw)))
                        .apply({"params": params}, jb))
    tm32 = _port(params, **kw)
    tm16 = _port(params, compute_dtype="bfloat16", **kw)
    assert all(p.dtype == torch.float32 for p in tm16.parameters())
    with torch.no_grad():
        out32, out16 = tm32(tb), tm16(tb)
    assert out16.dtype == torch.float32
    np.testing.assert_allclose(out16.numpy(), out32.numpy(), rtol=BF16_RTOL, atol=BF16_ATOL)
    np.testing.assert_allclose(out16.numpy(), want16, rtol=BF16_RTOL, atol=BF16_ATOL)
    # and it trains: gradients reach every parameter, finite
    loss = (tm16(tb)[tb.graph_mask] ** 2).sum()
    grads = torch.autograd.grad(loss, list(tm16.parameters()), allow_unused=True)
    assert all(g is not None and torch.isfinite(g).all() for g in grads)


def test_edge_softmax_and_attention_conv_match_jax(rng):
    n, e, d, h = 9, 30, 6, 5
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    mask = rng.random(e) > 0.2
    dst_p = np.where(mask, dst, n)  # padding edges point past the nodes
    scores = rng.standard_normal(e).astype(np.float32)
    want = np.asarray(jax_edge_softmax(jnp.asarray(scores), jnp.asarray(dst_p),
                                       jnp.asarray(mask), n))
    got = edge_softmax(torch.from_numpy(scores), torch.from_numpy(dst_p),
                       torch.from_numpy(mask), n).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    x = rng.standard_normal((n, d)).astype(np.float32)
    args = [jnp.asarray(a) for a in (x, src, dst_p, mask)]
    conv = JAttentionConv(h, qk_dim=4)
    vs = conv.init(jax.random.PRNGKey(0), *args, n)
    want = np.asarray(conv.apply(vs, *args, n))
    tconv = AttentionConv(d, h, qk_dim=4)
    tconv.load_state_dict(params_to_state_dict(jax.tree.map(np.asarray, vs["params"])))
    got = tconv(*[torch.from_numpy(a) for a in (x, src, dst_p, mask)], n)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)
    # gradients stay finite with padding edges (their gathers read row n-1)
    g = torch.autograd.grad((got ** 2).sum(), list(tconv.parameters()))
    assert all(torch.isfinite(t).all() for t in g)


@pytest.mark.parametrize("map_included", [False, True])
def test_attention_grusage_matches_jax(rng, map_included):
    """sage_type='attention': logits against JAX at 2e-4, and the param tree
    (sage/conv{i}/q, k, lin_l, lin_r, sage/norm{i}) carried both ways bit
    for bit."""
    gs = _graphs(rng)
    jflat, _ = _jax_batches(gs)
    tflat, _ = _port_batches(gs)
    kw = dict(sage_type="attention", attention_qk_dim=6, map_included=map_included,
              num_lane_types=3)
    map_kw, tmap_kw = {}, {}
    if map_included:
        emb = rng.standard_normal((20, 8)).astype(np.float32)
        cen = (rng.standard_normal((20, 2)) * 10).astype(np.float32)
        map_kw = dict(map_embeddings=jnp.asarray(emb), map_centroids=jnp.asarray(cen))
        tmap_kw = dict(map_embeddings=torch.from_numpy(emb), map_centroids=torch.from_numpy(cen))
    jm = JGruSage(JGruSageConfig(**_cfg(**kw)))
    params = jm.init(jax.random.PRNGKey(2), jflat, **map_kw)["params"]
    assert set(params["sage"]["conv0"]) == {"q", "k", "lin_l", "lin_r"}
    want = np.asarray(jm.apply({"params": params}, jflat, **map_kw))
    tm = _port(params, **kw)
    with torch.no_grad():
        got = tm(tflat, **tmap_kw).numpy()
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    back = state_dict_to_params(tm)
    flat_a = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, params))
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(flat_b[path], a)


def test_attention_grusage_trains(rng):
    """A few Adam steps of the attention GruSage lower its loss."""
    gs = _graphs(rng, 6)
    tflat, _ = _port_batches(gs)
    torch.manual_seed(0)
    tm = GruSage(GruSageConfig(**_cfg(sage_type="attention", attention_qk_dim=4)))
    tm.reset_parameters(torch.Generator().manual_seed(0))
    opt = torch.optim.Adam(tm.parameters(), lr=1e-2)
    sel = tflat.graph_mask
    losses = []
    for _ in range(15):
        opt.zero_grad()
        loss = torch.nn.functional.binary_cross_entropy_with_logits(tm(tflat)[sel], tflat.y[sel])
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
