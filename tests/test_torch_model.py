"""The port's GruSage (sldm_gnn_tpu_torch.models) against the JAX package's
on the CPU, with the JAX params transplanted through
sldm_gnn_tpu_torch.interop."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sldm_gnn_tpu.graph.batching import BatchDims as JBatchDims
from sldm_gnn_tpu.graph.batching import pad_and_batch as jax_pad_and_batch
from sldm_gnn_tpu.graph.containers import GraphArrays as JGraphArrays
from sldm_gnn_tpu.models import GruSage as JGruSage
from sldm_gnn_tpu.models import GruSageConfig as JGruSageConfig
from sldm_gnn_tpu.models.map_modules import MapSpatialAttention as JMapSpatialAttention

from sldm_gnn_tpu_torch.graph.batching import BatchDims, pad_and_batch
from sldm_gnn_tpu_torch.graph.containers import GraphArrays
from sldm_gnn_tpu_torch.interop import params_to_state_dict, state_dict_to_params
from sldm_gnn_tpu_torch.models.grusage import GruSage, GruSageConfig
from sldm_gnn_tpu_torch.models.map_modules import MapSpatialAttention

# f32 end to end: the JAX package's GruSage parity bound
# (tests/test_model_parity.py)
F32_ATOL = 2e-4
# pallas/pallas: both sides run the bf16 GRU (carry rounded to bf16 every
# step) and differ only in f32 summation order, which can flip a bf16
# rounding of h (<= 3.9e-3); through FC1/SAGE/pooling/head such a flip moves
# a logit by well under 2e-2, the bound used here (the JAX package's own
# bf16-vs-f32 logit contract is 3e-2, tests/test_gru_pallas.py).
BF16_ATOL = 2e-2

F, L, S, DMAP = 12, 2, 40, 8


def _graphs(rng, n_graphs=4):
    gs = []
    for _ in range(n_graphs):
        v = int(rng.integers(3, 8))
        e = int(rng.integers(2, v * (v - 1) + 1))
        src = rng.integers(0, v, e).astype(np.int32)
        dst = (src + 1 + rng.integers(0, v - 1, e).astype(np.int32)) % v
        gs.append(dict(
            x=rng.standard_normal((v, F, 6)).astype(np.float32),
            xsttype=rng.integers(0, 5, v).astype(np.int32),
            xdims=rng.standard_normal((v, 2)).astype(np.float32),
            edge_index=np.stack([src, dst]),
            edge_attr=rng.standard_normal((e, 4)).astype(np.float32),
            y=rng.integers(0, 2, L).astype(np.float32),
            pos_raw=(rng.standard_normal((v, F, 2)) * 10).astype(np.float32),
        ))
    return gs


def _batches(gs, n=40, e=96, g=5):
    jb = jax.tree.map(jnp.asarray, jax_pad_and_batch(
        [JGraphArrays(**d) for d in gs], JBatchDims(n, e, g, F, L)))
    tb = pad_and_batch([GraphArrays(**d) for d in gs], BatchDims(n, e, g, F, L))
    return jb, tb


def _cfg_kw(**kw):
    base = dict(frames_num=F, gru_hidden_size=16, gru_num_layers=2, fc1dims=(16,),
                sage_hidden_dims=(16, 16), fc2dims=(8,), out_dim=L, emb_dim=4,
                negative_slope=0.1)
    base.update(kw)
    return base


def _run_both(rng, **kw):
    gs = _graphs(rng)
    jb, tb = _batches(gs)
    emb = rng.standard_normal((S, DMAP)).astype(np.float32)
    cen = (rng.standard_normal((S, 2)) * 10).astype(np.float32)
    map_kw = {}
    if kw.get("map_included"):
        map_kw = dict(map_embeddings=jnp.asarray(emb), map_centroids=jnp.asarray(cen))
    jm = JGruSage(JGruSageConfig(**_cfg_kw(**kw)))
    params = jm.init(jax.random.PRNGKey(0), jb, **map_kw)["params"]
    want = np.asarray(jm.apply({"params": params}, jb, **map_kw))

    tm = GruSage(GruSageConfig(**_cfg_kw(**kw)))
    tm.load_state_dict(params_to_state_dict(jax.tree.map(np.asarray, params)))
    tm.eval()
    with torch.no_grad():
        got = tm(tb, **{k: torch.from_numpy(np.array(v)) for k, v in map_kw.items()})
    return got.numpy(), want, params, tm


@pytest.mark.parametrize("map_included", [False, True])
@pytest.mark.parametrize("pooling", ["double", "mean", "max"])
def test_grusage_scan_topk_matches_jax(rng, map_included, pooling):
    got, want, _, _ = _run_both(rng, map_included=map_included, global_pooling=pooling)
    assert got.shape == (5, L)
    np.testing.assert_allclose(got, want, rtol=F32_ATOL, atol=F32_ATOL)


@pytest.mark.parametrize("map_included", [False, True])
def test_grusage_pallas_matches_jax(rng, map_included):
    got, want, _, _ = _run_both(rng, map_included=map_included, gru_impl="pallas",
                                knn_impl="pallas")
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL)


def test_interop_round_trip_is_bit_equal(rng):
    _, _, params, tm = _run_both(rng, map_included=True)
    back = state_dict_to_params(tm)
    flat_a = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, params))
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(flat_b[path], a)


def test_map_attention_both_combines_match_jax(rng):
    V, K = 30, 5
    pts = (rng.standard_normal((V, 2)) * 10).astype(np.float32)
    cen = (rng.standard_normal((S, 2)) * 10).astype(np.float32)
    emb = rng.standard_normal((S, DMAP)).astype(np.float32)
    args = [jnp.asarray(a) for a in (pts, cen, emb)]
    m0 = JMapSpatialAttention(k_neighbors=K, knn_impl="topk")
    params = m0.init(jax.random.PRNGKey(1), *args)
    sd = params_to_state_dict(jax.tree.map(np.asarray, params["params"]))
    for impl in ("topk", "pallas"):
        want = np.asarray(JMapSpatialAttention(k_neighbors=K, knn_impl=impl)
                          .apply(params, *args))
        tm = MapSpatialAttention(K, impl)
        tm.load_state_dict(sd)
        with torch.no_grad():
            got = tm(*[torch.from_numpy(a) for a in (pts, cen, emb)]).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=impl)


def test_config_keys_match_jax():
    assert GruSageConfig().to_dict() == JGruSageConfig().to_dict()
    d = JGruSageConfig(fc1dims=(7, 5), gru_impl="pallas").to_dict()
    d["fc1dims"] = list(d["fc1dims"])
    assert GruSageConfig.from_dict(d) == GruSageConfig(fc1dims=(7, 5), gru_impl="pallas")


@pytest.mark.parametrize("kw,err", [
    (dict(map_edge_axis="ep"), NotImplementedError),
    (dict(map_included=True, map_segment_axis="ep"), NotImplementedError),
    (dict(map_segment_axis="ep"), NotImplementedError),
    (dict(gru_impl="cudnn"), ValueError),
    (dict(map_included=True, knn_impl="sort"), ValueError),
    (dict(global_pooling="sum"), ValueError),
    (dict(compute_dtype="float16"), ValueError),
    (dict(sage_type="gat"), ValueError),
])
def test_unported_options_raise(kw, err):
    with pytest.raises(err):
        GruSage(GruSageConfig(**_cfg_kw(**kw)))


def test_map_model_needs_baked_map(rng):
    tm = GruSage(GruSageConfig(**_cfg_kw(map_included=True))).eval()
    _, tb = _batches(_graphs(rng))
    with pytest.raises(ValueError, match="baked"):
        tm(tb)


def test_batching_matches_jax(rng):
    gs = _graphs(rng, 6)
    jdims = JBatchDims(48, 128, 8, F, L)
    want = jax_pad_and_batch([JGraphArrays(**d) for d in gs], jdims)
    got = pad_and_batch([GraphArrays(**d) for d in gs], BatchDims(48, 128, 8, F, L))
    for f in dataclasses.fields(got):
        w = getattr(want, f.name)
        if f.name == "adj":  # only an aligned batch has one, on either side
            assert got.adj is None and w is None
            continue
        np.testing.assert_array_equal(getattr(got, f.name).numpy(), np.asarray(w),
                                      err_msg=f.name)
    with pytest.raises(ValueError, match="overflow"):
        pad_and_batch([GraphArrays(**d) for d in gs], BatchDims(8, 8, 8, F, L))
    moved = got.to("cpu")
    assert moved.node_capacity == 48 and moved.device.type == "cpu"
