"""The port's training slice (sldm_gnn_tpu_torch.train, the live map
encoder, dropout, compute_batch_dims) against the JAX package's on the CPU:
a tiny GruSage (frames 12, GRU hidden 16, 3 labels) with a live 30-segment
map, inputs made with numpy and given to both packages, JAX params carried
across through sldm_gnn_tpu_torch.interop. On CPU tensors the GRU and KNN
kernels run their plain versions; the JAX Pallas kernels run in interpret
mode. The kernels themselves are held against the plain versions on the
card by chip_smoke.py."""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sldm_gnn_tpu.graph.batching import BatchDims as JBatchDims
from sldm_gnn_tpu.graph.batching import compute_batch_dims as jax_compute_batch_dims
from sldm_gnn_tpu.graph.batching import pad_and_batch as jax_pad_and_batch
from sldm_gnn_tpu.graph.containers import GraphArrays as JGraphArrays
from sldm_gnn_tpu.models import GruSage as JGruSage
from sldm_gnn_tpu.models import GruSageConfig as JGruSageConfig
from sldm_gnn_tpu.models.map_modules import MapData as JMapData
from sldm_gnn_tpu.models.map_modules import MapEncoder as JMapEncoder
from sldm_gnn_tpu.models.map_modules import map_zscore_norm as jax_map_zscore_norm
from sldm_gnn_tpu.train import losses as jlosses
from sldm_gnn_tpu.train.loop import build_step_fns as jax_build_step_fns
from sldm_gnn_tpu.train.loop import make_optimizer as jax_make_optimizer
from sldm_gnn_tpu.train.snapshot import load_snapshot as jax_load_snapshot
from sldm_gnn_tpu.train.snapshot import save_snapshot as jax_save_snapshot

from sldm_gnn_tpu_torch.evals.metrics import roc_auc_score
from sldm_gnn_tpu_torch.graph.batching import BatchDims, compute_batch_dims, pad_and_batch
from sldm_gnn_tpu_torch.graph.containers import GraphArrays
from sldm_gnn_tpu_torch.interop import params_to_state_dict, state_dict_to_params
from sldm_gnn_tpu_torch.models.blocks import dropout
from sldm_gnn_tpu_torch.models.grusage import GruSage, GruSageConfig
from sldm_gnn_tpu_torch.models.map_modules import MapData, MapEncoder, map_zscore_norm
from sldm_gnn_tpu_torch.serve.stream import InferenceEngine
from sldm_gnn_tpu_torch.train import losses as tlosses
from sldm_gnn_tpu_torch.train.loop import build_step_fns, make_optimizer, train_model
from sldm_gnn_tpu_torch.train.snapshot import save_snapshot

F, L, S, FEAT = 12, 3, 30, 9
LR, WD, POS_W = 1e-3, 1e-4, 2.0
# f32 end to end (gru_impl='scan'): the JAX package's GruSage parity bound
# (tests/test_model_parity.py:197)
F32_ATOL = 2e-4
# bf16 GRU kernels on both sides: the JAX package's whole-model contract for
# them (tests/test_gru_pallas.py:236-246), rtol 5e-2 and atol
# 5e-2 * (max|g| + 1e-6); the floor covers gradients that vanish exactly
# (the attention's score bias under its softmax)
BF16_GRAD_TOL = 5e-2


def _graph_dicts(rng, n=5):
    gs = []
    for _ in range(n):
        v = int(rng.integers(3, 7))
        src, dst = np.meshgrid(np.arange(v), np.arange(v))
        m = src != dst
        x = rng.standard_normal((v, F, 6)).astype(np.float32)
        gs.append(dict(
            x=x, xsttype=rng.integers(0, 5, v).astype(np.int32),
            xdims=rng.uniform(1.5, 5.0, (v, 2)).astype(np.float32),
            edge_index=np.stack([src[m], dst[m]]).astype(np.int32),
            edge_attr=np.zeros((int(m.sum()), 4), np.float32),
            y=(rng.random(L) < 0.4).astype(np.float32),
            pos_raw=(rng.standard_normal((v, F, 2)) * 10).astype(np.float32)))
    return gs


def _map_arrays(rng):
    feats = rng.standard_normal((S, FEAT)).astype(np.float32) * 3 + 1
    return dict(feats=feats,
                lane_type_cats=rng.integers(0, 8, S).astype(np.int32),
                edge_src=rng.integers(0, S, 4 * S).astype(np.int32),
                edge_dst=rng.integers(0, S, 4 * S).astype(np.int32),
                centroids=(rng.standard_normal((S, 2)) * 10).astype(np.float32))


def _maps(arrays):
    feats = np.array(jax_map_zscore_norm(jnp.asarray(arrays["feats"])))
    jmd = JMapData(feats=jnp.asarray(feats), **{k: jnp.asarray(v) for k, v in arrays.items()
                                                   if k != "feats"})
    tmd = MapData(feats=torch.from_numpy(feats),
                  **{k: torch.from_numpy(v) for k, v in arrays.items() if k != "feats"})
    return jmd, tmd.to("cpu")


def _cfg_kw(**kw):
    base = dict(frames_num=F, gru_hidden_size=16, fc1dims=(16,), sage_hidden_dims=(16, 16),
                fc2dims=(8,), out_dim=L, emb_dim=4, dropout=None, negative_slope=0.1,
                map_included=True, map_attention_topk=5, knn_impl="pallas")
    base.update(kw)
    return base


def _setup(rng, **kw):
    """Both models with the same params, both batches, both maps."""
    gs = _graph_dicts(rng)
    dims = (32, 160, 6)
    jb = jax.tree.map(jnp.asarray, jax_pad_and_batch([JGraphArrays(**d) for d in gs],
                                                     JBatchDims(*dims, F, L)))
    tb = pad_and_batch([GraphArrays(**d) for d in gs], BatchDims(*dims, F, L))
    jmd, tmd = _maps(_map_arrays(rng))
    jm = JGruSage(JGruSageConfig(**_cfg_kw(**kw)))
    jfns = jax_build_step_fns(jm, jax_make_optimizer(LR, WD), map_data=jmd, pos_weight=POS_W)
    jstate = jfns.init(jax.random.PRNGKey(0), jb)
    tm = GruSage(GruSageConfig(**_cfg_kw(**kw)), map_feat_dim=FEAT)
    tm.load_state_dict(params_to_state_dict(jax.tree.map(np.asarray, jstate.params)))
    return jm, jfns, jstate, jb, jmd, tm, tb, tmd


def _grads_as_params(model):
    """The gradients of ``model`` as a JAX-layout tree."""
    g = copy.deepcopy(model)
    with torch.no_grad():
        for p_g, p in zip(g.parameters(), model.parameters()):
            p_g.copy_(p.grad if p.grad is not None else torch.zeros_like(p))
    return state_dict_to_params(g)


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, tree)))


@pytest.mark.parametrize("loss_type", ["bce", "focal"])
@pytest.mark.parametrize("masked", [False, True])
def test_losses_match_jax(rng, loss_type, masked):
    logits = (rng.standard_normal((7, L)) * 4).astype(np.float32)
    y = (rng.random((7, L)) < 0.4).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 1, 0, 1], bool) if masked else np.ones(7, bool)
    kw = dict(loss_type=loss_type, pos_weight=2.5, focal_alpha=0.6, focal_gamma=2.0)
    want = float(jlosses.masked_graph_loss(jnp.asarray(logits), jnp.asarray(y),
                                           jnp.asarray(mask), **kw))
    got = float(tlosses.masked_graph_loss(torch.from_numpy(logits), torch.from_numpy(y),
                                          torch.from_numpy(mask), **kw))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))
    for fn_j, fn_t, extra in ((jlosses.bce_with_logits_pos_weight,
                               tlosses.bce_with_logits_pos_weight, (2.5,)),
                              (jlosses.focal_bce_loss, tlosses.focal_bce_loss, (0.6, 2.0))):
        w = float(fn_j(jnp.asarray(logits), jnp.asarray(y), *extra))
        g = float(fn_t(torch.from_numpy(logits), torch.from_numpy(y), *extra))
        assert abs(g - w) <= 1e-6 * max(1.0, abs(w))
    with pytest.raises(ValueError):
        tlosses.masked_graph_loss(torch.zeros(2, L), torch.zeros(2, L), torch.ones(2, dtype=bool),
                                  loss_type="hinge")


def test_map_encoder_and_encode_map_match_jax(rng):
    arrays = _map_arrays(rng)
    np.testing.assert_allclose(map_zscore_norm(torch.from_numpy(arrays["feats"])).numpy(),
                               np.asarray(jax_map_zscore_norm(jnp.asarray(arrays["feats"]))),
                               rtol=1e-6, atol=1e-6)
    jmd, tmd = _maps(arrays)
    assert tmd.num_segments == S and tmd.mask().all() and tmd.edge_src.dtype == torch.int64
    jenc = JMapEncoder(num_lane_types=8, lane_embed_dim=2, sage_hidden_dims=(8, 8),
                       negative_slope=0.1)
    params = jenc.init(jax.random.PRNGKey(2), jmd)
    tenc = MapEncoder(8, FEAT, 2, (8, 8), None, 0.1)
    tenc.load_state_dict(params_to_state_dict(jax.tree.map(np.asarray, params["params"])))
    assert tenc.out_dim == 8
    with torch.no_grad():
        got = tenc(tmd).numpy()
    np.testing.assert_allclose(got, np.asarray(jenc.apply(params, jmd)), rtol=1e-5, atol=1e-5)

    jm, _, jstate, jb, jmd, tm, tb, tmd = _setup(rng)
    want = np.asarray(jm.apply({"params": jstate.params}, jmd, method=JGruSage.encode_map))
    with torch.no_grad():
        np.testing.assert_allclose(tm.eval().encode_map(tmd).numpy(), want, rtol=1e-5,
                                   atol=1e-5)
        # the live map branch end to end, eval mode
        got = tm(tb, map_data=tmd).numpy()
    want = np.asarray(jm.apply({"params": jstate.params}, jb, map_data=jmd))
    np.testing.assert_allclose(got, want, rtol=F32_ATOL, atol=F32_ATOL)
    # and a padded edge list: masked edges drop out of the aggregation
    pad = MapData(tmd.feats, tmd.lane_type_cats, torch.cat([tmd.edge_src, tmd.edge_src[:5]]),
                  torch.cat([tmd.edge_dst, tmd.edge_dst[:5]]), tmd.centroids,
                  torch.cat([torch.ones(4 * S, dtype=torch.bool),
                             torch.zeros(5, dtype=torch.bool)]))
    with torch.no_grad():
        torch.testing.assert_close(tm.encode_map(pad), tm.encode_map(tmd))


@pytest.mark.parametrize("gru_impl", ["scan", "pallas", "pallas_sg"])
def test_train_steps_match_jax(rng, gru_impl):
    """Three train_steps from the same params, dropout off. 'scan': losses
    within 1e-5 relative and params within 2e-4 after the three steps.
    'pallas'/'pallas_sg' (bf16 kernels, v2/v3 backward): the first step's
    gradients at the JAX v2/v3 contract, and the three losses."""
    jm, jfns, jstate, jb, jmd, tm, tb, tmd = _setup(rng, gru_impl=gru_impl)
    fns = build_step_fns(tm, make_optimizer(LR, WD), map_data=tmd, pos_weight=POS_W)
    state = fns.init(None)

    if gru_impl != "scan":
        def loss_j(params):
            logits = jm.apply({"params": params}, jb, map_data=jmd, train=True)
            return jlosses.masked_graph_loss(logits, jb.y, jb.graph_mask, pos_weight=POS_W)

        want = _leaves(jax.grad(loss_j)(jstate.params))
        tm.train()
        loss = tlosses.masked_graph_loss(tm(tb, map_data=tmd), tb.y, tb.graph_mask,
                                         pos_weight=POS_W)
        loss.backward()
        got = _leaves(_grads_as_params(tm))
        assert got.keys() == want.keys()
        for path, w in want.items():
            np.testing.assert_allclose(got[path], w, rtol=BF16_GRAD_TOL,
                                       atol=BF16_GRAD_TOL * (np.abs(w).max() + 1e-6),
                                       err_msg=jax.tree_util.keystr(path))
        assert any("gru" in jax.tree_util.keystr(p) for p in want)

    loss_rtol = 1e-5 if gru_impl == "scan" else 1e-3
    for _ in range(3):
        jstate, jm_ = jfns.train_step(jstate, jb, jax.random.PRNGKey(1))
        state, m = fns.train_step(state, tb)
        assert abs(float(m["loss"]) - float(jm_["loss"])) <= loss_rtol * abs(float(jm_["loss"]))
        np.testing.assert_array_equal(m["correct"].numpy(), np.asarray(jm_["correct"]))
        assert int(m["n_graphs"]) == int(jm_["n_graphs"])
    assert state.step == 3
    if gru_impl == "scan":
        got = _leaves(state_dict_to_params(tm))
        for path, w in _leaves(jstate.params).items():
            np.testing.assert_allclose(got[path], w, rtol=0, atol=F32_ATOL,
                                       err_msg=jax.tree_util.keystr(path))
    ev_t = fns.eval_step(state, tb)
    assert set(ev_t) == {"loss", "correct", "n_graphs", "scores", "preds"}
    assert ev_t["scores"].shape == (6, L) and torch.isfinite(ev_t["loss"])


def test_dropout_keep_rate_and_scale():
    p = 0.25
    x = torch.ones(400_000)
    gen = torch.Generator().manual_seed(3)
    y = dropout(x, p, True, gen)
    kept = y != 0
    assert abs(kept.float().mean().item() - (1 - p)) < 4e-3
    assert torch.all(y[kept] == 1 / (1 - p))
    # the same generator state gives the same mask; eval and p=None are the identity
    assert torch.equal(dropout(x, p, True, torch.Generator().manual_seed(3)), y)
    assert dropout(x, p, False, gen) is x and dropout(x, None, True, None) is x
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, p, True, None)


def test_dropout_in_the_model_only_in_train_mode(rng):
    *_, tm, tb, tmd = _setup(rng)
    tm2 = GruSage(GruSageConfig(**_cfg_kw(dropout=0.25)), map_feat_dim=FEAT)
    tm2.load_state_dict(tm.state_dict())
    with torch.no_grad():
        base = tm.eval()(tb, map_data=tmd)
        torch.testing.assert_close(tm2.eval()(tb, map_data=tmd), base)
        tm2.train()
        a = tm2(tb, map_data=tmd, generator=torch.Generator().manual_seed(0))
        b = tm2(tb, map_data=tmd, generator=torch.Generator().manual_seed(0))
        c = tm2(tb, map_data=tmd, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, base)
    with pytest.raises(ValueError, match="Generator"):
        tm2(tb, map_data=tmd)


def _tiny_dataset(rng, n, frames, labels):
    gs = []
    for i in range(n):
        v = 4
        label = np.zeros(labels, np.float32)
        label[i % labels] = 1.0
        x = rng.standard_normal((v, frames, 6)).astype(np.float32) * 0.1
        x[:, :, 2] += float(i % labels)  # the speed channel encodes the label
        gs.append(GraphArrays(
            x=x, xsttype=np.zeros(v, np.int32), xdims=np.ones((v, 2), np.float32),
            edge_index=np.array([[0, 1, 2, 3], [1, 2, 3, 0]], np.int32),
            edge_attr=np.zeros((4, 4), np.float32), y=label, pos_raw=x[:, :, :2]))
    return gs


@pytest.mark.parametrize("gru_impl", ["scan", "pallas_sg"])
def test_train_model_overfits_tiny_dataset(rng, gru_impl):
    frames, labels = 6, 2
    gs = _tiny_dataset(rng, 8, frames, labels)
    batch = pad_and_batch(gs, compute_batch_dims(gs, 8, labels))
    cfg = GruSageConfig(frames_num=frames, gru_hidden_size=16, fc1dims=(16,),
                        sage_hidden_dims=(16,), fc2dims=(8,), out_dim=labels, emb_dim=4,
                        dropout=None, negative_slope=0.1, gru_impl=gru_impl)
    epochs_seen = []
    state, result = train_model(
        GruSage(cfg), lambda: [batch], lambda: [batch], epochs=40, lr=5e-3,
        weight_decay=0.0, active_labels=[0, 1], neg_over_pos_ratio=1.0, device="cpu",
        epoch_callback=lambda e, m: epochs_seen.append((e, m["val_loss"])))
    assert result.total_val_acc[0, -1] >= 0.9, result.total_val_acc
    assert result.train_loss[-1] < result.train_loss[0] * 0.5
    assert [e for e, _ in epochs_seen] == list(range(40)) and state.step == 40
    assert result.bin_cm is None and result.per_label_val_acc.shape == (labels, 40)


def test_train_model_single_label_curves_and_best_state(rng):
    gs = _tiny_dataset(rng, 8, 6, 2)
    for g in gs:  # one label: "is it class 1"
        object.__setattr__(g, "y", g.y[1:])
    batch = pad_and_batch(gs, compute_batch_dims(gs, 8, 1))
    cfg = GruSageConfig(frames_num=6, gru_hidden_size=8, fc1dims=(8,), sage_hidden_dims=(8,),
                        fc2dims=(4,), out_dim=1, emb_dim=2, dropout=0.1, negative_slope=0.1)
    best = []
    state, result = train_model(
        GruSage(cfg), lambda: [batch], lambda: [batch], epochs=25, lr=1e-2,
        weight_decay=1e-5, focal_gamma=2.0, device="cpu", seed=4,
        best_state_callback=lambda s, info: best.append((info["epoch"], info["loss_info"])))
    assert best and best[0][1]["type"] == "focal"
    assert result.bin_cm.shape == (4, 25) and (result.bin_cm.sum(axis=0) == 8).all()
    assert np.isfinite(result.bin_rocauc).all() and result.bin_rocauc[0, -1] >= 0.9
    assert result.best_val_acc == result.total_val_acc.max()
    gt = np.array([0, 1, 1, 0, 1])
    assert roc_auc_score(gt, np.array([0.1, 0.9, 0.8, 0.35, 0.3])) == pytest.approx(5 / 6)
    assert np.isnan(roc_auc_score(np.ones(3), np.arange(3.0)))


def test_compute_batch_dims_matches_jax(rng):
    gs = _graph_dicts(rng, 9)
    for bs in (4, 9, 20):
        want = jax_compute_batch_dims([JGraphArrays(**d) for d in gs], bs, L)
        got = compute_batch_dims([GraphArrays(**d) for d in gs], bs, L)
        assert got.__dict__ == want.__dict__
    with pytest.raises(ValueError):
        compute_batch_dims([], 4, L)


def test_trained_snapshot_serves_in_jax_and_in_the_port(rng, tmp_path):
    """Port-trained map model -> the port's train/snapshot.py (embeddings
    baked) -> the JAX package's load_snapshot and GruSage: logits within
    2e-4 of the port's live-map model; -> the port's InferenceEngine: the
    same scores."""
    jm, _, _, jb, _, tm, tb, tmd = _setup(rng)
    fns = build_step_fns(tm, make_optimizer(5e-3, WD), map_data=tmd, pos_weight=POS_W)
    state = fns.init(None)
    for _ in range(3):
        state, _ = fns.train_step(state, tb)
    path = tmp_path / "trained.pkl"
    save_snapshot(path, tm, map_data=tmd, train_prior=0.3, loss_info={"type": "BCEWithLogits"})
    snap = jax_load_snapshot(path)
    assert "map_encoder" not in snap["params"] and snap["map_embeddings"].shape == (S, 8)
    tm.eval()
    with torch.no_grad():
        want = tm(tb, map_data=tmd).numpy()
    got = np.asarray(JGruSage(snap["config"]).apply(
        {"params": snap["params"]}, jb, map_embeddings=jnp.asarray(snap["map_embeddings"]),
        map_centroids=jnp.asarray(snap["map_centroids"])))
    np.testing.assert_allclose(got, want, rtol=F32_ATOL, atol=F32_ATOL)

    eng = InferenceEngine(path, pack_size=F, device="cpu")
    assert eng.model.map_encoder is None
    g = GraphArrays(**_graph_dicts(rng, 1)[0])
    one = pad_and_batch([g], BatchDims(8, 32, 1, F, L))
    with torch.no_grad():
        want = torch.sigmoid(tm(one, map_data=tmd))[0].numpy()
    np.testing.assert_allclose(eng.score_graph(g), want, rtol=1e-5, atol=1e-5)

    # keep_map_encoder: the encoder's weights travel, in both packages' readers
    path2 = tmp_path / "with_encoder.pkl"
    save_snapshot(path2, tm, map_data=tmd, keep_map_encoder=True)
    assert "map_encoder" in jax_load_snapshot(path2)["params"]
    eng2 = InferenceEngine(path2, pack_size=F, device="cpu")
    assert eng2.model.map_encoder is not None
    np.testing.assert_allclose(eng2.score_graph(g), want, rtol=1e-5, atol=1e-5)


def test_jax_snapshot_with_map_encoder_loads_into_engine(rng, tmp_path):
    jm, _, jstate, jb, jmd, *_ = _setup(rng)
    emb = np.asarray(jm.apply({"params": jstate.params}, jmd, method=JGruSage.encode_map))
    path = tmp_path / "jax.pkl"
    jax_save_snapshot(path, params=jstate.params, config=jm.cfg, map_embeddings=emb,
                      map_centroids=np.asarray(jmd.centroids), keep_map_encoder=True)
    eng = InferenceEngine(path, pack_size=F, device="cpu")
    assert eng.model.map_encoder.feat_dim == FEAT
    got = state_dict_to_params(eng.model)["map_encoder"]
    for path_, w in _leaves(jstate.params["map_encoder"]).items():
        np.testing.assert_array_equal(_leaves(got)[path_], w)
