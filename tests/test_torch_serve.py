"""The port's serving path (sldm_gnn_tpu_torch.serve, .build.online) on the
CPU against the JAX package's: a snapshot written by the JAX package, a
window stream through both InferenceEngines, the FIFO server and the CLI."""

import json
import os
import pickle
import threading

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
from sldm_gnn_tpu.serve.stream import InferenceEngine as JInferenceEngine
from sldm_gnn_tpu.train.snapshot import save_snapshot as jax_save_snapshot

from sldm_gnn_tpu_torch.cli import rcv
from sldm_gnn_tpu_torch.serve.snapshot import load_snapshot
from sldm_gnn_tpu_torch.serve.stream import InferenceEngine, StreamingServer

PACK, S, DMAP, L = 6, 30, 8, 2
# bf16 GRU on both sides, summation order apart (see test_torch_model.py)
BF16_ATOL = 2e-2


def _cfg(**kw):
    base = dict(frames_num=PACK, gru_hidden_size=16, fc1dims=(16,),
                sage_hidden_dims=(16, 16), fc2dims=(8,), out_dim=L, emb_dim=4,
                negative_slope=0.1, map_included=True)
    base.update(kw)
    return JGruSageConfig(**base)


def _write_jax_snapshot(path, rng, **kw):
    cfg = _cfg(**kw)
    emb = rng.standard_normal((S, DMAP)).astype(np.float32)
    cen = (rng.standard_normal((S, 2)) * 15).astype(np.float32)
    v = 5
    g = JGraphArrays(
        x=rng.standard_normal((v, PACK, 6)).astype(np.float32),
        xsttype=np.zeros(v, np.int32), xdims=np.ones((v, 2), np.float32),
        edge_index=np.array([[0, 1], [1, 0]], np.int32),
        edge_attr=np.zeros((2, 4), np.float32))
    batch = jax.tree.map(jnp.asarray, jax_pad_and_batch([g], JBatchDims(8, 4, 1, PACK, L)))
    params = JGruSage(cfg).init(jax.random.PRNGKey(0), batch,
                                map_embeddings=jnp.asarray(emb),
                                map_centroids=jnp.asarray(cen))["params"]
    norm = {"mu": {"x": np.full(5, 0.5, np.float32), "xdims": np.array([2, 4], np.float32)},
            "sigma": {"x": np.full(5, 3.0, np.float32), "xdims": np.ones(2, np.float32)}}
    jax_save_snapshot(path, params=params, config=cfg, norm_stat_dict=norm,
                      train_prior=0.3, map_embeddings=emb, map_centroids=cen)
    return cfg


def _stream(n_frames=14, n_vehicles=8, seed=3):
    rng = np.random.default_rng(seed)
    static = {v: (float(rng.uniform(1.5, 2.5)), float(rng.uniform(3.5, 5)),
                  int(rng.integers(0, 6))) for v in range(n_vehicles)}
    frames = []
    for t in range(n_frames):
        rows = []
        for v in range(n_vehicles):
            if (t + v) % 5 == 0 or (t >= 9 and v >= 4):  # churn; vehicles leave
                continue
            w, ln, st = static[v]
            rows.append(dict(VehicleId=100 + v, X=float(v * 4 + 0.7 * t + rng.normal()),
                             Y=float(2 * np.sin(0.3 * t + v) + v), Speed=float(rng.uniform(0, 20)),
                             Angle=float(rng.uniform(0, 360)), Width=w, Length=ln,
                             StationType=st))
        frames.append(rows)
    frames[11] = []  # an empty frame
    return frames


@pytest.fixture
def jax_snapshot(tmp_path, rng):
    p = tmp_path / "snap.pkl"
    _write_jax_snapshot(p, rng)
    return p


def test_jax_snapshot_loads_unchanged(jax_snapshot):
    snap = load_snapshot(jax_snapshot)
    with open(jax_snapshot, "rb") as f:
        raw = pickle.load(f)
    assert snap["config"].to_dict() == raw["config"]
    assert snap["train_prior"] == pytest.approx(0.3)
    np.testing.assert_array_equal(snap["map_centroids"], raw["map_centroids"])
    flat = jax.tree_util.tree_leaves_with_path(raw["params"])
    flat_port = dict(jax.tree_util.tree_leaves_with_path(snap["params"]))
    for path, a in flat:
        np.testing.assert_array_equal(flat_port[path], a)


def test_snapshot_loader_reads_frozen_params(tmp_path):
    from flax.core import FrozenDict

    p = tmp_path / "frozen.pkl"
    cfg = _cfg().to_dict()
    with open(p, "wb") as f:
        pickle.dump({"params": FrozenDict({"linout": {"bias": np.ones(2, np.float32)}}),
                     "config": cfg, "format_version": 1}, f, protocol=5)
    snap = load_snapshot(p)
    assert type(snap["params"]) is dict
    np.testing.assert_array_equal(snap["params"]["linout"]["bias"], [1.0, 1.0])
    assert snap["map_embeddings"] is None


def test_snapshot_loader_refuses_foreign_classes(tmp_path):
    p = tmp_path / "evil.pkl"
    with open(p, "wb") as f:
        pickle.dump({"params": {}, "config": {}, "hook": os.system}, f)
    with pytest.raises(pickle.UnpicklingError):
        load_snapshot(p)


@pytest.mark.parametrize("impl", ["scan", "pallas"])
def test_stream_matches_jax_engine(tmp_path, rng, impl):
    """Equal window graphs and equal scores from both engines on one
    stream (warm-up, churn, an empty frame, a refresh of the
    accumulators)."""
    p = tmp_path / "snap.pkl"
    knn = "topk" if impl == "scan" else "pallas"
    _write_jax_snapshot(p, rng, gru_impl=impl, knn_impl=knn)
    want = JInferenceEngine(p, pack_size=PACK, incremental=True)
    got = InferenceEngine(p, pack_size=PACK, device="cpu")
    tol = 1e-5 if impl == "scan" else BF16_ATOL
    n_scored = 0
    for rows in _stream():
        sj = want.push_frame_rows(rows)
        st = got.push_frame_rows(rows)
        assert got.warm == want.warm
        if not got.warm:
            assert st is None
            continue
        gj, gt = want.inc_creator.window(), got.inc_creator.window()
        for f in ("x", "xsttype", "xdims", "edge_index", "pos_raw"):
            np.testing.assert_array_equal(getattr(gt, f), getattr(gj, f), err_msg=f)
        np.testing.assert_allclose(gt.edge_attr, gj.edge_attr, rtol=1e-6, atol=1e-6)
        if sj is None:
            assert st is None
            continue
        np.testing.assert_allclose(st, np.asarray(sj), rtol=0, atol=tol)
        assert st.shape == (L,)
        n_scored += 1
    assert n_scored >= 6


def test_null_wire_fields_are_served(jax_snapshot):
    """A JSON null or a missing X/Y/Speed/Angle/StationType does not kill
    the push: floats become NaN, StationType and dims 0."""
    eng = InferenceEngine(jax_snapshot, pack_size=PACK, device="cpu")
    good = dict(VehicleId=1, X=1.0, Y=2.0, Speed=3.0, Angle=0.0, Width=2.0, Length=4.0,
                StationType=3)
    bad = dict(VehicleId=2, X=None, Y=1.0, Angle=None, Width=None, Length=float("nan"),
               StationType=None)
    for _ in range(PACK):
        eng.push_frame_rows([good, bad])
    assert eng.warm
    g = eng.inc_creator.window()
    assert g.num_nodes == 2
    np.testing.assert_array_equal(g.xsttype, [3, 0])
    assert np.isnan(g.pos_raw[1, :, 0]).all()  # X null -> NaN
    assert not np.isnan(g.pos_raw[0]).any()
    raw_dims = eng.inc_creator._wl[eng.inc_creator._vid2slot[2]]
    np.testing.assert_array_equal(raw_dims, [0.0, 0.0])
    # a missing Speed also becomes NaN, not an error
    no_speed = {k: v for k, v in good.items() if k != "Speed"} | {"VehicleId": 3}
    eng.push_frame_rows([good, no_speed])
    g = eng.inc_creator.window()
    assert np.isnan(g.x[2, -1, 2]) and not np.isnan(g.x[0, -1, 2])


def test_entry_points_need_a_card_unless_cpu_is_asked(jax_snapshot, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(jax_snapshot, pack_size=PACK)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingServer(tmp_path / "f", jax_snapshot, tmp_path / "o.csv", pack_size=PACK)
    fifo = tmp_path / "f.fifo"
    fifo.write_text("")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rcv.main(["-f", str(fifo), "-p", str(PACK), "-s", str(jax_snapshot)])
    InferenceEngine(jax_snapshot, pack_size=PACK, device="cpu")


def test_streaming_server_fifo_end_to_end(jax_snapshot, tmp_path):
    frames = _stream()
    fifo = tmp_path / "frames.fifo"
    os.mkfifo(fifo)
    out_csv = tmp_path / "scores.csv"
    server = StreamingServer(fifo, jax_snapshot, out_csv, pack_size=PACK, device="cpu")
    th = threading.Thread(target=server.run)
    th.start()
    with open(fifo, "w") as w:
        for rows in frames:
            w.write(json.dumps(rows) + "\n")
            w.flush()
    th.join(timeout=120)
    assert not th.is_alive()
    lines = out_csv.read_text().strip().split("\n")
    assert lines[0] == "Score"
    assert len(lines) == 1 + len(frames) - PACK + 1

    eng = InferenceEngine(jax_snapshot, pack_size=PACK, device="cpu")
    want = [eng.push_frame_rows(rows) for rows in frames][PACK - 1:]
    for line, s in zip(lines[1:], want):
        if s is None:
            assert line == "."
        else:
            np.testing.assert_allclose([float(v) for v in line.split(",")], s, atol=2e-6)


def test_rcv_parser():
    args = rcv.build_parser().parse_args(
        ["-f", __file__, "-p", "100", "-s", __file__, "--device", "cpu"])
    assert args.pack_size == 100 and args.m_radius == 25.0 and args.device == "cpu"
    assert str(args.output_csv_file) == "out.csv"
