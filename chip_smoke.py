#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``sldm_gnn_tpu_torch/csrc`` with
``nvcc``, holds each kernel against its plain PyTorch version on the card,
times kernel, plain version and one library call at the flagship shapes,
then serves a stream through the port's ``InferenceEngine`` at the
flagship width (``bench_flagship.py``'s GruSage: 100 frames, GRU hidden
96, map on with 1000 baked segments, ``gru_impl='pallas'``,
``knn_impl='pallas'``) with random weights from a seed. It prints its
findings, a ``{"kernels": [...]}`` line, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``. Any failed check raises, and
the exit code is not 0. Without a card it exits with code 2 and prints no
result. It needs no file outside the repository and no network.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

SEED = 0
FRAMES = 100
HIDDEN = 96
FEATURES = 6
PACKS = 2048  # bench_flagship.py at FLAG_BATCH=2048: ~20k GRU rows
SEGMENTS = 1000
K = 5

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOP_S = 989e12
PEAK_F32_FLOP_S = 67e12

# tolerances, kernel vs its plain version on the same card:
#  GRU: both sum exact bf16 products in f32, in different orders, and round
#  the carry to bf16 every step; an order difference can flip one rounding
#  (one bf16 ulp, 2^-8 relative), which then propagates through the
#  remaining steps. 3e-2 absolute is the JAX package's own contract for
#  this kernel against the f32 scan (tests/test_gru_pallas.py).
#  KNN: the same rounded operations on both sides; indices must be equal
#  and distances agree to one f32 ulp.
GRU_ATOL = 3e-2
KNN_RTOL = 1.2e-7
#  serving scores (sigmoid of the logits) of the kernel engine against the
#  same engine on the plain versions, and against the f32 scan/topk engine
SCORE_ATOL = 3e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(fn, iters: int, warmup: int = 2) -> tuple[float, float]:
    """(ms per call on the card, by CUDA events around back-to-back calls;
    ms per call for the host to issue them). Where the second is the larger,
    the first measures the host, not the kernel."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, host


def bound(nbytes: float, flops: float, peak_flops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flagship_rows(rng: np.random.Generator) -> int:
    """GRU rows of a batch of PACKS packs of 8-11 vehicles, drawn as
    bench_flagship.synth_graph draws them."""
    return int(sum(int(rng.integers(8, 12)) for _ in range(PACKS)))


def gru_weights(gen: torch.Generator, d: int, h: int, dev):
    b = 1.0 / h ** 0.5
    u = lambda *s: (torch.rand(s, generator=gen) * 2 * b - b).to(dev)
    return u(d, 3 * h), u(3 * h), u(h, 3 * h), u(3 * h)


def check_gru(gru_cuda, gen, rng, dev) -> dict:
    n = flagship_rows(rng)
    x = torch.randn((n, FRAMES, FEATURES), generator=gen).to(dev)
    w = gru_weights(gen, FEATURES, HIDDEN, dev)
    got = gru_cuda.gru_fwd(x, *w)
    want = gru_cuda.gru_fwd_plain(x, *w)
    torch.cuda.synchronize()
    err = (got - want).abs()
    log(f"gru_fwd h_last N={n} T={FRAMES} D={FEATURES} H={HIDDEN}: "
        f"max_abs_err {err.max().item():.3e} mean {err.mean().item():.3e} "
        f"(tol {GRU_ATOL})")
    if not torch.isfinite(got).all() or err.max().item() > GRU_ATOL:
        raise AssertionError("gru_fwd kernel disagrees with its plain version")
    max_err = err.max().item()

    # ragged row count (not a multiple of the kernel's row block)
    xr = x[:37].contiguous()
    e = (gru_cuda.gru_fwd(xr, *w) - gru_cuda.gru_fwd_plain(xr, *w)).abs().max().item()
    log(f"gru_fwd h_last ragged N=37: max_abs_err {e:.3e}")
    if e > GRU_ATOL:
        raise AssertionError("gru_fwd kernel disagrees at N=37")
    max_err = max(max_err, e)

    # 2-layer stack: sequence mode for layer 0, strided input for layer 1
    from sldm_gnn_tpu_torch.ops.gru import GRUParams

    w1 = gru_weights(gen, HIDDEN, HIDDEN, dev)
    params = GRUParams(w[0], w[2], w[1], w[3], w1[0][None], w1[2][None],
                       w1[1][None], w1[3][None])
    hs_k = gru_cuda.gru_fwd(x, *w, seq=True)
    hs_p = gru_cuda.gru_fwd_plain(x, *w, seq=True)
    e_seq = (hs_k.float() - hs_p.float()).abs().max().item()
    h2_k = gru_cuda.gru_last_forward(params, x)
    with mock.patch.object(gru_cuda, "gru_fwd", gru_cuda.gru_fwd_plain):
        h2_p = gru_cuda.gru_last_forward(params, x)
    e2 = (h2_k - h2_p).abs().max().item()
    log(f"gru_fwd seq [T,N,H] bf16: max_abs_err {e_seq:.3e}; 2-layer h_last: {e2:.3e}")
    if e_seq > GRU_ATOL or e2 > GRU_ATOL:
        raise AssertionError("gru_fwd kernel disagrees in sequence mode")
    max_err = max(max_err, e_seq, e2)

    # a hidden width whose W_hh does not fit one block's shared memory raises
    wide = gru_weights(gen, FEATURES, 320, dev)
    try:
        gru_cuda.gru_fwd(x[:4], *wide)
    except RuntimeError as e:
        if "shared memory" not in str(e):
            raise
        log(f"gru_fwd at H=320 raises as it should: {e}")
    else:
        raise AssertionError("gru_fwd at H=320 launched past its shared memory")

    ms, _ = timed(lambda: gru_cuda.gru_fwd(x, *w), iters=20)
    xs = x[:32].contiguous()  # a served window: 32 node rows (power-of-two padding)
    serve_ms, serve_host = timed(lambda: gru_cuda.gru_fwd(xs, *w), iters=200)
    log(f"gru_fwd at N=32 (one served window): {serve_ms:.4f} ms per call on the card, "
        f"{serve_host:.4f} ms to issue it on the host")
    plain_ms, _ = timed(lambda: gru_cuda.gru_fwd_plain(x, *w), iters=3, warmup=1)
    # yardstick: cuDNN's GRU in f32 (TF32 off); the same call in bf16 is
    # printed beside it
    lib = torch.nn.GRU(FEATURES, HIDDEN, batch_first=True).to(dev)
    lib_bf16 = torch.nn.GRU(FEATURES, HIDDEN, batch_first=True).to(dev, torch.bfloat16)
    xb = x.to(torch.bfloat16)
    with torch.inference_mode():
        library_ms, _ = timed(lambda: lib(x), iters=20)
        library_bf16_ms, _ = timed(lambda: lib_bf16(xb), iters=20)
    flops = 2.0 * n * FRAMES * 3 * HIDDEN * (FEATURES + HIDDEN)
    nbytes = (x.numel() * 4 + 2 * 3 * HIDDEN * (FEATURES + HIDDEN)
              + 2 * 3 * HIDDEN * 4 + n * HIDDEN * 4)
    bound_ms, bound_by = bound(nbytes, flops, PEAK_BF16_FLOP_S)
    log(f"gru_fwd timing N={n}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"nn.GRU f32 {library_ms:.4f} ms (bf16 {library_bf16_ms:.4f} ms), bound {bound_ms:.4f} ms ({bound_by})")
    return dict(name="gru_fwd", route="cuda", source="sldm_gnn_tpu_torch/csrc/gru_fwd.cu",
                replaces="sldm_gnn_tpu/ops/gru_pallas.py:407",
                shape=f"N={n} T={FRAMES} D={FEATURES} H={HIDDEN} h_last",
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, serve_shape_ms=serve_ms)


def check_knn(knn_ops, gen, rng, dev) -> dict:
    max_err = 0.0

    def compare(pts, cts, what):
        nonlocal max_err
        d_k, i_k = knn_ops.knn_topk_fused(pts, cts, K)
        d_p, i_p = knn_ops.knn_topk_plain(pts, cts, K)
        torch.cuda.synchronize()
        if not torch.equal(i_k, i_p):
            bad = (i_k != i_p).any(dim=1).sum().item()
            raise AssertionError(f"knn_topk kernel indices differ ({what}): {bad} rows")
        err = (d_k - d_p).abs().max().item()
        rel = ((d_k - d_p).abs() / d_p.abs().clamp_min(1e-30)).max().item()
        log(f"knn_topk {what}: indices equal, max_abs_err {err:.3e} max_rel {rel:.3e}")
        if rel > KNN_RTOL:
            raise AssertionError(f"knn_topk kernel distances disagree ({what})")
        max_err = max(max_err, err)

    v = flagship_rows(rng)
    pts = (torch.randn((v, 2), generator=gen) * 100).to(dev)
    cts = (torch.randn((SEGMENTS, 2), generator=gen) * 100).to(dev)
    compare(pts, cts, f"V={v} S={SEGMENTS} k={K}")
    big = (torch.randn((5000, 2), generator=gen) * 100).to(dev)
    compare(pts, big, f"V={v} S=5000 k={K} (3 shared-memory chunks)")
    dup = cts.clone()
    dup[500] = dup[10]
    dup[777] = dup[10]
    dup[999] = dup[10]
    tie_pts = pts.clone()
    tie_pts[: v // 2] = dup[10] + torch.randn((v // 2, 2), generator=gen).to(dev) * 1e-3
    compare(tie_pts, dup, f"V={v} S={SEGMENTS} k={K} duplicate-centroid ties")

    ms, host = timed(lambda: knn_ops.knn_topk_fused(pts, cts, K), iters=50)
    log(f"knn_topk V={v}: host {host:.4f} ms to issue one call")
    ps = pts[:32].contiguous()
    serve_ms, serve_host = timed(lambda: knn_ops.knn_topk_fused(ps, cts, K), iters=200)
    log(f"knn_topk at V=32 (one served window): {serve_ms:.4f} ms per call on the card, "
        f"{serve_host:.4f} ms to issue it on the host")
    plain_ms, _ = timed(lambda: knn_ops.knn_topk_plain(pts, cts, K), iters=10)
    library_ms, _ = timed(lambda: torch.topk(torch.cdist(pts, cts), K, dim=1, largest=False),
                         iters=50)
    flops = 5.0 * v * SEGMENTS
    nbytes = v * 2 * 4 + SEGMENTS * 2 * 4 + v * K * 8
    bound_ms, bound_by = bound(nbytes, flops, PEAK_F32_FLOP_S)
    log(f"knn_topk timing V={v} S={SEGMENTS}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"cdist+topk {library_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
    return dict(name="knn_topk", route="cuda", source="sldm_gnn_tpu_torch/csrc/knn_topk.cu",
                replaces="sldm_gnn_tpu/ops/knn_pallas.py:123",
                shape=f"V={v} S={SEGMENTS} k={K}",
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, serve_shape_ms=serve_ms)


def write_snapshot(path: Path, gru_impl: str, knn_impl: str) -> None:
    """A flagship-width snapshot with random weights from SEED and a baked
    map of SEGMENTS segments (8-wide embeddings)."""
    from sldm_gnn_tpu_torch.interop import state_dict_to_params
    from sldm_gnn_tpu_torch.models.grusage import GruSage, GruSageConfig
    from sldm_gnn_tpu_torch.serve.snapshot import save_snapshot

    cfg = GruSageConfig(
        frames_num=FRAMES, gru_hidden_size=HIDDEN, fc1dims=(HIDDEN,),
        sage_hidden_dims=(HIDDEN, HIDDEN), fc2dims=(32,), out_dim=4, emb_dim=8,
        dropout=0.25, negative_slope=0.1, map_included=True, map_attention_topk=K,
        gru_impl=gru_impl, knn_impl=knn_impl)
    gen = torch.Generator().manual_seed(SEED)
    model = GruSage(cfg)
    model.reset_parameters(gen)
    emb = torch.randn((SEGMENTS, cfg.mapenc_sage_hdims[-1]), generator=gen).numpy()
    cen = (torch.randn((SEGMENTS, 2), generator=gen) * 100).numpy()
    norm = {"mu": {"x": np.zeros(5, np.float32), "xdims": np.array([2.0, 4.5], np.float32)},
            "sigma": {"x": np.array([50, 50, 10, 1, 1], np.float32),
                      "xdims": np.array([0.3, 0.5], np.float32)}}
    save_snapshot(path, params=state_dict_to_params(model), config=cfg,
                  norm_stat_dict=norm, map_embeddings=emb, map_centroids=cen)


def wire_stream(n_frames: int = 120, n_vehicles: int = 24) -> list[list[dict]]:
    """~20 vehicles a frame, as JSON rows; vehicles enter and leave."""
    rng = np.random.default_rng(SEED)
    start = rng.integers(-30, 40, n_vehicles)
    life = rng.integers(60, 200, n_vehicles)
    x0 = rng.uniform(-100, 100, n_vehicles)
    y0 = rng.uniform(-100, 100, n_vehicles)
    heading = rng.uniform(0, 360, n_vehicles)
    speed = rng.uniform(3, 15, n_vehicles)
    dims = rng.uniform([1.6, 3.8], [2.4, 5.2], (n_vehicles, 2))
    frames = []
    for t in range(n_frames):
        rows = []
        for v in range(n_vehicles):
            if not start[v] <= t < start[v] + life[v]:
                continue
            a = np.deg2rad(heading[v] + 0.5 * t)
            rows.append({
                "VehicleId": int(1000 + v),
                "X": float(x0[v] + 0.1 * speed[v] * t * np.cos(a)),
                "Y": float(y0[v] + 0.1 * speed[v] * t * np.sin(a)),
                "Speed": float(speed[v]), "Angle": float(heading[v] + 0.5 * t),
                "Width": float(dims[v, 0]), "Length": float(dims[v, 1]),
                "StationType": 5,
            })
        frames.append(rows)
    return frames


def serve(engine, frames) -> tuple[np.ndarray, list[float]]:
    """Push every frame; the scores of the warm windows and their host
    times (each ends in a copy of the scores to the host)."""
    scores, times = [], []
    for rows in frames:
        t0 = time.perf_counter()
        s = engine.push_frame_rows(rows)
        if engine.warm:
            times.append((time.perf_counter() - t0) * 1e3)
            if s is None:
                raise AssertionError("a warm window with vehicles scored nothing")
            scores.append(s)
    return np.stack(scores), times


def check_serving(gru_cuda, knn_ops, tmp: Path, dev) -> dict:
    from sldm_gnn_tpu_torch.serve.stream import InferenceEngine

    frames = wire_stream()
    log(f"serve: {len(frames)} frames, {np.mean([len(f) for f in frames]):.1f} vehicles "
        f"a frame, window {FRAMES}")
    snap = tmp / "flagship.pkl"
    write_snapshot(snap, "pallas", "pallas")

    engine = InferenceEngine(snap, pack_size=FRAMES, device=dev)
    gru_cuda.gru_fwd.launches = 0
    knn_ops.knn_topk_fused.launches = 0
    scores, times = serve(engine, frames)
    launches = {"gru_fwd": gru_cuda.gru_fwd.launches,
                "knn_topk": knn_ops.knn_topk_fused.launches}
    log(f"serve: {len(scores)} windows scored, launches {launches}, host ms/window "
        f"max {np.max(times):.3f} (the first, with warm-up)")
    if scores.shape != (len(frames) - FRAMES + 1, 4) or not np.isfinite(scores).all() \
            or scores.min() < 0 or scores.max() > 1:
        raise AssertionError(f"bad scores: shape {scores.shape}, range "
                             f"[{scores.min()}, {scores.max()}]")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"serving never launched the {name} kernel")

    # host share of a window: the graph update alone, on a fresh creator
    from sldm_gnn_tpu_torch.build.online import IncrementalGraphOnlineCreator

    creator = IncrementalGraphOnlineCreator(FRAMES, 25.0,
                                            norm_stats=engine.inc_creator.norm_stats)
    graph_ms = []
    for rows in frames:
        t0 = time.perf_counter()
        creator.push_arrays([r["VehicleId"] for r in rows],
                            *[np.array([r[c] for r in rows], np.float32)
                              for c in ("X", "Y", "Speed", "Angle", "Width", "Length")],
                            np.array([r["StationType"] for r in rows], np.int32))
        if creator.warm:
            creator.window()
            graph_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"serve: host ms/window p50 {np.median(times):.3f}, of which the graph update "
        f"(push + window) p50 {np.median(graph_ms):.3f}; the rest is batching, copies "
        f"and the model")

    plain_engine = InferenceEngine(snap, pack_size=FRAMES, device=dev)
    with mock.patch.object(gru_cuda, "gru_fwd", gru_cuda.gru_fwd_plain), \
            mock.patch.object(knn_ops, "knn_topk_fused", knn_ops.knn_topk_plain):
        plain_scores, _ = serve(plain_engine, frames)
    e_plain = np.abs(scores - plain_scores).max()
    ref_snap = tmp / "flagship_f32.pkl"
    write_snapshot(ref_snap, "scan", "topk")
    ref_scores, _ = serve(InferenceEngine(ref_snap, pack_size=FRAMES, device=dev), frames)
    e_ref = np.abs(scores - ref_scores).max()
    log(f"serve: scores vs plain versions on the card max_abs {e_plain:.3e}, vs the f32 "
        f"scan/topk engine {e_ref:.3e} (tol {SCORE_ATOL}); scores in "
        f"[{scores.min():.4f}, {scores.max():.4f}]")
    if e_plain > SCORE_ATOL or e_ref > SCORE_ATOL:
        raise AssertionError("serving scores disagree with the plain versions")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run",
              file=sys.stderr)
        return 2
    from sldm_gnn_tpu_torch.ops import _build, gru_cuda
    from sldm_gnn_tpu_torch.ops import knn as knn_ops

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    log(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.load()
    log(f"build: {time.perf_counter() - t0:.1f} s wall"
        + (f" (nvcc {_build.build_seconds:.1f} s)" if _build.build_seconds else " (cached)"))
    for line in (_build.build_log or "").splitlines():
        if "ptxas info" in line and ("Used" in line or "Compiling" in line):
            log("  " + line.strip())

    gen = torch.Generator().manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    entries = [check_gru(gru_cuda, gen, rng, dev), check_knn(knn_ops, gen, rng, dev)]

    with tempfile.TemporaryDirectory() as tmp:
        launches = check_serving(gru_cuda, knn_ops, Path(tmp), dev)
    for e in entries:
        e["launches"] = launches[e["name"]]
    log(f"total wall {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
