#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``sldm_gnn_tpu_torch/csrc`` with
``nvcc`` (one process per source, in parallel), holds each kernel against
its plain PyTorch version on the card (and two launches against each
other, bit for bit), and times kernel, plain version and one library call
at the main paths' shapes. Then it drives the port's paths, with every
launch count set to 0 just before a path and read just after it:

  * serving GruSage at the flagship width (``bench_flagship.py``: 100
    frames, GRU hidden 96, FC1 96, SAGE 96x2, FC2 32, 4 labels, top-5 map
    attention, ``knn_impl='pallas'``): a 120-frame wire stream through
    ``InferenceEngine``, from a snapshot with random weights and 1000
    baked map segments (``gru_impl='pallas'``);
  * training GruSage: ``build_step_fns`` on 2048 synthetic graphs of 8-11
    vehicles with a live 1000-segment map, once with ``gru_impl=
    'pallas_sg'`` and once with ``'pallas'``: one step's gradients through
    the kernels against the same step through the plain versions, then 20
    steps with dropout 0.25; the trained ``'pallas_sg'`` model is saved
    with baked map embeddings and serves the same stream. The GRU backward
    is also checked at H=128 (D=6 and D=128) and at D=96 with the
    per-frame cotangent (the upper layer of a stack);
  * bench.py's two-layer fused GraphSAGE step (``banded_residual+fused``:
    200 000 nodes, 3.2M edges of reach 256, D=H=128, bf16, ReLU, tile 128,
    K=12, count_cap 7): one step's gradients through the kernels against
    the plain versions, then 20 steps (p50 ms/step and edges/s);
  * ``BlockedSageClassifier((128, 128), num_classes=4)`` on the same graph,
    20 Adam steps with ``fused_ln`` on the banded-residual layout and 20
    unfused on the pure banded layout; the loss must fall. The unfused
    model's weights then run inference with ``int8_features=True`` (the
    int8 banded kernel): bit-equal to its plain version, within 5e-2 of
    max|logit| of the f32 path;
  * the same pure banded layouts widened (``widen_banded``, the TPU
    kernel's ``wide`` branch): the kernel on them bit-equal to the narrow
    kernel both ways and timed beside it, bench.py's ``BENCH_SPMM=banded
    BENCH_FUSED=0 BENCH_BANDED_WIDE=1`` two-layer step (20 steps) and the
    unfused classifier (20 Adam steps) on them;
  * the halo overlap layers (``parallel/halo_fused``, what
    ``cli/train_halo.py --fused-ln`` runs) on the same graph planned for 4
    shards (``banded_k=8``, hidden 96), run one shard after another on
    this card, each shard's halo table gathered from the global x in place
    of the all-to-all (not ported yet): ``halo_fused_sage_ln_ov`` and
    ``halo_fused_sage_ov`` forward and backward against the plain versions,
    the fused forward's ``ypre`` output, the four shards put back together
    against the one-chip layer, and times on the shard with the most
    boundary groups;
  * the same graph as bench.py's one-hot (tile 512, 512-slot chunks, 2 a
    step), dense (int8 counts, tile 128, 4-block padding), hybrid
    (min_pair_edges 300) and gather (tile 128, K=12, R=24) layouts: the one-hot,
    dense and gather kernels (and the int8 banded kernel) against their
    plain versions and timed; bench.py's two-layer step on each layout (one
    step's gradients against the plain versions, then 20 steps); and the
    classifier, 20 Adam steps on the one-hot layout (``k_per_step=2``) and
    20 on the hybrid;
  * int8 aggregation and SDDMM on the same graph: ``x [200192, 128]``
    quantized per row (``quantize_rows``, round to nearest and stochastic)
    and per tensor, ``spmm_int8`` and ``spmm_int8_pt`` over the one-hot
    layout (2 chunks a step), and ``sddmm_apply`` forward and backward over
    ``prepare_sddmm``'s layouts (the backward through the one-hot kernel):
    each new kernel against its plain version, two launches bit-equal, the
    outputs against the f32 references, timed against a library call; and
    the RCM reorder of the graph shuffled as ``BENCH_SHUFFLE=1`` does;
  * the v1 GRU scan (``gru_forward_v1``) at the flagship training batch's
    rows, one and two layers, forward and backward against the f32 scan
    under autograd, its widest H probed, timed against cuDNN's f32 GRU;
  * GruSage's other paths on the training batch: the aligned batch
    (``pad_and_batch_aligned``, vmax 11) with ``MapData.adj`` against the
    flat batch, ``compute_dtype='bfloat16'`` against f32, and
    ``sage_type='attention'``, 20 steps each;
  * the megakernel SpMM (``spmm_mk``, both modes) on bench.py's graph;
  * the cmap tier on a scattered low-degree graph of 200 064 nodes
    (``tests/test_spmm_cmap.py``'s generator): its four banded kernels,
    bench.py's fused step and the classifier (``fused_ln`` and unfused);
  * after the k-NN check, a sweep of ``knn_topk`` at V of 1 to 19 430, k of
    1 to 128, S from k to 5000, on integer-grid data (exact distance ties)
    and on copies of one centroid 1, 32, 33 and 256 places apart, indices
    equal to the plain version's;
  * before the banded phases, a sweep of the banded tensor-core kernels
    (``spmm_banded``, the fused forward ``banded_sage_fwd`` and the reverse
    kernel of ``banded_sage_bwd`` / ``banded_sage_ln_bwd``) over ragged
    shapes on a small graph: tiles 32, 64 and 128, widths (D, H) of (40,
    4), (4, 40) and (128, 96), f32 and bf16, int8 counts and f32 weights,
    with and without scales, x and the residual, the forward's bias,
    LayerNorm, activation and ``ypre`` output, and a cmap layout; each
    against its plain version; and ``spmm_banded`` on wide layouts (tiles
    32-128, spans 1-8), each case bit-equal to the narrow kernel. Then the
    dense SpMM over the same tiles, D 4, 40, 96 and 128, int8, f32 and
    bf16 tiles, both directions, with and without a row scale, and layouts
    of 1, 5 and 70 slots a block;
  * after the GRU checks, a sweep of ``gru_fwd`` (h_last and seq) and
    ``gru_fwd_sg`` at N of 1 to 19 558, H of 16, 40, 96, 128 and each D's
    widest, D of 6, 96 and 128, against their plain versions, with the
    kernel each width routes to (tensor cores or FMA) printed; then the
    backwards' sweep (``check_gru_bwd_sweep``) at D 6, 40, 128 and 160,
    and the v1 backward's (``check_gru_scan_bwd_sweep``: N of 1 to 19 558
    around its row tiles, T of 1, 2 and 100, H of 8 to its widest, strided
    xproj and g, and ``gru_forward_v1`` at one and two layers);
  * after the int8 banded sweep, the gather kernel's (``check_gather_sweep``:
    tiles 32, 64 and 128, R of 1 to 32, D of 1 to 128, bf16 and f32, with
    and without a row scale, both directions, padding slots and an
    infinite x row), bit-equal to its plain version.

``python3 chip_smoke.py --gru-bwd-ms`` only times both GRU backwards at a
stack's upper layer (the flagship's rows, D=H=128), so a copy of this file
in a checkout of an earlier version times that version at the same inputs.

Times are the card's: where the host takes about as long to launch a call
as the card to run it (the k-NN and GRU kernels and their library calls at
one served window), the calls are replayed from a CUDA graph
(``device_ms``).

It prints its findings, a ``{"kernels": [...]}`` line, the card's name and
power limit, and last ``{"ok": true, "device": {...}}``. Any failed check
raises, and the exit code is not 0. Without a card it exits with code 2
and prints no result. It needs no file outside the repository and no
network.
"""

from __future__ import annotations

import dataclasses
import itertools
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
LABELS = 4
TRAIN_STEPS = 20
MAP_FEATS = 9

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOP_S = 989e12
PEAK_F32_FLOP_S = 67e12
PEAK_TF32_FLOP_S = 495e12
PEAK_INT8_OP_S = 1979e12

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
#  GRU backward: both round dxp/dhp to bf16 before every product and sum
#  exact bf16 products in f32, in different orders; an order difference
#  can flip one bf16 rounding of a dxp/dhp value. 1e-2 * max|g| per output
#  is the JAX package's own bound for its plain XLA twin.
GRAD_RTOL = 1e-2
#  store-gates forward: its gates against the same gates recomputed in plain
#  PyTorch from the kernel's own hs, within one bf16 ulp of the larger
#  value; the ulp is floored at 2^-20, the f32 rounding noise of a gate's
#  pre-activation of size ~8, which decides the rounding of a value that
#  cancels to near zero (tanh of a near-zero sum).
GATE_ULP_FLOOR = 2.0 ** -20
#  training step through the kernels vs through the plain versions on the
#  card: the JAX package's whole-model contract for its GRU kernels
#  (tests/test_gru_pallas.py:236-246), per parameter rtol 5e-2 and atol
#  5e-2 * (max|g| + 1e-6). The 1e-6 floor matters where the exact gradient
#  vanishes: the attention's softmax over the K neighbours makes the
#  gradient of its score bias exactly zero and that of the distance MLP's
#  first layer nearly so, leaving only rounding noise to compare.
STEP_GRAD_TOL = 5e-2
STEP_GRAD_FLOOR = 1e-6
#  serving scores (sigmoid of the logits) of the kernel engine against the
#  same engine on the plain versions, and against the f32 scan/topk engine
SCORE_ATOL = 3e-2

# bench.py's default (banded_residual+fused, BENCH_r05.json): a local graph
# of 200 000 nodes with 16 in-edges each of reach 256 (make_local_graph),
# D = H = 128, bf16 activations, tile 128, K = 12, count_cap 7
BENCH_NODES = 200_000
BENCH_DEG = 16
BENCH_REACH = 256
BENCH_DIM = 128
BANDED_TILE = 128
BANDED_K = 12
COUNT_CAP = 7
BENCH_STEPS = 20
CLS_CLASSES = 4
CLS_STEPS = 20
#  banded kernels vs their plain versions: the same bf16 roundings, f32
#  sums in another order, which can flip one bf16 rounding of an
#  intermediate (the aggregate before @ Wl, t before dx and dW, an output
#  at bf16): 2^-8 = 3.9e-3 relative of that value. max|err| / max|plain|
#  within 1e-2, the CPU tests' bound against the Pallas interpret kernels.
BANDED_REL = 1e-2
# bench.py's other layouts of the same graph: one-hot (BENCH_SPMM=onehot:
# BENCH_TILE 512, BENCH_EDGE_CHUNK 512, BENCH_K_PER_STEP 2), dense (int8
# counts, tile 128, BENCH_DENSE_K 4), gather (tile 128, K 12) and hybrid.
# At bench.py's BENCH_HYBRID_MIN of 64 every block pair of this graph is
# dense (the smallest has 191 edges); 300 sends the outer pairs, about a
# quarter of the edges, to the one-hot half.
# The gather builder's own slot cap stops at 16 sources a row, which leaves
# about a tenth of this graph's edges out (its in-degree is 16, its
# out-degree varies about 16; 9.6 % at 20 000 nodes) and raises, in the JAX
# package too; bench.py's BENCH_GATHER_R=24 leaves 0.3 % in the residual.
GATHER_R = 24
ONEHOT_TILE = 512
ONEHOT_CHUNK = 512
ONEHOT_K = 2
DENSE_K = 4
HYBRID_MIN = 300
#  the dense kernel vs its plain version with f32 output: the
#  same products, f32 sums in another order; 1e-5 of max|out| (the CPU
#  tests' bound against the Pallas interpret kernels). With bf16 output
#  BANDED_REL. The one-hot, gather and int8 banded kernels sum in the plain
#  versions' order (or exactly): bit-equal.
AGG_F32_REL = 1e-5
#  int8-feature logits vs the f32 path: the per-tensor quantization error,
#  5e-2 of max|logit| (tests/test_blocked_sage.py:145)
INT8_REL = 5e-2
# the int8 and SDDMM phase: the one-hot layout above for the int8
# aggregations (bench.py's BENCH_SPMM=onehot), prepare_sddmm's layouts
# (tile 128, auto_edge_chunk's 256-slot chunks) of the same graph for the
# SDDMM; the stochastic quantizer at seed 0, and the reorder of the graph
# shuffled by bench.py's BENCH_SHUFFLE permutation (default_rng(2)).
#  quantizer kernel vs its plain version: the same IEEE divisions and hash
#  bits, bit-equal. int8 aggregations: the same products summed in another
#  order (index_add_ on the card), AGG_F32_REL of max|out|; against the f32
#  aggregation of the unquantized x, the JAX tests' 5e-2 of max|out|
#  (tests/test_spmm.py:316). SDDMM: the same products in the same order,
#  SDDMM_REL of max|score| (in fact bit-equal); its gradients, which run the
#  one-hot kernel at DEFAULT precision (bf16 cotangent and rows), at the
#  STEP_GRAD_TOL scale.
QUANT_SEED = 0
SHUFFLE_SEED = 2
SDDMM_REL = 1e-5
# The v1 GRU scan (f32 throughout) against the f32 scan under
# autograd: the JAX package's contract for gru_scan_pallas
# (tests/test_gru_pallas.py:14-66): outputs at rtol/atol 1e-5; gradients
# at rtol 2e-4 (one layer) and 5e-4 (two) plus that times max|g| + 1e-6
# (f32 sums in another order, compounded over 100 frames).
SCAN_TOL = 1e-5
SCAN_GRAD_TOL = {1: 2e-4, 2: 5e-4}
# the megakernel layout of bench.py's graph: block_edges at tile 128 and
# chunks of 256 slots (auto_edge_chunk's choice), mean weights
MK_CHUNK = 256
# the cmap tier's graph: tests/test_spmm_cmap.py's scattered low-degree
# generator at 200 064 nodes and bench.py's degree 16
CMAP_NODES = 200_064
# GruSage's aligned batch: the flagship packs hold at most 11 vehicles; the
# aligned logits against the flat ones at the JAX test's 2e-5
# (tests/test_model_parity.py:262); bf16 compute against f32 at its 0.1 /
# 0.05 (:259)
ALIGNED_VMAX = 11
DENSE_TOL = 2e-5
BF16_RTOL, BF16_ATOL = 0.1, 0.05


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


def graph_ms(fn, iters: int, reps: int = 5) -> float:
    """ms per call on the card of `iters` calls of fn captured in one CUDA
    graph and replayed `reps` times: no host work between the calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream, as capture asks
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def device_ms(fn, iters: int, what: str) -> float:
    """ms per call on the card: timed() where the host launches a call well
    within the card's time for it; else (the events then time the host)
    the same calls replayed from a CUDA graph, both logged."""
    ms, host = timed(fn, iters)
    if host < 0.8 * ms:
        return ms
    g = graph_ms(fn, iters)
    log(f"  {what}: {ms:.4f} ms a call by events around launched calls (host {host:.4f} ms "
        f"a call), {g:.4f} ms replayed from a CUDA graph")
    return g


def bound(nbytes: float, flops: float, peak_flops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gru_fwd_cost(n: int, d: int, h: int) -> tuple[float, float]:
    """(bytes, operations) of the GRU forward's h_last: x read once, both
    weights and biases, h_last written; both projections every frame."""
    nbytes = n * FRAMES * d * 4 + 2 * 3 * h * (d + h) + 2 * 3 * h * 4 + n * h * 4
    return nbytes, 2.0 * n * FRAMES * 3 * h * (d + h)


def gru_chain_floor_ms(d: int, h: int) -> float:
    """The least time of the forward's FRAMES dependent steps in the
    tensor-core kernel's design: one SM takes a 64-row tile, and each step's
    carry product (64 x Hp by Hp x 3Hp, Hp = H padded to 32) cannot start
    before the last step's carry exists; at one SM's share of the bf16 peak.
    The input product, gate math and barrier come on top."""
    hp = -(-h // 32) * 32
    sm_peak = PEAK_BF16_FLOP_S / torch.cuda.get_device_properties(0).multi_processor_count
    return FRAMES * 2.0 * 64 * 3 * hp * hp / sm_peak * 1e3


def knn_cost(v: int) -> tuple[float, float]:
    nbytes = v * 2 * 4 + SEGMENTS * 2 * 4 + v * K * 8
    return nbytes, 5.0 * v * SEGMENTS


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
    serve_ms = device_ms(lambda: gru_cuda.gru_fwd(xs, *w), 200, "gru_fwd at N=32")
    serve_plain_ms, _ = timed(lambda: gru_cuda.gru_fwd_plain(xs, *w), iters=5, warmup=1)
    serve_bound_ms, serve_bound_by = bound(*gru_fwd_cost(32, FEATURES, HIDDEN), PEAK_BF16_FLOP_S)
    chain_ms = gru_chain_floor_ms(FEATURES, HIDDEN)
    lib32 = torch.nn.GRU(FEATURES, HIDDEN, batch_first=True).to(dev)
    with torch.inference_mode():
        serve_library_ms = device_ms(lambda: lib32(xs), 200, "nn.GRU f32 at N=32")
    log(f"gru_fwd at N=32 (one served window): {serve_ms:.4f} ms per call on the card; plain "
        f"{serve_plain_ms:.4f} ms; bound "
        f"{serve_bound_ms:.6f} ms ({serve_bound_by}); the design's chain floor {chain_ms:.4f} ms; "
        f"nn.GRU f32 at N=32 {serve_library_ms:.4f} ms")
    plain_ms, _ = timed(lambda: gru_cuda.gru_fwd_plain(x, *w), iters=3, warmup=1)
    # yardstick: cuDNN's GRU in f32 (TF32 off); the same call in bf16 is
    # printed beside it
    lib = torch.nn.GRU(FEATURES, HIDDEN, batch_first=True).to(dev)
    lib_bf16 = torch.nn.GRU(FEATURES, HIDDEN, batch_first=True).to(dev, torch.bfloat16)
    xb = x.to(torch.bfloat16)
    with torch.inference_mode():
        library_ms, _ = timed(lambda: lib(x), iters=20)
        library_bf16_ms, _ = timed(lambda: lib_bf16(xb), iters=20)
    bound_ms, bound_by = bound(*gru_fwd_cost(n, FEATURES, HIDDEN), PEAK_BF16_FLOP_S)
    log(f"gru_fwd timing N={n}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"nn.GRU f32 {library_ms:.4f} ms (bf16 {library_bf16_ms:.4f} ms), bound {bound_ms:.4f} ms ({bound_by})")
    return dict(name="gru_fwd", route="cuda", source="sldm_gnn_tpu_torch/csrc/gru_fwd.cu",
                replaces="sldm_gnn_tpu/ops/gru_pallas.py:407",
                shape=f"N={n} T={FRAMES} D={FEATURES} H={HIDDEN} h_last",
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, serve_shape_ms=serve_ms,
                serve_shape_plain_ms=serve_plain_ms, serve_shape_bound_ms=serve_bound_ms,
                serve_shape_library_ms=serve_library_ms)


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

    ms = device_ms(lambda: knn_ops.knn_topk_fused(pts, cts, K), 50, f"knn_topk at V={v}")
    ps = pts[:32].contiguous()
    serve_ms = device_ms(lambda: knn_ops.knn_topk_fused(ps, cts, K), 200, "knn_topk at V=32")
    serve_plain_ms, _ = timed(lambda: knn_ops.knn_topk_plain(ps, cts, K), iters=50)
    serve_bound_ms, serve_bound_by = bound(*knn_cost(32), PEAK_F32_FLOP_S)
    serve_library_ms = device_ms(
        lambda: torch.topk(torch.cdist(ps, cts), K, dim=1, largest=False), 200,
        "cdist+topk at V=32")
    log(f"knn_topk at V=32 (one served window, {knn_ops.knn_topk_warps(32)} warps a point): "
        f"{serve_ms:.4f} ms per call on the card; plain {serve_plain_ms:.4f} ms; bound "
        f"{serve_bound_ms:.7f} ms ({serve_bound_by}); cdist+topk at V=32 {serve_library_ms:.4f} "
        f"ms")
    plain_ms, _ = timed(lambda: knn_ops.knn_topk_plain(pts, cts, K), iters=10)
    library_ms = device_ms(lambda: torch.topk(torch.cdist(pts, cts), K, dim=1, largest=False),
                           50, f"cdist+topk at V={v}")
    bound_ms, bound_by = bound(*knn_cost(v), PEAK_F32_FLOP_S)
    log(f"knn_topk timing V={v} S={SEGMENTS}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"cdist+topk {library_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
    return dict(name="knn_topk", route="cuda", source="sldm_gnn_tpu_torch/csrc/knn_topk.cu",
                replaces="sldm_gnn_tpu/ops/knn_pallas.py:123",
                shape=f"V={v} S={SEGMENTS} k={K}",
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, serve_shape_ms=serve_ms,
                serve_shape_plain_ms=serve_plain_ms, serve_shape_bound_ms=serve_bound_ms,
                serve_shape_library_ms=serve_library_ms)


# the k-NN sweep: point counts around one warp's width, those that take 2
# and 4 warps a point on 132 SMs, and the training batch's; k on one list
# row a lane (<= 32) and on four (above); S from k up, below 32, not a
# multiple of 32, past one shared-memory chunk (2048)
KNN_SWEEP_V = (1, 31, 32, 33, 300, 700, 19430)
KNN_SWEEP_K = (1, 5, 8, 9, 32, 33, 128)
KNN_SWEEP_S = (20, 37, 1000, 5000)


def check_knn_sweep(knn_ops, dev) -> int:
    """knn_topk_fused against knn_topk_plain over KNN_SWEEP_V x KNN_SWEEP_K x
    S of k and KNN_SWEEP_S (those >= k), so every warps-a-point choice, on
    two kinds of data: centroids on a small integer grid (exact d2 ties
    between different centroids everywhere) with points on it, and spread
    centroids with copies of centroid 0 at 1, 32, 33 and 256 (ties within
    one batch of 32, between batches and between warps) and points near
    it. Indices equal, distances within KNN_RTOL. Returns the number of
    cases held."""
    rng = np.random.default_rng(SEED)
    n_cases, t0 = 0, time.perf_counter()
    warps = {v: knn_ops.knn_topk_warps(v) for v in KNN_SWEEP_V}
    for v, k in itertools.product(KNN_SWEEP_V, KNN_SWEEP_K):
        for S, kind in itertools.product(sorted({k, *(n for n in KNN_SWEEP_S if n >= k)}),
                                         ("grid", "copies")):
            if kind == "grid":
                cts = rng.integers(-6, 7, (S, 2)).astype(np.float32)
                pts = rng.integers(-6, 7, (v, 2)).astype(np.float32)
            else:
                cts = (rng.standard_normal((S, 2)) * 100).astype(np.float32)
                for off in (1, 32, 33, 256):
                    if off < S:
                        cts[off] = cts[0]
                pts = (cts[0] + rng.standard_normal((v, 2)) * 1e-3).astype(np.float32)
            p, c = torch.from_numpy(pts).to(dev), torch.from_numpy(cts).to(dev)
            d_k, i_k = knn_ops.knn_topk_fused(p, c, k)
            d_p, i_p = knn_ops.knn_topk_plain(p, c, k)
            torch.cuda.synchronize()
            rel = ((d_k - d_p).abs() / d_p.abs().clamp_min(1e-30)).max().item()
            if not torch.equal(i_k, i_p) or rel > KNN_RTOL:
                bad = (i_k != i_p).any(dim=1).sum().item()
                raise AssertionError(f"knn sweep V={v} S={S} k={k} {kind}: {bad} rows' indices "
                                     f"differ, max_rel {rel:.3e} (tol {KNN_RTOL})")
            n_cases += 1
    log(f"knn sweep: {n_cases} cases, indices equal, distances within {KNN_RTOL}; warps a point "
        + ", ".join(f"V={v}: {w}" for v, w in warps.items())
        + f"; {time.perf_counter() - t0:.1f} s")
    return n_cases


def gates_from_hs(gru_cuda, x, hs, w_ih, b_ih, w_hh, b_hh) -> torch.Tensor:
    """Plain PyTorch gates r|z|n|hn [T, N, 4H] bf16 of every frame, from
    hs[t-1] (the forward's own carry), as the store-gates forward forms them."""
    xb = x.to(torch.bfloat16).float().transpose(0, 1)
    hprev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]]).float()
    xp = torch.matmul(xb, w_ih.to(torch.bfloat16).float()) + b_ih
    hp = torch.matmul(hprev, w_hh.to(torch.bfloat16).float()) + b_hh
    return torch.cat(gru_cuda._gates_math(xp, hp), dim=-1).to(torch.bfloat16)


def beyond_one_ulp(a: torch.Tensor, b: torch.Tensor) -> tuple[int, float]:
    """(values of a and b further apart than one bf16 ulp of the larger,
    floored at GATE_ULP_FLOOR; max abs difference)."""
    a, b = a.float(), b.float()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    ulp = torch.ldexp(torch.ones_like(a), e - 8).clamp_min(GATE_ULP_FLOOR)
    d = (a - b).abs()
    return int((d > ulp).sum().item()), d.max().item()


def grad_errors(got, want) -> list[float]:
    """max|got - want| / max|want| of each output that is not None."""
    return [((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
            for a, b in zip(got, want) if b is not None]


def compare(name, kernel, plain, shape) -> float:
    """A GRU backward kernel against its plain version (and two launches
    against each other); returns the max abs error."""
    got = kernel()
    want = plain()
    again = kernel()
    torch.cuda.synchronize()
    errs = grad_errors(got, want)
    stable = all(torch.equal(a, b) for a, b in zip(got, again) if a is not None)
    abs_err = max((a - b).abs().max().item() for a, b in zip(got, want) if b is not None)
    log(f"{name} {shape}: max|err|/max|g| per output {['%.2e' % e for e in errs]} "
        f"(tol {GRAD_RTOL}); two launches bit-equal {stable}")
    if max(errs) > GRAD_RTOL or not stable or not all(
            torch.isfinite(a).all() for a in got if a is not None):
        raise AssertionError(f"{name} kernel disagrees with its plain version ({shape})")
    return abs_err


def check_gru_training_kernels(gru_cuda, gen, dev) -> list[dict]:
    """The store-gates forward and both backwards at the flagship shape
    (h_last cotangent, no dx: GruSage's use), with dx and the per-frame
    cotangent at a smaller N, and at a ragged N; bit-stability across two
    launches; times against their plain versions and cuDNN's GRU."""
    n = flagship_rows(np.random.default_rng(SEED))  # the GRU rows of check_gru
    x = torch.randn((n, FRAMES, FEATURES), generator=gen).to(dev)
    w = gru_weights(gen, FEATURES, HIDDEN, dev)
    g = torch.randn((n, HIDDEN), generator=gen).to(dev)

    hs, gates = gru_cuda.gru_fwd_sg(x, *w)
    hs_v2 = gru_cuda.gru_fwd(x, *w, seq=True)
    hs_p, _ = gru_cuda.gru_fwd_sg_plain(x, *w)
    torch.cuda.synchronize()
    if not torch.equal(hs, hs_v2):
        raise AssertionError("gru_fwd_sg's hs differs from gru_fwd's (must be bit-equal)")
    e_hs = (hs.float() - hs_p.float()).abs().max().item()
    off, e_gates = beyond_one_ulp(gates, gates_from_hs(gru_cuda, x, hs, *w))
    hs2, gates2 = gru_cuda.gru_fwd_sg(x, *w)
    stable = torch.equal(hs, hs2) and torch.equal(gates, gates2)
    log(f"gru_fwd_sg N={n}: hs bit-equal to gru_fwd's; hs vs plain max_abs_err {e_hs:.3e} "
        f"(tol {GRU_ATOL}); gates vs plain from the same hs: {off} of {gates.numel()} "
        f"beyond one bf16 ulp, max_abs {e_gates:.3e}; two launches bit-equal {stable}")
    if e_hs > GRU_ATOL or off or not stable:
        raise AssertionError("gru_fwd_sg kernel disagrees with its plain version")
    del hs_v2, hs_p, hs2, gates2

    shape = f"N={n} T={FRAMES} h_last, no dx"
    err_bwd = compare("gru_bwd", lambda: gru_cuda.gru_bwd(x, hs, *w, g, with_dx=False),
                      lambda: gru_cuda.gru_bwd_plain(x, hs, *w, g, with_dx=False), shape)
    err_sg = compare(
        "gru_bwd_sg", lambda: gru_cuda.gru_bwd_sg(x, hs, gates, w[0], w[2], g, with_dx=False),
        lambda: gru_cuda.gru_bwd_sg_plain(x, hs, gates, w[0], w[2], g, with_dx=False), shape)
    for m, seq in ((2000, True), (37, False), (37, True)):
        xs = x[:m].contiguous()
        hs_s, gates_s = gru_cuda.gru_fwd_sg(xs, *w)
        gs = torch.randn((m, FRAMES, HIDDEN) if seq else (m, HIDDEN), generator=gen).to(dev)
        shape = f"N={m} {'per-frame' if seq else 'h_last'} cotangent, with dx"
        compare("gru_bwd", lambda: gru_cuda.gru_bwd(xs, hs_s, *w, gs, seq_cot=seq),
                lambda: gru_cuda.gru_bwd_plain(xs, hs_s, *w, gs, seq_cot=seq), shape)
        compare("gru_bwd_sg",
                lambda: gru_cuda.gru_bwd_sg(xs, hs_s, gates_s, w[0], w[2], gs, seq_cot=seq),
                lambda: gru_cuda.gru_bwd_sg_plain(xs, hs_s, gates_s, w[0], w[2], gs,
                                                  seq_cot=seq), shape)

    # times at the flagship shape
    fwd_ms, fwd_host = timed(lambda: gru_cuda.gru_fwd_sg(x, *w), iters=10)
    bwd_ms, bwd_host = timed(lambda: gru_cuda.gru_bwd(x, hs, *w, g, with_dx=False), iters=5)
    sg_ms, sg_host = timed(
        lambda: gru_cuda.gru_bwd_sg(x, hs, gates, w[0], w[2], g, with_dx=False), iters=5)
    fwd_plain, _ = timed(lambda: gru_cuda.gru_fwd_sg_plain(x, *w), iters=2, warmup=1)
    bwd_plain, _ = timed(lambda: gru_cuda.gru_bwd_plain(x, hs, *w, g, with_dx=False),
                         iters=2, warmup=1)
    sg_plain, _ = timed(lambda: gru_cuda.gru_bwd_sg_plain(x, hs, gates, w[0], w[2], g,
                                                          with_dx=False), iters=2, warmup=1)
    # yardstick: cuDNN's GRU (f32 with TF32 off, and bf16) at the same shape:
    # its training forward, and its backward as (forward + backward) minus
    # that forward, for the weight gradients of h_last's cotangent
    lib = {}
    for dt in (torch.float32, torch.bfloat16):
        gru = torch.nn.GRU(FEATURES, HIDDEN, batch_first=True).to(dev, dt)
        xd, gd = x.to(dt), g.to(dt)[None]
        params = list(gru.parameters())
        f_ms, _ = timed(lambda: gru(xd), iters=10)

        def fwd_bwd():
            _, h_n = gru(xd)
            torch.autograd.grad(h_n, params, gd)

        fb_ms, _ = timed(fwd_bwd, iters=10)
        lib[dt] = (f_ms, fb_ms - f_ms)
    H3 = 3 * HIDDEN
    xb, hsb, gb = x.numel() * 4, hs.numel() * 2, gates.numel() * 2
    wb = 2 * H3 * (FEATURES + HIDDEN) + 2 * H3 * 4
    outb = (FEATURES + HIDDEN + 2) * H3 * 4
    rows = n * FRAMES
    fwd_bound = bound(xb + wb + hsb + gb, 2.0 * rows * H3 * (FEATURES + HIDDEN),
                      PEAK_BF16_FLOP_S)
    # v2: the recomputed projections, dh, dW_hh + db_hh, dW_ih + db_ih
    bwd_flops = 2.0 * rows * H3 * ((FEATURES + HIDDEN) + HIDDEN + (HIDDEN + 1)
                                   + (FEATURES + 1))
    bwd_bound = bound(xb + hsb + g.numel() * 4 + wb + outb, bwd_flops, PEAK_BF16_FLOP_S)
    sg_flops = 2.0 * rows * H3 * (HIDDEN + (HIDDEN + 1) + (FEATURES + 1))
    sg_bound = bound(xb + hsb + gb + g.numel() * 4 + wb + outb, sg_flops, PEAK_BF16_FLOP_S)
    (lf32, lb32), (lf16, lb16) = lib[torch.float32], lib[torch.bfloat16]
    log(f"gru_fwd_sg timing N={n}: kernel {fwd_ms:.4f} ms (host issue {fwd_host:.4f}), plain "
        f"{fwd_plain:.4f} ms, cuDNN training forward f32 {lf32:.4f} ms (bf16 {lf16:.4f}), "
        f"bound {fwd_bound[0]:.4f} ms ({fwd_bound[1]})")
    log(f"gru_bwd timing N={n}: kernel {bwd_ms:.4f} ms (host issue {bwd_host:.4f}), plain "
        f"{bwd_plain:.4f} ms, cuDNN backward f32 {lb32:.4f} ms (bf16 {lb16:.4f}), bound "
        f"{bwd_bound[0]:.4f} ms ({bwd_bound[1]}, {bwd_flops / 1e9:.1f} GFLOP)")
    log(f"gru_bwd_sg timing N={n}: kernel {sg_ms:.4f} ms (host issue {sg_host:.4f}), plain "
        f"{sg_plain:.4f} ms, cuDNN backward f32 {lb32:.4f} ms (bf16 {lb16:.4f}), bound "
        f"{sg_bound[0]:.4f} ms ({sg_bound[1]}, {sg_flops / 1e9:.1f} GFLOP)")
    common = dict(route="cuda", path="train")
    return [
        dict(name="gru_fwd_sg", source="sldm_gnn_tpu_torch/csrc/gru_fwd.cu",
             replaces="sldm_gnn_tpu/ops/gru_pallas.py:766", shape=f"N={n} T={FRAMES} hs+gates",
             max_abs_err=max(e_hs, e_gates), ms=fwd_ms, plain_ms=fwd_plain,
             bound_ms=fwd_bound[0], bound_by=fwd_bound[1], library_ms=lf32, **common),
        dict(name="gru_bwd", source="sldm_gnn_tpu_torch/csrc/gru_bwd.cu",
             replaces="sldm_gnn_tpu/ops/gru_pallas.py:440",
             shape=f"N={n} T={FRAMES} h_last, no dx", max_abs_err=err_bwd, ms=bwd_ms,
             plain_ms=bwd_plain, bound_ms=bwd_bound[0], bound_by=bwd_bound[1],
             library_ms=lb32, **common),
        dict(name="gru_bwd_sg", source="sldm_gnn_tpu_torch/csrc/gru_bwd_sg.cu",
             replaces="sldm_gnn_tpu/ops/gru_pallas.py:805",
             shape=f"N={n} T={FRAMES} h_last, no dx", max_abs_err=err_sg, ms=sg_ms,
             plain_ms=sg_plain, bound_ms=sg_bound[0], bound_by=sg_bound[1],
             library_ms=lb32, **common),
    ]


def check_gru_widths(gru_cuda, gen, dev) -> None:
    """The GRU kernels at the widths a stack trains: the store-gates forward
    and both backwards at H=128 (D=6 with h_last's cotangent; D=128 with the
    per-frame one, the upper layer) and at D=96 (H=96, per-frame cotangent:
    the upper layer of the flagship's stack), against their plain versions;
    and the widest H each GRU kernel takes at D=6 and D=128."""
    import ctypes

    from sldm_gnn_tpu_torch.ops import _build

    n = 2000
    for d, h, seq in ((FEATURES, 128, False), (128, 128, True), (HIDDEN, HIDDEN, True)):
        x = torch.randn((n, FRAMES, d), generator=gen).to(dev)
        w = gru_weights(gen, d, h, dev)
        hs, gates = gru_cuda.gru_fwd_sg(x, *w)
        hs_p, _ = gru_cuda.gru_fwd_sg_plain(x, *w)
        e = (hs.float() - hs_p.float()).abs().max().item()
        log(f"gru_fwd_sg N={n} D={d} H={h}: hs max_abs_err {e:.3e} (tol {GRU_ATOL})")
        if e > GRU_ATOL:
            raise AssertionError(f"gru_fwd_sg disagrees with its plain version at D={d} H={h}")
        gs = torch.randn((n, FRAMES, h) if seq else (n, h), generator=gen).to(dev)
        shape = f"N={n} D={d} H={h} {'per-frame' if seq else 'h_last'} cotangent, with dx"
        compare("gru_bwd", lambda: gru_cuda.gru_bwd(x, hs, *w, gs, seq_cot=seq),
                lambda: gru_cuda.gru_bwd_plain(x, hs, *w, gs, seq_cot=seq), shape)
        compare("gru_bwd_sg",
                lambda: gru_cuda.gru_bwd_sg(x, hs, gates, w[0], w[2], gs, seq_cot=seq),
                lambda: gru_cuda.gru_bwd_sg_plain(x, hs, gates, w[0], w[2], gs, seq_cot=seq),
                shape)

    def widest(takes, hi: int) -> int:
        lo = 0
        while lo < hi:
            mid = (lo + hi + 1) // 2
            lo, hi = (mid, hi) if takes(mid) else (lo, mid - 1)
        return lo

    def fwd_takes(fn, d):
        def takes(h):
            try:
                fn(torch.zeros((1, 1, d), device=dev), *gru_weights(gen, d, h, dev))
            except RuntimeError as err:
                if "shared memory" not in str(err) and "does not take" not in str(err):
                    raise
                return False
            return True
        return takes

    lib = _build.load()

    def bwd_takes(grid, d):
        def takes(h):
            nbytes = ctypes.c_int64(0)
            return getattr(lib, grid)(1, FRAMES, d, h, ctypes.byref(nbytes)) == 0
        return takes

    out = []
    for d in (FEATURES, 128):
        out.append(f"D={d}: gru_fwd {widest(fwd_takes(gru_cuda.gru_fwd, d), 512)}, gru_fwd_sg "
                   f"{widest(fwd_takes(gru_cuda.gru_fwd_sg, d), 512)}, gru_bwd "
                   f"{widest(bwd_takes('gru_bwd_grid', d), 341)}, gru_bwd_sg "
                   f"{widest(bwd_takes('gru_bwd_sg_grid', d), 341)}")
    log("widest H each GRU kernel takes on this card: " + "; ".join(out))


# the forward kernels' ragged sweep: row counts around the tensor-core
# kernel's 64-row tile and the flagship batch, hidden widths padded to 32 by
# it (20, 33 and 100 are not multiples of 8: their outputs are stored by
# each thread, 33's element by element), and each D's widest, which the FMA
# kernel takes; D of 6 (the features) and 96, 128 (a stack's upper layer)
GRU_SWEEP_N = (1, 16, 32, 37, 64, 65, 19558)
GRU_SWEEP_H = (16, 20, 33, 40, 96, 100, 128)
GRU_SWEEP_D = (6, 96, 128)
# the widest H the FMA kernel took at each D before the tensor-core kernel
# came (PERF.md's limits table); none of them may stop working
GRU_FMA_WIDEST = {6: 186, 96: 146, 128: 134}


def route_ranges(route_of, d: int, hi: int = 512) -> str:
    """'H 1-128 <route>, 129-186 <route>, ...' for input width d."""
    out, start = [], 1
    for h in range(2, hi + 2):
        if h > hi or route_of(d, h) != route_of(d, start):
            out.append(f"{start}-{h - 1} {route_of(d, start)}")
            start = h
    return ", ".join(out)


def check_gru_sweep(gru_cuda, dev) -> int:
    """gru_fwd (h_last and seq) and gru_fwd_sg against their plain versions
    at GRU_ATOL (h_last, hs, gates) on every case of GRU_SWEEP_N x
    (GRU_SWEEP_H and the widest H) x GRU_SWEEP_D, FRAMES frames; two launches
    of each bit-equal, the store-gates hs bit-equal to the plain instance's,
    h_last equal to hs's last frame. Prints the kernel each width routes to
    (csrc/gru_fwd.cu's rule, gru_cuda.gru_fwd_route), checks that every H up
    to 128 takes the tensor cores and that no width the FMA kernel took
    before (GRU_FMA_WIDEST) has stopped working, and returns the number of
    cases held."""
    route = gru_cuda.gru_fwd_route
    widest = {}
    for d in GRU_SWEEP_D:
        routes = {h: route(d, h) for h in range(1, 513)}
        widest[d] = max(h for h, r in routes.items() if r >= 0)
        log(f"gru_fwd / gru_fwd_sg route at D={d}: H " + route_ranges(
            lambda dd, h: gru_cuda.FWD_ROUTES[routes[h]], d))
        if any(routes[h] != 1 for h in range(1, 129)) or widest[d] < GRU_FMA_WIDEST[d] or any(
                routes[h] < 0 for h in range(1, widest[d] + 1)):
            raise AssertionError(f"gru_fwd route at D={d}: H <= 128 not all on the tensor cores, "
                                 f"or the widest H {widest[d]} below {GRU_FMA_WIDEST[d]}")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    wgen = torch.Generator().manual_seed(SEED)
    worst = dict.fromkeys(("h_last", "hs", "gates"), 0.0)
    n_cases = 0
    t0 = time.perf_counter()
    for d in GRU_SWEEP_D:
        xall = torch.randn((max(GRU_SWEEP_N), FRAMES, d), generator=gen, device=dev)
        for h in GRU_SWEEP_H + (widest[d],):
            w = gru_weights(wgen, d, h, dev)
            for n in GRU_SWEEP_N:
                x = xall[:n]
                h_k, h_k2 = (gru_cuda.gru_fwd(x, *w) for _ in range(2))
                hs_k, hs_k2 = (gru_cuda.gru_fwd(x, *w, seq=True) for _ in range(2))
                (sg_hs, sg_g), (sg_hs2, sg_g2) = (gru_cuda.gru_fwd_sg(x, *w) for _ in range(2))
                hs_p, g_p = gru_cuda.gru_fwd_sg_plain(x, *w)
                torch.cuda.synchronize()
                errs = {"h_last": (h_k - hs_p[-1].float()).abs().max().item(),
                        "hs": (hs_k.float() - hs_p.float()).abs().max().item(),
                        "gates": (sg_g.float() - g_p.float()).abs().max().item()}
                stable = (torch.equal(h_k, h_k2) and torch.equal(hs_k, hs_k2)
                          and torch.equal(sg_hs, sg_hs2) and torch.equal(sg_g, sg_g2))
                same = torch.equal(sg_hs, hs_k) and torch.equal(h_k, hs_k[-1].float())
                finite = all(torch.isfinite(v.float()).all() for v in (h_k, hs_k, sg_g))
                if max(errs.values()) > GRU_ATOL or not (stable and same and finite):
                    raise AssertionError(
                        f"gru sweep N={n} D={d} H={h} ({gru_cuda.FWD_ROUTES[route(d, h)]}): "
                        f"max_abs_err {errs} (tol {GRU_ATOL}), two launches bit-equal {stable}, "
                        f"sg hs = seq hs and h_last = hs[-1] {same}, finite {finite}")
                for k, v in errs.items():
                    worst[k] = max(worst[k], v)
                n_cases += 1
        del xall
    log(f"gru sweep: {n_cases} cases (N {GRU_SWEEP_N}, H {GRU_SWEEP_H} + the widest, D "
        f"{GRU_SWEEP_D}) within {GRU_ATOL} of the plain versions, worst "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
        + f"; two launches bit-equal, sg hs bit-equal to gru_fwd's; "
        f"{time.perf_counter() - t0:.1f} s")
    return n_cases


# the backward kernels' sweep: row counts around the 64-row tile and a
# training batch, hidden widths padded to 32 by the tensor-core route (20,
# 33 and 100 are not multiples of 8: hs and the gates are read pair by pair,
# 33 element by element) and each route's widest, D of 6 (the features) and
# 128 (a stack's upper layer); D 40 (three k-steps: the recomputing
# backward streams W_ih^T at Hp = 128 for D > 16, an odd count through its
# two stages) and 160 (past the tensor-core route: the FMA kernel, both
# versions) at fewer widths; each (version, D, H) takes h_last's and the
# per-frame cotangent, with dx and without, across its row counts; and the
# flagship's rows at two shapes
GRU_BWD_SWEEP_N = (1, 37, 63, 64, 65, 2000)
GRU_BWD_SWEEP_H = (16, 20, 33, 96, 100, 128)
GRU_BWD_SWEEP_D = (6, 40, 128, 160)
GRU_BWD_SWEEP_H_AT = {40: (100, 128), 160: (16, 96, 128)}  # D: its widths, if not all
GRU_BWD_COMBOS = ((False, False), (True, True), (False, True), (True, False))  # (seq, dx)
# the widest H each backward took before the tensor-core route came (ROADMAP
# "Limits"); none may stop working. Every H <= 128 runs at every D swept.
GRU_BWD_WIDEST = {False: {6: 170, 128: 166}, True: {6: 128, 128: 128}}


def time_gru_bwd(gru_cuda, x, w, hs, gates, gs) -> None:
    """Logs both backwards' ms (CUDA events, 5 calls) at these inputs, with
    the per-frame cotangent and dx."""
    n, _, d = x.shape
    h = hs.shape[-1]
    ms = [timed(lambda: gru_cuda.gru_bwd(x, hs, *w, gs, seq_cot=True, with_dx=True), 5)[0],
          timed(lambda: gru_cuda.gru_bwd_sg(x, hs, gates, w[0], w[2], gs, seq_cot=True,
                                            with_dx=True), 5)[0]]
    route = (gru_cuda.FWD_ROUTES[gru_cuda.gru_bwd_route(d, h)]
             if hasattr(gru_cuda, "gru_bwd_route") else "route not reported")
    log(f"gru backward N={n} D={d} H={h} per-frame cotangent, dx: gru_bwd ({route}) "
        f"{ms[0]:.4f} ms, gru_bwd_sg {ms[1]:.4f} ms (CUDA events, 5 calls)")


def gru_bwd_upper_layer(dev) -> None:
    """`python3 chip_smoke.py --gru-bwd-ms`: only time_gru_bwd at the
    flagship's rows, D=128, H=128 (a stack's upper layer), on the
    sldm_gnn_tpu_torch beside this file; so a checkout of an earlier
    version can be timed by this script at the same inputs."""
    from sldm_gnn_tpu_torch.ops import gru_cuda

    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((flagship_rows(np.random.default_rng(SEED)), FRAMES, 128), generator=gen,
                    device=dev)
    w = gru_weights(torch.Generator().manual_seed(SEED), 128, 128, dev)
    hs, gates = gru_cuda.gru_fwd_sg(x, *w)
    gs = torch.randn((x.shape[0], FRAMES, 128), generator=gen, device=dev)
    time_gru_bwd(gru_cuda, x, w, hs, gates, gs)


def bwd_tc_expected(d: int, h: int, stored: bool) -> bool:
    """Whether csrc/gru_bwd.cuh's rule should send (d, h) to the tensor
    cores: every H <= 128 at D <= 128, both versions; wider H or D take the
    FMA kernel."""
    return h <= 128 and d <= 128


def check_gru_bwd_sweep(gru_cuda, dev) -> int:
    """gru_bwd and gru_bwd_sg against their plain versions at GRAD_RTOL of
    max|g| per output, two launches bit-equal, on every case of the sweep;
    prints each backward's routes (csrc/gru_bwd.cuh's rule,
    gru_cuda.gru_bwd_route), checks that H <= 128 takes the tensor cores
    (bwd_tc_expected) and that no width of GRU_BWD_WIDEST stopped working.
    Returns the number of cases held."""
    widest = {}
    for stored in (False, True):
        name = "gru_bwd_sg" if stored else "gru_bwd"
        for d in GRU_BWD_SWEEP_D:
            routes = {h: gru_cuda.gru_bwd_route(d, h, stored=stored) for h in range(1, 342)}
            log(f"{name} route at D={d}: H " + route_ranges(
                lambda dd, h: gru_cuda.FWD_ROUTES[routes[h]], d, 341))
            runs = [h for h, r in routes.items() if r >= 0]
            widest[stored, d] = sorted({max(h for h in runs if routes[h] == r)
                                        for r in (0, 1) if any(routes[h] == r for h in runs)})
            bad = [h for h in range(1, 129) if (routes[h] == 1) != bwd_tc_expected(d, h, stored)]
            want = max(128, GRU_BWD_WIDEST[stored].get(d, 0))
            if bad or max(runs) < want or any(routes[h] < 0 for h in range(1, max(runs) + 1)):
                raise AssertionError(f"{name} route at D={d}: H {bad} off the expected route, or "
                                     f"the widest H {max(runs)} below {want}")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    wgen = torch.Generator().manual_seed(SEED)
    worst = {False: 0.0, True: 0.0}
    n_cases = 0

    def hold(stored, x, w, hs, gates, gs, seq, with_dx, what):
        nonlocal n_cases
        if stored:
            run = lambda: gru_cuda.gru_bwd_sg(x, hs, gates, w[0], w[2], gs, seq_cot=seq,
                                              with_dx=with_dx)
            want = gru_cuda.gru_bwd_sg_plain(x, hs, gates, w[0], w[2], gs, seq_cot=seq,
                                             with_dx=with_dx)
        else:
            run = lambda: gru_cuda.gru_bwd(x, hs, *w, gs, seq_cot=seq, with_dx=with_dx)
            want = gru_cuda.gru_bwd_plain(x, hs, *w, gs, seq_cot=seq, with_dx=with_dx)
        got, again = run(), run()
        torch.cuda.synchronize()
        errs = grad_errors(got, want)
        stable = all(torch.equal(a, b) for a, b in zip(got, again) if a is not None)
        finite = all(torch.isfinite(a).all() for a in got if a is not None)
        if max(errs) > GRAD_RTOL or not (stable and finite):
            raise AssertionError(
                f"{'gru_bwd_sg' if stored else 'gru_bwd'} sweep {what}: max|err|/max|g| per "
                f"output {['%.2e' % e for e in errs]} (tol {GRAD_RTOL}), two launches bit-equal "
                f"{stable}, finite {finite}")
        worst[stored] = max(worst[stored], max(errs))
        n_cases += 1

    t0 = time.perf_counter()
    for d in GRU_BWD_SWEEP_D:
        xall = torch.randn((max(GRU_BWD_SWEEP_N), FRAMES, d), generator=gen, device=dev)
        for stored in (False, True):
            for h in sorted(set(GRU_BWD_SWEEP_H_AT.get(d, GRU_BWD_SWEEP_H))
                            | set(widest[stored, d])):
                w = gru_weights(wgen, d, h, dev)
                # hs and gates from the forward kernel, or where no forward
                # kernel takes the width (the backward's widest), its plain version
                fwd = (gru_cuda.gru_fwd_sg if gru_cuda.gru_fwd_route(d, h) >= 0
                       else gru_cuda.gru_fwd_sg_plain)
                route = gru_cuda.FWD_ROUTES[gru_cuda.gru_bwd_route(d, h, stored=stored)]
                for i, n in enumerate(GRU_BWD_SWEEP_N):
                    seq, with_dx = GRU_BWD_COMBOS[i % len(GRU_BWD_COMBOS)]
                    x = xall[:n]
                    hs, gates = fwd(x, *w)
                    gs = torch.randn((n, FRAMES, h) if seq else (n, h), generator=gen,
                                     device=dev)
                    hold(stored, x, w, hs, gates, gs, seq, with_dx,
                         f"N={n} D={d} H={h} ({route}) {'per-frame' if seq else 'h_last'} "
                         f"cotangent, dx {with_dx}")
        del xall
    n = flagship_rows(np.random.default_rng(SEED))
    for d, h, seq, with_dx in ((FEATURES, HIDDEN, False, False), (128, 128, True, True)):
        x = torch.randn((n, FRAMES, d), generator=gen, device=dev)
        w = gru_weights(wgen, d, h, dev)
        hs, gates = gru_cuda.gru_fwd_sg(x, *w)
        gs = torch.randn((n, FRAMES, h) if seq else (n, h), generator=gen, device=dev)
        for stored in (False, True):
            hold(stored, x, w, hs, gates, gs, seq, with_dx,
                 f"N={n} D={d} H={h} {'per-frame' if seq else 'h_last'} cotangent, dx {with_dx}")
        if d == 128:  # a stack's upper layer; gru_bwd streams W_ih^T here
            time_gru_bwd(gru_cuda, x, w, hs, gates, gs)
        del x, hs, gates, gs
    log(f"gru backward sweep: {n_cases} cases (N {GRU_BWD_SWEEP_N} and {n}, H {GRU_BWD_SWEEP_H} "
        f"(at D 40 and 160: {GRU_BWD_SWEEP_H_AT}) + each route's widest, D {GRU_BWD_SWEEP_D}, "
        f"both cotangents, dx on and off) within "
        f"{GRAD_RTOL} of max|g| of the plain versions, worst gru_bwd {worst[False]:.3e}, "
        f"gru_bwd_sg {worst[True]:.3e}; two launches bit-equal; "
        f"{time.perf_counter() - t0:.1f} s")
    return n_cases


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


def flagship_config(gru_impl: str, dropout: float | None):
    from sldm_gnn_tpu_torch.models.grusage import GruSageConfig

    return GruSageConfig(
        frames_num=FRAMES, gru_hidden_size=HIDDEN, fc1dims=(HIDDEN,),
        sage_hidden_dims=(HIDDEN, HIDDEN), fc2dims=(32,), out_dim=LABELS, emb_dim=8,
        dropout=dropout, negative_slope=0.1, map_included=True, map_attention_topk=K,
        gru_impl=gru_impl, knn_impl="pallas")


def synth_training_data(dev, with_graphs: bool = False):
    """bench_flagship.py's recipe: PACKS graphs of 8-11 fully connected
    vehicles with Bernoulli(0.3) labels, and a live map of SEGMENTS segments
    (9 features, z-scored; 4 random edges a segment; centroids ~ N(0, 100)).
    Returns (batch, map data), and with ``with_graphs`` the graphs too."""
    from sldm_gnn_tpu_torch.graph.batching import compute_batch_dims, pad_and_batch
    from sldm_gnn_tpu_torch.graph.containers import GraphArrays
    from sldm_gnn_tpu_torch.models.map_modules import MapData, map_zscore_norm

    rng = np.random.default_rng(SEED)
    graphs = []
    for _ in range(PACKS):
        v = int(rng.integers(8, 12))
        x = rng.standard_normal((v, FRAMES, FEATURES)).astype(np.float32)
        x[:, :, 5] = 1.0
        src, dst = np.meshgrid(np.arange(v), np.arange(v))
        m = src != dst
        graphs.append(GraphArrays(
            x=x, xsttype=rng.integers(0, 10, v).astype(np.int32),
            xdims=rng.uniform(1.5, 5.0, (v, 2)).astype(np.float32),
            edge_index=np.stack([src[m], dst[m]]).astype(np.int32),
            edge_attr=np.zeros((int(m.sum()), 4), np.float32),
            y=(rng.random(LABELS) < 0.3).astype(np.float32)))
    batch = pad_and_batch(graphs, compute_batch_dims(graphs, PACKS, LABELS)).to(dev)
    feats = torch.from_numpy(rng.standard_normal((SEGMENTS, MAP_FEATS)).astype(np.float32))
    md = MapData(
        feats=map_zscore_norm(feats),
        lane_type_cats=torch.from_numpy(rng.integers(0, 8, SEGMENTS)),
        edge_src=torch.from_numpy(rng.integers(0, SEGMENTS, 4 * SEGMENTS)),
        edge_dst=torch.from_numpy(rng.integers(0, SEGMENTS, 4 * SEGMENTS)),
        centroids=torch.from_numpy(rng.standard_normal((SEGMENTS, 2)).astype(np.float32) * 100),
    ).to(dev)
    return (batch, md, graphs) if with_graphs else (batch, md)


COUNTED = {"gru_fwd": ("gru_cuda", "gru_fwd"), "gru_fwd_sg": ("gru_cuda", "gru_fwd_sg"),
           "gru_bwd": ("gru_cuda", "gru_bwd"), "gru_bwd_sg": ("gru_cuda", "gru_bwd_sg"),
           "knn_topk": ("knn_ops", "knn_topk_fused"),
           "spmm_banded": ("spmm_banded", "spmm_banded"),
           "banded_sage_fwd": ("sage_fused", "banded_sage_fwd"),
           "banded_sage_bwd": ("sage_fused", "banded_sage_bwd"),
           "banded_sage_ln_bwd": ("sage_fused", "banded_sage_ln_bwd"),
           "spmm_onehot": ("spmm", "spmm_onehot"), "spmm_dense": ("spmm_dense", "spmm_dense"),
           "spmm_gather": ("spmm_gather", "spmm_gather"),
           "spmm_banded_int8": ("spmm_banded", "spmm_banded_int8"),
           "quantize_rows": ("quant", "quantize_rows"), "spmm_int8": ("spmm", "spmm_int8"),
           "spmm_int8_pt": ("spmm", "spmm_int8_pt"), "sddmm": ("sddmm", "sddmm"),
           "gru_scan_fwd": ("gru_cuda", "gru_scan_fwd"),
           "gru_scan_bwd": ("gru_cuda", "gru_scan_bwd"), "spmm_mk": ("spmm_mk", "spmm_mk")}


def set_counts_to_zero(mods: dict) -> None:
    for mod, fn in COUNTED.values():
        getattr(mods[mod], fn).launches = 0


def read_counts(mods: dict) -> dict:
    return {name: getattr(mods[mod], fn).launches for name, (mod, fn) in COUNTED.items()}


def plain_versions(gru_cuda, knn_ops):
    """Every kernel wrapper of the training path replaced by its plain version."""
    from contextlib import ExitStack

    stack = ExitStack()
    for name in ("gru_fwd", "gru_fwd_sg", "gru_bwd", "gru_bwd_sg"):
        stack.enter_context(mock.patch.object(gru_cuda, name,
                                              getattr(gru_cuda, f"{name}_plain")))
    stack.enter_context(mock.patch.object(knn_ops, "knn_topk_fused", knn_ops.knn_topk_plain))
    return stack


def check_training(mods: dict, gru_impl: str, batch, md, dev, smi: str):
    """The flagship step through build_step_fns: (a) one step's parameter
    gradients (dropout off) through the kernels against the plain versions
    on the card; (b) TRAIN_STEPS steps with dropout 0.25 from the card's
    generator, every loss finite; (c) one forward and one backward GRU
    launch and one KNN launch a step. Returns the trained model and counts."""
    from sldm_gnn_tpu_torch.models.grusage import GruSage
    from sldm_gnn_tpu_torch.train.losses import masked_graph_loss
    from sldm_gnn_tpu_torch.train.loop import build_step_fns, make_optimizer

    gru_cuda, knn_ops = mods["gru_cuda"], mods["knn_ops"]
    y = batch.y[batch.graph_mask]
    pos_weight = float((y == 0).sum() / (y == 1).sum().clamp_min(1))
    model = GruSage(flagship_config(gru_impl, 0.25), map_feat_dim=MAP_FEATS).to(dev)
    fns = build_step_fns(model, make_optimizer(1e-3, 5e-5), map_data=md, pos_weight=pos_weight)
    card_gen = torch.Generator(device=dev).manual_seed(SEED)
    state = fns.init(card_gen)
    params = [p for p in model.parameters()]
    names = [n for n, _ in model.named_parameters()]

    def grads():
        model.eval()  # dropout off; the GRU still takes the autograd path
        loss = masked_graph_loss(model(batch, map_data=md), batch.y, batch.graph_mask,
                                 pos_weight=pos_weight)
        return loss, torch.autograd.grad(loss, params)

    loss_k, g_k = grads()
    with plain_versions(gru_cuda, knn_ops):
        loss_p, g_p = grads()
    torch.cuda.synchronize()
    worst, worst_name, worst_scale = 0.0, "", 0.0
    for name, a, b in zip(names, g_k, g_p):
        scale = b.abs().max().item() + STEP_GRAD_FLOOR
        excess = ((a - b).abs() - STEP_GRAD_TOL * b.abs()).max().item() / scale
        if excess > worst:
            worst, worst_name, worst_scale = excess, name, scale
        if not torch.isfinite(a).all() or excess > STEP_GRAD_TOL:
            raise AssertionError(f"train {gru_impl}: gradient of {name} through the kernels "
                                 f"disagrees with the plain versions ({excess:.3e})")
    log(f"train {gru_impl} N={batch.node_capacity} rows, {PACKS} graphs: one step (dropout off) "
        f"through the kernels vs the plain versions: loss {loss_k.item():.6f} vs "
        f"{loss_p.item():.6f}; {len(names)} gradients within rtol {STEP_GRAD_TOL} + "
        f"{STEP_GRAD_TOL} * (max|g| + {STEP_GRAD_FLOOR}) (largest excess over rtol: "
        f"{worst:.3e} of that scale, {worst_name}, max|g| + floor {worst_scale:.3e})")

    set_counts_to_zero(mods)
    times, losses = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = fns.train_step(state, batch, card_gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"])
    counts = read_counts(mods)
    losses = torch.stack(losses).cpu().numpy()
    fwd = "gru_fwd_sg" if gru_impl == "pallas_sg" else "gru_fwd"
    bwd = "gru_bwd_sg" if gru_impl == "pallas_sg" else "gru_bwd"
    p50 = float(np.median(times))
    log(f"train {gru_impl}: {TRAIN_STEPS} steps (dropout 0.25), losses {losses[0]:.5f} -> "
        f"{losses[-1]:.5f}, p50 {p50:.3f} ms/step ({PACKS / p50 * 1e3:.1f} graphs/s; first "
        f"step {times[0]:.1f} ms), launches {counts}, on {smi}")
    want = {fwd: TRAIN_STEPS, bwd: TRAIN_STEPS, "knn_topk": TRAIN_STEPS}
    if not np.isfinite(losses).all():
        raise AssertionError(f"train {gru_impl}: a loss is not finite: {losses}")
    if any(counts[k] != v for k, v in want.items()) or \
            sum(counts.values()) != sum(want.values()):
        raise AssertionError(f"train {gru_impl}: launches {counts}, want {want}")

    def run_step():
        nonlocal state
        state, _ = fns.train_step(state, batch, card_gen)

    profile_steps(run_step, gru_impl, GRU_KERNEL_KEYS)
    return model, counts


def profile_steps(run_step, label: str, keys: tuple[str, ...], steps: int = 3) -> None:
    """Device time of `steps` calls of run_step() by kernel, from
    torch.profiler (CUPTI): the port's kernels named in `keys`, the rest by
    name; and the card's idle share of the window's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                run_step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    except RuntimeError as e:
        log(f"profile {label}: not measured (torch.profiler failed: {e})")
        return
    busy = sum(e.self_device_time_total for e in events) / 1e3
    if busy <= 0:
        log(f"profile {label}: not measured (no device time in the trace)")
        return
    groups: dict[str, float] = {}
    for e in events:
        key = next((k for k in keys if k in e.key), e.key[:60])
        groups[key] = groups.get(key, 0.0) + e.self_device_time_total / 1e3 / steps
    top = sorted(groups.items(), key=lambda kv: -kv[1])[:12]
    log(f"profile {label}: {steps} steps, wall {wall / steps:.3f} ms/step, device busy "
        f"{busy / steps:.3f} ms/step (idle share {max(0.0, 1 - busy / wall):.3f}); device ms "
        f"per step by kernel: " + "; ".join(f"{k} {v:.3f}" for k, v in top))


# gru_bwd_tc_kernel, gru_dw_kernel (+ gru_dw_reduce) and gru_dx_kernel: the
# backward's tensor-core route (csrc/gru_bwd.cuh); gru_bwd_kernel (+
# gru_bwd_reduce) its FMA kernel for wide H
GRU_KERNEL_KEYS = ("gru_fwd_tc_kernel", "gru_fwd_fma_kernel", "gru_bwd_tc_kernel",
                   "gru_dw_kernel", "gru_dw_reduce", "gru_dx_kernel", "gru_bwd_kernel",
                   "gru_bwd_reduce", "knn_topk_kernel")
# slot_spmm_kernel: spmm_banded's and spmm_dense's kernel (csrc/slot_spmm.cuh)
BANDED_KERNEL_KEYS = ("slot_spmm_kernel", "sage_fwd_kernel", "sage_bwd_kernel",
                      "sage_dw_kernel", "ln_bwd_prologue_kernel", "reduce_partials_kernel")
LAYOUT_KERNEL_KEYS = ("spmm_onehot_kernel", "slot_spmm_kernel", "spmm_gather_kernel")


def check_train_to_serve(mods: dict, model, md, tmp: Path, dev) -> None:
    """The trained model, saved through train/snapshot.py with its map
    embeddings baked, serves the wire stream through InferenceEngine."""
    from sldm_gnn_tpu_torch.serve.stream import InferenceEngine
    from sldm_gnn_tpu_torch.train.snapshot import save_snapshot

    path = tmp / "trained.pkl"
    save_snapshot(path, model, map_data=md, loss_info={"type": "BCEWithLogits"})
    frames = wire_stream()
    engine = InferenceEngine(path, pack_size=FRAMES, device=dev)
    set_counts_to_zero(mods)
    scores, times = serve(engine, frames)
    counts = read_counts(mods)
    with plain_versions(mods["gru_cuda"], mods["knn_ops"]):
        plain, _ = serve(InferenceEngine(path, pack_size=FRAMES, device=dev), frames)
    err = np.abs(scores - plain).max()
    log(f"train -> serve: snapshot with baked map ({engine.map_embeddings.shape[0]} segments), "
        f"{len(scores)} windows scored, host ms/window p50 {np.median(times):.3f}, launches "
        f"{counts}; scores vs plain versions max_abs {err:.3e} (tol {SCORE_ATOL})")
    if scores.shape != (len(frames) - FRAMES + 1, LABELS) or not np.isfinite(scores).all() \
            or scores.min() < 0 or scores.max() > 1 or err > SCORE_ATOL:
        raise AssertionError("the trained snapshot does not serve")
    if counts["gru_fwd"] <= 0 or counts["knn_topk"] <= 0:
        raise AssertionError(f"serving the trained snapshot skipped a kernel: {counts}")


def make_local_graph(n: int, deg: int, *, reach: int = 256, seed: int = 0):
    """bench.py's map-like graph: node ids follow spatial order, edges reach
    nearby ids (a copy of bench.make_local_graph, which imports JAX)."""
    rng = np.random.default_rng(seed)
    dst = np.repeat(np.arange(n), deg)
    src = np.clip(dst + rng.integers(-reach, reach + 1, n * deg), 0, n - 1)
    return src.astype(np.int64), dst.astype(np.int64)


def banded_layouts(mods: dict, dev):
    """bench.py's graph as the banded-residual layout (count_cap 7) and as the
    pure banded layout, built on the host and moved to the card."""
    tsb, tbr = mods["spmm_banded"], mods["banded_residual"]
    src, dst = make_local_graph(BENCH_NODES, BENCH_DEG, reach=BENCH_REACH)
    t0 = time.perf_counter()
    resid, n_pad = tbr.prepare_banded_residual_mean_aggregate(
        src, dst, BENCH_NODES, tile=BANDED_TILE, k=BANDED_K, count_cap=COUNT_CAP)
    t1 = time.perf_counter()
    fwd, rev, _ = tsb.prepare_banded_mean_aggregate(src, dst, BENCH_NODES, tile=BANDED_TILE,
                                                    k=BANDED_K)
    t2 = time.perf_counter()
    log(f"banded layouts of {BENCH_NODES} nodes, {len(src)} edges (n_pad {n_pad}, "
        f"{fwd.num_dst_blocks} blocks): banded-residual built in {t1 - t0:.3f} s on the host "
        f"(span {resid.banded_fwd.s_span}/{resid.banded_rev.s_span}, {len(resid.r_src)} "
        f"residual edges, slots {resid.m_fwd}/{resid.m_rev} of {resid.steps} groups); pure "
        f"banded in {t2 - t1:.3f} s (span {fwd.s_span}/{rev.s_span}, A "
        f"{fwd.a.numel() / 1e6:.1f} MB a direction, max count {int(fwd.a.max())})")
    return resid.to(dev), (fwd.to(dev), rev.to(dev)), n_pad, (src, dst)


def mean_csr(src, dst, n_pad: int, dev, transpose: bool = False):
    """The mean-aggregation matrix M[dst, src] = 1/deg(dst) as a CUDA CSR
    (or its transpose): the library yardstick's operand."""
    deg = np.bincount(dst, minlength=n_pad)
    w = torch.from_numpy((1.0 / np.maximum(deg, 1))[dst].astype(np.float32))
    rows, cols = (src, dst) if transpose else (dst, src)
    idx = torch.from_numpy(np.stack([rows, cols]))
    return torch.sparse_coo_tensor(idx, w, (n_pad, n_pad)).coalesce().to(dev).to_sparse_csr()


def banded_cost(blocks, d: int, h: int, xbytes: int, kind: str, extra: float = 0.0):
    """(bytes, operations) of one banded kernel call on these inputs: each
    input read once, each output written once; the products of the dense
    count tiles as the kernel does them."""
    nb, s_span, t = blocks.num_dst_blocks, blocks.s_span, blocks.tile
    n = nb * t
    a = blocks.a.numel() * blocks.a.element_size() + n * 4  # tiles + 1/deg
    if kind == "spmm":
        return a + 2 * n * d * xbytes + extra, 2.0 * nb * s_span * t * t * d
    w = 2 * d * h * xbytes
    if kind == "fwd":
        return (a + n * d * xbytes + n * h * xbytes + w + extra,
                2.0 * nb * t * d * (s_span * t + 2 * h))
    nbytes = a + n * h * xbytes + 2 * n * d * xbytes + w + 2 * d * h * 4 + extra
    flops = 2.0 * nb * t * h * (s_span * t + 2 * d) + 4.0 * nb * t * d * h
    if kind == "ln_bwd":
        nbytes += n * h * xbytes + n * 4  # xhat, rstd
    return nbytes, flops


def graph_plain_versions(mods: dict):
    """The graph kernels' wrappers (banded, fused SAGE, one-hot, dense,
    gather, int8 banded, quantizer, int8 one-hot, SDDMM, megakernel)
    replaced by their plain versions, wherever the port's modules call
    them."""
    from contextlib import ExitStack

    stack = ExitStack()
    tsb, tsf, tbr = mods["spmm_banded"], mods["sage_fused"], mods["banded_residual"]
    stack.enter_context(mock.patch.object(tsb, "spmm_banded", tsb.spmm_banded_plain))
    stack.enter_context(mock.patch.object(tsb, "spmm_banded_int8", tsb.spmm_banded_int8_plain))
    for mod, name in (("spmm", "spmm_onehot"), ("spmm_dense", "spmm_dense"),
                      ("spmm_gather", "spmm_gather"), ("quant", "quantize_rows"),
                      ("spmm", "spmm_int8"), ("spmm", "spmm_int8_pt"), ("sddmm", "sddmm"),
                      ("spmm_mk", "spmm_mk")):
        stack.enter_context(mock.patch.object(mods[mod], name,
                                              getattr(mods[mod], f"{name}_plain")))
    for name in ("banded_sage_fwd", "banded_sage_bwd", "banded_sage_ln_bwd"):
        plain = getattr(tsf, f"{name}_plain")
        for mod in (tsf, tbr, mods["halo_fused"]):
            if hasattr(mod, name):
                stack.enter_context(mock.patch.object(mod, name, plain))
    return stack


def check_banded_kernels(mods: dict, resid, pure, graph, gen, dev, label: str = "") -> list[dict]:
    """The four banded kernels against their plain versions at bench.py's
    shape, on both layouts, with bf16 and f32 activations and weights, the
    resid and ln options, and two launches bit-equal; then times of kernel,
    plain version and library yardstick (bf16, the bench's dtype). `label`
    prefixes the log lines (the cmap run's)."""
    tsb, tsf, tbr = mods["spmm_banded"], mods["sage_fused"], mods["banded_residual"]
    n_pad, d, h = resid.n_pad, BENCH_DIM, BENCH_DIM
    errs = {k: 0.0 for k in ("spmm_banded", "banded_sage_fwd", "banded_sage_bwd",
                             "banded_sage_ln_bwd")}

    def relerr(a, b):
        return ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30)).item()

    def compare(name, what, kernel, plain, rows=None):
        """`rows`: the rows of the groups with a residual slot, held on their
        own in every output with a row per node."""
        got, again, want = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        got, again, want = (v if isinstance(v, tuple) else (v,) for v in (got, again, want))
        rel = [relerr(a, b) for a, b in zip(got, want)]
        stable = all(torch.equal(a, b) for a, b in zip(got, again))
        err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
        rel_r = [] if rows is None or rows.numel() == 0 else [
            relerr(a[rows], b[rows]) for a, b in zip(got, want) if a.shape[0] == n_pad]
        log(f"{label}{name} {what}: max|err|/max|plain| per output {['%.2e' % e for e in rel]}"
            + ("" if rows is None else f", on the {rows.numel()} rows of the residual groups "
               f"{['%.2e' % e for e in rel_r]}")
            + f" (tol {BANDED_REL}); two launches bit-equal {stable}")
        if max(rel + rel_r) > BANDED_REL or not stable or \
                not all(torch.isfinite(a).all() for a in got):
            raise AssertionError(f"{name} kernel disagrees with its plain version ({what})")
        errs[name] = max(errs[name], err)

    pf, pr = pure
    rg_f, rg_r = resid.rg_fwd, resid.rg_rev
    kt = resid.group_rows
    rows_f, rows_r = ((torch.nonzero(rg > 0).flatten()[:, None] * kt
                       + torch.arange(kt, device=rg.device)).flatten() for rg in (rg_f, rg_r))
    log(f"{label}residual groups: {rows_f.numel() // kt} of {rg_f.numel()} forward, "
        f"{rows_r.numel() // kt} reverse ({kt} rows each)")
    inputs = {}
    for dt in (torch.bfloat16, torch.float32):
        name = "bf16" if dt == torch.bfloat16 else "f32"
        x = torch.randn((n_pad, d), generator=gen).to(dev, dt)
        g = torch.randn((n_pad, h), generator=gen).to(dev, dt)
        wl, wr = ((torch.randn((d, h), generator=gen) * 0.05).to(dev, dt) for _ in range(2))
        b = (torch.randn(h, generator=gen) * 0.1).to(dev, dt)
        ln = ((1 + 0.2 * torch.randn(h, generator=gen)).to(dev, dt),
              (0.1 * torch.randn(h, generator=gen)).to(dev, dt))
        r_f = tbr.residual_fwd_compact(x, resid).to(dt)
        r_r = tbr.residual_rev_compact(g, resid).to(dt)
        inputs[name] = (x, g, wl, wr, b, ln, r_f, r_r)
        for lay, what in ((pf, "forward layout"), (pr, "reverse layout (1/deg on x's rows)")):
            compare("spmm_banded", f"{name} {what}", lambda: tsb.spmm_banded(x, lay),
                    lambda: tsb.spmm_banded_plain(x, lay))
        fw = dict(negative_slope=0.0, resid=(r_f, rg_f))
        compare("banded_sage_fwd", f"{name} banded-residual, ReLU, no bias",
                lambda: tsf.banded_sage_fwd(x, wl, wr, None, resid.banded_fwd, **fw),
                lambda: tsf.banded_sage_fwd_plain(x, wl, wr, None, resid.banded_fwd, **fw),
                rows_f)
        fw = dict(negative_slope=0.1, resid=(r_f, rg_f), ln=ln)
        compare("banded_sage_fwd", f"{name} banded-residual, bias, LN, LeakyReLU (out, xhat, rstd)",
                lambda: tsf.banded_sage_fwd(x, wl, wr, b, resid.banded_fwd, **fw),
                lambda: tsf.banded_sage_fwd_plain(x, wl, wr, b, resid.banded_fwd, **fw),
                rows_f)
        compare("banded_sage_fwd", f"{name} pure banded, bias, no activation",
                lambda: tsf.banded_sage_fwd(x, wl, wr, b, pf),
                lambda: tsf.banded_sage_fwd_plain(x, wl, wr, b, pf))
        bw = dict(x=x, resid=(r_r, rg_r))
        compare("banded_sage_bwd", f"{name} banded-residual with x (dx, dWl, dWr)",
                lambda: tsf.banded_sage_bwd(g, wl, wr, resid.banded_rev, **bw),
                lambda: tsf.banded_sage_bwd_plain(g, wl, wr, resid.banded_rev, **bw), rows_r)
        compare("banded_sage_bwd", f"{name} pure banded without x (t, dx)",
                lambda: tsf.banded_sage_bwd(g, wl, wr, pr),
                lambda: tsf.banded_sage_bwd_plain(g, wl, wr, pr))
        _, xhat, rstd = tsf.banded_sage_fwd(x, wl, wr, b, resid.banded_fwd, negative_slope=0.1,
                                            resid=(r_f, rg_f), ln=ln)
        for lay, rs, rows, what in ((resid.banded_rev, (r_r, rg_r), rows_r, "banded-residual"),
                                    (pr, None, None, "pure banded")):
            lw = dict(negative_slope=0.1, resid=rs)
            compare("banded_sage_ln_bwd", f"{name} {what} (dx, dWl, dWr, dstats)",
                    lambda: tsf.banded_sage_ln_bwd(g, xhat, rstd, wl, wr, *ln, lay, x, **lw),
                    lambda: tsf.banded_sage_ln_bwd_plain(g, xhat, rstd, wl, wr, *ln, lay, x, **lw),
                    rows)
        del xhat, rstd
    del inputs["f32"]
    torch.cuda.empty_cache()

    # times at bench.py's shape and dtype (bf16), with the library yardstick:
    # cuSPARSE's CSR product by the mean-aggregation matrix (f32, on an f32
    # copy of the inputs), plus the dense products and the epilogue
    x, g, wl, wr, b, ln, r_f, r_r = inputs["bf16"]
    _, xhat, rstd = tsf.banded_sage_fwd(x, wl, wr, b, resid.banded_fwd, negative_slope=0.1,
                                        resid=(r_f, rg_f), ln=ln)
    m_csr, mt_csr = (mean_csr(*graph, n_pad, dev, transpose=tr) for tr in (False, True))
    x32, g32, wl32, wr32 = x.float(), g.float(), wl.float(), wr.float()
    gam32, bet32 = ln[0].float(), ln[1].float()
    xh32 = xhat.float()

    def lib_bwd(gg):
        t = torch.sparse.mm(mt_csr, gg)
        return t @ wl32.T + gg @ wr32.T, x32.T @ t, x32.T @ gg

    def lib_ln_bwd():
        gt = torch.where(xh32 * gam32 + bet32 > 0, g32, 0.1 * g32)
        gz = gt * gam32
        dy = (gz - gz.mean(1, keepdim=True) - xh32 * (gz * xh32).mean(1, keepdim=True)) * rstd
        return lib_bwd(dy), (gt * xh32).sum(0), gt.sum(0), dy.sum(0)

    rb = r_f.numel() * 2
    runs = [
        ("spmm_banded", "sldm_gnn_tpu_torch/csrc/spmm_banded.cu",
         "sldm_gnn_tpu/ops/spmm_banded.py:478", "pure banded forward layout, bf16",
         lambda: tsb.spmm_banded(x, pf), lambda: tsb.spmm_banded_plain(x, pf),
         lambda: torch.sparse.mm(m_csr, x32), banded_cost(pf, d, h, 2, "spmm")),
        ("banded_sage_fwd", "sldm_gnn_tpu_torch/csrc/sage_fused_fwd.cu",
         "sldm_gnn_tpu/ops/sage_fused.py:283", "banded-residual, bf16, ReLU, no bias",
         lambda: tsf.banded_sage_fwd(x, wl, wr, None, resid.banded_fwd, negative_slope=0.0,
                                     resid=(r_f, rg_f)),
         lambda: tsf.banded_sage_fwd_plain(x, wl, wr, None, resid.banded_fwd,
                                           negative_slope=0.0, resid=(r_f, rg_f)),
         lambda: torch.relu(torch.sparse.mm(m_csr, x32) @ wl32 + x32 @ wr32),
         banded_cost(resid.banded_fwd, d, h, 2, "fwd", rb)),
        ("banded_sage_bwd", "sldm_gnn_tpu_torch/csrc/sage_fused_bwd.cu",
         "sldm_gnn_tpu/ops/sage_fused.py:554", "banded-residual with x, bf16",
         lambda: tsf.banded_sage_bwd(g, wl, wr, resid.banded_rev, x=x, resid=(r_r, rg_r)),
         lambda: tsf.banded_sage_bwd_plain(g, wl, wr, resid.banded_rev, x=x,
                                           resid=(r_r, rg_r)),
         lambda: lib_bwd(g32), banded_cost(resid.banded_rev, d, h, 2, "bwd", rb)),
        ("banded_sage_ln_bwd", "sldm_gnn_tpu_torch/csrc/sage_fused_bwd.cu",
         "sldm_gnn_tpu/ops/sage_fused.py:905", "banded-residual, bf16, LeakyReLU 0.1",
         lambda: tsf.banded_sage_ln_bwd(g, xhat, rstd, wl, wr, *ln, resid.banded_rev, x,
                                        negative_slope=0.1, resid=(r_r, rg_r)),
         lambda: tsf.banded_sage_ln_bwd_plain(g, xhat, rstd, wl, wr, *ln, resid.banded_rev, x,
                                              negative_slope=0.1, resid=(r_r, rg_r)),
         lib_ln_bwd, banded_cost(resid.banded_rev, d, h, 2, "ln_bwd", rb)),
    ]
    entries = []
    for name, source, replaces, shape, kernel, plain, library, cost in runs:
        ms, host = timed(kernel, iters=10)
        plain_ms, _ = timed(plain, iters=3, warmup=1)
        library_ms, _ = timed(library, iters=10)
        bound_ms, bound_by = bound(*cost, PEAK_BF16_FLOP_S)
        log(f"{label}{name} timing ({shape}): kernel {ms:.4f} ms (host issue {host:.4f}), plain "
            f"{plain_ms:.4f} ms, library {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}: {cost[0] / 1e6:.1f} MB, {cost[1] / 1e9:.1f} GFLOP)")
        entries.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            shape=f"N={n_pad} D=H={d} {shape}", max_abs_err=errs[name], ms=ms,
                            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=library_ms))
    return entries


def step_grad_excess(label: str, names, got, want) -> float:
    """Holds one step's gradients through the kernels against the plain
    versions' at rtol STEP_GRAD_TOL + STEP_GRAD_TOL * (max|g| +
    STEP_GRAD_FLOOR); returns the largest excess over that scale."""
    torch.cuda.synchronize()
    worst = 0.0
    for name, a, b in zip(names, got, want):
        scale = b.float().abs().max().item() + STEP_GRAD_FLOOR
        excess = ((a.float() - b.float()).abs() - STEP_GRAD_TOL * b.float().abs()).max().item()
        worst = max(worst, excess / scale)
        if not torch.isfinite(a).all() or excess / scale > STEP_GRAD_TOL:
            raise AssertionError(f"{label}: gradient of {name} through the kernels disagrees "
                                 f"with the plain versions ({excess / scale:.3e})")
    return worst


def check_bench_step(mods: dict, label: str, layer, n_pad: int, per_step: dict, keys_k: tuple,
                     n_edges: int, dev, smi: str) -> dict:
    """bench.py's step (bench_step :106-109): two layers `layer(h, wa, wb)`,
    bf16, loss sum(h.float()), gradients of the f32 params and the bf16 x,
    and the p - 1e-9 g update. One step's gradients through the kernels
    against the plain versions, then BENCH_STEPS timed steps with the
    launches `per_step` a step, and a profile of 3 (kernels named by
    `keys_k`)."""
    bf16 = torch.bfloat16
    rng = np.random.default_rng(1)
    d = BENCH_DIM
    x = torch.from_numpy(rng.standard_normal((n_pad, d)).astype(np.float32)).to(dev, bf16)
    keys = ("w0a", "w0b", "w1a", "w1b")
    params = {k: torch.from_numpy(rng.standard_normal((d, d)).astype(np.float32) * 0.05).to(dev)
              for k in keys}

    def grads(params, x):
        ps = [params[k].detach().requires_grad_() for k in keys]
        xg = x.detach().requires_grad_()
        p = [v.to(bf16) for v in ps]
        h = layer(layer(xg, p[0], p[1]), p[2], p[3])
        loss = h.float().sum()
        return loss, torch.autograd.grad(loss, [*ps, xg])

    def step(params, x):
        _, gs = grads(params, x)
        return ({k: params[k] - 1e-9 * gk for k, gk in zip(keys, gs)},
                (x - 1e-9 * gs[-1]).to(bf16))

    loss_k, g_k = grads(params, x)
    with graph_plain_versions(mods):
        loss_p, g_p = grads(params, x)
    worst = step_grad_excess(f"bench step {label}", (*keys, "x"), g_k, g_p)
    log(f"bench step ({label}, bf16): loss {loss_k.item():.6e} through the kernels vs "
        f"{loss_p.item():.6e} through the plain versions; gradients of w0a..w1b and x within "
        f"rtol {STEP_GRAD_TOL} + {STEP_GRAD_TOL} * (max|g| + {STEP_GRAD_FLOOR}) (largest excess "
        f"{worst:.3e} of that scale)")
    del g_k, g_p

    set_counts_to_zero(mods)
    times = []
    for _ in range(BENCH_STEPS):
        t0 = time.perf_counter()
        params, x = step(params, x)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = read_counts(mods)
    p50 = float(np.median(times))
    log(f"bench step {label}: {BENCH_STEPS} steps, p50 {p50:.3f} ms/step, "
        f"{n_edges / (p50 / 1e3):.4e} edges/s ({n_edges} edges; first step {times[0]:.3f} ms), "
        f"launches {counts} ({per_step} a step), on {smi}")
    want = {k: v * BENCH_STEPS for k, v in per_step.items()}
    if any(counts[k] != v for k, v in want.items()) or \
            sum(counts.values()) != sum(want.values()):
        raise AssertionError(f"bench step {label}: launches {counts}, want {want}")
    if not all(torch.isfinite(v).all() for v in params.values()):
        raise AssertionError(f"bench step {label}: a parameter is not finite")
    state = [params, x]

    def run_step():
        state[0], state[1] = step(*state)

    profile_steps(run_step, f"bench step {label}", keys_k)
    return counts


def classifier_data(n_pad: int, dev):
    """Features [n_pad, D] and labels of the classifier runs, from numpy
    with SEED: the label adds 1 to its feature."""
    rng = np.random.default_rng(SEED)
    y = rng.integers(0, CLS_CLASSES, BENCH_NODES)
    x = np.zeros((n_pad, BENCH_DIM), np.float32)
    x[:BENCH_NODES] = rng.standard_normal((BENCH_NODES, BENCH_DIM)) * 0.5
    x[np.arange(BENCH_NODES), y] += 1.0
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)


def check_classifier(mods: dict, layout, n_pad: int, mode: dict, label: str, want: dict,
                     dev):
    """BlockedSageClassifier((128, 128), num_classes=4, negative_slope=0.1)
    over `layout` (forward, reverse): features and labels from numpy with
    SEED (the label adds 1 to its feature), random weights from SEED, Adam
    (lr 1e-2) on cross-entropy for CLS_STEPS steps. The first loss through
    the kernels agrees with the plain versions', every loss is finite, the
    last is below the first, and the launches are `want` per step. Before
    training, the first step's logits through the kernels are held against
    the plain versions' (max|err| / max|logit| within BANDED_REL) and its
    parameter gradients at STEP_GRAD_TOL. Returns (counts, trained model)."""
    from sldm_gnn_tpu_torch.models.blocked_sage import BlockedSageClassifier

    x, y = classifier_data(n_pad, dev)
    torch.manual_seed(SEED)
    model = BlockedSageClassifier((BENCH_DIM, BENCH_DIM), num_classes=CLS_CLASSES,
                                  in_features=BENCH_DIM, negative_slope=0.1, **mode).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    lossf = torch.nn.functional.cross_entropy
    names = [k for k, _ in model.named_parameters()]

    def first_step():
        logits = model(x, *layout, n_pad)
        loss = lossf(logits[:BENCH_NODES], y)
        return logits.detach(), loss.item(), torch.autograd.grad(loss, list(model.parameters()))

    logits_k, first_k, g_k = first_step()
    with graph_plain_versions(mods):
        logits_p, first_p, g_p = first_step()
    rel = ((logits_k - logits_p).abs().max() / logits_p.abs().max()).item()
    if not torch.isfinite(logits_k).all() or rel > BANDED_REL:
        raise AssertionError(f"classifier {label}: logits through the kernels disagree with "
                             f"the plain versions' ({rel:.3e} of max|logit|)")
    worst = step_grad_excess(f"classifier {label}", names, g_k, g_p)
    del logits_k, logits_p, g_k, g_p
    set_counts_to_zero(mods)
    losses, times = [], []
    for _ in range(CLS_STEPS):
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = lossf(model(x, *layout, n_pad)[:BENCH_NODES], y)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = read_counts(mods)
    losses = torch.stack(losses).cpu().numpy()
    log(f"classifier {label}: first step through the kernels vs the plain versions: logits "
        f"max|err|/max|logit| {rel:.3e} (tol {BANDED_REL}), loss {first_k:.6f} vs "
        f"{first_p:.6f}, gradients of {len(names)} parameters within rtol {STEP_GRAD_TOL} + "
        f"{STEP_GRAD_TOL} * (max|g| + {STEP_GRAD_FLOOR}) (largest excess {worst:.3e}); "
        f"{CLS_STEPS} Adam steps, losses {losses[0]:.5f} -> "
        f"{losses[-1]:.5f}, p50 {np.median(times):.3f} ms/step, launches {counts}")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"classifier {label}: the loss did not fall: {losses}")
    want = {k: v * CLS_STEPS for k, v in want.items()}
    if any(counts[k] != v for k, v in want.items()) or \
            sum(counts.values()) != sum(want.values()):
        raise AssertionError(f"classifier {label}: launches {counts}, want {want}")
    return counts, model


def layout_set(mods: dict, graph, dev) -> dict:
    """bench.py's graph as its one-hot (BENCH_SPMM=onehot: tile 512, 512-slot
    chunks, 2 chunks a step), dense (int8 counts, tile 128, padded to 4
    blocks), gather (tile 128, K=12, R=24) and hybrid (dense int8 tiles for the
    pairs of at least HYBRID_MIN edges, one-hot chunks for the rest) layouts,
    built on the host and moved to the card: {name: ((fwd, rev), n_pad)}."""
    src, dst = graph
    n = BENCH_NODES
    t = [time.perf_counter()]
    of, orv, n1 = mods["spmm"].prepare_mean_aggregate(
        src, dst, n, step_chunks=ONEHOT_K, tile=ONEHOT_TILE, edge_chunk=ONEHOT_CHUNK)
    t.append(time.perf_counter())
    df, dr, n2 = mods["spmm_dense"].prepare_dense_mean_aggregate(
        src, dst, n, tile=BANDED_TILE, pad_blocks_to=DENSE_K, dtype=np.int8)
    t.append(time.perf_counter())
    gl, n3 = mods["spmm_gather"].prepare_gather_residual_mean_aggregate(
        src, dst, n, tile=BANDED_TILE, k=BANDED_K, r=GATHER_R)
    t.append(time.perf_counter())
    hl, n4 = mods["spmm_hybrid"].prepare_hybrid_mean_aggregate(
        src, dst, n, tile=BANDED_TILE, dense_k=DENSE_K, k_per_step=ONEHOT_K,
        min_pair_edges=HYBRID_MIN, a_budget_bytes=8e9, dense_dtype=np.int8)
    t.append(time.perf_counter())
    dt = np.diff(t)
    log(f"one-hot layout in {dt[0]:.3f} s on the host: n_pad {n1}, {of.num_chunks}/"
        f"{orv.num_chunks} chunks of {of.edge_chunk} slots (fwd/rev), "
        f"{int((of.weight != 0).sum())} live slots")
    log(f"dense layout in {dt[1]:.3f} s: n_pad {n2}, {df.num_dst_blocks} blocks, s_max "
        f"{df.s_max}/{dr.s_max}, A {df.a.numel() / 1e6:.1f} MB a direction, max count "
        f"{int(df.a.max())}")
    gf, gr = gl.gather_fwd, gl.gather_rev
    log(f"gather layout in {dt[2]:.3f} s: n_pad {n3}, R {gf.r}/{gr.r}, wsz {gf.wsz}/{gr.wsz}, "
        f"codes {gf.codes.numel() * 4 / 1e6:.1f} MB a direction, residual "
        f"{gl.resid_frac:.5f} ({len(gl.r_src)} edges, slots {gl.m_fwd}/{gl.m_rev} of "
        f"{gl.steps} groups)")
    nb = n4 // BANDED_TILE
    _, pair_edges = np.unique(dst // BANDED_TILE * nb + src // BANDED_TILE, return_counts=True)
    log(f"block pairs of tile {BANDED_TILE}: {len(pair_edges)}, the smallest with "
        f"{pair_edges.min()} edges")
    log(f"hybrid layout in {dt[3]:.3f} s: n_pad {n4}, min_pair_edges {HYBRID_MIN}, dense_frac "
        f"{hl.dense_frac:.4f}, dense s_max {hl.dense_fwd.s_max}/{hl.dense_rev.s_max}, one-hot "
        f"{hl.onehot_fwd.num_chunks}/{hl.onehot_rev.num_chunks} chunks of "
        f"{hl.onehot_fwd.edge_chunk}")
    return {"onehot": ((of.to(dev), orv.to(dev)), n1), "dense": ((df.to(dev), dr.to(dev)), n2),
            "gather": ((gl.to(dev), None), n3), "hybrid": ((hl.to(dev), None), n4)}


def check_layout_kernels(mods: dict, lays: dict, pure, graph, gen, dev) -> list[dict]:
    """The one-hot, dense, gather and int8 banded kernels against their plain
    versions at bench.py's shapes (f32 and bf16 x; HIGHEST for the one-hot;
    both directions), two launches bit-equal; then times of kernel, plain
    version and the cuSPARSE CSR yardstick (bf16 x, int8 for the int8
    kernel)."""
    tsp, tsd, tsg, tsb = mods["spmm"], mods["spmm_dense"], mods["spmm_gather"], mods["spmm_banded"]
    quantize = mods["quant"].quantize_tensor_xla
    d = BENCH_DIM
    errs = dict.fromkeys(("spmm_onehot", "spmm_dense", "spmm_gather", "spmm_banded_int8"), 0.0)

    def compare(name, what, kernel, plain, tol):
        """`tol` None: kernel and plain must be bit-equal."""
        got, again, want = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        stable, equal = torch.equal(got, again), torch.equal(got, want)
        err = (got.float() - want.float()).abs().max().item()
        rel = err / max(want.float().abs().max().item(), 1e-30)
        log(f"{name} {what}: max|err| {err:.3e}, {rel:.2e} of max|plain| (tol "
            f"{'bit-equal' if tol is None else tol}; bit-equal {equal}); two launches "
            f"bit-equal {stable}")
        if not stable or not torch.isfinite(got).all() or \
                (not equal if tol is None else rel > tol):
            raise AssertionError(f"{name} kernel disagrees with its plain version ({what})")
        errs[name] = max(errs[name], err)

    (of, orv), n1 = lays["onehot"]
    (df, dr), n2 = lays["dense"]
    (gl, _), n3 = lays["gather"]
    pf, n_int8 = pure[0], pure[0].num_dst_blocks * pure[0].tile
    xs = {}
    for dt in (torch.bfloat16, torch.float32):
        name = "bf16" if dt == torch.bfloat16 else "f32"
        tol = BANDED_REL if dt == torch.bfloat16 else AGG_F32_REL
        x1, x2, x3 = (torch.randn((n, d), generator=gen).to(dev, dt) for n in (n1, n2, n3))
        xs[name] = (x1, x2, x3)
        for lay, what in ((of, "forward"), (orv, "reverse")):
            compare("spmm_onehot", f"{name} {what}",
                    lambda: tsp.spmm_onehot(x1, lay, k_per_step=ONEHOT_K),
                    lambda: tsp.spmm_onehot_plain(x1, lay, k_per_step=ONEHOT_K), None)
            if dt == torch.float32:
                compare("spmm_onehot", f"f32 HIGHEST {what}",
                        lambda: tsp.spmm_onehot(x1, lay, precision="highest"),
                        lambda: tsp.spmm_onehot_plain(x1, lay, precision="highest"), None)
        for lay, what in ((df, "forward (row scale)"), (dr, "reverse (column scale)")):
            compare("spmm_dense", f"{name} int8 tiles {what}",
                    lambda: tsd.spmm_dense(x2, lay, step_blocks=DENSE_K),
                    lambda: tsd.spmm_dense_plain(x2, lay, step_blocks=DENSE_K), tol)
        g_rev = dataclasses.replace(gl.gather_rev, col_scale=None)
        x3r = (x3.float() * gl.gather_rev.col_scale).to(dt)
        for lay, xv, what in ((gl.gather_fwd, x3, "forward"),
                              (g_rev, x3r, "reverse (column scale folded into x)")):
            compare("spmm_gather", f"{name} {what}", lambda: tsg.spmm_gather(xv, lay),
                    lambda: tsg.spmm_gather_plain(xv, lay), None)
    x_int8 = torch.randn((n_int8, d), generator=gen).to(dev)
    xq, x_scale = quantize(x_int8)
    compare("spmm_banded_int8", "pure banded forward layout",
            lambda: tsb.spmm_banded_int8(xq, x_scale, pf),
            lambda: tsb.spmm_banded_int8_plain(xq, x_scale, pf), None)
    del xs["f32"]
    torch.cuda.empty_cache()

    # times at bench.py's dtype (bf16; int8 for the int8 kernel), with the
    # library yardstick: cuSPARSE's CSR product by the mean-aggregation
    # matrix, f32, on an f32 copy of the inputs
    x1, x2, x3 = xs["bf16"]
    csr = {n: mean_csr(*graph, n, dev) for n in {n1, n2, n3, n_int8}}
    live = int((of.weight != 0).sum())
    plan_mb = sum(a.numel() * a.element_size() for a in tsp.onehot_plan(of, n1)) / 1e6
    log(f"spmm_onehot plan (row_ptr, perm, src_row; structure only, kept on the layout): "
        f"{plan_mb:.1f} MB, read beside the layout's {of.src_local.numel() * 12 / 1e6:.1f} MB "
        f"(the bound counts the layout, x and out)")
    gf = gl.gather_fwd
    runs = [
        ("spmm_onehot", "sldm_gnn_tpu_torch/csrc/spmm_onehot.cu", "sldm_gnn_tpu/ops/spmm.py:202",
         f"N={n1} D={d} one-hot forward layout, tile {ONEHOT_TILE}, {of.num_chunks} chunks "
         f"of {of.edge_chunk}, bf16",
         lambda: tsp.spmm_onehot(x1, of, k_per_step=ONEHOT_K),
         lambda: tsp.spmm_onehot_plain(x1, of, k_per_step=ONEHOT_K), x1,
         (of.num_chunks * 8 + of.src_local.numel() * 12 + 2 * n1 * d * 2, 2.0 * live * d),
         PEAK_BF16_FLOP_S),
        ("spmm_dense", "sldm_gnn_tpu_torch/csrc/spmm_dense.cu",
         "sldm_gnn_tpu/ops/spmm_dense.py:241",
         f"N={n2} D={d} dense forward layout, int8 tiles, s_max {df.s_max}, bf16",
         lambda: tsd.spmm_dense(x2, df, step_blocks=DENSE_K),
         lambda: tsd.spmm_dense_plain(x2, df, step_blocks=DENSE_K), x2,
         (df.a.numel() + df.src_blk.numel() * 4 + n2 * 4 + 2 * n2 * d * 2,
          2.0 * df.num_dst_blocks * df.s_max * df.tile ** 2 * d), PEAK_BF16_FLOP_S),
        ("spmm_gather", "sldm_gnn_tpu_torch/csrc/spmm_gather.cu",
         "sldm_gnn_tpu/ops/spmm_gather.py:483",
         f"N={n3} D={d} gather forward layout, R {gf.r}, bf16",
         lambda: tsg.spmm_gather(x3, gf), lambda: tsg.spmm_gather_plain(x3, gf), x3,
         (n3 * gf.r * 8 + gf.woff.numel() * 4 + n3 * 4 + 2 * n3 * d * 2, 2.0 * n3 * gf.r * d),
         PEAK_F32_FLOP_S),
        ("spmm_banded_int8", "sldm_gnn_tpu_torch/csrc/spmm_banded_int8.cu",
         "sldm_gnn_tpu/ops/spmm_banded.py:564",
         f"N={n_int8} D={d} pure banded forward layout, s_span {pf.s_span}, int8 x, f32 out",
         lambda: tsb.spmm_banded_int8(xq, x_scale, pf),
         lambda: tsb.spmm_banded_int8_plain(xq, x_scale, pf), x_int8,
         (pf.a.numel() + pf.bo.numel() * 4 + n_int8 * d + 4 + n_int8 * 4 + n_int8 * d * 4,
          2.0 * pf.num_dst_blocks * pf.s_span * pf.tile ** 2 * d), PEAK_INT8_OP_S),
    ]
    entries = []
    for name, source, replaces, shape, kernel, plain, xin, cost, peak in runs:
        ms, host = timed(kernel, iters=10)
        plain_ms, _ = timed(plain, iters=3, warmup=1)
        x32, m = xin.float(), csr[xin.shape[0]]
        library_ms, _ = timed(lambda: torch.sparse.mm(m, x32), iters=10)
        bound_ms, bound_by = bound(*cost, peak)
        log(f"{name} timing ({shape}): kernel {ms:.4f} ms (host issue {host:.4f}), plain "
            f"{plain_ms:.4f} ms, cuSPARSE CSR f32 {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}: {cost[0] / 1e6:.1f} MB, {cost[1] / 1e9:.2f} G operations)")
        entries.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            shape=shape, max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms))
    return entries


def layout_step(mods: dict, name: str, layout):
    """bench.py's unfused layer on the layout `name` (two_layer_sage :70-90
    with loss_pallas's aggregation :501-513: relu(agg(h) @ wa + h @ wb)),
    the layout's n_pad, and the kernel launches of one two-layer step: 2
    forward and 2 reverse aggregations (each half's for the hybrid)."""
    (fwd, rev), n_pad = layout
    if name == "onehot":
        agg = lambda h: mods["spmm"].spmm_apply(h, fwd, rev, n_pad, True, ONEHOT_K)
        per_step = {"spmm_onehot": 4}
    elif name == "dense":
        agg = lambda h: mods["spmm_dense"].spmm_dense_apply(h, fwd, rev, True, DENSE_K)
        per_step = {"spmm_dense": 4}
    elif name == "gather":
        agg = lambda h: mods["spmm_gather"].spmm_gather_residual_apply(h, fwd, True)
        per_step = {"spmm_gather": 4}
    else:
        agg = lambda h: mods["spmm_hybrid"].spmm_hybrid_apply(h, fwd, True)
        per_step = {"spmm_dense": 4, "spmm_onehot": 4}
    return (lambda h, wa, wb: torch.relu(agg(h) @ wa + h @ wb)), n_pad, per_step


def check_int8_inference(mods: dict, model, pure, n_pad: int, dev) -> dict:
    """BlockedSageClassifier with int8_features=True, the weights of `model`
    (the unfused classifier trained on the pure banded layout): its logits
    through the int8 kernel equal those through its plain version bit for
    bit, and lie within INT8_REL of max|logit| of the f32 path (the same
    weights with use_pallas=False). Returns the launch counts of one
    inference."""
    from sldm_gnn_tpu_torch.models.blocked_sage import BlockedSageClassifier

    x, _ = classifier_data(n_pad, dev)
    kw = dict(in_features=BENCH_DIM, negative_slope=0.1)
    m8 = BlockedSageClassifier((BENCH_DIM, BENCH_DIM), CLS_CLASSES, int8_features=True, **kw)
    m32 = BlockedSageClassifier((BENCH_DIM, BENCH_DIM), CLS_CLASSES, use_pallas=False, **kw)
    for m in (m8, m32):
        m.load_state_dict(model.state_dict())
        m.to(dev).eval()
    with torch.no_grad():
        set_counts_to_zero(mods)
        got = m8(x, *pure, n_pad)
        torch.cuda.synchronize()
        counts = read_counts(mods)
        with graph_plain_versions(mods):
            plain = m8(x, *pure, n_pad)
        f32 = m32(x, *pure, n_pad)
        ms, _ = timed(lambda: m8(x, *pure, n_pad), iters=10)
        ms32, _ = timed(lambda: m32(x, *pure, n_pad), iters=10)
    torch.cuda.synchronize()
    equal = torch.equal(got, plain)
    rel = ((got - f32).abs().max() / f32.abs().max()).item()
    log(f"int8 inference (pure banded, the unfused classifier's weights): logits through the "
        f"kernel bit-equal to the plain version's {equal}; max|err| vs the f32 path {rel:.3e} "
        f"of max|logit| (tol {INT8_REL}); {ms:.3f} ms per inference (f32 twin {ms32:.3f} ms); "
        f"launches {counts}")
    if not equal or not torch.isfinite(got).all() or rel > INT8_REL:
        raise AssertionError("int8 inference disagrees")
    want = {"spmm_banded_int8": 2}
    if any(counts[k] != v for k, v in want.items()) or \
            sum(counts.values()) != sum(want.values()):
        raise AssertionError(f"int8 inference: launches {counts}, want {want}")
    return counts


def check_wide(mods: dict, pure, n_pad: int, graph, dev, smi: str) -> dict:
    """The wide banded layout (widen_banded, the TPU kernel's `wide` branch)
    on bench.py's graph: the pure banded layouts widened on the card; the
    kernel on them bit-equal to the narrow kernel in both directions (bf16
    and f32 x) and within BANDED_REL of the plain version; timed beside the
    narrow kernel in turns (narrow, wide, wide, narrow), with the plain
    version and cuSPARSE; then bench.py's BENCH_SPMM=banded BENCH_FUSED=0
    BENCH_BANDED_WIDE=1 two-layer step over spmm_banded_apply on them, and
    the unfused classifier 20 Adam steps. Returns the kernel line's entry."""
    tsb = mods["spmm_banded"]
    pf, pr = pure
    t0 = time.perf_counter()
    wf, wr = tsb.widen_banded(pf), tsb.widen_banded(pr)
    torch.cuda.synchronize()
    log(f"wide layouts: a {tuple(pf.a.shape)} -> {tuple(wf.a.shape)} (forward), "
        f"{tuple(pr.a.shape)} -> {tuple(wr.a.shape)} (reverse), widened on the card in "
        f"{time.perf_counter() - t0:.3f} s")
    d = BENCH_DIM
    rng = np.random.default_rng(SEED + 5)
    err = 0.0
    for dt in (torch.bfloat16, torch.float32):
        x = torch.from_numpy(rng.standard_normal((n_pad, d)).astype(np.float32)).to(dev, dt)
        for narrow, wide, what in ((pf, wf, "forward layout"),
                                   (pr, wr, "reverse layout (1/deg on x's rows)")):
            got, again = tsb.spmm_banded(x, wide), tsb.spmm_banded(x, wide)
            want, plain = tsb.spmm_banded(x, narrow), tsb.spmm_banded_plain(x, wide)
            torch.cuda.synchronize()
            rel = ((got.float() - plain.float()).abs().max()
                   / plain.float().abs().max()).item()
            name = "bf16" if dt == torch.bfloat16 else "f32"
            log(f"spmm_banded wide {name} {what}: bit-equal to the narrow kernel "
                f"{torch.equal(got, want)}, two launches bit-equal {torch.equal(got, again)}, "
                f"max|err|/max|plain| {rel:.2e} (tol {BANDED_REL})")
            if not torch.equal(got, want) or not torch.equal(got, again) or \
                    rel > BANDED_REL or not torch.isfinite(got).all():
                raise AssertionError(f"spmm_banded wide {name} {what} disagrees")
            err = max(err, (got.float() - plain.float()).abs().max().item())
    x = torch.from_numpy(rng.standard_normal((n_pad, d)).astype(np.float32)).to(dev,
                                                                               torch.bfloat16)
    turns = [timed(lambda: tsb.spmm_banded(x, lay), iters=20)[0] for lay in (pf, wf, wf, pf)]
    ms = (turns[1] + turns[2]) / 2
    plain_ms, _ = timed(lambda: tsb.spmm_banded_plain(x, wf), iters=3, warmup=1)
    m_csr = mean_csr(*graph, n_pad, dev)
    x32 = x.float()
    library_ms, _ = timed(lambda: torch.sparse.mm(m_csr, x32), iters=10)
    del m_csr, x32
    cost = banded_cost(wf, d, d, 2, "spmm")
    bound_ms, bound_by = bound(*cost, PEAK_BF16_FLOP_S)
    log(f"spmm_banded wide timing (pure banded forward layout, bf16, in turns narrow, wide, "
        f"wide, narrow): {', '.join(f'{t:.4f}' for t in turns)} ms; wide {ms:.4f} ms, narrow "
        f"{(turns[0] + turns[3]) / 2:.4f} ms, plain {plain_ms:.4f} ms, cuSPARSE {library_ms:.4f} "
        f"ms, bound {bound_ms:.4f} ms ({bound_by}: {cost[0] / 1e6:.1f} MB), on {smi}")
    check_bench_step(
        mods, "banded wide (BENCH_SPMM=banded BENCH_FUSED=0 BENCH_BANDED_WIDE=1)",
        lambda h, wa, wb: torch.relu(tsb.spmm_banded_apply(h, wf, wr, True) @ wa + h @ wb),
        n_pad, {"spmm_banded": 4}, ("slot_spmm_kernel",), len(graph[0]), dev, smi)
    counts, _ = check_classifier(mods, (wf, wr), n_pad, {}, "unfused, wide banded",
                                 {"spmm_banded": 3}, dev)
    return dict(name="spmm_banded", route="cuda", source="sldm_gnn_tpu_torch/csrc/spmm_banded.cu",
                replaces="sldm_gnn_tpu/ops/spmm_banded.py:478", layout="wide",
                path="classifier unfused, wide", launches=counts["spmm_banded"],
                shape=f"N={n_pad} D={d} pure banded forward layout, wide (a {tuple(wf.a.shape)}), "
                      f"bf16", max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


# the halo phase: cli/train_halo.py --fused-ln's defaults (--banded-k 8,
# --hidden 96, negative slope 0.1, the overlap layers) on bench.py's graph
# split over 4 shards, run here one shard after another
HALO_EP = 4
HALO_K = 8
HALO_HIDDEN = 96
HALO_SLOPE = 0.1
LN_EPS = 1e-5
# the shards put back together against the one-chip layer: two kernel paths
# over different layouts (tile 128 and K 8 against the banded-residual
# layout's K 12), each within BANDED_REL of max|out| of the same exact
# layer (bf16 operands and a bf16 output), so within twice that of each
# other
HALO_ASSEMBLED_REL = 2 * BANDED_REL


def check_halo(mods: dict, graph, resid, dev, smi: str) -> dict:
    """The per-shard overlap layers of the halo path on bench.py's graph:
    plan_halo_fused(ep=4, banded_k=8), x [200000, 128] bf16, H 96. For each
    shard in turn the card gathers its halo table from the global x by
    send_idx (in place of the all-to-all, which is not ported yet), then
    runs halo_fused_sage_ln_ov and halo_fused_sage_ov forward and backward
    through the kernels (the main path: launches counted), with the loss
    sum(out ** 2) / 2 over the shard's real rows. Each is held
    against the plain versions on the card (output at BANDED_REL of
    max|out|, dx, dhalo and the partial weight gradients at STEP_GRAD_TOL),
    and y_pre_c's mapped slots at BANDED_REL; the shards' outputs, put back
    in global order, and their dx (plus the dhalo rows sent back to their
    owners) and summed weight gradients are held against the one-chip
    banded_residual_sage(_ln)_apply on the whole graph. Then, on the shard
    with the most boundary groups, the layer and the fused forward with and
    without ypre are timed. Returns the kernel line's entry."""
    thf, tsf, tbr = mods["halo_fused"], mods["sage_fused"], mods["banded_residual"]
    bf16 = torch.bfloat16
    src, dst = graph
    n, d, h, ep = BENCH_NODES, BENCH_DIM, HALO_HIDDEN, HALO_EP
    t0 = time.perf_counter()
    plan = thf.plan_halo_fused(src, dst, n, ep, banded_k=HALO_K)
    t_plan = time.perf_counter() - t0
    gplan = plan.to(dev)
    bnd = plan.bnd
    n_local, n_pad_local, kt = plan.n_local, plan.n_pad_local, bnd.kt
    groups_b = (bnd.rg_b > 0).sum(1).tolist()
    f0, r0, _ = plan.shard(0)
    log(f"halo plan of {n} nodes, {len(src)} edges over {ep} shards (banded_k {HALO_K}, tile "
        f"{f0.tile}): built in {t_plan:.2f} s on the host; n_local {n_local}, n_pad_local "
        f"{n_pad_local}, span {f0.s_span}/{r0.s_span}, wsz {f0.wsz}; halo table {bnd.h_rows} "
        f"rows; boundary groups a shard "
        f"{groups_b} (m_b {bnd.m_b}), interior-overflow edges a shard "
        f"{(bnd.i_w_f > 0).sum(1).tolist()} (m_io {bnd.m_io}, m_rev {bnd.m_rev})")
    rng = np.random.default_rng(SEED + 7)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dev, bf16)
    prm = {k: torch.from_numpy(v).to(dev) for k, v in dict(
        wl=rng.standard_normal((d, h)).astype(np.float32) * 0.05,
        wr=rng.standard_normal((d, h)).astype(np.float32) * 0.05,
        b=rng.standard_normal(h).astype(np.float32) * 0.1,
        gamma=1 + 0.2 * rng.standard_normal(h).astype(np.float32),
        beta=0.1 * rng.standard_normal(h).astype(np.float32)).items()}
    xs = torch.zeros((ep * n_local, d), dtype=bf16, device=dev)
    xs[:n] = x
    send = gplan.send_idx.long()
    layers = {"halo_fused_sage_ln_ov": (thf.halo_fused_sage_ln_ov,
                                        ("wl", "wr", "b", "gamma", "beta"), (HALO_SLOPE, LN_EPS)),
              "halo_fused_sage_ov": (thf.halo_fused_sage_ov, ("wl", "wr", "b"), (HALO_SLOPE,))}

    def halo_rows(p):
        """Rows of the global x that shard p receives: the exchange's
        delivery, gathered on this card in its place."""
        return (torch.arange(ep, device=dev)[:, None] * n_local + send[:, p, :]).reshape(-1)

    def shard_inputs(p):
        xp = torch.zeros((n_pad_local, d), dtype=bf16, device=dev)
        xp[:n_local] = xs[p * n_local:(p + 1) * n_local]
        return xp, xs[halo_rows(p)]

    def square_loss_cotangent(y, rows):
        """d/dy of sum(y[:rows] ** 2) / 2: smooth at the activation's kink,
        so that a bf16 rounding that flips a near-zero pre-activation moves
        the gradients by little (ROADMAP's hazards)"""
        g = y.detach().clone()
        g[rows:] = 0
        return g

    shard_lays = [gplan.shard(p) for p in range(ep)]

    def run(layer, p, inputs=None):
        """The layer on shard p, forward and backward of the square loss on
        its real rows: (out, [dx, dhalo, d params...])."""
        fn, names, extra = layers[layer]
        xp, halo = inputs or shard_inputs(p)
        leaves = [xp.detach().requires_grad_(), halo.detach().requires_grad_()] + [
            prm[k].clone().requires_grad_() for k in names]
        y = fn(*leaves, *shard_lays[p], True, *extra)
        torch.autograd.backward(y, square_loss_cotangent(y, min(n_local, n - p * n_local)))
        return y.detach(), [v.grad for v in leaves]

    # the main path: both layers on every shard, launches counted
    set_counts_to_zero(mods)
    got = {(layer, p): run(layer, p) for layer in layers for p in range(ep)}
    torch.cuda.synchronize()
    counts = read_counts(mods)
    want = {"banded_sage_fwd": 2 * ep, "banded_sage_ln_bwd": ep, "banded_sage_bwd": ep}
    log(f"halo layers, {ep} shards x 2 layers forward and backward through the kernels: "
        f"launches {counts} (want {want}; a layer: 1 banded_sage_fwd with ypre and 1 "
        f"backward)")
    if any(counts[k] != v for k, v in want.items()) or \
            sum(counts.values()) != sum(want.values()):
        raise AssertionError(f"halo layers: launches {counts}, want {want}")

    with graph_plain_versions(mods):
        plain = {key: run(*key) for key in got}
    for (layer, p), (y, gr) in got.items():
        yp, gp = plain[(layer, p)]
        rel = ((y.float() - yp.float()).abs().max() / yp.float().abs().max()).item()
        names = ("x", "halo") + layers[layer][1]
        worst = step_grad_excess(f"{layer} shard {p}", names, gr, gp)
        log(f"{layer} shard {p}: output max|err|/max|plain| {rel:.2e} (tol {BANDED_REL}); dx, "
            f"dhalo, {', '.join('d' + k for k in layers[layer][1])} within rtol "
            f"{STEP_GRAD_TOL} + {STEP_GRAD_TOL} * (max|g| + {STEP_GRAD_FLOOR}) (largest excess "
            f"{worst:.3e})")
        if rel > BANDED_REL or not torch.isfinite(y).all():
            raise AssertionError(f"{layer} shard {p}: output disagrees with the plain versions")
    del plain

    # y_pre_c of every shard's fused forward (the --fused-ln layer's call)
    ln = (prm["gamma"], prm["beta"])
    ypre_err = 0.0
    for p in range(ep):
        int_fwd, _, b_p = shard_lays[p]
        xp, _ = shard_inputs(p)
        kw = dict(negative_slope=HALO_SLOPE, ln=ln, ypre=(b_p.rg_b, b_p.m_b),
                  resid=(thf.io_fwd_compact(xp, b_p).to(bf16), b_p.rg_io))
        outs = tsf.banded_sage_fwd(xp, prm["wl"], prm["wr"], prm["b"], int_fwd, **kw)
        again = tsf.banded_sage_fwd(xp, prm["wl"], prm["wr"], prm["b"], int_fwd, **kw)
        want_o = tsf.banded_sage_fwd_plain(xp, prm["wl"], prm["wr"], prm["b"], int_fwd, **kw)
        live = int(b_p.rg_b.max().item())
        yk, yp = outs[-1][1:live + 1], want_o[-1][1:live + 1]
        rel = ((yk - yp).abs().max() / yp.abs().max()).item() if live else 0.0
        stable = all(torch.equal(a, b) for a, b in zip(outs, again))
        log(f"banded_sage_fwd ypre shard {p}: y_pre_c [{b_p.m_b}, {kt}, {h}], slots 1..{live} "
            f"max|err|/max|plain| {rel:.2e} (tol {BANDED_REL}); two launches bit-equal {stable}")
        if rel > BANDED_REL or not stable or not torch.isfinite(outs[-1]).all():
            raise AssertionError(f"banded_sage_fwd ypre shard {p} disagrees")
        if live:
            ypre_err = max(ypre_err, (yk - yp).abs().max().item())

    # the shards put back together against the one-chip layer on the whole graph
    n_pad = resid.n_pad
    for layer, (fn, names, extra) in layers.items():
        out = torch.zeros((ep * n_local, h), dtype=bf16, device=dev)
        dxs = torch.zeros((ep * n_local, d), dtype=torch.float32, device=dev)
        dparams = [torch.zeros_like(prm[k]) for k in names]
        for p in range(ep):
            y, gr = got[(layer, p)]
            out[p * n_local:(p + 1) * n_local] = y[:n_local]
            dxs[p * n_local:(p + 1) * n_local] += gr[0][:n_local].float()
            dxs.index_add_(0, halo_rows(p), gr[1].float())  # dhalo back to its owners
            for acc, gv in zip(dparams, gr[2:]):
                acc += gv
        xg = torch.zeros((n_pad, d), dtype=bf16, device=dev)
        xg[:n] = x
        xg.requires_grad_()
        ps = [prm[k].clone().requires_grad_() for k in names]
        if layer == "halo_fused_sage_ln_ov":
            y1 = tbr.banded_residual_sage_ln_apply(xg, *ps, resid, True, HALO_SLOPE, LN_EPS)
        else:
            y1 = tbr.banded_residual_sage_apply(xg, *ps, resid, True, HALO_SLOPE)
        torch.autograd.backward(y1, square_loss_cotangent(y1, n))
        rel = ((out[:n].float() - y1[:n].float()).abs().max()
               / y1[:n].float().abs().max()).item()
        worst = step_grad_excess(f"{layer} assembled", ("x",) + names,
                                 [dxs[:n]] + dparams, [xg.grad[:n]] + [v.grad for v in ps])
        log(f"{layer}: the {ep} shards' output in global order against the one-chip "
            f"{'banded_residual_sage_ln_apply' if 'ln' in layer else 'banded_residual_sage_apply'}"
            f" (banded-residual layout, tile {BANDED_TILE}, K {BANDED_K}; kernels on both sides, "
            f"bf16, the sums in other orders): max|err|/max|out| {rel:.2e} (tol "
            f"{HALO_ASSEMBLED_REL}); "
            f"dx (each shard's plus its dhalo rows sent back) and the summed partial "
            f"{', '.join('d' + k for k in names)} within rtol {STEP_GRAD_TOL} + {STEP_GRAD_TOL} "
            f"* (max|g| + {STEP_GRAD_FLOOR}) (largest excess {worst:.3e})")
        if rel > HALO_ASSEMBLED_REL or not torch.isfinite(out[:n]).all():
            raise AssertionError(f"{layer}: the shards do not assemble to the one-chip layer")
        del xg, ps, y1, dxs
    del got
    torch.cuda.empty_cache()

    # times on the shard with the most boundary groups
    p = int(np.argmax(groups_b))
    int_fwd, _, b_p = shard_lays[p]
    inputs = shard_inputs(p)
    xp, halo = inputs
    for layer, (fn, names, extra) in layers.items():
        args = [prm[k] for k in names]
        with torch.no_grad():
            fwd_ms, _ = timed(lambda: fn(xp, halo, *args, *shard_lays[p], True, *extra),
                              iters=10)
        set_counts_to_zero(mods)
        run(layer, p, inputs)
        torch.cuda.synchronize()
        per_layer = {k: v for k, v in read_counts(mods).items() if v}
        both_ms, _ = timed(lambda: run(layer, p, inputs), iters=10)
        log(f"{layer} shard {p} ({groups_b[p]} boundary groups, m_b {b_p.m_b}): forward "
            f"{fwd_ms:.4f} ms, backward {both_ms - fwd_ms:.4f} ms (forward and backward "
            f"{both_ms:.4f} ms, CUDA events around back-to-back calls); launches a layer "
            f"{per_layer}; on {smi}")
        profile_steps(lambda: run(layer, p, inputs), f"{layer} shard {p} forward and backward",
                      BANDED_KERNEL_KEYS)
    r_io = thf.io_fwd_compact(xp, b_p).to(bf16)
    kw = dict(negative_slope=HALO_SLOPE, ln=ln, resid=(r_io, b_p.rg_io))
    kw_y = dict(kw, ypre=(b_p.rg_b, b_p.m_b))
    # ypre with no group mapped: the output's cost without its stores
    kw_0 = dict(kw, ypre=(torch.zeros_like(b_p.rg_b), b_p.m_b))
    fwd_args = (xp, prm["wl"], prm["wr"], prm["b"], int_fwd)
    turns = [timed(lambda: tsf.banded_sage_fwd(*fwd_args, **k), iters=20)[0]
             for k in (kw, kw_y, kw_0, kw_0, kw_y, kw)]
    ms = (turns[1] + turns[4]) / 2
    plain_ms, _ = timed(lambda: tsf.banded_sage_fwd_plain(*fwd_args, **kw_y), iters=3, warmup=1)
    # the library yardstick: cuSPARSE over the shard's interior edges (the
    # global 1/deg), the dense products, bias, LayerNorm and the activation
    # in f32
    own = (dst // n_local == p) & (src // n_local == p)
    deg = np.bincount(dst, minlength=n)
    w = torch.from_numpy((1.0 / np.maximum(deg, 1))[dst[own]].astype(np.float32))
    idx = torch.from_numpy(np.stack([dst[own] - p * n_local, src[own] - p * n_local]))
    m_int = torch.sparse_coo_tensor(idx, w, (n_pad_local, n_pad_local)).coalesce().to(
        dev).to_sparse_csr()
    x32, wl32, wr32 = xp.float(), prm["wl"], prm["wr"]

    def library():
        y = torch.sparse.mm(m_int, x32) @ wl32 + x32 @ wr32 + prm["b"]
        return torch.nn.functional.leaky_relu(torch.nn.functional.layer_norm(
            y, (h,), prm["gamma"], prm["beta"], LN_EPS), HALO_SLOPE)

    library_ms, _ = timed(library, iters=10)
    ypre_bytes = b_p.m_b * kt * h * 4
    nbytes, flops = banded_cost(int_fwd, d, h, 2, "fwd",
                                r_io.numel() * 2 + n_pad_local * (h * 2 + 4) + ypre_bytes)
    bound_ms, bound_by = bound(nbytes, flops, PEAK_BF16_FLOP_S)
    log(f"banded_sage_fwd shard {p} (LN, LeakyReLU {HALO_SLOPE}, interior-overflow residual), "
        f"in turns without, with, with none mapped, with none mapped, with, without ypre: "
        f"{', '.join(f'{t:.4f}' for t in turns)} ms; with ypre {ms:.4f} ms, with none mapped "
        f"{(turns[2] + turns[3]) / 2:.4f} ms, without {(turns[0] + turns[5]) / 2:.4f} ms "
        f"(y_pre_c {ypre_bytes / 1e6:.2f} MB), plain {plain_ms:.4f} ms, library "
        f"{library_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP)")
    return dict(name="banded_sage_fwd", route="cuda",
                source="sldm_gnn_tpu_torch/csrc/sage_fused_fwd.cu",
                replaces="sldm_gnn_tpu/ops/sage_fused.py:283", layout="ypre",
                path="halo overlap", launches=counts["banded_sage_fwd"],
                shape=f"shard {p} of {ep}: N={n_pad_local} D={d} H={h} bf16, LN, LeakyReLU "
                      f"{HALO_SLOPE}, interior-overflow residual, ypre m_b {b_p.m_b}",
                max_abs_err=ypre_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def check_int8_sddmm(mods: dict, lays: dict, graph, gen, dev) -> list[dict]:
    """The int8 and SDDMM path at bench.py's width, through the entry points:
    ``quantize_rows`` (round to nearest and stochastic) and
    ``quantize_tensor_xla`` of x [n_pad, 128], ``spmm_int8`` and
    ``spmm_int8_pt`` over the one-hot layout (k_per_step 2), and
    ``sddmm_apply`` of x, y [n_pad, 128] over prepare_sddmm's layouts,
    forward and backward (loss sum(tanh(score) * c)). Counts set to 0 just
    before the path and read just after; then the same path through the
    plain versions (bit-equal quantizers, AGG_F32_REL int8 sums, SDDMM_REL
    scores, STEP_GRAD_TOL gradients), again through the kernels (the same
    bits), the outputs against the f32 references, and times of kernel,
    plain version and a library call."""
    tq, tsp, tsd = mods["quant"], mods["spmm"], mods["sddmm"]
    (of, _), n1 = lays["onehot"]
    src, dst = graph
    d, n_edges = BENCH_DIM, len(src)
    t0 = time.perf_counter()
    sf, sr, n2 = tsd.prepare_sddmm(src, dst, BENCH_NODES)
    log(f"SDDMM layouts in {time.perf_counter() - t0:.3f} s on the host: n_pad {n2}, "
        f"{sf.num_chunks}/{sr.num_chunks} chunks of {sf.edge_chunk} slots (fwd/rev)")
    sf, sr = sf.to(dev), sr.to(dev)
    x = torch.randn((n1, d), generator=gen).to(dev)
    xa, ya = (torch.randn((n2, d), generator=gen).to(dev) for _ in range(2))
    coef = torch.randn(n_edges, generator=gen).to(dev)

    def path():
        xq, xs = tq.quantize_rows(x)
        sq, ss = tq.quantize_rows(x, stochastic=True, seed=QUANT_SEED)
        pq, ps = tq.quantize_tensor_xla(x)
        out_row = tsp.spmm_int8(xq, xs, of, n1, k_per_step=ONEHOT_K)
        out_pt = tsp.spmm_int8_pt(pq, ps, of, n1, k_per_step=ONEHOT_K)
        xg, yg = xa.detach().requires_grad_(), ya.detach().requires_grad_()
        score = tsd.sddmm_apply(xg, yg, sf, sr, n2, True, n_edges)
        gx, gy = torch.autograd.grad((torch.tanh(score) * coef).sum(), [xg, yg])
        return dict(q=xq, s=xs, sq=sq, ss=ss, pq=pq, ps=ps, out_row=out_row, out_pt=out_pt,
                    score=score.detach(), gx=gx, gy=gy)

    set_counts_to_zero(mods)
    got = path()
    torch.cuda.synchronize()
    counts = read_counts(mods)
    want = {"quantize_rows": 2, "spmm_int8": 1, "spmm_int8_pt": 1, "sddmm": 1, "spmm_onehot": 2}
    log(f"int8 + SDDMM path: launches {counts}")
    if any(counts[k] != v for k, v in want.items()) or \
            sum(counts.values()) != sum(want.values()):
        raise AssertionError(f"int8 + SDDMM path: launches {counts}, want {want}")
    again = path()
    with graph_plain_versions(mods):
        plain = path()
    torch.cuda.synchronize()
    unstable = [k for k in got if not torch.equal(got[k], again[k])]
    errs = {}
    for name, keys, tol in (("quantize_rows", ("q", "s", "sq", "ss"), None),
                            ("spmm_int8", ("out_row",), AGG_F32_REL),
                            ("spmm_int8_pt", ("out_pt",), AGG_F32_REL),
                            ("sddmm", ("score",), SDDMM_REL)):
        err = max((got[k].float() - plain[k].float()).abs().max().item() for k in keys)
        rel = err / max(plain[keys[0]].float().abs().max().item(), 1e-30)
        equal = all(torch.equal(got[k], plain[k]) for k in keys)
        log(f"{name} {'/'.join(keys)}: max|err| {err:.3e}, {rel:.2e} of max|plain| (tol "
            f"{'bit-equal' if tol is None else tol}; bit-equal {equal})")
        if not all(torch.isfinite(got[k].float()).all() for k in keys) or \
                (not equal if tol is None else rel > tol):
            raise AssertionError(f"{name} kernel disagrees with its plain version")
        errs[name] = err
    worst = step_grad_excess("sddmm_apply backward", ("x", "y"), (got["gx"], got["gy"]),
                             (plain["gx"], plain["gy"]))
    log(f"sddmm_apply gradients of x and y through the kernels vs the plain versions within "
        f"the STEP_GRAD_TOL scale (largest excess {worst:.3e}); the whole path again through "
        f"the kernels bit-equal: {not unstable} {unstable or ''}")
    if unstable:
        raise AssertionError(f"int8 + SDDMM path: a second run differs in {unstable}")

    # against the references: the f32 aggregation of the unquantized x, the
    # edge-order reference scores; x / s - q within half a step (round to
    # nearest) and within one step with mean 0 (stochastic: q = floor(x / s
    # + u) leaves x / s - q in [-1, 1), unbiased; -1 where the f32 sum
    # x / s + u rounds up to the next integer, as on the TPU)
    ref = tsp.spmm_onehot(x, of, precision="highest", k_per_step=ONEHOT_K)
    for key in ("out_row", "out_pt"):
        rel = ((got[key] - ref).abs().max() / ref.abs().max()).item()
        log(f"{key} vs the f32 aggregation of x: {rel:.3e} of max|out| (tol {INT8_REL})")
        if rel > INT8_REL:
            raise AssertionError(f"{key}: int8 aggregation far from the f32 one")
    ts, td = (torch.from_numpy(a).to(dev) for a in graph)
    sref = tsd.sddmm_xla(xa, ya, ts, td)
    rel = ((got["score"] - sref).abs().max() / sref.abs().max()).item()
    near = (x / got["s"] - got["q"].float()).abs().max().item()
    step = x / got["ss"] - got["sq"].float()
    lo, hi, mean = step.min().item(), step.max().item(), step.mean().item()
    log(f"SDDMM scores vs sddmm_xla: {rel:.3e} of max|score| (tol {SDDMM_REL}); x / s - q: "
        f"round to nearest max |.| {near:.4f}, stochastic in [{lo:.4f}, {hi:.4f}], mean "
        f"{mean:.2e} over {step.numel()} values")
    if rel > SDDMM_REL or near > 0.5 or lo < -1.0 or hi >= 1.0 or abs(mean) > 1e-3:
        raise AssertionError("SDDMM scores or the quantizers off their references")
    del again, plain, ref, sref, step
    torch.cuda.empty_cache()

    # times; the library yardsticks are used nowhere in the port
    xq, xs, pq, ps = got["q"], got["s"], got["pq"], got["ps"]
    csr = mean_csr(src, dst, n1, dev)
    deq_row, deq_pt = tq.dequantize_rows(xq, xs), pq.float() * ps
    pattern = torch.sparse_coo_tensor(
        torch.stack([td, ts]), torch.ones(n_edges, device=dev), (n2, n2)).coalesce().to_sparse_csr()
    yt = ya.T.contiguous()
    live_o = int((of.weight != 0).sum())
    slots_o, slots_s = of.src_local.numel(), sf.src_local.numel()
    scales = xs[:, 0].double()
    zeros = torch.zeros(n1, dtype=torch.int64, device=dev)

    def library(name, fn):
        try:
            fn()
        except (RuntimeError, NotImplementedError) as exc:
            log(f"{name} library call unavailable: {str(exc).splitlines()[0]}")
            return None
        return timed(fn, iters=10)[0]

    runs = [
        ("quantize_rows", "sldm_gnn_tpu_torch/csrc/quant_rows.cu", "sldm_gnn_tpu/ops/quant.py:85",
         f"x [{n1}, {d}] f32, round to nearest",
         lambda: tq.quantize_rows(x), lambda: tq.quantize_rows_plain(x),
         "torch.quantize_per_channel with the kernel's scales (no PyTorch call computes the "
         "absmax scales too)",
         lambda: torch.quantize_per_channel(x, scales, zeros, 0, torch.qint8),
         (n1 * d * 4 + n1 * d + n1 * 4, 3.0 * n1 * d), PEAK_F32_FLOP_S),
        ("spmm_int8", "sldm_gnn_tpu_torch/csrc/spmm_onehot_int8.cu",
         "sldm_gnn_tpu/ops/spmm.py:329",
         f"N={n1} D={d} one-hot fwd layout (tile {ONEHOT_TILE}, {of.num_chunks} chunks of "
         f"{of.edge_chunk}), int8 x, per-row scales, f32 out",
         lambda: tsp.spmm_int8(xq, xs, of, n1, k_per_step=ONEHOT_K),
         lambda: tsp.spmm_int8_plain(xq, xs, of, n1, k_per_step=ONEHOT_K),
         "cuSPARSE CSR f32 on the dequantized x", lambda: torch.sparse.mm(csr, deq_row),
         (of.num_chunks * 8 + slots_o * 12 + n1 * d + n1 * 4 + n1 * d * 4, 2.0 * live_o * d),
         PEAK_F32_FLOP_S),
        ("spmm_int8_pt", "sldm_gnn_tpu_torch/csrc/spmm_onehot_int8.cu",
         "sldm_gnn_tpu/ops/spmm.py:443",
         f"N={n1} D={d} one-hot fwd layout, int8 x, per-tensor scale, f32 out",
         lambda: tsp.spmm_int8_pt(pq, ps, of, n1, k_per_step=ONEHOT_K),
         lambda: tsp.spmm_int8_pt_plain(pq, ps, of, n1, k_per_step=ONEHOT_K),
         "cuSPARSE CSR f32 on the dequantized x", lambda: torch.sparse.mm(csr, deq_pt),
         (of.num_chunks * 8 + slots_o * 12 + n1 * d + 4 + n1 * d * 4, 2.0 * live_o * d),
         PEAK_F32_FLOP_S),
        ("sddmm", "sldm_gnn_tpu_torch/csrc/sddmm.cu", "sldm_gnn_tpu/ops/sddmm.py:92",
         f"N={n2} D={d} prepare_sddmm fwd layout (tile {sf.tile}, {sf.num_chunks} chunks of "
         f"{sf.edge_chunk}), f32",
         lambda: tsd.sddmm(xa, ya, sf), lambda: tsd.sddmm_plain(xa, ya, sf),
         "torch.sparse.sampled_addmm on a CSR of the graph",
         lambda: torch.sparse.sampled_addmm(pattern, xa, yt, beta=0.0),
         (sf.num_chunks * 8 + slots_s * 12 + 2 * n2 * d * 4 + slots_s * 4, 2.0 * n_edges * d),
         PEAK_F32_FLOP_S),
    ]
    entries = []
    for name, source, replaces, shape, kernel, plain_fn, lib_name, lib_fn, cost, peak in runs:
        ms, host = timed(kernel, iters=10)
        plain_ms, _ = timed(plain_fn, iters=3, warmup=1)
        library_ms = library(name, lib_fn)
        bound_ms, bound_by = bound(*cost, peak)
        lib_txt = "unavailable" if library_ms is None else f"{library_ms:.4f} ms"
        log(f"{name} timing ({shape}): kernel {ms:.4f} ms (host issue {host:.4f}), plain "
            f"{plain_ms:.4f} ms, {lib_name} {lib_txt}, bound {bound_ms:.4f} ms ({bound_by}: "
            f"{cost[0] / 1e6:.1f} MB, {cost[1] / 1e9:.2f} G operations)")
        entries.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            shape=shape, path="int8 + SDDMM", launches=counts[name],
                            max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms))
    return entries


def check_reorder(mods: dict, graph) -> None:
    """graph/reorder on bench.py's graph with its node ids shuffled as
    BENCH_SHUFFLE=1 shuffles them: host seconds and the recovered span."""
    tro = mods["reorder"]
    src, dst = graph
    scramble = np.random.default_rng(SHUFFLE_SEED).permutation(BENCH_NODES)
    s2, d2 = scramble[src], scramble[dst]
    span0 = tro.source_span_tiles(s2, d2, BENCH_NODES)
    t0 = time.perf_counter()
    perm = tro.reorder_for_banding(s2, d2, BENCH_NODES)
    secs = time.perf_counter() - t0
    span1 = tro.source_span_tiles(*tro.relabel_edges(s2, d2, perm), BENCH_NODES)
    log(f"reorder of the shuffled graph ({len(src)} edges): {secs:.3f} s on the host, span "
        f"{span0} -> {span1} tiles of {BANDED_TILE} (unshuffled "
        f"{tro.source_span_tiles(src, dst, BENCH_NODES)})")
    if perm is None or span1 > 16:
        raise AssertionError("the reorder did not band the shuffled graph")

# ---------------- the v1 GRU, GruSage's other paths, the megakernel, cmap


def v1_leaves(gen, h: int, layers: int, dev) -> list[torch.Tensor]:
    """GRUParams' leaves of a v1 stack over FEATURES inputs: the first
    layer's w_ih, w_hh, b_ih, b_hh, then the upper layers' stacked (empty at
    one layer)."""
    w0 = gru_weights(gen, FEATURES, h, dev)  # (w_ih, b_ih, w_hh, b_hh)
    rest = [gru_weights(gen, h, h, dev) for _ in range(layers - 1)]

    def stacked(i, shape):
        return torch.stack([r[i] for r in rest]) if rest else \
            torch.zeros((0,) + shape, device=dev)

    return [w0[0], w0[2], w0[1], w0[3], stacked(0, (h, 3 * h)), stacked(2, (h, 3 * h)),
            stacked(1, (3 * h,)), stacked(3, (3 * h,))]


def v1_grads(forward, leaves, x, coef):
    """(outputs, gradients of sum(out * coef) + sum(h_last^2) by x and every
    non-empty leaf) of a GRU stack `forward`."""
    from sldm_gnn_tpu_torch.ops.gru import GRUParams

    ps = [t.detach().clone().requires_grad_(t.numel() > 0) for t in leaves]
    xg = x.detach().clone().requires_grad_()
    out, h_last = forward(GRUParams(*ps), xg)
    loss = (out * coef).sum() + (h_last ** 2).sum()
    return out.detach(), torch.autograd.grad(loss, [xg, *[p for p in ps if p.requires_grad]])


def v1_agreement(out_k, g_k, out_p, g_p, tol: float) -> tuple[bool, float]:
    """(outputs within SCAN_TOL of the f32 scan's, the largest excess of a
    gradient over tol * |g| as a share of its max|g| + 1e-6)."""
    ok = bool(((out_k - out_p).abs() <= SCAN_TOL + SCAN_TOL * out_p.abs()).all())
    excess = max(((a - b).abs() - tol * b.abs()).max().item() / (b.abs().max().item() + 1e-6)
                 for a, b in zip(g_k, g_p))
    return ok, excess


def check_gru_scan(mods: dict, gen, dev, smi: str) -> list[dict]:
    """The v1 GRU scan (gru_forward_v1: the input projection by torch.matmul,
    then gru_scan_fwd / gru_scan_bwd through GruScanFn) at the flagship
    training batch's rows, T=100, D=6, H=96, at 1 and 2 layers: forward,
    then backward of sum(out * coef) + sum(h_last^2) through the kernels
    (launch counts set to 0 just before, read just after), against the f32
    scan (ops/gru.gru_forward) under autograd: outputs at SCAN_TOL, the
    gradients of x and every parameter at SCAN_GRAD_TOL[layers] of max|g| +
    1e-6; a second run bit-equal. Then each kernel against its plain version
    and times of kernel, plain version and cuDNN's f32 GRU (TF32 off)."""
    from sldm_gnn_tpu_torch.ops.gru import gru_forward

    gru_cuda = mods["gru_cuda"]
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: the v1 scan's xproj would not be f32")
    n = flagship_rows(np.random.default_rng(SEED))
    h = HIDDEN
    x = torch.randn((n, FRAMES, FEATURES), generator=gen).to(dev)
    coef = torch.randn((n, FRAMES, h), generator=gen).to(dev)
    errs = {"gru_scan_fwd": 0.0, "gru_scan_bwd": 0.0}
    counts = None
    for layers in (1, 2):
        leaves = v1_leaves(gen, h, layers, dev)
        set_counts_to_zero(mods)
        out_k, g_k = v1_grads(gru_cuda.gru_forward_v1, leaves, x, coef)
        torch.cuda.synchronize()
        c = read_counts(mods)
        want = {"gru_scan_fwd": layers, "gru_scan_bwd": layers}
        if any(c[k] != v for k, v in want.items()) or sum(c.values()) != sum(want.values()):
            raise AssertionError(f"v1 GRU {layers} layer(s): launches {c}, want {want}")
        if layers == 1:
            counts = c
        out_a, g_a = v1_grads(gru_cuda.gru_forward_v1, leaves, x, coef)
        out_p, g_p = v1_grads(gru_forward, leaves, x, coef)
        torch.cuda.synchronize()
        stable = torch.equal(out_k, out_a) and all(torch.equal(a, b) for a, b in zip(g_k, g_a))
        e_out = (out_k - out_p).abs().max().item()
        tol = SCAN_GRAD_TOL[layers]
        ok_out, worst = v1_agreement(out_k, g_k, out_p, g_p, tol)
        log(f"v1 GRU N={n} T={FRAMES} D={FEATURES} H={h}, {layers} layer(s): outputs vs the f32 "
            f"scan max_abs {e_out:.3e} (rtol/atol {SCAN_TOL}: {ok_out}); {len(g_k)} gradients "
            f"within rtol {tol} + {tol} * (max|g| + 1e-6): largest excess {worst:.3e} of that "
            f"scale; launches {c}; a second run bit-equal {stable}")
        if not ok_out or worst > tol or not stable or not torch.isfinite(out_k).all():
            raise AssertionError(f"v1 GRU at {layers} layer(s) disagrees with the f32 scan")
        del out_k, g_k, out_a, g_a, out_p, g_p
    torch.cuda.empty_cache()

    # each kernel against its plain version, at the first layer's shapes
    w_ih, b_ih, w_hh, b_hh = gru_weights(gen, FEATURES, h, dev)
    xproj = (torch.matmul(x, w_ih) + b_ih).transpose(0, 1)  # [T, N, 3H] view
    g = coef.transpose(0, 1)
    hs = gru_cuda.gru_scan_fwd(xproj, w_hh, b_hh)
    hs_p = gru_cuda.gru_scan_fwd_plain(xproj, w_hh, b_hh)
    d_k = gru_cuda.gru_scan_bwd(xproj, hs, w_hh, b_hh, g)
    d_p = gru_cuda.gru_scan_bwd_plain(xproj, hs, w_hh, b_hh, g)
    torch.cuda.synchronize()
    errs["gru_scan_fwd"] = (hs - hs_p).abs().max().item()
    errs["gru_scan_bwd"] = max((a - b).abs().max().item() for a, b in zip(d_k, d_p))
    rel = [((a - b).abs().max() / (b.abs().max() + 1e-6)).item() for a, b in zip(d_k, d_p)]
    log(f"gru_scan_fwd vs its plain version: max_abs {errs['gru_scan_fwd']:.3e}; gru_scan_bwd "
        f"(dxproj, dW_hh, db_hh) max|err| / (max|plain| + 1e-6) {['%.2e' % r for r in rel]}")
    if errs["gru_scan_fwd"] > SCAN_TOL or max(rel) > SCAN_GRAD_TOL[1]:
        raise AssertionError("a v1 GRU kernel disagrees with its plain version")
    del hs_p, d_k, d_p

    # the widest H the kernels take (shared memory, registers): SCAN_WIDEST_H
    # runs, one more raises a ValueError that names it
    import ctypes

    from sldm_gnn_tpu_torch.ops import _build

    lib = _build.load()
    widest = gru_cuda.SCAN_WIDEST_H

    def fwd_takes(hh):
        try:
            gru_cuda.gru_scan_fwd(torch.zeros((1, 1, 3 * hh), device=dev),
                                  torch.zeros((hh, 3 * hh), device=dev),
                                  torch.zeros(3 * hh, device=dev))
        except ValueError as err:
            if "than a block may use" not in str(err):
                raise
            return False
        return True

    def bwd_takes(hh):
        return lib.gru_scan_bwd_grid(1, hh, ctypes.byref(ctypes.c_int(0))) == 0

    probe = {"forward": (fwd_takes(widest["forward"]), fwd_takes(widest["forward"] + 1)),
             "backward": (bwd_takes(widest["backward"]), bwd_takes(widest["backward"] + 1))}
    log(f"v1 GRU widest H on this card (takes H, takes H + 1): {probe} at H = {widest}")
    if any(p != (True, False) for p in probe.values()):
        raise AssertionError("the v1 scan's widest H differs from SCAN_WIDEST_H")
    # the backward's row tile by width, as the library reports it, against
    # the kernel's header: 32 rows at H <= SCAN_BWD_H_32_ROWS, 16 up to the
    # widest, none past it
    tiles = {hh: gru_cuda.gru_scan_bwd_rows(hh) for hh in range(1, widest["backward"] + 2)}
    want_tiles = {hh: 32 if hh <= SCAN_BWD_H_32_ROWS else 16 if hh <= widest["backward"] else 0
                  for hh in tiles}
    log(f"v1 backward row tile by H (gru_scan_bwd_rows): 32 rows at H <= "
        f"{max((hh for hh, m in tiles.items() if m == 32), default=0)}, 16 at H <= "
        f"{max((hh for hh, m in tiles.items() if m == 16), default=0)}, "
        f"{tiles[widest['backward'] + 1]} at {widest['backward'] + 1}")
    if tiles != want_tiles:
        raise AssertionError(f"the v1 backward's row tiles differ from the header's: "
                             f"{ {hh: m for hh, m in tiles.items() if m != want_tiles[hh]} }")

    fwd_ms, fwd_host = timed(lambda: gru_cuda.gru_scan_fwd(xproj, w_hh, b_hh), iters=10)
    bwd_ms, bwd_host = timed(lambda: gru_cuda.gru_scan_bwd(xproj, hs, w_hh, b_hh, g), iters=3)
    fwd_plain, _ = timed(lambda: gru_cuda.gru_scan_fwd_plain(xproj, w_hh, b_hh), iters=2,
                         warmup=1)
    bwd_plain, _ = timed(lambda: gru_cuda.gru_scan_bwd_plain(xproj, hs, w_hh, b_hh, g),
                         iters=2, warmup=1)
    # yardstick: cuDNN's f32 GRU with the same weights, TF32 off; it
    # computes the input projection too, which the kernels take as given
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        lib = torch.nn.GRU(FEATURES, h, batch_first=True).to(dev)
        with torch.no_grad():
            lib.weight_ih_l0.copy_(w_ih.T)
            lib.weight_hh_l0.copy_(w_hh.T)
            lib.bias_ih_l0.copy_(b_ih)
            lib.bias_hh_l0.copy_(b_hh)
        params = list(lib.parameters())
        lib_fwd, _ = timed(lambda: lib(x), iters=10)

        def lib_fwd_bwd():
            out, _ = lib(x)
            torch.autograd.grad(out, params, coef)

        lib_bwd = timed(lib_fwd_bwd, iters=10)[0] - lib_fwd
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    rows, H3 = n * FRAMES, 3 * h
    io = rows * H3 * 4 + rows * h * 4  # xproj and hs (or g)
    # the forward's h @ W_hh runs as 3xTF32: three TF32 products
    fwd_bound = bound(io + (H3 * h + H3) * 4, 3 * 2.0 * rows * H3 * h, PEAK_TF32_FLOP_S)
    # the backward reads xproj, hs and g and writes dxproj (2 io); its three
    # products run as 3xTF32: three TF32 products each
    bwd_bound = bound(2 * io + (H3 * h + H3) * 8, 3 * 6.0 * rows * H3 * h,
                      PEAK_TF32_FLOP_S)
    for name, ms, host, plain_ms, lib_ms, bnd in (
            ("gru_scan_fwd", fwd_ms, fwd_host, fwd_plain, lib_fwd, fwd_bound),
            ("gru_scan_bwd", bwd_ms, bwd_host, bwd_plain, lib_bwd, bwd_bound)):
        log(f"{name} timing N={n} T={FRAMES} H={h}: kernel {ms:.4f} ms (host issue {host:.4f}), "
            f"plain {plain_ms:.4f} ms, cuDNN f32 GRU {'forward' if name.endswith('fwd') else 'backward'} "
            f"(with the input projection) {lib_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}), on {smi}")
    del xproj, hs, g, x, coef
    torch.cuda.empty_cache()
    common = dict(route="cuda", path="v1 GRU (gru_forward_v1, 1 layer)",
                  source="sldm_gnn_tpu_torch/csrc/gru_scan.cu")
    return [
        dict(name="gru_scan_fwd", replaces="sldm_gnn_tpu/ops/gru_pallas.py:125",
             shape=f"N={n} T={FRAMES} H={h} xproj f32", launches=counts["gru_scan_fwd"],
             max_abs_err=errs["gru_scan_fwd"], ms=fwd_ms, plain_ms=fwd_plain,
             bound_ms=fwd_bound[0], bound_by=fwd_bound[1], library_ms=lib_fwd,
             library="cuDNN nn.GRU f32 forward, input projection included", **common),
        dict(name="gru_scan_bwd", replaces="sldm_gnn_tpu/ops/gru_pallas.py:147",
             shape=f"N={n} T={FRAMES} H={h} per-frame cotangent", launches=counts["gru_scan_bwd"],
             max_abs_err=errs["gru_scan_bwd"], ms=bwd_ms, plain_ms=bwd_plain,
             bound_ms=bwd_bound[0], bound_by=bwd_bound[1], library_ms=lib_bwd,
             library="cuDNN nn.GRU f32 backward, input projection included", **common),
    ]


# the v1 backward's sweep: N around its row tiles (16, 32, 64 rows), T of
# one, two and the flagship's frames, H not a multiple of 4 or 16, past 96
# (where the row tile narrows and dW_hh takes two passes) and the widest;
# the flagship's rows at T 2 (and 100 at the widest); the autograd path at
# one and two layers
SCAN_SWEEP_N = (1, 23, 24, 25, 63, 64, 65)
SCAN_SWEEP_T = (1, 2, FRAMES)
SCAN_SWEEP_H = (8, 20, 33, 64, 96, 100)
SCAN_SWEEP_FN = ((65, 10, 33), (200, 10, 100))  # (N, T, H) through GruScanFn
SCAN_BWD_H_32_ROWS = 112  # the widest H of the backward's 32-row tile (its header)


# the v1 forward's sweep: N around its 16-row m-tiles, T of one, two, an
# odd count and the flagship's frames, H not a multiple of 16 (the padded
# gates), past 96 and the widest; the flagship's rows (blocks of several
# m-tiles) at T 2 for every H and at T 100 for 96 and the widest
SCAN_FWD_SWEEP_N = (1, 15, 16, 17, 33, 64, 65)
SCAN_FWD_SWEEP_T = (1, 2, 37, FRAMES)
SCAN_FWD_SWEEP_H = (8, 20, 33, 64, 96, 100, 112)


def check_gru_scan_fwd_sweep(gru_cuda, dev) -> int:
    """gru_scan_fwd against its plain version: max|hs - plain| within
    SCAN_TOL, every output finite, two launches bit-equal; N in
    SCAN_FWD_SWEEP_N and the flagship's rows, T in SCAN_FWD_SWEEP_T, H in
    SCAN_FWD_SWEEP_H and SCAN_WIDEST_H's; every other case with xproj a
    strided view of [N, T, 3H] (as gru_forward_v1 passes it). The autograd
    path at 1 and 2 layers runs in check_gru_scan and
    check_gru_scan_bwd_sweep. Returns the number of cases."""
    gen = torch.Generator().manual_seed(SEED + 1)
    widest = gru_cuda.SCAN_WIDEST_H["forward"]
    flag = flagship_rows(np.random.default_rng(SEED))
    hs_all = SCAN_FWD_SWEEP_H + (widest,)
    cases = [(n, t, h) for h in hs_all for n in SCAN_FWD_SWEEP_N for t in SCAN_FWD_SWEEP_T]
    cases += [(flag, 2, h) for h in hs_all] + [(flag, FRAMES, h) for h in (HIDDEN, widest)]
    worst = 0.0
    t0 = time.perf_counter()
    for i, (n, t, h) in enumerate(cases):
        w = gru_weights(gen, h, h, dev)
        strided = i % 2 == 1
        xp = torch.randn((n, t, 3 * h) if strided else (t, n, 3 * h), generator=gen) * 0.8
        xp = xp.to(dev)
        if strided:
            xp = xp.transpose(0, 1)
        got, again = (gru_cuda.gru_scan_fwd(xp, w[2], w[3]) for _ in range(2))
        want = gru_cuda.gru_scan_fwd_plain(xp, w[2], w[3])
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        stable = torch.equal(got, again)
        worst = max(worst, err)
        if not err <= SCAN_TOL or not stable or not torch.isfinite(got).all():
            raise AssertionError(f"v1 forward sweep: N={n} T={t} H={h} (strided {strided}): "
                                 f"max|hs - plain| {err:.3e} (tol {SCAN_TOL}), two launches "
                                 f"bit-equal {stable}")
        del xp, got, again, want
    log(f"v1 forward sweep: {len(cases)} cases (N {SCAN_FWD_SWEEP_N} and {flag}, T "
        f"{SCAN_FWD_SWEEP_T}, H {hs_all}; half with strided xproj) within {SCAN_TOL} of the "
        f"plain version (worst {worst:.3e}), two launches bit-equal; "
        f"{time.perf_counter() - t0:.1f} s")
    return len(cases)


def check_gru_scan_bwd_sweep(gru_cuda, dev) -> int:
    """gru_scan_bwd against its plain version: max|err| / (max|plain| +
    1e-6) of dxproj, dW_hh and db_hh within SCAN_GRAD_TOL[1], every output
    finite, two launches bit-equal; N in SCAN_SWEEP_N and the flagship's
    rows, T in SCAN_SWEEP_T, H in SCAN_SWEEP_H and SCAN_WIDEST_H's; every
    other case with xproj and g as strided views of [N, T, .] (as
    gru_forward_v1 passes them). hs from gru_scan_fwd. Then gru_forward_v1
    (GruScanFn) at SCAN_SWEEP_FN, one and two layers, against the f32 scan
    under autograd at SCAN_TOL / SCAN_GRAD_TOL[layers], two runs bit-equal.
    Returns the number of cases."""
    from sldm_gnn_tpu_torch.ops.gru import gru_forward

    gen = torch.Generator().manual_seed(SEED)
    widest = gru_cuda.SCAN_WIDEST_H["backward"]
    flag = flagship_rows(np.random.default_rng(SEED))
    cases = [(n, t, h) for h in SCAN_SWEEP_H + (widest,) for n in SCAN_SWEEP_N
             for t in SCAN_SWEEP_T]
    cases += [(flag, 2, h) for h in SCAN_SWEEP_H + (widest,)] + [(flag, FRAMES, widest)]
    worst = 0.0
    t0 = time.perf_counter()
    for i, (n, t, h) in enumerate(cases):
        w = gru_weights(gen, h, h, dev)
        strided = i % 2 == 1
        xp = torch.randn((n, t, 3 * h) if strided else (t, n, 3 * h), generator=gen) * 0.8
        g = torch.randn((n, t, h) if strided else (t, n, h), generator=gen)
        xp, g = xp.to(dev), g.to(dev)
        if strided:
            xp, g = xp.transpose(0, 1), g.transpose(0, 1)
        hs = gru_cuda.gru_scan_fwd(xp, w[2], w[3])
        got, again = (gru_cuda.gru_scan_bwd(xp, hs, w[2], w[3], g) for _ in range(2))
        want = gru_cuda.gru_scan_bwd_plain(xp, hs, w[2], w[3], g)
        torch.cuda.synchronize()
        rel = [((a - b).abs().max() / (b.abs().max() + 1e-6)).item() for a, b in zip(got, want)]
        stable = all(torch.equal(a, b) for a, b in zip(got, again))
        worst = max(worst, *rel)
        if max(rel) > SCAN_GRAD_TOL[1] or not stable or not all(
                torch.isfinite(a).all() for a in got):
            raise AssertionError(
                f"v1 backward sweep: N={n} T={t} H={h} (strided {strided}): max|err| / "
                f"(max|plain| + 1e-6) {['%.2e' % r for r in rel]} (tol {SCAN_GRAD_TOL[1]}), "
                f"two launches bit-equal {stable}")
        del xp, g, hs, got, again, want
    for (n, t, h), layers in itertools.product(SCAN_SWEEP_FN, (1, 2)):
        leaves = v1_leaves(gen, h, layers, dev)
        x = torch.randn((n, t, FEATURES), generator=gen).to(dev)
        coef = torch.randn((n, t, h), generator=gen).to(dev)
        out_k, g_k = v1_grads(gru_cuda.gru_forward_v1, leaves, x, coef)
        out_a, g_a = v1_grads(gru_cuda.gru_forward_v1, leaves, x, coef)
        out_p, g_p = v1_grads(gru_forward, leaves, x, coef)
        torch.cuda.synchronize()
        stable = torch.equal(out_k, out_a) and all(torch.equal(a, b) for a, b in zip(g_k, g_a))
        ok, excess = v1_agreement(out_k, g_k, out_p, g_p, SCAN_GRAD_TOL[layers])
        if not ok or excess > SCAN_GRAD_TOL[layers] or not stable:
            raise AssertionError(f"v1 GRU N={n} T={t} H={h}, {layers} layer(s): outputs within "
                                 f"SCAN_TOL {ok}, gradient excess {excess:.3e} (tol "
                                 f"{SCAN_GRAD_TOL[layers]}), two runs bit-equal {stable}")
    log(f"v1 backward sweep: {len(cases)} cases (N {SCAN_SWEEP_N} and {flag}, T "
        f"{SCAN_SWEEP_T}, "
        f"H {SCAN_SWEEP_H} and the widest {widest}; half with strided xproj and g) within "
        f"{SCAN_GRAD_TOL[1]} of max|plain| (worst {worst:.2e}), two launches bit-equal; "
        f"gru_forward_v1 at (N, T, H) {SCAN_SWEEP_FN}, 1 and 2 layers, against the f32 scan, "
        f"two runs bit-equal; "
        f"{time.perf_counter() - t0:.1f} s")
    return len(cases)


def check_spmm_mk(mods: dict, graph, gen, dev, smi: str) -> list[dict]:
    """The megakernel SpMM on bench.py's graph with mean weights
    (block_edges at tile 128 and 256-slot chunks, then
    to_megakernel_layout): both modes through the public op (counts set to 0
    just before, read just after), against their plain versions
    (AGG_F32_REL of max|out|) and the f32 naive weighted sum (f32 mode: the
    JAX test's 1e-4 / 1e-3; fast mode, whose x and A are rounded to bf16:
    BANDED_REL of max|out|), two launches bit-equal; times of kernel, plain
    version and cuSPARSE's f32 CSR product."""
    tmk, tcsr = mods["spmm_mk"], mods["csr"]
    src, dst = graph
    n_pad = tcsr.pad_nodes(BENCH_NODES)
    w = tcsr.mean_weights(dst, BENCH_NODES)
    t0 = time.perf_counter()
    mk = tmk.to_megakernel_layout(
        tcsr.block_edges(src, dst, n_pad, weight=w, tile=BANDED_TILE, edge_chunk=MK_CHUNK), n_pad)
    log(f"megakernel layout in {time.perf_counter() - t0:.3f} s on the host: n_pad {n_pad}, "
        f"{mk.num_chunks} chunks of {mk.edge_chunk} slots, tile {mk.tile}")
    mk = mk.to(dev)
    x = torch.randn((n_pad, BENCH_DIM), generator=gen).to(dev)

    set_counts_to_zero(mods)
    got = {fast: tmk.spmm_mk(x, mk, n_pad, fast=fast) for fast in (True, False)}
    torch.cuda.synchronize()
    counts = read_counts(mods)
    if counts["spmm_mk"] != 2 or sum(counts.values()) != 2:
        raise AssertionError(f"megakernel path: launches {counts}, want spmm_mk 2")
    ts, td = (torch.from_numpy(a).to(dev) for a in graph)
    naive = mods["spmm"].spmm_xla(x, ts, td, torch.from_numpy(w).to(dev), n_pad)
    errs = {}
    for fast in (True, False):
        again = tmk.spmm_mk(x, mk, n_pad, fast=fast)
        plain = tmk.spmm_mk_plain(x, mk, n_pad, fast=fast)
        torch.cuda.synchronize()
        err = (got[fast] - plain).abs().max().item()
        rel = err / plain.abs().max().item()
        stable = torch.equal(got[fast], again)
        e_naive = (got[fast] - naive).abs().max().item()
        if fast:  # bf16 x and bf16 A: two roundings of 2^-9 a term
            close = e_naive / naive.abs().max().item() <= BANDED_REL
            what = f"within {BANDED_REL} of max|out|"
        else:
            close = torch.allclose(got[fast], naive, rtol=1e-4, atol=1e-3)
            what = "within rtol 1e-4 / atol 1e-3"
        log(f"spmm_mk fast={fast}: vs plain {rel:.3e} of max|out| (tol {AGG_F32_REL}); vs the f32 "
            f"naive sum {what}: {close} (max_abs {e_naive:.3e}); two launches bit-equal {stable}")
        if rel > AGG_F32_REL or not close or not stable:
            raise AssertionError(f"spmm_mk (fast={fast}) disagrees")
        errs[fast] = err
    del again, plain, naive
    csr = mean_csr(src, dst, n_pad, dev)
    used = int(mk.chunk_ptr[-1])
    nbytes = (2 * n_pad * BENCH_DIM * 4 + used * mk.edge_chunk * 12 + used * 4
              + mk.chunk_ptr.numel() * 4)
    live = int((mk.weight != 0).sum())
    bnd = bound(nbytes, 2.0 * live * BENCH_DIM, PEAK_F32_FLOP_S)
    lib_ms, _ = timed(lambda: torch.sparse.mm(csr, x), iters=10)
    entries = []
    for fast in (True, False):
        ms, host = timed(lambda: tmk.spmm_mk(x, mk, n_pad, fast=fast), iters=10)
        plain_ms, _ = timed(lambda: tmk.spmm_mk_plain(x, mk, n_pad, fast=fast), iters=3, warmup=1)
        mode = "fast (bf16 A and x)" if fast else "f32"
        log(f"spmm_mk timing ({mode}, N={n_pad} D={BENCH_DIM}): kernel {ms:.4f} ms (host issue "
            f"{host:.4f}), plain {plain_ms:.4f} ms, cuSPARSE CSR f32 {lib_ms:.4f} ms, bound "
            f"{bnd[0]:.4f} ms ({bnd[1]}: {nbytes / 1e6:.1f} MB), on {smi}")
        entries.append(dict(name="spmm_mk", route="cuda", source="sldm_gnn_tpu_torch/csrc/spmm_mk.cu",
                            replaces="sldm_gnn_tpu/ops/spmm_mk.py:205", mode=mode,
                            shape=f"N={n_pad} D={BENCH_DIM} megakernel layout ({mk.num_chunks} "
                                  f"chunks of {mk.edge_chunk}), f32 x",
                            path="megakernel op (spmm_mk)", launches=1, max_abs_err=errs[fast],
                            ms=ms, plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1],
                            library_ms=lib_ms))
    del x, mk, csr
    torch.cuda.empty_cache()
    return entries


def scattered_graph(n: int, deg: int, tile: int, seed: int = 0):
    """tests/test_spmm_cmap.py's low-degree generator at scale: every
    destination block draws its sources from 4 preferred source tiles
    scattered over +-8 tiles (local, but not a band)."""
    rng = np.random.default_rng(seed)
    dst = np.repeat(np.arange(n, dtype=np.int64), deg)
    nb = n // tile
    prefs = np.clip(np.arange(nb)[:, None] + rng.integers(-8, 9, (nb, 4)), 0, nb - 1)
    pick = prefs[dst // tile, rng.integers(0, 4, len(dst))]
    src = np.clip(pick * tile + rng.integers(0, tile, len(dst)), 0, n - 1)
    return src.astype(np.int64), dst


def cmap_layout(mods: dict, dev):
    """The scattered graph as the cmap layout (and, for comparison, as the
    contiguous banded-residual layout): host seconds, c and window, A bytes,
    residual; holds that cmap differs from the band's off + s in most
    blocks (else the card run would not exercise cmap)."""
    src, dst = scattered_graph(CMAP_NODES, BENCH_DEG, BANDED_TILE)
    t0 = time.perf_counter()
    lay, n_pad = mods["spmm_cmap"].prepare_cmap_residual_mean_aggregate(
        src, dst, CMAP_NODES, tile=BANDED_TILE, k=BANDED_K, count_cap=COUNT_CAP)
    t1 = time.perf_counter()
    f, r = lay.banded_fwd, lay.banded_rev
    band = f.off.long()[:, None] + torch.arange(f.s_span)[None, :]
    differs = (f.cmap.long().reshape(-1, f.s_span) != band).any(1).float().mean().item()
    log(f"cmap layout of {CMAP_NODES} nodes, {len(src)} edges (scattered, deg {BENCH_DEG}): "
        f"{t1 - t0:.3f} s on the host, n_pad {n_pad}, c {f.s_span}/{r.s_span}, window "
        f"{f.wsz}/{r.wsz} tiles, A {f.a.numel() / 1e6:.1f}+{r.a.numel() / 1e6:.1f} MB, residual "
        f"{lay.resid_frac:.5f} ({len(lay.r_src)} edges); cmap differs from off + s in "
        f"{differs:.4f} of the {f.num_dst_blocks} forward blocks")
    if differs < 0.5:
        raise AssertionError("the cmap layout is nearly a band: the check would prove nothing")
    t0 = time.perf_counter()
    cont, _ = mods["banded_residual"].prepare_banded_residual_mean_aggregate(
        src, dst, CMAP_NODES, tile=BANDED_TILE, k=BANDED_K, count_cap=COUNT_CAP)
    cf, cr = cont.banded_fwd, cont.banded_rev
    log(f"the contiguous banded-residual layout of the same graph: {time.perf_counter() - t0:.3f} "
        f"s, span {cf.s_span}/{cr.s_span}, A {cf.a.numel() / 1e6:.1f}+{cr.a.numel() / 1e6:.1f} "
        f"MB, residual {cont.resid_frac:.5f} ({len(cont.r_src)} edges)")
    del cont
    return lay.to(dev), n_pad, (src, dst)


def check_grusage_rest(mods: dict, batch, md, graphs, dev, smi: str) -> dict:
    """GruSage at the flagship width on the 2048-graph batch with the live
    map, gru_impl 'pallas_sg': (a) the aligned batch (pad_and_batch_aligned,
    vmax 11) with MapData.adj: logits equal the flat batch's at DENSE_TOL,
    then TRAIN_STEPS steps; (b) compute_dtype 'bfloat16' on the same
    weights: logits within BF16_RTOL / BF16_ATOL of f32, then TRAIN_STEPS
    steps; (c) sage_type 'attention': TRAIN_STEPS steps, the loss finite and
    falling. Every run launches the store-gates GRU pair and the KNN kernel
    once a step. Returns the counts of the aligned run."""
    from sldm_gnn_tpu_torch.graph.batching import pad_and_batch_aligned
    from sldm_gnn_tpu_torch.models.grusage import GruSage
    from sldm_gnn_tpu_torch.models.map_modules import dense_map_adj
    from sldm_gnn_tpu_torch.train.loop import build_step_fns, make_optimizer

    t0 = time.perf_counter()
    aligned = pad_and_batch_aligned(graphs, ALIGNED_VMAX, num_frames=FRAMES,
                                    num_labels=LABELS).to(dev)
    md_dense = dataclasses.replace(md, adj=torch.from_numpy(dense_map_adj(md)).to(dev))
    log(f"aligned batch (vmax {ALIGNED_VMAX}, {aligned.node_capacity} rows) and the dense map "
        f"adjacency [1, {SEGMENTS}, {SEGMENTS}] in {time.perf_counter() - t0:.3f} s on the host")
    y = batch.y[batch.graph_mask]
    pos_weight = float((y == 0).sum() / (y == 1).sum().clamp_min(1))

    def model_for(**kw):
        cfg = dataclasses.replace(flagship_config("pallas_sg", 0.25), **kw)
        m = GruSage(cfg, map_feat_dim=MAP_FEATS)
        m.reset_parameters(torch.Generator().manual_seed(SEED))
        return m.to(dev)

    def train(label, model, b, m_data, must_fall):
        fns = build_step_fns(model, make_optimizer(1e-3, 5e-5), map_data=m_data,
                             pos_weight=pos_weight)
        card_gen = torch.Generator(device=dev).manual_seed(SEED)
        state = fns.init(card_gen)
        set_counts_to_zero(mods)
        times, losses = [], []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            state, m = fns.train_step(state, b, card_gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(m["loss"])
        counts = read_counts(mods)
        losses = torch.stack(losses).float().cpu().numpy()
        p50 = float(np.median(times))
        log(f"GruSage {label}: {TRAIN_STEPS} steps (dropout 0.25), losses {losses[0]:.5f} -> "
            f"{losses[-1]:.5f}, p50 {p50:.3f} ms/step ({PACKS / p50 * 1e3:.1f} graphs/s), "
            f"launches {counts}, on {smi}")
        want = {"gru_fwd_sg": TRAIN_STEPS, "gru_bwd_sg": TRAIN_STEPS, "knn_topk": TRAIN_STEPS}
        if any(counts[k] != v for k, v in want.items()) or \
                sum(counts.values()) != sum(want.values()):
            raise AssertionError(f"GruSage {label}: launches {counts}, want {want}")
        if not np.isfinite(losses).all() or (must_fall and not losses[-1] < losses[0]):
            raise AssertionError(f"GruSage {label}: losses {losses}")
        return counts

    # (a) aligned + dense map against flat, then training
    m32 = model_for().eval()
    with torch.no_grad():
        lf = m32(batch, map_data=md)
        ld = m32(aligned, map_data=md_dense)
    g = batch.graph_mask
    err = (ld[g] - lf[g]).abs().max().item()
    ok = bool(((ld[g] - lf[g]).abs() <= DENSE_TOL + DENSE_TOL * lf[g].abs()).all())
    log(f"GruSage aligned batch + MapData.adj vs the flat batch (eval): logits max_abs {err:.3e} "
        f"(rtol/atol {DENSE_TOL}: {ok})")
    if not ok:
        raise AssertionError("the aligned GruSage disagrees with the flat one")
    counts = train("aligned + dense map", m32.train(), aligned, md_dense, False)

    # (b) bf16 compute on the same weights
    m16 = model_for(compute_dtype="bfloat16")
    m16.load_state_dict(model_for().state_dict())
    m32 = model_for().eval()
    m16.eval()
    with torch.no_grad():
        l32, l16 = m32(batch, map_data=md), m16(batch, map_data=md)
    err = (l16[g] - l32[g]).abs().max().item()
    ok = l16.dtype == torch.float32 and \
        bool(((l16[g] - l32[g]).abs() <= BF16_ATOL + BF16_RTOL * l32[g].abs()).all())
    log(f"GruSage compute_dtype bfloat16 vs f32 on the same weights (eval): logits {l16.dtype}, "
        f"max_abs {err:.3e} (rtol {BF16_RTOL} / atol {BF16_ATOL}: {ok})")
    if not ok:
        raise AssertionError("the bf16 GruSage is off the f32 one")
    train("compute_dtype bfloat16", m16.train(), batch, md, False)
    del m16, m32

    # (c) edge attention
    train("sage_type attention", model_for(sage_type="attention"), batch, md, True)
    del aligned, md_dense
    torch.cuda.empty_cache()
    return counts


# the ragged sweep of the two tensor-core kernels (spmm_banded and the
# reverse kernel of banded_sage_bwd / banded_sage_ln_bwd): a small local
# graph (seed 0) at every tile the kernels take a step of, and feature
# widths (D, H) that are not multiples of 16 or 8, or differ, or are the
# widest; the cmap tier on a small scattered graph
SWEEP_NODES = 3000
SWEEP_DEG = 6
SWEEP_TILES = (32, 64, 128)
SWEEP_WIDTHS = ((40, 4), (4, 40), (128, 96))
SWEEP_CMAP_NODES = 4096
# the fused forward's epilogues in the sweep, (bias, LayerNorm, slope): each
# option on and off, and every slope (None: no activation, 0: ReLU, 0.1:
# LeakyReLU) with LayerNorm and without
FWD_EPILOGUES = ((False, False, None), (True, False, 0.0), (False, False, 0.1),
                 (True, True, None), (False, True, 0.0), (True, True, 0.1))
# the wide layout's sweep: one-sided graphs whose source band is exactly
# 1 to 8 tiles (reach (s - 1) * tile - tile / 2 above each row), feature
# widths through the element path (4: rows of 8 or 16 bytes; 40) and TMA
# (128)
WIDE_SWEEP_SPANS = tuple(range(1, 9))
WIDE_SWEEP_D = (4, 40, 128)
# the fused forward's ypre cases: the group -> slot maps (none mapped, every
# group mapped, a random half mapped among spare slots), with and without
# LayerNorm and the residual
YPRE_MAPS = ("none", "all", "random")


def check_ragged_sweep(mods: dict, dev) -> int:
    """spmm_banded, banded_sage_fwd, banded_sage_bwd and banded_sage_ln_bwd
    against their plain versions at BANDED_REL (max|err| / max|plain| per
    output), two launches bit-equal, outputs finite: tiles 32, 64 and 128;
    (D, H) in SWEEP_WIDTHS; bf16 and f32 activations; int8 counts and f32
    weight tiles (a_f32); the forward layout (rs), the reverse layout (cs)
    and neither scale; with and without x; the compact residual; the fused
    forward's FWD_EPILOGUES and its ypre output (YPRE_MAPS, LayerNorm and
    the residual on and off: y_pre_c held with the other outputs, its
    unmapped slots zero in both); and a cmap layout. Then the wide layout's
    cases (wide_sweep). Returns the number of cases held."""
    tsb, tsf, tbr, tcm = (mods[k] for k in ("spmm_banded", "sage_fused", "banded_residual",
                                            "spmm_cmap"))
    gen = torch.Generator().manual_seed(SEED)
    worst = {"spmm_banded": 0.0, "banded_sage_fwd": 0.0, "banded_sage_bwd": 0.0,
             "banded_sage_ln_bwd": 0.0}
    n_cases = 0

    def hold(name, what, kernel, plain):
        nonlocal n_cases
        got, again, want = kernel(), kernel(), plain()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        got, again, want = (v if isinstance(v, tuple) else (v,) for v in (got, again, want))
        rel = max(((a.float() - b.float()).abs().max()
                   / b.float().abs().max().clamp_min(1e-30)).item() for a, b in zip(got, want))
        stable = all(torch.equal(a, b) for a, b in zip(got, again))
        if rel > BANDED_REL or not stable or not all(torch.isfinite(a).all() for a in got):
            raise AssertionError(f"ragged sweep: {name} {what}: max|err|/max|plain| {rel:.3e} "
                                 f"(tol {BANDED_REL}), two launches bit-equal {stable}")
        worst[name] = max(worst[name], rel)
        n_cases += 1

    def rand(*shape, dt=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev, dt)

    def sweep(tag, lay8, lay32, resid, n_pad):
        rev8 = lay8[1]
        for d, h in SWEEP_WIDTHS:
            for dt in (torch.bfloat16, torch.float32):
                dn = f"{tag} D {d} H {h} {'bf16' if dt == torch.bfloat16 else 'f32'}"
                x, g = rand(n_pad, d, dt=dt), rand(n_pad, h, dt=dt)
                wl, wr = rand(d, h, dt=dt, scale=0.2), rand(d, h, dt=dt, scale=0.2)
                spmm = [("int8 forward (rs)", lay8[0]), ("int8 reverse (cs)", rev8),
                        ("no scales", dataclasses.replace(lay8[0], row_scale=None))]
                if lay32 is not None:
                    spmm.append(("f32 weights, reverse (cs)", lay32[1]))
                for what, lay in spmm:
                    hold("spmm_banded", f"{dn} {what}", lambda: tsb.spmm_banded(x, lay),
                         lambda: tsb.spmm_banded_plain(x, lay))
                r_f = (tbr.residual_fwd_compact(x, resid).to(dt), resid.rg_fwd)
                bias = rand(h, scale=0.1)
                ln = (rand(h, scale=0.2) + 1.0, rand(h, scale=0.1))
                fwd = [("int8 (rs)", lay8[0], None),
                       ("int8, no rs", dataclasses.replace(lay8[0], row_scale=None), None),
                       ("residual", resid.banded_fwd, r_f)]
                if lay32 is not None:
                    fwd.append(("f32 weights (rs)", lay32[0], None))
                for (what, lay, rf), (b_on, ln_on, slope) in itertools.product(fwd, FWD_EPILOGUES):
                    kw = dict(negative_slope=slope, resid=rf, ln=ln if ln_on else None)
                    bv = bias if b_on else None
                    hold("banded_sage_fwd",
                         f"{dn} {what}, bias {b_on}, LN {ln_on}, slope {slope}",
                         lambda: tsf.banded_sage_fwd(x, wl, wr, bv, lay, **kw),
                         lambda: tsf.banded_sage_fwd_plain(x, wl, wr, bv, lay, **kw))
                steps = resid.steps
                for kind, (what, lay, rf), ln_on in itertools.product(
                        YPRE_MAPS, fwd[::2], (False, True)):
                    rg_b, m_b = ypre_map(kind, steps, gen)
                    kw = dict(negative_slope=0.1, resid=rf, ln=ln if ln_on else None,
                              ypre=(rg_b.to(dev), m_b))
                    hold("banded_sage_fwd", f"{dn} {what}, ypre {kind} (m_b {m_b}), LN {ln_on}",
                         lambda: tsf.banded_sage_fwd(x, wl, wr, bias, lay, **kw),
                         lambda: tsf.banded_sage_fwd_plain(x, wl, wr, bias, lay, **kw))
                r_r = (tbr.residual_rev_compact(g, resid).to(dt), resid.rg_rev)
                bwd = [("with x", rev8, dict(x=x)), ("without x", rev8, {}),
                       ("no 1/deg, with x", dataclasses.replace(rev8, col_scale=None), dict(x=x)),
                       ("residual, with x", resid.banded_rev, dict(x=x, resid=r_r)),
                       ("residual, without x", resid.banded_rev, dict(resid=r_r))]
                if lay32 is not None:
                    bwd.append(("f32 weights, with x", lay32[1], dict(x=x)))
                for what, lay, kw in bwd:
                    hold("banded_sage_bwd", f"{dn} {what}",
                         lambda: tsf.banded_sage_bwd(g, wl, wr, lay, **kw),
                         lambda: tsf.banded_sage_bwd_plain(g, wl, wr, lay, **kw))
                xhat = rand(n_pad, h, dt=dt)
                rstd = (torch.rand((n_pad, 1), generator=gen) + 0.5).to(dev)
                lnb = [("1/deg", rev8, None),
                       ("no 1/deg", dataclasses.replace(rev8, col_scale=None), None),
                       ("residual", resid.banded_rev, r_r)]
                for what, lay, rs in lnb:
                    kw = dict(negative_slope=0.1, resid=rs)
                    hold("banded_sage_ln_bwd", f"{dn} {what}",
                         lambda: tsf.banded_sage_ln_bwd(g, xhat, rstd, wl, wr, *ln, lay, x, **kw),
                         lambda: tsf.banded_sage_ln_bwd_plain(g, xhat, rstd, wl, wr, *ln, lay, x,
                                                              **kw))

    t0 = time.perf_counter()
    for tile in SWEEP_TILES:
        src, dst = make_local_graph(SWEEP_NODES, SWEEP_DEG, reach=tile, seed=SEED)
        lays = {}
        for dtype in (np.int8, np.float32):
            fwd, rev, n_pad = tsb.prepare_banded_mean_aggregate(src, dst, SWEEP_NODES, tile=tile,
                                                                k=4, dtype=dtype)
            lays[dtype] = (fwd.to(dev), rev.to(dev))
        # the residual layout: the same graph and 25 long edges, which its
        # band of 3 tiles (reach `tile`) leaves out
        o_dst = np.random.default_rng(SEED).integers(0, SWEEP_NODES, 25)
        span = 3
        resid, _ = tbr.prepare_banded_residual_mean_aggregate(
            np.concatenate([src, (o_dst + SWEEP_NODES // 2) % SWEEP_NODES]),
            np.concatenate([dst, o_dst]), SWEEP_NODES, tile=tile, k=4, span=span)
        sweep(f"tile {tile} (span {lays[np.int8][0].s_span}, residual span {span}, "
              f"{len(resid.r_src)} residual edges)", lays[np.int8], lays[np.float32],
              resid.to(dev), n_pad)
    src, dst = scattered_graph(SWEEP_CMAP_NODES, 4, 32, seed=SEED)
    clay, c_pad = tcm.prepare_cmap_residual_mean_aggregate(src, dst, SWEEP_CMAP_NODES, tile=32,
                                                           k=2, range_budget=24,
                                                           resid_frac=0.02)
    clay = clay.to(dev)
    sweep(f"cmap tile 32 (c {clay.banded_fwd.s_span})", (clay.banded_fwd, clay.banded_rev), None,
          clay, c_pad)
    log(f"ragged sweep: {n_cases} cases within {BANDED_REL} of max|plain|, two launches "
        f"bit-equal (worst {', '.join(f'{k} {v:.2e}' for k, v in worst.items())}), "
        f"{time.perf_counter() - t0:.1f} s")
    return n_cases + wide_sweep(tsb, gen, dev)


def ypre_map(kind: str, steps: int, gen) -> tuple[torch.Tensor, int]:
    """A group -> boundary slot map (int32 [steps]) and its slot count m_b:
    no group mapped, every group mapped in order, or a random half of the
    groups on random distinct slots among twice as many."""
    if kind == "none":
        return torch.zeros(steps, dtype=torch.int32), 1
    if kind == "all":
        return torch.arange(1, steps + 1, dtype=torch.int32), steps + 1
    rg = torch.zeros(steps, dtype=torch.int32)
    groups = torch.randperm(steps, generator=gen)[: max(1, steps // 2)]
    rg[groups] = (torch.randperm(2 * len(groups), generator=gen)[: len(groups)] + 1).int()
    return rg, 2 * len(groups) + 1


def wide_sweep(tsb, gen, dev) -> int:
    """spmm_banded on wide layouts (widen_banded): tiles SWEEP_TILES, source
    bands WIDE_SWEEP_SPANS, widths WIDE_SWEEP_D, int8 counts and f32
    weights, bf16 and f32 x, the forward layout (rs), the reverse one (cs)
    and no scales. Each case bit-equal to the narrow kernel on the same
    graph, within BANDED_REL of the plain version, two launches
    bit-equal. Returns the number of cases held."""
    t0 = time.perf_counter()
    n_cases, worst = 0, 0.0
    for tile, span in itertools.product(SWEEP_TILES, WIDE_SWEEP_SPANS):
        rng = np.random.default_rng(SEED + span)
        dst = np.repeat(np.arange(SWEEP_NODES), SWEEP_DEG)
        reach = max(0, (span - 1) * tile - tile // 2)
        src = np.minimum(dst + rng.integers(0, reach + 1, len(dst)), SWEEP_NODES - 1)
        for dtype in (np.int8, np.float32):
            fwd, rev, n_pad = tsb.prepare_banded_mean_aggregate(src, dst, SWEEP_NODES, tile=tile,
                                                                k=4, dtype=dtype)
            if fwd.s_span != span:
                raise AssertionError(f"wide sweep: the graph for span {span} at tile {tile} "
                                     f"has span {fwd.s_span}")
            lays = [(what, lay.to(dev)) for what, lay in (
                ("forward (rs)", fwd), ("reverse (cs)", rev),
                ("no scales", dataclasses.replace(fwd, row_scale=None)))]
            lays = [(what, narrow, tsb.widen_banded(narrow)) for what, narrow in lays]
            for (what, narrow, wide), d, dt in itertools.product(
                    lays, WIDE_SWEEP_D, (torch.bfloat16, torch.float32)):
                x = torch.randn((n_pad, d), generator=gen).to(dev, dt)
                got, again = tsb.spmm_banded(x, wide), tsb.spmm_banded(x, wide)
                want, plain = tsb.spmm_banded(x, narrow), tsb.spmm_banded_plain(x, wide)
                torch.cuda.synchronize()
                rel = ((got.float() - plain.float()).abs().max()
                       / plain.float().abs().max().clamp_min(1e-30)).item()
                case = (f"tile {tile} span {span} {np.dtype(dtype).name} {what} D {d} "
                        f"{'bf16' if dt == torch.bfloat16 else 'f32'}")
                if not torch.equal(got, want) or not torch.equal(got, again) or \
                        rel > BANDED_REL or not torch.isfinite(got).all():
                    raise AssertionError(f"wide sweep {case}: bit-equal to narrow "
                                         f"{torch.equal(got, want)}, two launches bit-equal "
                                         f"{torch.equal(got, again)}, max|err|/max|plain| "
                                         f"{rel:.3e} (tol {BANDED_REL})")
                worst = max(worst, rel)
                n_cases += 1
    log(f"wide sweep: {n_cases} cases of spmm_banded on wide layouts (tiles {SWEEP_TILES}, spans "
        f"{WIDE_SWEEP_SPANS[0]}-{WIDE_SWEEP_SPANS[-1]}, D {WIDE_SWEEP_D}, int8/f32 A, bf16/f32 x, "
        f"rs/cs/no scales), each bit-equal to the narrow kernel and two launches bit-equal, "
        f"within {BANDED_REL} of the plain version (worst {worst:.2e}), "
        f"{time.perf_counter() - t0:.1f} s")
    return n_cases


DENSE_SWEEP_WIDTHS = (4, 40, 96, 128)


# the int8 banded kernel's sweep: tiles 32/64/128, D 4 (the element path:
# rows of 4 bytes), 40 (not a multiple of 16: the element path) and 128
# (TMA), source bands of 1, 5 and 9 tiles, a ragged node count; and the
# exactness case (int8_exact_counts). Every case bit-equal to the plain
# version.
INT8_SWEEP_NODES = 2999
INT8_SWEEP_WIDTHS = (4, 40, 128)
INT8_SWEEP_SPANS = (1, 5, 9)
INT8_EXACT_SOURCES = 1152


def int8_exact_counts() -> np.ndarray:
    """The exactness case: how many times one row takes each of 1152
    sources (9 tiles of 128), with xq = 127 everywhere. Every count is 124
    (a multiple of 4) but source 1087's, 123, and the last one's, 126: the
    sum up to source 1087 is odd and past 2^24, the rest adds 2 mod 4, so
    the exact sum (18141823) rounds once to a multiple of 4 while a sum in
    f32 rounds at 1087 and ends 2 off (int8_f32_sums_differ)."""
    c = np.full(INT8_EXACT_SOURCES, 124, np.int64)
    c[1087], c[-1] = 123, 126
    return c


def int8_f32_sums_differ(contrib: np.ndarray, groups=(1, 16, 32, 64)) -> bool:
    """Whether an f32 accumulator that adds the exact sums of `g`
    consecutive terms in order, for every g in `groups`, ends away from
    the correctly rounded sum of `contrib`: a check that the exactness
    case tells an s32 sum from an f32 one."""
    want = np.float32(int(contrib.sum()))
    for g in groups:
        acc = np.float32(0)
        for i in range(0, len(contrib), g):
            acc = np.float32(acc + np.float32(int(contrib[i:i + g].sum())))
        if acc == want:
            return False
    return True


def check_int8_sweep(mods: dict, dev) -> int:
    """spmm_banded_int8 against its plain version, bit for bit, and two
    launches bit-equal, on INT8_SWEEP's cases; returns the number held."""
    tsb, tq = mods["spmm_banded"], mods["quant"]
    rng = np.random.default_rng(SEED)
    gen = torch.Generator().manual_seed(SEED)
    n_cases = 0

    def hold(what, lay, xq, scale):
        nonlocal n_cases
        got, again = (tsb.spmm_banded_int8(xq, scale, lay) for _ in range(2))
        want = tsb.spmm_banded_int8_plain(xq, scale, lay)
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(got, again)):
            raise AssertionError(
                f"int8 sweep: {what}: max|err| {(got - want).abs().max().item():.3e}, "
                f"two launches bit-equal {torch.equal(got, again)} (must be bit-equal)")
        n_cases += 1
        return got

    t0 = time.perf_counter()
    n = INT8_SWEEP_NODES
    for tile in SWEEP_TILES:
        nb = -(-n // tile)
        for span in INT8_SWEEP_SPANS:
            # sources within span // 2 tiles of the destination's, clipped at
            # the ends; one interior row reaches both ends of its band
            dst = rng.integers(0, n, n * SWEEP_DEG)
            dst[:2] = (nb // 2) * tile
            off = rng.integers(-(span // 2), span // 2 + 1, len(dst))
            off[:2] = (-(span // 2), span // 2)
            src = np.clip(dst // tile + off, 0, nb - 1) * tile + rng.integers(0, tile, len(dst))
            src = np.minimum(src, n - 1)
            fwd, _, n_pad = tsb.prepare_banded_mean_aggregate(src, dst, n, tile=tile, k=1)
            if fwd.s_span != span:
                raise AssertionError(f"int8 sweep: tile {tile} band {span}: s_span {fwd.s_span}")
            lay = fwd.to(dev)
            for d in INT8_SWEEP_WIDTHS:
                xq, scale = tq.quantize_tensor_xla(torch.randn((n_pad, d), generator=gen).to(dev))
                hold(f"tile {tile} s_span {span} D {d} (nb {nb})", lay, xq, scale)
    # the exactness case
    tile = BANDED_TILE
    counts = int8_exact_counts()
    src = np.repeat(np.arange(INT8_EXACT_SOURCES, dtype=np.int64), counts)
    dst = np.full(len(src), INT8_EXACT_SOURCES // 2, np.int64)
    fwd, _, n_pad = tsb.prepare_banded_mean_aggregate(src, dst, INT8_EXACT_SOURCES, tile=tile,
                                                      k=1)
    xq = torch.full((n_pad, BENCH_DIM), 127, dtype=torch.int8, device=dev)
    scale = torch.ones(1, device=dev)
    got = hold(f"exactness, tile {tile} s_span {fwd.s_span}", fwd.to(dev), xq, scale)
    total = int(counts.sum()) * 127
    want = np.float32(total) * np.float32(fwd.row_scale[INT8_EXACT_SOURCES // 2, 0].item())
    if (fwd.s_span != 9 or got[INT8_EXACT_SOURCES // 2, 0].item() != want
            or not int8_f32_sums_differ(counts * 127)):
        raise AssertionError(f"int8 sweep: exactness case {got[INT8_EXACT_SOURCES // 2, 0].item()} "
                             f"!= {want} (sum {total}, s_span {fwd.s_span}), or the case does not "
                             f"tell an f32 sum from an exact one")
    log(f"int8 sweep: {n_cases} cases (tiles {SWEEP_TILES}, D {INT8_SWEEP_WIDTHS}, s_span "
        f"{INT8_SWEEP_SPANS}, {n} nodes; the exactness case, sum {total} > 2^24) bit-equal to "
        f"the plain version, two launches bit-equal; {time.perf_counter() - t0:.1f} s")
    return n_cases


# the gather kernel's sweep: synthetic layouts of GATHER_SWEEP_BLOCKS
# destination blocks (more than two a SM) in groups of 2 over x windows of 4
# tiles, slot counts below, at and past the kernel's 4-slot unroll and the
# 32-slot line (R 31 and 32 at tile 128 split a block into two runs of
# rows), widths that are not a multiple of its 16-byte loads (8 bf16 or 4
# f32 columns) and the widest
GATHER_SWEEP_R = (1, 2, 7, 8, 9, 16, 24, 31, 32)
GATHER_SWEEP_D = (1, 4, 40, 96, 127, 128)
GATHER_SWEEP_BLOCKS = 300
GATHER_SWEEP_MODES = ("forward, row scale", "forward, no scale",
                      "reverse (column scale folded into x)")


def check_gather_sweep(mods: dict, dev) -> int:
    """spmm_gather against its plain version, bit for bit, and two launches
    bit-equal: tiles 32, 64 and 128, R in GATHER_SWEEP_R, D in
    GATHER_SWEEP_D, bf16 and f32 x, with a row scale, without, and the
    reverse direction (a column scale folded into x, as the dispatch does).
    A quarter of the slots are padding (code 0, multiplicity 0), and x's
    first window base row, which the padding slots point at, is infinite:
    the non-finite outputs must fall where the plain version's do. Returns
    the number of cases."""
    tsg = mods["spmm_gather"]
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    nb, k, wsz = GATHER_SWEEP_BLOCKS, 2, 4
    n_cases = 0
    t0 = time.perf_counter()
    for tile, r in itertools.product(SWEEP_TILES, GATHER_SWEEP_R):
        n = nb * tile
        woff = rng.integers(0, nb - wsz + 1, nb // k).astype(np.int32)
        codes = rng.integers(0, wsz * tile, (nb, r * tile + tile, 1)).astype(np.int32)
        mult = rng.integers(1, 4, (nb, r * tile, 1)).astype(np.float32)
        pad = rng.random((nb, r * tile, 1)) < 0.25
        mult[pad] = 0.0
        codes[:, : r * tile][pad] = 0
        scale = (1.0 / rng.integers(1, 9, (n, 1))).astype(np.float32)
        base = tsg.GatherBlocks(
            codes=torch.from_numpy(codes), mult=torch.from_numpy(mult),
            bo=torch.zeros(nb, dtype=torch.int32), woff=torch.from_numpy(woff),
            off=torch.zeros(nb, dtype=torch.int32), tile=tile, wsz=wsz, k=k).to(dev)
        sc = torch.from_numpy(scale).to(dev)
        for d, dt, mode in itertools.product(GATHER_SWEEP_D, (torch.bfloat16, torch.float32),
                                             GATHER_SWEEP_MODES):
            x = torch.randn((n, d), generator=gen, device=dev)
            x[int(woff[0]) * tile] = float("inf")
            lay = base
            if mode.startswith("forward, row"):
                lay = dataclasses.replace(base, row_scale=sc)
            elif mode.startswith("reverse"):
                x = x * sc
            x = x.to(dt)
            got, again = (tsg.spmm_gather(x, lay) for _ in range(2))
            want = tsg.spmm_gather_plain(x, lay)
            torch.cuda.synchronize()
            fin = torch.isfinite(want)
            same = (torch.equal(fin, torch.isfinite(got)) and torch.equal(got[fin], want[fin])
                    and torch.equal(got.isnan(), want.isnan()))
            stable = torch.equal(got.isnan(), again.isnan()) and torch.equal(
                got.nan_to_num(), again.nan_to_num())
            if not (same and stable and not bool(fin.all())):
                err = (got.float() - want.float())[fin].abs().max().item()
                raise AssertionError(
                    f"gather sweep: tile {tile} R {r} D {d} {dt} {mode}: max|err| {err:.3e} "
                    f"where finite, non-finite positions equal "
                    f"{torch.equal(fin, torch.isfinite(got))}, two launches bit-equal {stable} "
                    f"(must be bit-equal, with some non-finite outputs)")
            n_cases += 1
    log(f"gather sweep: {n_cases} cases (tiles {SWEEP_TILES}, R {GATHER_SWEEP_R}, D "
        f"{GATHER_SWEEP_D}, bf16 and f32, {len(GATHER_SWEEP_MODES)} scale modes, padding "
        f"slots, an infinite x row) bit-equal to the plain version, two launches bit-equal; "
        f"{time.perf_counter() - t0:.1f} s")
    return n_cases


ONEHOT_SWEEP_TILES = (32, 64, 128, 512)
ONEHOT_SWEEP_K = (1, 2)
ONEHOT_SWEEP_D = (1, 4, 40, 100, 128)
# live slots of the designated rows, in and out alike (so both directions
# have them); row 0, with none, is also where padding slots point
ONEHOT_SWEEP_COUNTS = (0, 1, 31, 32, 33, 250)
ONEHOT_SWEEP_MODES = (("bf16", "default"), ("f32", "default"), ("f32", "highest"))


def onehot_sweep_graph(rng) -> tuple[np.ndarray, np.ndarray, dict]:
    """SWEEP_NODES nodes, SWEEP_DEG random edges a node among the rows not
    designated, and designated rows (0, then spread out) with exactly
    ONEHOT_SWEEP_COUNTS in-edges and as many out-edges: {row: count}."""
    n = SWEEP_NODES
    rows = {0: 0}
    for i, c in enumerate(ONEHOT_SWEEP_COUNTS[1:]):
        rows[97 + 431 * i] = c
    free = np.setdiff1d(np.arange(n), list(rows))
    src = [rng.choice(free, n * SWEEP_DEG)]
    dst = [rng.choice(free, n * SWEEP_DEG)]
    for r, c in rows.items():
        src += [rng.choice(free, c), np.full(c, r)]
        dst += [np.full(c, r), rng.choice(free, c)]
    return np.concatenate(src), np.concatenate(dst), rows


def check_onehot_sweep(mods: dict, dev) -> int:
    """spmm_onehot against its slot-ordered plain version, bit for bit, and
    two launches bit-equal: tiles ONEHOT_SWEEP_TILES at k_per_step 1 and
    2, D in ONEHOT_SWEEP_D, bf16 and f32 x at DEFAULT and f32 at HIGHEST,
    the forward and reverse mean layouts of onehot_sweep_graph (rows of 0,
    1, 31, 32, 33 and 250 live slots); the SDDMM backward's layouts
    (prepare_sddmm's, the structural plan shared through
    sddmm._with_weight with cotangent weights, a tenth of the live slots 0);
    the hybrid layout's one-hot (straggler) half. In every case row 0, which
    no live slot reads and padding slots point at, is infinite, and so is
    the 33-slot row, which live slots read: the non-finite outputs must
    fall where the plain version's do, and some must. Returns the number of
    cases."""
    tsp, tsd, tsh = mods["spmm"], mods["sddmm"], mods["spmm_hybrid"]
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    src, dst, rows = onehot_sweep_graph(rng)
    r33 = next(r for r, c in rows.items() if c == 33)
    n_cases, pad_reads, worst_rows = 0, 0, 0

    def hold(what, lay, n_pad, k=1):
        nonlocal n_cases, pad_reads, worst_rows
        row_ptr, _, src_row = tsp.onehot_plan(lay, n_pad)
        worst_rows = max(worst_rows, int((row_ptr[1:] - row_ptr[:-1]).max()))
        s_all, _, w_all = tsp.global_edges(lay)
        pad_reads += int(((w_all == 0) & (s_all == 0)).sum())
        if bool((src_row == 0).any()):
            raise AssertionError(f"one-hot sweep: {what}: a live slot reads row 0")
        for d, (xt, prec) in itertools.product(ONEHOT_SWEEP_D, ONEHOT_SWEEP_MODES):
            x = torch.randn((n_pad, d), generator=gen, device=dev)
            x[0] = float("inf")
            x[r33] = -float("inf")
            x = x.to(torch.bfloat16 if xt == "bf16" else torch.float32)
            got, again = (tsp.spmm_onehot(x, lay, precision=prec, k_per_step=k)
                          for _ in range(2))
            want = tsp.spmm_onehot_plain(x, lay, precision=prec, k_per_step=k)
            torch.cuda.synchronize()
            fin = torch.isfinite(want)
            same = (torch.equal(fin, torch.isfinite(got)) and torch.equal(got[fin], want[fin])
                    and torch.equal(got.isnan(), want.isnan()) and
                    torch.equal(got[~fin & ~want.isnan()], want[~fin & ~want.isnan()]))
            stable = torch.equal(got.isnan(), again.isnan()) and torch.equal(
                got.nan_to_num(), again.nan_to_num())
            if not (same and stable and not bool(fin.all())):
                err = (got.float() - want.float())[fin].abs().max().item()
                raise AssertionError(
                    f"one-hot sweep: {what} D {d} {xt} {prec}: max|err| {err:.3e} where "
                    f"finite, non-finite positions equal {torch.equal(fin, torch.isfinite(got))}"
                    f", two launches bit-equal {stable} (must be bit-equal, with some "
                    f"non-finite outputs)")
            n_cases += 1

    t0 = time.perf_counter()
    for tile, k in itertools.product(ONEHOT_SWEEP_TILES, ONEHOT_SWEEP_K):
        fwd, rev, n_pad = tsp.prepare_mean_aggregate(src, dst, SWEEP_NODES, step_chunks=k,
                                                     tile=tile, edge_chunk=min(tile, 512))
        for lay, dn in ((fwd, "forward"), (rev, "reverse")):
            hold(f"tile {tile} k {k} {dn}", lay.to(dev), n_pad, k)
    # the SDDMM backward: the structural layouts' plans, then their cotangents
    sf, sr, n_pad = tsd.prepare_sddmm(src, dst, SWEEP_NODES)
    for lay, dn in ((sf.to(dev), "forward"), (sr.to(dev), "reverse")):
        plan = tsp.onehot_plan(lay, n_pad)
        g = torch.randn(lay.weight.shape, generator=gen, device=dev)
        g = torch.where((lay.weight != 0) & (torch.rand(g.shape, generator=gen, device=dev)
                                             >= 0.1), g, 0.0)
        moved = tsd._with_weight(lay, g)
        if tsp.onehot_plan(moved, n_pad) is not plan:
            raise AssertionError("one-hot sweep: _with_weight did not keep the plan")
        hold(f"SDDMM backward {dn}, cotangent weights", moved, n_pad)
    hl, n_pad = tsh.prepare_hybrid_mean_aggregate(
        src, dst, SWEEP_NODES, tile=BANDED_TILE, dense_k=DENSE_K, k_per_step=ONEHOT_K,
        min_pair_edges=40, dense_dtype=np.int8)
    if hl.onehot_fwd is None or hl.dense_fwd is None:
        raise AssertionError("one-hot sweep: the hybrid layout has no one-hot or no dense half")
    for lay, dn in ((hl.onehot_fwd, "forward"), (hl.onehot_rev, "reverse")):
        hold(f"hybrid straggler half {dn} (dense_frac {hl.dense_frac:.3f})", lay.to(dev),
             n_pad, ONEHOT_K)
    if pad_reads == 0 or worst_rows < max(ONEHOT_SWEEP_COUNTS):
        raise AssertionError(f"one-hot sweep: {pad_reads} padding slots point at row 0, the "
                             f"longest row has {worst_rows} live slots")
    log(f"one-hot sweep: {n_cases} cases (tiles {ONEHOT_SWEEP_TILES}, k_per_step "
        f"{ONEHOT_SWEEP_K}, D {ONEHOT_SWEEP_D}, {ONEHOT_SWEEP_MODES}, forward and reverse; "
        f"the SDDMM backward's cotangent weights; the hybrid straggler half; rows of "
        f"{ONEHOT_SWEEP_COUNTS} live slots, the longest {worst_rows}; {pad_reads} padding "
        f"slots at the infinite row 0, an infinite row read by 33 live slots) bit-equal to "
        f"the plain version, two launches bit-equal; {time.perf_counter() - t0:.1f} s")
    return n_cases


def check_dense_sweep(mods: dict, dev) -> int:
    """spmm_dense against its plain version on ragged shapes: tiles 32, 64
    and 128 of a small local graph, D in DENSE_SWEEP_WIDTHS, int8, f32 and
    bf16 tiles, f32 x (AGG_F32_REL of max|plain|) and bf16 x (BANDED_REL),
    with a row scale and without, both directions; then layouts of s_max 1
    (block-diagonal), 5 (bench.py's reach 256 at tile 128) and 70 (tile 32,
    one destination block fed by 70 source blocks). Two launches bit-equal
    every time. Returns the number of cases held."""
    tsd = mods["spmm_dense"]
    gen = torch.Generator().manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    worst = {"f32": 0.0, "bf16": 0.0}
    n_cases = 0

    def hold(what, lay, x):
        nonlocal n_cases
        got, again, want = (tsd.spmm_dense(x, lay), tsd.spmm_dense(x, lay),
                            tsd.spmm_dense_plain(x, lay))
        torch.cuda.synchronize()
        rel = ((got.float() - want.float()).abs().max()
               / want.float().abs().max().clamp_min(1e-30)).item()
        stable = torch.equal(got, again)
        key = "bf16" if x.dtype == torch.bfloat16 else "f32"
        tol = BANDED_REL if key == "bf16" else AGG_F32_REL
        if rel > tol or not stable or not torch.isfinite(got).all():
            raise AssertionError(f"dense sweep: {what} {key} x: max|err|/max|plain| {rel:.3e} "
                                 f"(tol {tol}), two launches bit-equal {stable}")
        worst[key] = max(worst[key], rel)
        n_cases += 1

    def cases(tag, lay):
        lay = lay.to(dev)
        n_pad = lay.num_dst_blocks * lay.tile
        rs = (torch.rand((n_pad, 1), generator=gen) * 0.75 + 0.25).to(dev)
        with_rs = lay if lay.row_scale is not None else dataclasses.replace(lay, row_scale=rs)
        for d in DENSE_SWEEP_WIDTHS:
            x = torch.randn((n_pad, d), generator=gen).to(dev)
            for lv, rtag in ((with_rs, "row scale"), (dataclasses.replace(lay, row_scale=None),
                                                       "no row scale")):
                for xv in (x, x.to(torch.bfloat16)):
                    hold(f"{tag} D {d} {rtag}", lv, xv)

    def both(tag, src, dst, n, tile, kinds=("int8", "f32", "bf16")):
        for kind in kinds:
            fwd, rev, _ = tsd.prepare_dense_mean_aggregate(
                src, dst, n, tile=tile, dtype=np.int8 if kind == "int8" else np.float32)
            for lay, dn in ((fwd, "forward"), (rev, "reverse")):
                if kind == "bf16":
                    lay = dataclasses.replace(lay, a=lay.a.to(torch.bfloat16))
                cases(f"{tag} {kind} tiles {dn} (s_max {lay.s_max})", lay)

    t0 = time.perf_counter()
    for tile in SWEEP_TILES:
        src, dst = make_local_graph(SWEEP_NODES, SWEEP_DEG, reach=tile, seed=SEED)
        both(f"tile {tile}", src, dst, SWEEP_NODES, tile)
    # s_max 1: every edge inside its block
    dst = rng.integers(0, SWEEP_NODES, SWEEP_NODES * SWEEP_DEG)
    src = np.minimum(dst // BANDED_TILE * BANDED_TILE + rng.integers(0, BANDED_TILE, len(dst)),
                     SWEEP_NODES - 1)
    both("block-diagonal, tile 128", src, dst, SWEEP_NODES, BANDED_TILE, ("int8",))
    src, dst = make_local_graph(SWEEP_NODES, SWEEP_DEG, reach=BENCH_REACH, seed=SEED)
    both("reach 256, tile 128", src, dst, SWEEP_NODES, BANDED_TILE, ("int8",))
    # s_max 70: block 0 fed by 70 source blocks of 32
    nsrc, tile = 70, 32
    n = (nsrc + 1) * tile
    src = np.concatenate([np.arange(1, nsrc + 1) * tile + rng.integers(0, tile, nsrc),
                          rng.integers(0, n, 4 * n)])
    dst = np.concatenate([rng.integers(0, tile, nsrc), rng.integers(0, n, 4 * n)])
    both("70 sources, tile 32", src, dst, n, tile, ("int8", "bf16"))
    log(f"dense sweep: {n_cases} cases within {AGG_F32_REL} (f32 x) / {BANDED_REL} (bf16 x) of "
        f"max|plain|, two launches bit-equal (worst f32 {worst['f32']:.2e}, bf16 "
        f"{worst['bf16']:.2e}), {time.perf_counter() - t0:.1f} s")
    return n_cases


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run",
              file=sys.stderr)
        return 2
    from sldm_gnn_tpu_torch.graph import csr, reorder
    from sldm_gnn_tpu_torch.ops import _build, banded_residual, gru_cuda, quant, sage_fused, spmm
    from sldm_gnn_tpu_torch.ops import knn as knn_ops
    from sldm_gnn_tpu_torch.ops import sddmm, spmm_banded, spmm_cmap, spmm_dense, spmm_gather
    from sldm_gnn_tpu_torch.ops import spmm_hybrid, spmm_mk
    from sldm_gnn_tpu_torch.parallel import halo_fused

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    if sys.argv[1:] == ["--gru-bwd-ms"]:
        gru_bwd_upper_layer(dev)
        return 0
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
    check_knn_sweep(knn_ops, dev)
    for e in entries:
        e["path"] = "serve"
    train_entries = check_gru_training_kernels(gru_cuda, gen, dev)
    check_gru_widths(gru_cuda, gen, dev)
    check_gru_sweep(gru_cuda, dev)
    check_gru_bwd_sweep(gru_cuda, dev)
    check_gru_scan_fwd_sweep(gru_cuda, dev)
    check_gru_scan_bwd_sweep(gru_cuda, dev)
    torch.cuda.empty_cache()

    mods = {"gru_cuda": gru_cuda, "knn_ops": knn_ops, "spmm_banded": spmm_banded,
            "sage_fused": sage_fused, "banded_residual": banded_residual, "spmm": spmm,
            "spmm_dense": spmm_dense, "spmm_gather": spmm_gather, "spmm_hybrid": spmm_hybrid,
            "quant": quant, "sddmm": sddmm, "reorder": reorder, "spmm_mk": spmm_mk,
            "spmm_cmap": spmm_cmap, "csr": csr, "halo_fused": halo_fused}
    scan_entries = check_gru_scan(mods, gen, dev, smi)
    with tempfile.TemporaryDirectory() as tmp:
        launches = check_serving(gru_cuda, knn_ops, Path(tmp), dev)
        for e in entries:
            e["launches"] = launches[e["name"]]
        batch, md, graphs = synth_training_data(dev, with_graphs=True)
        model_sg, counts_sg = check_training(mods, "pallas_sg", batch, md, dev, smi)
        _, counts_v2 = check_training(mods, "pallas", batch, md, dev, smi)
        check_grusage_rest(mods, batch, md, graphs, dev, smi)
        del batch, graphs
        torch.cuda.empty_cache()
        check_train_to_serve(mods, model_sg, md, Path(tmp), dev)
    for e in train_entries:
        e["launches"] = (counts_sg if e["name"].endswith("_sg") else counts_v2)[e["name"]]
    entries += train_entries
    del model_sg, md
    torch.cuda.empty_cache()

    check_ragged_sweep(mods, dev)
    check_dense_sweep(mods, dev)
    check_int8_sweep(mods, dev)
    check_gather_sweep(mods, dev)
    check_onehot_sweep(mods, dev)
    resid, pure, n_pad, graph = banded_layouts(mods, dev)
    banded_entries = check_banded_kernels(mods, resid, pure, graph, gen, dev)
    torch.cuda.empty_cache()
    counts_bench = check_bench_step(
        mods, "banded_residual+fused",
        lambda h, wa, wb: banded_residual.banded_residual_sage_apply(h, wa, wb, None, resid,
                                                                     True, 0.0),
        n_pad, {"banded_sage_fwd": 2, "banded_sage_bwd": 2}, BANDED_KERNEL_KEYS,
        len(graph[0]), dev, smi)
    counts_ln, _ = check_classifier(mods, (resid, None), n_pad, dict(fused=True, fused_ln=True),
                                    "fused_ln, banded-residual",
                                    {"banded_sage_fwd": 2, "banded_sage_ln_bwd": 2}, dev)
    # the first layer's input needs no gradient, so its aggregation runs no
    # backward: two forward and one reverse launch a step
    counts_unfused, model_unfused = check_classifier(mods, pure, n_pad, {},
                                                     "unfused, pure banded",
                                                     {"spmm_banded": 3}, dev)
    launch_of = {"spmm_banded": ("classifier unfused", counts_unfused),
                 "banded_sage_fwd": ("bench step", counts_bench),
                 "banded_sage_bwd": ("bench step", counts_bench),
                 "banded_sage_ln_bwd": ("classifier fused_ln", counts_ln)}
    for e in banded_entries:
        e["path"], counts = launch_of[e["name"]]
        e["launches"] = counts[e["name"]]
    entries += banded_entries
    counts_int8 = check_int8_inference(mods, model_unfused, pure, n_pad, dev)
    del model_unfused
    torch.cuda.empty_cache()
    entries.append(check_wide(mods, pure, n_pad, graph, dev, smi))
    torch.cuda.empty_cache()
    entries.append(check_halo(mods, graph, resid, dev, smi))
    torch.cuda.empty_cache()

    lays = layout_set(mods, graph, dev)
    layout_entries = check_layout_kernels(mods, lays, pure, graph, gen, dev)
    del resid
    torch.cuda.empty_cache()
    step_counts = {name: check_bench_step(mods, name, *layout_step(mods, name, lays[name]),
                                          LAYOUT_KERNEL_KEYS, len(graph[0]), dev, smi)
                   for name in ("onehot", "dense", "hybrid", "gather")}
    for name, mode, want in (("onehot", dict(k_per_step=ONEHOT_K), {"spmm_onehot": 3}),
                             ("hybrid", {}, {"spmm_dense": 3, "spmm_onehot": 3})):
        check_classifier(mods, *lays[name], mode, f"unfused, {name}", want, dev)
    launch_of = {"spmm_onehot": ("bench step onehot", step_counts["onehot"]),
                 "spmm_dense": ("bench step dense", step_counts["dense"]),
                 "spmm_gather": ("bench step gather", step_counts["gather"]),
                 "spmm_banded_int8": ("int8 inference", counts_int8)}
    for e in layout_entries:
        e["path"], counts = launch_of[e["name"]]
        e["launches"] = counts[e["name"]]
    entries += layout_entries
    del lays["dense"], lays["gather"], lays["hybrid"]
    torch.cuda.empty_cache()
    entries += check_int8_sddmm(mods, lays, graph, gen, dev)
    check_reorder(mods, graph)
    del lays
    torch.cuda.empty_cache()
    entries += scan_entries
    entries += check_spmm_mk(mods, graph, gen, dev, smi)

    # the cmap tier on the scattered graph: the four banded kernels, bench.py's
    # fused step and the classifier (fused_ln and unfused) on its layout
    clay, c_pad, cgraph = cmap_layout(mods, dev)
    cmap_entries = check_banded_kernels(mods, clay, (clay.banded_fwd, clay.banded_rev), cgraph,
                                        gen, dev, label="cmap: ")
    torch.cuda.empty_cache()
    counts_cbench = check_bench_step(
        mods, "cmap+fused",
        lambda h, wa, wb: banded_residual.banded_residual_sage_apply(h, wa, wb, None, clay,
                                                                     True, 0.0),
        c_pad, {"banded_sage_fwd": 2, "banded_sage_bwd": 2}, BANDED_KERNEL_KEYS,
        len(cgraph[0]), dev, smi)
    counts_cln, _ = check_classifier(mods, (clay, None), c_pad, dict(fused=True, fused_ln=True),
                                     "fused_ln, cmap", {"banded_sage_fwd": 2,
                                                        "banded_sage_ln_bwd": 2}, dev)
    counts_cun, _ = check_classifier(mods, (clay.banded_fwd, clay.banded_rev), c_pad, {},
                                     "unfused, cmap banded part", {"spmm_banded": 3}, dev)
    launch_of = {"spmm_banded": ("classifier unfused, cmap", counts_cun),
                 "banded_sage_fwd": ("bench step cmap", counts_cbench),
                 "banded_sage_bwd": ("bench step cmap", counts_cbench),
                 "banded_sage_ln_bwd": ("classifier fused_ln, cmap", counts_cln)}
    for e in cmap_entries:
        e["path"], counts = launch_of[e["name"]]
        e["launches"] = counts[e["name"]]
        e["layout"] = "cmap"
        e["shape"] = e["shape"].replace("banded-residual", "cmap-residual").replace(
            "pure banded", "cmap banded part") + f", c {clay.banded_fwd.s_span}"
    entries += cmap_entries
    log(f"total wall {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
