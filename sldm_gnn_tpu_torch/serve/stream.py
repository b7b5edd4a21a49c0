"""Streaming inference: FIFO of newline-delimited JSON frames -> sliding
window -> incremental graph build -> GruSage -> CSV of scores.

Port of ``sldm_gnn_tpu/serve/stream.py`` (``InferenceEngine`` :45 with
``push_frame_rows`` :120 and ``_score_graph`` :150, ``StreamingServer``
:165) on its incremental wire-row path: each frame arrives as a JSON list
of per-vehicle rows, is pushed into
:class:`~sldm_gnn_tpu_torch.build.online.IncrementalGraphOnlineCreator`,
and every push after warm-up scores the current window. The CSV gets one
line per scored window, ``"."`` for an empty one.

Window graphs are padded to power-of-two node and edge capacities, as in
the JAX package, so the model sees few distinct shapes.
"""

from __future__ import annotations

import json
import os
import select
import threading
from collections import deque
from pathlib import Path

import numpy as np
import torch

from ..build.online import IncrementalGraphOnlineCreator
from ..device import resolve_device
from ..graph.batching import BatchDims, pad_and_batch
from ..graph.containers import GraphArrays
from ..interop import map_feat_dim, params_to_state_dict
from ..models.grusage import GruSage
from .snapshot import load_snapshot

MAX_JSON_CHUNK_SIZE = 32 * 1024


def _next_pow2(n: int, lo: int = 4) -> int:
    v = lo
    while v < n:
        v *= 2
    return v


def _column(rows: list[dict], key: str, dtype, missing) -> np.ndarray:
    """One wire column; a JSON null or a missing key becomes ``missing``
    (what the pandas path of the JAX package coerced them to)."""
    return np.asarray([missing if r.get(key) is None else r[key] for r in rows], dtype)


class InferenceEngine:
    """Snapshot-driven sliding-window scoring on ``device`` (default the
    card; ``device='cpu'`` runs the plain versions of the kernels)."""

    def __init__(self, snapshot_path: Path | str, *, pack_size: int,
                 m_radius: float = 25.0, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        snap = load_snapshot(snapshot_path)
        self.config = snap["config"]
        self.pack_size = pack_size
        self.model = GruSage(self.config, map_feat_dim=map_feat_dim(
            snap["params"], self.config.mapenc_lane_embdim))
        self.model.load_state_dict(params_to_state_dict(snap["params"]))
        self.model.to(self.device).eval()

        def on_device(a):
            return None if a is None else torch.as_tensor(
                np.array(a, np.float32), device=self.device)

        self.map_embeddings = on_device(snap["map_embeddings"])
        self.map_centroids = on_device(snap["map_centroids"])
        self.inc_creator = IncrementalGraphOnlineCreator(
            frames_num=pack_size, m_radius=m_radius, norm_stats=snap["norm_stat_dict"])

    @property
    def warm(self) -> bool:
        """Whether a full window has been pushed."""
        return self.inc_creator.warm

    def push_frame_rows(self, rows: list[dict]) -> np.ndarray | None:
        """Ingest one frame in the wire format (a list of per-vehicle row
        dicts) and score the current window. None while warming up or when
        the warm window is empty (check :attr:`warm` to tell them apart).

        A null or missing X, Y, Speed or Angle becomes NaN, a null or NaN
        Width or Length 0.0 (NaN would poison the pair distances) and a
        null StationType 0, as the JAX package's pandas path coerced them;
        the frame is still served.
        """
        nan = float("nan")
        width = np.nan_to_num(_column(rows, "Width", np.float32, 0.0), nan=0.0)
        length = np.nan_to_num(_column(rows, "Length", np.float32, 0.0), nan=0.0)
        sttype = np.nan_to_num(_column(rows, "StationType", np.float64, 0.0),
                               nan=0.0).astype(np.int32)
        self.inc_creator.push_arrays(
            [r["VehicleId"] for r in rows],
            _column(rows, "X", np.float32, nan), _column(rows, "Y", np.float32, nan),
            _column(rows, "Speed", np.float32, nan), _column(rows, "Angle", np.float32, nan),
            width, length, sttype,
        )
        if not self.inc_creator.warm:
            return None
        return self.score_graph(self.inc_creator.window())

    def score_graph(self, g: GraphArrays) -> np.ndarray | None:
        """Sigmoid scores [out_dim] of one window graph; None if empty."""
        if g.num_nodes == 0:
            return None
        dims = BatchDims(
            node_capacity=_next_pow2(g.num_nodes),
            edge_capacity=_next_pow2(max(g.num_edges, 1)),
            graph_capacity=1,
            num_frames=self.pack_size,
            num_labels=self.config.out_dim,
        )
        batch = pad_and_batch([g], dims).to(self.device)
        with torch.inference_mode():
            logits = self.model(batch, map_embeddings=self.map_embeddings,
                                map_centroids=self.map_centroids)
            return torch.sigmoid(logits)[0].cpu().numpy()


class StreamingServer:
    """Producer thread: non-blocking FIFO reads, one JSON frame per line,
    into a deque. Consumer thread: one :meth:`InferenceEngine.
    push_frame_rows` per frame and one CSV line per warm push."""

    def __init__(self, fifo_path: Path | str, snapshot_path: Path | str,
                 output_csv: Path | str, *, pack_size: int, m_radius: float = 25.0,
                 device: str | torch.device = "cuda"):
        self.fifo_path = Path(fifo_path)
        self.snapshot_path = Path(snapshot_path)
        self.output_csv = Path(output_csv)
        self.pack_size = pack_size
        self.m_radius = m_radius
        self.device = resolve_device(device)

        self.frames: deque[list] = deque()
        self.condition = threading.Condition(threading.Lock())
        self.terminate = threading.Event()
        self.n_scored = 0
        self.consumer_error: BaseException | None = None

    def _signal_termination(self, reason: str | None = None):
        if reason:
            print(reason)
        self.terminate.set()
        with self.condition:
            self.condition.notify_all()

    def _producer(self, fd: int):
        buffer = ""
        try:
            while not self.terminate.is_set():
                # bounded wait, so termination ends this thread even if the
                # writer never sends another byte
                readable, _, _ = select.select([fd], [], [], 0.2)
                if not readable:
                    continue
                try:
                    chunk = os.read(fd, MAX_JSON_CHUNK_SIZE).decode()
                except BlockingIOError:
                    continue
                except OSError as e:
                    self._signal_termination(f"FIFO read error: {e}")
                    break
                if not chunk:
                    self._signal_termination("writer closed the FIFO")
                    break
                buffer += chunk
                while "\n" in buffer:
                    line, buffer = buffer.split("\n", 1)
                    if not line.strip():
                        continue
                    try:
                        data = json.loads(line)
                    except json.JSONDecodeError as e:
                        self._signal_termination(f"malformed JSON frame: {e}")
                        return
                    if not isinstance(data, list):
                        self._signal_termination(
                            "frame is not a JSON list of per-vehicle rows")
                        return
                    with self.condition:
                        self.frames.append(data)
                        self.condition.notify_all()
        finally:
            self._signal_termination()

    def _consumer(self):
        try:
            self._consume_loop()
        except Exception as e:
            # fail fast: no silently dead consumer behind a live producer;
            # run() re-raises on the caller's thread
            self.consumer_error = e
            self._signal_termination(f"consumer error: {type(e).__name__}: {e}")

    def _consume_loop(self):
        engine = InferenceEngine(self.snapshot_path, pack_size=self.pack_size,
                                 m_radius=self.m_radius, device=self.device)
        with open(self.output_csv, "w") as f:
            f.write("Score\n")
        while True:
            with self.condition:
                while not self.frames and not self.terminate.is_set():
                    self.condition.wait()
                frame = self.frames.popleft() if self.frames else None
            if frame is None:
                break
            scores = engine.push_frame_rows(frame)
            if engine.warm:
                self._append_score_row(scores)

    def _append_score_row(self, scores):
        with open(self.output_csv, "a") as f:
            if scores is None:
                f.write(".\n")
            else:
                f.write(",".join(f"{s:.6f}" for s in np.atleast_1d(scores)) + "\n")
        self.n_scored += 1

    def run(self):
        # blocking open (waits for a writer), then non-blocking reads under
        # select so that termination can interrupt them
        fd = os.open(self.fifo_path, os.O_RDONLY)
        try:
            os.set_blocking(fd, False)
            t1 = threading.Thread(target=self._producer, args=(fd,))
            t2 = threading.Thread(target=self._consumer)
            t1.start()
            t2.start()
            t1.join()
            t2.join()
        finally:
            os.close(fd)
        if self.consumer_error is not None:
            raise self.consumer_error
