"""Training and evaluation steps and the epoch loop.

Port of ``sldm_gnn_tpu/train/loop.py`` (``make_optimizer`` :40,
``build_step_fns`` :57-169, ``TrainResult`` :172, ``train_model`` :196):
Adam with L2 folded into the gradient before the moments (which is
``torch.optim.Adam(weight_decay=...)`` itself), BCE with ``pos_weight``
or focal loss over the valid graphs of a padded batch, per-epoch train
and eval phases with 0.5-threshold accuracy, best-validation callbacks,
per-label accuracy curves, and the confusion matrix and ROC-AUC of
single-label runs.

The step runs eagerly on the model's device: the GRU through the fused
CUDA kernels (``gru_impl='pallas'``/``'pallas_sg'``) or the f32 scan,
the KNN through its kernel (``knn_impl='pallas'``). Dropout masks come
from the ``torch.Generator`` passed to each step. A step updates the
state in place. Metrics stay on the device and are read once an epoch.
Not ported: the data-parallel ``mesh``, ``checkpoint_manager`` and
``prefetch_depth`` (``parallel/``, ``train/checkpoint.py``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..evals.metrics import roc_auc_score
from ..graph.containers import PaddedGraphBatch
from ..models.grusage import GruSage
from ..models.map_modules import MapData
from .losses import masked_graph_loss


def make_optimizer(lr: float, weight_decay: float) -> Callable[..., torch.optim.Optimizer]:
    """``params -> torch.optim.Adam(params, lr, weight_decay)``: L2 is added
    to the gradient before the moments, as the JAX package's optax chain
    does (``train/loop.py:40-47``)."""
    return functools.partial(torch.optim.Adam, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


@dataclass
class TrainState:
    """The model (its parameters), its optimizer and the step count."""

    model: GruSage
    optimizer: torch.optim.Optimizer
    step: int = 0


@dataclass
class StepFns:
    train_step: Callable
    eval_step: Callable
    init: Callable


def _threshold_metrics(logits: torch.Tensor, batch: PaddedGraphBatch):
    """Sigmoid scores, 0.5-threshold predictions, per-label correct counts
    over valid graphs and the valid-graph count (device tensors)."""
    scores = torch.sigmoid(logits)
    preds = (scores >= 0.5).to(torch.float32)
    valid = batch.graph_mask[:, None]
    correct = ((preds == batch.y) & valid).sum(dim=0)
    return scores, preds, correct, batch.graph_mask.sum()


def build_step_fns(model: GruSage, optimizer: Callable[..., torch.optim.Optimizer], *,
                   loss_type: str = "bce", pos_weight: float = 1.0,
                   focal_alpha: float = 0.75, focal_gamma: float = 2.0,
                   map_data: MapData | None = None, eval_scores: bool = True) -> StepFns:
    """Train and eval steps for ``model`` (on its device, with ``map_data``
    on the same device). ``optimizer`` maps parameters to an optimizer
    (:func:`make_optimizer`). ``eval_scores=False`` drops the per-graph
    scores and predictions from ``eval_step`` (only the single-label
    CM/ROC-AUC reads them)."""
    loss_kw = dict(loss_type=loss_type, pos_weight=pos_weight, focal_alpha=focal_alpha,
                   focal_gamma=focal_gamma)

    def train_step(state: TrainState, batch: PaddedGraphBatch,
                   generator: torch.Generator | None = None):
        m = state.model
        m.train()
        state.optimizer.zero_grad(set_to_none=True)
        logits = m(batch, map_data=map_data, generator=generator)
        loss = masked_graph_loss(logits, batch.y, batch.graph_mask, **loss_kw)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        with torch.no_grad():
            _, _, correct, n_graphs = _threshold_metrics(logits, batch)
        return state, {"loss": loss.detach(), "correct": correct, "n_graphs": n_graphs}

    def eval_step(state: TrainState, batch: PaddedGraphBatch) -> dict:
        m = state.model
        m.eval()
        with torch.no_grad():
            logits = m(batch, map_data=map_data)
            loss = masked_graph_loss(logits, batch.y, batch.graph_mask, **loss_kw)
            scores, preds, correct, n_graphs = _threshold_metrics(logits, batch)
        out = {"loss": loss, "correct": correct, "n_graphs": n_graphs}
        if eval_scores:
            out["scores"], out["preds"] = scores, preds
        return out

    def init(generator: torch.Generator | None = None) -> TrainState:
        """A fresh state: parameters drawn from ``generator`` (on the
        model's device; None keeps the model's current parameters) and a new
        optimizer."""
        if generator is not None:
            model.reset_parameters(generator)
        return TrainState(model=model, optimizer=optimizer(model.parameters()))

    return StepFns(train_step=train_step, eval_step=eval_step, init=init)


@dataclass
class TrainResult:
    """Accuracy curves: per-label and total train/val accuracy per epoch,
    plus binary CM/ROC-AUC stats for single-label runs."""

    per_label_train_acc: np.ndarray  # [L, epochs]
    total_train_acc: np.ndarray  # [1, epochs]
    per_label_val_acc: np.ndarray  # [L, epochs]
    total_val_acc: np.ndarray  # [1, epochs]
    bin_cm: np.ndarray | None = None  # [4, epochs] tn,fp,fn,tp
    bin_rocauc: np.ndarray | None = None  # [1, epochs]
    best_val_acc: float = 0.0
    train_loss: np.ndarray | None = None
    val_loss: np.ndarray | None = None


def _sum_metrics(step_metrics: list[dict], L: int) -> tuple[np.ndarray, int, float]:
    """(per-label correct, valid graphs, mean loss) of an epoch's steps,
    read from the device once."""
    if not step_metrics:
        return np.zeros((L,), np.int64), 0, 0.0
    correct = torch.stack([m["correct"] for m in step_metrics]).sum(dim=0).cpu().numpy()
    n = int(torch.stack([m["n_graphs"] for m in step_metrics]).sum().item())
    loss = float(torch.stack([m["loss"] for m in step_metrics]).float().mean().item())
    return correct.astype(np.int64), n, loss


def train_model(model: GruSage,
                train_batches: Callable[[], Iterable[PaddedGraphBatch]],
                eval_batches: Callable[[], Iterable[PaddedGraphBatch]], *,
                epochs: int = 10, lr: float = 1e-3, weight_decay: float = 1e-5,
                active_labels: Sequence[int] = (0,), neg_over_pos_ratio: float = 1.0,
                focal_alpha: float | None = None, focal_gamma: float = 0.0,
                map_data: MapData | None = None, seed: int = 0,
                best_state_callback: Callable[[TrainState, dict], None] | None = None,
                epoch_callback: Callable[[int, dict], None] | None = None,
                init_state: TrainState | None = None,
                device: str | torch.device = "cuda") -> tuple[TrainState, TrainResult]:
    """Full training run on ``device`` (default the card). ``train_batches``
    and ``eval_batches`` are zero-argument callables returning fresh
    per-epoch iterables of host batches; each batch moves to the device
    before its step.

    Loss selection: focal when ``focal_gamma > 0`` (alpha defaults to the
    negative fraction), else BCE with ``pos_weight = neg_over_pos_ratio``.
    Without ``init_state`` the parameters are drawn from a generator seeded
    with ``seed``, which then draws every dropout mask. The state passed to
    ``best_state_callback`` is live: copy what you keep (e.g.
    ``interop.state_dict_to_params(state.model)``).
    """
    dev = resolve_device(device)
    L = len(active_labels)
    if focal_gamma > 0:
        if focal_alpha is None:
            focal_alpha = neg_over_pos_ratio / (1.0 + neg_over_pos_ratio)
        loss_kw = dict(loss_type="focal", focal_alpha=focal_alpha, focal_gamma=focal_gamma)
        loss_info = {"type": "focal", "alpha": focal_alpha, "gamma": focal_gamma}
    else:
        loss_kw = dict(loss_type="bce", pos_weight=float(neg_over_pos_ratio))
        loss_info = {"type": "BCEWithLogits", "pos_weight": float(neg_over_pos_ratio)}

    model.to(dev)
    if map_data is not None:
        map_data = map_data.to(dev)
    fns = build_step_fns(model, make_optimizer(lr, weight_decay), map_data=map_data,
                         eval_scores=(L == 1), **loss_kw)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = init_state if init_state is not None else fns.init(gen)

    pl_tracc = np.zeros((L, epochs), np.float32)
    tot_tracc = np.zeros((1, epochs), np.float32)
    pl_vacc = np.zeros((L, epochs), np.float32)
    tot_vacc = np.zeros((1, epochs), np.float32)
    tr_loss_curve = np.zeros((epochs,), np.float32)
    vl_loss_curve = np.zeros((epochs,), np.float32)
    bin_cm = np.zeros((4, epochs), np.int64) if L == 1 else None
    bin_auc = np.zeros((1, epochs), np.float32) if L == 1 else None
    best_vacc = 0.0

    for epoch in range(epochs):
        step_metrics = []
        for batch in train_batches():
            state, m = fns.train_step(state, batch.to(dev), gen)
            step_metrics.append(m)
        correct, n, tr_loss_curve[epoch] = _sum_metrics(step_metrics, L)
        tot_tracc[0, epoch] = correct.sum() / max(n * L, 1)
        pl_tracc[:, epoch] = correct / max(n, 1)

        step_metrics, masks, gts = [], [], []
        for batch in eval_batches():
            step_metrics.append(fns.eval_step(state, batch.to(dev)))
            if L == 1:
                masks.append(batch.graph_mask.cpu().numpy())
                gts.append(batch.y.cpu().numpy())
        correct, n, vl_loss_curve[epoch] = _sum_metrics(step_metrics, L)
        tot_vacc[0, epoch] = correct.sum() / max(n * L, 1)
        pl_vacc[:, epoch] = correct / max(n, 1)

        if tot_vacc[0, epoch] > best_vacc:
            best_vacc = float(tot_vacc[0, epoch])
            if best_state_callback is not None:
                best_state_callback(state, {"val_acc": best_vacc, "epoch": epoch,
                                            "loss_info": loss_info})

        if L == 1 and step_metrics:
            scr = np.concatenate([m["scores"].cpu().numpy()[gm]
                                  for m, gm in zip(step_metrics, masks)]).ravel()
            prd = np.concatenate([m["preds"].cpu().numpy()[gm]
                                  for m, gm in zip(step_metrics, masks)]).ravel()
            gt = np.concatenate([g[gm] for g, gm in zip(gts, masks)]).ravel().astype(np.int32)
            tp = int(((prd == 1) & (gt == 1)).sum())
            tn = int(((prd == 0) & (gt == 0)).sum())
            fp = int(((prd == 1) & (gt == 0)).sum())
            fn = int(((prd == 0) & (gt == 1)).sum())
            bin_cm[:, epoch] = [tn, fp, fn, tp]
            bin_auc[0, epoch] = roc_auc_score(gt, scr)

        if epoch_callback is not None:
            epoch_callback(epoch, {
                "train_acc": float(tot_tracc[0, epoch]),
                "val_acc": float(tot_vacc[0, epoch]),
                "train_loss": float(tr_loss_curve[epoch]),
                "val_loss": float(vl_loss_curve[epoch]),
            })

    result = TrainResult(
        per_label_train_acc=pl_tracc, total_train_acc=tot_tracc,
        per_label_val_acc=pl_vacc, total_val_acc=tot_vacc,
        bin_cm=bin_cm, bin_rocauc=bin_auc, best_val_acc=best_vacc,
        train_loss=tr_loss_curve, val_loss=vl_loss_curve,
    )
    return state, result
