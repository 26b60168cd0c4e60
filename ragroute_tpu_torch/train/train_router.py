"""Corpus-router training in torch on the chosen device.

Counterpart of :mod:`ragroute_tpu.train.train_router`, with the reference
training scripts' recipe (``scripts/train/train_medrag_router.py:285-506``
and the feb4rag / mmlu variants):

* features: the serving features of
  :func:`ragroute_tpu_torch.router.features.build_features`;
* StandardScaler fit on the training rows (medrag / wikipedia, ``:350-354``);
* ``BCEWithLogitsLoss`` with ``pos_weight`` (feb4rag ``:123-124``, mmlu 5x);
* Adam after a global-norm clip of 1.0 (``:394-468``), the clip written as
  optax's ``clip_by_global_norm`` (``g / norm`` when ``norm >= 1``; torch's
  ``clip_grad_norm_`` divides by ``norm + 1e-6``);
* CyclicLR(1e-3 to 5e-3, triangular2) until epoch 115, then StepLR(50,
  0.05) (``:394-414``), as a function of the step driven through
  ``LambdaLR`` on an lr of 1.0: the first ``optimizer.step()`` takes
  ``schedule(0)``, as optax's first update does; 150 epochs;
* inverted dropout 0.4 after each ReLU, its masks and the epoch
  permutations drawn from one ``torch.Generator`` on the device;
* best-validation-accuracy checkpointing and the ROC threshold search
  argmax(tpr - fpr) on validation (``:157-184``).

The training tensors, the model and the optimiser state live on the device
the caller names (default the card; ``"cpu"`` for tests). The train /
validation split is the JAX package's (numpy's ``default_rng(seed)``) and
its ``split.json`` format, so a split either package wrote trains the other
on the same indices.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ragroute_tpu_torch.router.mlp import CorpusRouter
from ragroute_tpu_torch.utils.precision import resolve_device

# reference hyperparameters (train_medrag_router.py:394-414)
BASE_LR = 1e-3
MAX_LR = 5e-3
CYCLE_EPOCHS = 10           # CyclicLR step_size ~ a few epochs per half-cycle
SWITCH_EPOCH = 115
STEP_LR_EVERY = 50
STEP_LR_GAMMA = 0.05
NUM_EPOCHS = 150
GRAD_CLIP = 1.0


def cyclic_then_step_schedule(steps_per_epoch: int) -> Callable[[int], float]:
    """CyclicLR triangular2 (1e-3 to 5e-3) until epoch 115, then StepLR
    decaying by 0.05 every 50 epochs from the base LR: the learning rate
    of the update numbered ``step`` (from 0)."""
    half = max(1, (CYCLE_EPOCHS * steps_per_epoch) // 2)
    switch_step = SWITCH_EPOCH * steps_per_epoch

    def schedule(step: int) -> float:
        if step < switch_step:
            # triangular2: amplitude halves every full cycle
            cycle = math.floor(1 + step / (2 * half))
            x = abs(step / half - 2 * cycle + 1)
            amp = (MAX_LR - BASE_LR) / 2.0 ** (cycle - 1)
            return BASE_LR + amp * max(0.0, 1 - x)
        epochs_after = (step - switch_step) / steps_per_epoch
        return BASE_LR * STEP_LR_GAMMA ** (
            math.floor(epochs_after / STEP_LR_EVERY) + 1)

    return schedule


def make_optimizer(model: torch.nn.Module, steps_per_epoch: int):
    """``(Adam, LambdaLR)``: Adam at lr 1.0 scaled step by step by
    :func:`cyclic_then_step_schedule`."""
    opt = torch.optim.Adam(model.parameters(), lr=1.0)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, cyclic_then_step_schedule(steps_per_epoch))
    return opt, sched


def clip_by_global_norm(params, max_norm: float = GRAD_CLIP) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` on the gradients in place: when the
    global norm reaches ``max_norm`` each gradient is divided by
    ``norm / max_norm``. No host sync; returns the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    div = torch.where(norm < max_norm, torch.ones_like(norm),
                      norm / max_norm)
    for g in grads:
        g.div_(div)
    return norm


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor,
                    pos_weight=1.0) -> torch.Tensor:
    """``BCEWithLogitsLoss(pos_weight=...)``, mean over the batch."""
    if not torch.is_tensor(pos_weight):
        pos_weight = torch.tensor(pos_weight, dtype=logits.dtype,
                                  device=logits.device)
    return F.binary_cross_entropy_with_logits(logits, labels,
                                              pos_weight=pos_weight)


def train_step(model: CorpusRouter, opt, sched, x: torch.Tensor,
               y: torch.Tensor, pos_weight=1.0,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One update: the loss (with dropout drawn from ``generator``, or none
    without one), its gradients clipped, an Adam step at the schedule's
    rate. Returns the loss on the device (no sync)."""
    opt.zero_grad(set_to_none=True)
    logits = (model(x) if generator is None
              else model.forward_train(x, generator))
    loss = bce_with_logits(logits, y, pos_weight)
    loss.backward()
    clip_by_global_norm(model.parameters(), GRAD_CLIP)
    opt.step()
    sched.step()
    return loss.detach()


def find_optimal_threshold(
    logits: np.ndarray, labels: np.ndarray
) -> float:
    """ROC argmax(tpr - fpr) threshold on sigmoid probabilities
    (reference train_medrag_router.py:157-184)."""
    probs = 1.0 / (1.0 + np.exp(-np.asarray(logits, np.float64)))
    labels = np.asarray(labels).astype(bool)
    order = np.argsort(-probs)
    p_sorted = probs[order]
    l_sorted = labels[order]
    tp = np.cumsum(l_sorted)
    fp = np.cumsum(~l_sorted)
    n_pos = max(int(labels.sum()), 1)
    n_neg = max(int((~labels).sum()), 1)
    tpr = tp / n_pos
    fpr = fp / n_neg
    j = np.argmax(tpr - fpr)
    return float(p_sorted[j])


def fit_scaler(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """sklearn StandardScaler parity: biased std, zeros-variance guard."""
    mean = x.mean(axis=0)
    scale = x.std(axis=0)
    scale = np.where(scale == 0.0, 1.0, scale)
    return mean.astype(np.float32), scale.astype(np.float32)


def classification_metrics(probs, labels, threshold=0.5) -> Dict[str, float]:
    """Accuracy / precision / recall / F1 / AUC (reference eval block,
    train_medrag_router.py:187-236)."""
    labels = np.asarray(labels).astype(bool)
    preds = np.asarray(probs) > threshold
    tp = int((preds & labels).sum())
    fp = int((preds & ~labels).sum())
    fn = int((~preds & labels).sum())
    tn = int((~preds & ~labels).sum())
    acc = (tp + tn) / max(len(labels), 1)
    prec = tp / max(tp + fp, 1)
    rec = tp / max(tp + fn, 1)
    f1 = 2 * prec * rec / max(prec + rec, 1e-12)
    # AUC via rank statistic
    order = np.argsort(np.asarray(probs))
    ranks = np.empty(len(order))
    ranks[order] = np.arange(1, len(order) + 1)
    n_pos = int(labels.sum())
    n_neg = len(labels) - n_pos
    if n_pos and n_neg:
        auc = (ranks[labels].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)
    else:
        auc = float("nan")
    return {"accuracy": acc, "precision": prec, "recall": rec,
            "f1": f1, "auc": float(auc),
            "tp": tp, "fp": fp, "fn": fn, "tn": tn}


def split_indices(m: int, *, val_fraction: float = 0.2, seed: int = 0,
                  split_path: Optional[str] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """``(train_idx, val_idx)``: read from ``split_path`` when it exists,
    else drawn as the JAX package draws them and written there (the
    reference's frozen splits, train_medrag_router.py:296-317)."""
    if split_path and os.path.exists(split_path):
        with open(split_path) as f:
            saved = json.load(f)
        val_idx = np.asarray(saved["val"], dtype=np.int64)
        train_idx = np.asarray(saved["train"], dtype=np.int64)
        if len(val_idx) + len(train_idx) != m:
            raise ValueError(
                f"persisted split at {split_path} covers "
                f"{len(val_idx) + len(train_idx)} examples, dataset has {m}")
        return train_idx, val_idx
    perm = np.random.default_rng(seed).permutation(m)
    n_val = max(1, int(m * val_fraction))
    val_idx, train_idx = perm[:n_val], perm[n_val:]
    if split_path:
        os.makedirs(os.path.dirname(os.path.abspath(split_path)),
                    exist_ok=True)
        with open(split_path, "w") as f:
            json.dump({"train": train_idx.tolist(),
                       "val": val_idx.tolist()}, f)
    return train_idx, val_idx


@dataclasses.dataclass
class TrainResult:
    params: Dict[str, torch.Tensor]     # best CorpusRouter state_dict (CPU)
    threshold: float
    scaler: Optional[Tuple[np.ndarray, np.ndarray]]
    metrics: Dict[str, float]
    epoch_seconds: List[float]          # wall time of each epoch
    steps: int                          # optimiser steps taken
    # devices of the parameters and optimiser state at the last epoch
    devices: List[str] = dataclasses.field(default_factory=list)


def _state_devices(model: torch.nn.Module, opt) -> List[str]:
    tensors = list(model.parameters()) + [
        v for st in opt.state.values() for v in st.values()
        if torch.is_tensor(v) and v.dim() > 0]
    return sorted({str(t.device) for t in tensors})


def train_router(
    features: np.ndarray,          # [M, D_in] raw (unscaled) features
    labels: np.ndarray,            # [M] 0/1
    *,
    use_scaler: bool = True,
    pos_weight: float = 1.0,
    num_epochs: int = NUM_EPOCHS,
    batch_size: int = 256,
    val_fraction: float = 0.2,
    seed: int = 0,
    verbose: bool = False,
    split_path: Optional[str] = None,
    device="cuda",
) -> TrainResult:
    """Full training loop with best-val checkpointing + threshold search,
    on ``device`` (``resolve_device``: a CUDA request without CUDA
    raises)."""
    dev = resolve_device(device)
    m, d_in = features.shape
    train_idx, val_idx = split_indices(m, val_fraction=val_fraction,
                                       seed=seed, split_path=split_path)
    scaler = fit_scaler(features[train_idx]) if use_scaler else None
    xf = (features - scaler[0]) / scaler[1] if scaler is not None \
        else features
    x_train = torch.from_numpy(
        np.ascontiguousarray(xf[train_idx], np.float32)).to(dev)
    y_train = torch.from_numpy(
        np.asarray(labels[train_idx], np.float32)).to(dev)
    x_val = torch.from_numpy(
        np.ascontiguousarray(xf[val_idx], np.float32)).to(dev)
    y_val_np = np.asarray(labels[val_idx]) > 0.5
    y_val = torch.from_numpy(y_val_np).to(dev)

    n_train = len(train_idx)
    steps_per_epoch = max(1, n_train // batch_size)
    model = CorpusRouter.from_seed(d_in, seed, dev)
    opt, sched = make_optimizer(model, steps_per_epoch)
    gen = torch.Generator(device=dev).manual_seed(seed)
    pw = torch.tensor(pos_weight, dtype=torch.float32, device=dev)

    best_val_acc = -1.0
    best = {k: v.detach().clone() for k, v in model.state_dict().items()}
    epoch_seconds: List[float] = []
    loss = None
    for epoch in range(num_epochs):
        t0 = time.perf_counter()
        order = torch.randperm(n_train, generator=gen, device=dev)
        for s in range(steps_per_epoch):
            sl = order[s * batch_size:(s + 1) * batch_size]
            loss = train_step(model, opt, sched, x_train[sl], y_train[sl],
                              pw, gen)
        with torch.no_grad():
            val_acc = float(((model(x_val) > 0.0) == y_val)
                            .float().mean())     # the epoch's one sync
        epoch_seconds.append(time.perf_counter() - t0)
        if val_acc > best_val_acc:
            best_val_acc = val_acc
            best = {k: v.detach().clone()
                    for k, v in model.state_dict().items()}
        if verbose and (epoch % 10 == 0 or epoch == num_epochs - 1):
            print(f"epoch {epoch}: loss={float(loss):.4f} "
                  f"val_acc={val_acc:.4f} best={best_val_acc:.4f} "
                  f"({epoch_seconds[-1]:.3f} s)", flush=True)
    devices = _state_devices(model, opt)

    model.load_state_dict(best)
    with torch.no_grad():
        val_logits = model(x_val).cpu().numpy()
    threshold = find_optimal_threshold(val_logits, y_val_np)
    probs = 1.0 / (1.0 + np.exp(-val_logits))
    metrics = classification_metrics(probs, y_val_np, threshold)
    metrics["best_val_acc"] = best_val_acc
    params = {k: v.cpu() for k, v in best.items()}
    return TrainResult(params, threshold, scaler, metrics, epoch_seconds,
                       steps_per_epoch * num_epochs, devices)
