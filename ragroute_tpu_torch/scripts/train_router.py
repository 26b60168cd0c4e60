"""Train a corpus router for a world and save it to the data root.

Counterpart of ``scripts/train_router.py`` (the reference's
``scripts/train/train_{medrag,feb4rag,mmlu}_router.py``): one script for
all worlds, the serving features, the world's routing labels
(``relevant.npy``), training on ``--device`` (default the card), and a
checkpoint the serving system picks up (``<root>/<world>/router.npz`` with
the scaler and the ROC-optimal threshold inside, readable by both
packages). The split is kept in ``<root>/<world>/split.json``.

    python -m ragroute_tpu_torch.scripts.make_synthetic_data --dataset medrag
    python -m ragroute_tpu_torch.scripts.train_router --dataset medrag
    python -m ragroute_tpu_torch.main --dataset medrag --routing ragroute \\
        --disable-llm
"""

import argparse
import json
import os

import numpy as np
import torch

from ragroute_tpu_torch.config import data_root, get_world
from ragroute_tpu_torch.router.features import RouterBank, build_features
from ragroute_tpu_torch.router.torch_import import save_router_npz
from ragroute_tpu_torch.train.train_router import NUM_EPOCHS, train_router


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", type=str, default="medrag")
    parser.add_argument("--data-root", type=str, default=None)
    parser.add_argument("--epochs", type=int, default=None,
                        help="override the reference's 150 epochs")
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--pos-weight", type=float, default=None,
                        help="default: 1.0 medrag/feb4rag, 5.0 wikipedia "
                             "(train_mmlu_router.py 5x pos_weight)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="training device: cuda (or cuda:N); cpu for "
                             "tests")
    return parser.parse_args(argv)


def world_examples(wroot: str, world):
    """``(features [M, D_in], labels [M])``: every (question, source) pair
    of the world's query table, unscaled, and its routing label."""
    qdir = os.path.join(wroot, "queries")
    with open(os.path.join(qdir, "encoders.json")) as f:
        encoders = json.load(f)
    query_embs = {enc: torch.from_numpy(
        np.load(os.path.join(qdir, f"enc_{i}.npy")))
        for i, enc in enumerate(encoders)}
    with open(os.path.join(wroot, "centroids.json")) as f:
        centroids = {k: np.asarray(v, np.float32)
                     for k, v in json.load(f).items()}
    labels_path = os.path.join(wroot, "relevant.npy")
    if not os.path.exists(labels_path):
        raise FileNotFoundError(
            f"{labels_path} missing; regenerate with make_synthetic_data "
            "or compute contribution labels from real retrieval logs")
    labels = np.load(labels_path)
    bank = RouterBank.create(world, centroids)
    with torch.no_grad():
        feats = build_features(world, bank, query_embs).numpy()
    return (feats.reshape(-1, world.router_input_dim),
            labels.reshape(-1).astype(np.float32))


def main(argv=None):
    """Train and save; returns ``(TrainResult, path of router.npz)``."""
    args = parse_args(argv)
    root = args.data_root or data_root()
    world = get_world(args.dataset)
    wroot = os.path.join(root, world.name)
    x, y = world_examples(wroot, world)
    print(f"training router: {x.shape[0]} examples, dim {x.shape[1]}, "
          f"positives {y.mean():.3f}, device {args.device}")

    pos_weight = args.pos_weight
    if pos_weight is None:
        pos_weight = 5.0 if world.name == "wikipedia" else 1.0

    result = train_router(
        x, y,
        split_path=os.path.join(wroot, "split.json"),
        use_scaler=world.uses_scaler,
        pos_weight=pos_weight,
        num_epochs=args.epochs or NUM_EPOCHS,
        batch_size=args.batch_size,
        seed=args.seed,
        verbose=True,
        device=args.device,
    )
    total = sum(result.epoch_seconds)
    print(f"{result.steps} steps in {total:.3f} s: "
          f"{total / len(result.epoch_seconds):.4f} s an epoch, "
          f"{result.steps / total:.1f} steps/s; parameters and optimiser "
          f"state on {result.devices}")
    print("validation metrics:", json.dumps(result.metrics, indent=2))

    out = os.path.join(wroot, "router.npz")
    save_router_npz(out, result.params, threshold=result.threshold,
                    scaler=result.scaler)
    print(f"saved {out} (threshold={result.threshold:.4f})")
    return result, out


if __name__ == "__main__":
    main()
