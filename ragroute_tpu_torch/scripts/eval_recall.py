"""Recall evaluation: the engine on the card against exact f32 brute force.

Counterpart of ``scripts/eval_recall.py``: recall@k of the port's engine
(the stored dtype, the chosen ``--impl``) against the exact float32 oracle
over the same corpus (``oracle.exact_oracle``), per routing strategy,
restricted to the strategy's mask. Prints one JSON line, the JAX script's.

    python -m ragroute_tpu_torch.scripts.eval_recall --dataset medrag \\
        --strategies all ragroute
"""

import argparse
import json
import os

import numpy as np

from ragroute_tpu_torch.config import IVF_NPROBE_DIVISOR, data_root, get_world
from ragroute_tpu_torch.engine.engine import IMPLS, FederatedSearchEngine
from ragroute_tpu_torch.index.shard import STORAGE_DTYPES
from ragroute_tpu_torch.oracle import engine_recall, exact_oracle
from ragroute_tpu_torch.system import load_world_artifacts
from ragroute_tpu_torch.utils.precision import resolve_device


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", default="medrag")
    parser.add_argument("--data-root", default=None)
    parser.add_argument("--strategies", nargs="+",
                        default=["all", "ragroute", "random"])
    parser.add_argument("--dtype", default="bfloat16",
                        choices=sorted(STORAGE_DTYPES))
    parser.add_argument("--num-queries", type=int, default=128)
    parser.add_argument("--impl", default="auto", choices=IMPLS,
                        help="'ivf' / 'hybrid' / 'lowrank' measure the "
                             "approximate modes against the same oracle")
    parser.add_argument("--ivf-clusters", type=int, default=-1,
                        help="clusters per shard for --impl ivf / hybrid "
                             "(-1 = ~4*sqrt(n) default)")
    parser.add_argument("--nprobe", type=int, default=0,
                        help="clusters probed per query (0 = C/8)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (or cuda:N); cpu for tests")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    """Print the report's JSON line and return the report."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    root = args.data_root or data_root()
    world = get_world(args.dataset)
    ivf = args.impl in ("ivf", "hybrid")
    (shard_set, router, bank, provider, _, _, threshold) = \
        load_world_artifacts(
            root, world, dtype=STORAGE_DTYPES[args.dtype], device=dev,
            ivf_clusters=args.ivf_clusters if ivf else None,
            lowrank=-1 if args.impl == "lowrank" else None)
    engine = FederatedSearchEngine(shard_set, router, bank,
                                   threshold=threshold, impl=args.impl,
                                   nprobe=args.nprobe or None)

    # raw embeddings for the oracle + the precomputed query table
    wroot = os.path.join(root, world.name)
    embeddings = {
        s.name: np.load(os.path.join(wroot, s.name, "embeddings.npy"),
                        mmap_mode="r")
        for s in world.sources
    }
    qids = sorted(provider.table)[: args.num_queries]
    query_embs = {
        enc: np.stack([provider.table[q][enc] for q in qids])
        for enc in world.encoders
    }

    report = {"dataset": world.name, "k": world.k, "dtype": args.dtype,
              "impl": args.impl, "num_queries": len(qids), "recall": {}}
    if ivf:
        report["ivf"] = {
            s.name: {"C": s.ivf.n_clusters, "S": s.ivf.capacity,
                     "nprobe": args.nprobe or max(
                         1, s.ivf.n_clusters // IVF_NPROBE_DIVISOR)}
            for s in shard_set.shards}
    for strategy in args.strategies:
        out = engine.search(query_embs, strategy=strategy)
        mask = out.mask if strategy != "all" else None
        oracle = exact_oracle(world, embeddings, query_embs, world.k,
                              mask=mask)
        report["recall"][strategy] = round(
            engine_recall(world, out, oracle), 4)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
