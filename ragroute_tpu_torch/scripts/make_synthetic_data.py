"""Generate and persist a synthetic world under the data root.

Counterpart of ``scripts/make_synthetic_data.py``: regenerable ground-truth
data (shards, payloads, centroids, query table, routing labels, benchmark
file) so the whole system (serve, benchmark, router training) runs
anywhere. The world is made with numpy on the host; ``--device`` is checked
(a CUDA request without CUDA raises) so that every script of the offline
path takes the same flags.

    python -m ragroute_tpu_torch.scripts.make_synthetic_data \\
        --dataset medrag --docs-per-source 100000 --num-queries 512
    python -m ragroute_tpu_torch.scripts.train_router --dataset medrag
    python -m ragroute_tpu_torch.main --dataset medrag --routing ragroute \\
        --disable-llm
"""

import argparse

from ragroute_tpu_torch.config import WORLDS, data_root
from ragroute_tpu_torch.index.synthetic import make_synthetic_world, save_world
from ragroute_tpu_torch.utils.precision import resolve_device


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", type=str, default="medrag",
                        choices=sorted(WORLDS))
    parser.add_argument("--docs-per-source", type=int, default=20000)
    parser.add_argument("--num-queries", type=int, default=256)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--data-root", type=str, default=None)
    parser.add_argument("--subclusters", type=int, default=1,
                        help="within-source topic clusters (>1 makes the "
                             "corpus topically structured like real data; "
                             "used to evaluate the IVF approximate mode)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (or cuda:N); cpu for tests")
    return parser.parse_args(argv)


def main(argv=None) -> str:
    args = parse_args(argv)
    resolve_device(args.device)
    root = args.data_root or data_root()
    print(f"Generating synthetic {args.dataset} world "
          f"({args.docs_per_source} docs/source, {args.num_queries} queries)")
    syn = make_synthetic_world(
        args.dataset,
        docs_per_source=args.docs_per_source,
        num_queries=args.num_queries,
        seed=args.seed,
        subclusters=args.subclusters,
    )
    out = save_world(syn, root)
    print(f"Saved to {out}")
    return out


if __name__ == "__main__":
    main()
