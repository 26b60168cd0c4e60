"""CLI entry point: serve the federated search system with PyTorch.

The same flags as the JAX package's ``main.py``, plus ``--device``. Values
outside the ported slices (meshes, host-RAM tiers, the dtype policy, live
updates, live encoders, the JAX LLM stack, the native front-end, workers)
fail at start-up naming their ROADMAP item.

Examples (on a CUDA card)::

    python -m ragroute_tpu_torch.main --dataset medrag --routing ragroute \
        --disable-llm
    python -m ragroute_tpu_torch.main --dataset medrag --routing ragroute \
        --disable-llm --impl ivf --nprobe 512
    python -m ragroute_tpu_torch.main --dataset medrag --routing ragroute \
        --disable-llm --impl lowrank --dtype int4
"""

from __future__ import annotations

import argparse
import asyncio
import logging

from ragroute_tpu_torch.config import ROUTING_STRATEGIES, SUPPORTED_MODELS, WORLDS

logger = logging.getLogger("main")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ragroute_tpu_torch")
    p.add_argument("--dataset", type=str, default="wikipedia",
                   choices=sorted(WORLDS),
                   help="The dataset being evaluated (the data sources)")
    p.add_argument("--routing", type=str, default="ragroute",
                   choices=list(ROUTING_STRATEGIES),
                   help="Routing method; random picks a fixed-size subset")
    p.add_argument("--disable-llm", action="store_true",
                   help="Disable the LLM for testing purposes")
    p.add_argument("--simulate", action="store_true",
                   help="Simulate the system (for testing purposes)")
    p.add_argument("--model", type=str, default=SUPPORTED_MODELS[0],
                   choices=list(SUPPORTED_MODELS),
                   help="The model to use for the LLM")
    p.add_argument("--device", type=str, default="cuda",
                   help="Serving device: cuda (or cuda:N); cpu for tests")
    p.add_argument("--llm-backend", type=str, default="auto",
                   choices=["auto", "ollama", "openai", "echo", "jax"],
                   help="Generation backend (auto: ollama, echo when "
                        "--disable-llm/--simulate); jax is not ported")
    p.add_argument("--llm-checkpoint", type=str, default=None,
                   help="(--llm-backend jax; not ported)")
    p.add_argument("--llm-max-new", type=int, default=256,
                   help="(--llm-backend jax; not ported)")
    p.add_argument("--llm-quant", type=str, default=None,
                   choices=["int8", "int4"],
                   help="(--llm-backend jax; not ported)")
    p.add_argument("--llm-serving", type=str, default="batch",
                   choices=["batch", "continuous"],
                   help="(--llm-backend jax; not ported)")
    p.add_argument("--llm-spec-window", type=int, default=0,
                   help="(--llm-backend jax; not ported)")
    p.add_argument("--llm-temperature", type=float, default=0.0,
                   help="(--llm-backend jax; not ported)")
    p.add_argument("--llm-top-k", type=int, default=0,
                   help="(--llm-backend jax; not ported)")
    p.add_argument("--llm-top-p", type=float, default=1.0,
                   help="(--llm-backend jax; not ported)")
    p.add_argument("--llm-prefix-cache", action="store_true",
                   help="(--llm-backend jax; not ported)")
    p.add_argument("--llm-kv-quant", type=str, default=None,
                   choices=["int8"], help="(--llm-backend jax; not ported)")
    p.add_argument("--data-root", type=str, default=None,
                   help="Data root (default: $RAGROUTE_DATA)")
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32", "int8", "int4", "policy"],
                   help="On-device index dtype (int8: per-doc symmetric "
                        "quantization; int4: two 4-bit codes per byte; "
                        "policy is not ported)")
    p.add_argument("--impl", type=str, default="auto",
                   choices=["auto", "pallas", "chunked", "exact", "ivf",
                            "hybrid", "lowrank", "stream", "hostrefine"],
                   help="Top-k implementation: auto = the fused CUDA kernel "
                        "for shards above 4096 docs on the card ('pallas' "
                        "names it), exact for small shards; ivf = "
                        "cluster-probed approximate search; hybrid = ivf "
                        "for small batches on large shards; lowrank = "
                        "low-rank coarse scan + exact refine; stream and "
                        "hostrefine are not ported")
    p.add_argument("--hbm-budget-gb", type=float, default=None,
                   help="(--impl stream/hostrefine; not ported)")
    p.add_argument("--nprobe", type=int, default=None,
                   help="Clusters probed per query (--impl ivf/hybrid; "
                        "default C/8 resp. C/32 per shard)")
    p.add_argument("--ivf-clusters", type=int, default=-1,
                   help="Clusters per shard for --impl ivf/hybrid "
                        "(-1 = ~4*sqrt(n) per shard)")
    p.add_argument("--rank", type=int, default=-1,
                   help="--impl lowrank: rank of the coarse projection "
                        "(-1 = by spectral energy)")
    p.add_argument("--refine-mult", type=int, default=None,
                   help="--impl lowrank: candidates per query = "
                        "refine_mult * k (default 4)")
    p.add_argument("--buckets", type=int, nargs="+", default=None,
                   help="Batch bucket sizes (each is warmed at start-up; "
                        "default 1 8 32 128 512)")
    p.add_argument("--frontend", type=str, default="aiohttp",
                   choices=["aiohttp", "native"],
                   help="HTTP front-end (native is not ported)")
    p.add_argument("--workers", type=int, default=1,
                   help="SO_REUSEPORT worker processes (not ported: 1)")
    p.add_argument("--mesh", type=str, default=None,
                   help="DPxIDX device mesh (not ported)")
    p.add_argument("--mutable", action="store_true",
                   help="Live index updates (not ported)")
    p.add_argument("--reserve-docs", type=int, default=0,
                   help="(--mutable; not ported)")
    p.add_argument("--embedder", type=str, default="auto",
                   choices=["auto", "precomputed", "hash", "zoo"],
                   help="Query-embedding provider: auto (precomputed table "
                        "if present, else hash); zoo is not ported")
    p.add_argument("--coordinator", type=str, default=None,
                   help="Multi-host cluster (not ported)")
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=0)
    return p.parse_args(argv)


def main(argv=None) -> None:
    from ragroute_tpu_torch.system import ServingSystem

    logging.basicConfig(level=logging.INFO)
    system = ServingSystem(parse_args(argv))
    try:
        asyncio.run(system.run_forever())
    except KeyboardInterrupt:
        pass
    logger.info("Exiting application")


if __name__ == "__main__":
    main()
