"""CLI entry point: serve the federated search system with PyTorch.

The same flags as the JAX package's ``main.py``, plus ``--device``. Values
outside the ported slices (meshes, the dtype policy, live encoders) fail at
start-up naming their ROADMAP item. ``--llm-backend jax`` keeps the JAX package's value, so that one
command line drives both packages; here it means generation on the card by
this package's decoder (``ragroute_tpu_torch.llm``).

Examples (on a CUDA card)::

    python -m ragroute_tpu_torch.main --dataset medrag --routing ragroute \
        --disable-llm
    python -m ragroute_tpu_torch.main --dataset medrag --routing ragroute \
        --disable-llm --impl ivf --nprobe 512
    python -m ragroute_tpu_torch.main --dataset medrag --routing ragroute \
        --disable-llm --impl lowrank --dtype int4
    python -m ragroute_tpu_torch.main --dataset medrag --routing ragroute \
        --disable-llm --impl hostrefine --dtype int8 --hbm-budget-gb 3.0
    python -m ragroute_tpu_torch.main --dataset medrag --llm-backend jax \
        --llm-checkpoint DIR --llm-quant int4 --llm-kv-quant int8 \
        --llm-serving continuous --llm-prefix-cache --llm-spec-window 4
    python -m ragroute_tpu_torch.main --dataset medrag --routing ragroute \
        --disable-llm --frontend native --mutable --reserve-docs 4096
    python -m ragroute_tpu_torch.main --dataset medrag --routing ragroute \
        --disable-llm --workers 2
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
                   help="Generation backend: auto = reference behavior "
                        "(ollama daemon; echo when --disable-llm/--simulate);"
                        " jax = generation on the card next to retrieval "
                        "(the registry model as this package's PyTorch "
                        "decoder, micro-batched, KV-cache decode; the value "
                        "keeps the JAX package's name)")
    p.add_argument("--llm-checkpoint", type=str, default=None,
                   help="Local HF causal-LM checkpoint directory for "
                        "--llm-backend jax (Llama/Qwen3 layouts; needs "
                        "transformers). Without it the jax backend serves a "
                        "tiny DEMO decoder (offline; answers are gibberish, "
                        "the path is real)")
    p.add_argument("--llm-max-new", type=int, default=256,
                   help="Max generated tokens per answer with --llm-backend "
                        "jax")
    p.add_argument("--llm-quant", type=str, default=None,
                   choices=["int8", "int4"],
                   help="Weight-only quantization of the checkpoint for "
                        "--llm-backend jax: int8 per-channel halves the "
                        "decode weight stream; int4 packs group-scaled "
                        "nibbles through the int4 matmul kernel for another "
                        "2x fewer bytes")
    p.add_argument("--llm-serving", type=str, default="batch",
                   choices=["batch", "continuous"],
                   help="Generation scheduling for --llm-backend jax: "
                        "'batch' decodes each micro-batch to completion; "
                        "'continuous' is slot-based continuous batching "
                        "(requests join/leave the running decode at chunk "
                        "boundaries)")
    p.add_argument("--llm-spec-window", type=int, default=0,
                   help="Prompt-lookup speculative decoding window for "
                        "--llm-serving continuous (0 = off, >=2 = verify "
                        "that many tokens per step; greedy-exact, drafts "
                        "copied from each answer's own history)")
    p.add_argument("--llm-temperature", type=float, default=0.0,
                   help="Sampling temperature for --llm-backend jax (0 = "
                        "greedy, the default)")
    p.add_argument("--llm-top-k", type=int, default=0,
                   help="Keep only the k highest-probability tokens when "
                        "sampling (0 = off)")
    p.add_argument("--llm-top-p", type=float, default=1.0,
                   help="Nucleus sampling: keep the smallest token set whose "
                        "probability mass reaches p (1.0 = off)")
    p.add_argument("--llm-prefix-cache", action="store_true",
                   help="Shared-prefix KV for --llm-serving continuous: the "
                        "constant head every RAG prompt shares is prefilled "
                        "once and attended as a broadcast segment; admission"
                        " prefills only the per-request suffix")
    p.add_argument("--llm-kv-quant", type=str, default=None,
                   choices=["int8"],
                   help="Quantize the KV cache (int8 codes + per-(position, "
                        "head) scales): halves the cache bytes each decode "
                        "step reads")
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
                        "low-rank coarse scan + exact refine; stream = "
                        "resident prefix + host-RAM slabs uploaded per "
                        "batch; hostrefine = device coarse scan + exact "
                        "rescore from host-RAM rows")
    p.add_argument("--hbm-budget-gb", type=float, default=None,
                   help="--impl stream/hostrefine: device-memory budget "
                        "for exact rows in GB (default "
                        "$RAGROUTE_HBM_BUDGET_GB or 6.0)")
    p.add_argument("--nprobe", type=int, default=None,
                   help="Clusters probed per query (--impl ivf/hybrid: "
                        "default C/8 resp. C/32 per shard; --impl "
                        "hostrefine over a clustered coarse slab: C/8)")
    p.add_argument("--ivf-clusters", type=int, default=-1,
                   help="Clusters per shard for --impl ivf/hybrid "
                        "(-1 = ~4*sqrt(n) per shard)")
    p.add_argument("--rank", type=int, default=-1,
                   help="--impl lowrank: rank of the coarse projection "
                        "(-1 = by spectral energy)")
    p.add_argument("--refine-mult", type=int, default=None,
                   help="--impl lowrank/hostrefine: candidates per query "
                        "= refine_mult * k (default 4)")
    p.add_argument("--buckets", type=int, nargs="+", default=None,
                   help="Batch bucket sizes (each is warmed at start-up; "
                        "default 1 8 32 128 512)")
    p.add_argument("--frontend", type=str, default="aiohttp",
                   choices=["aiohttp", "native"],
                   help="HTTP front end: aiohttp, or native = the C++ "
                        "epoll front end (native/frontend.cpp, built with "
                        "g++ at start-up) whose batch pull is the "
                        "micro-batcher")
    p.add_argument("--workers", type=int, default=1,
                   help="Serving processes sharing the port through "
                        "SO_REUSEPORT; on one card each holds its own copy "
                        "of the index (not with --mutable)")
    p.add_argument("--mesh", type=str, default=None,
                   help="DPxIDX device mesh (not ported)")
    p.add_argument("--mutable", action="store_true",
                   help="Serve a live index: POST /docs/add and /docs/delete "
                        "insert and remove documents at serve time (in-place "
                        "writes on the card), POST /admin/snapshot persists "
                        "them. Not with --impl ivf/hybrid/lowrank/stream/"
                        "hostrefine or --workers")
    p.add_argument("--reserve-docs", type=int, default=0,
                   help="Extra free slots per shard for live adds (with "
                        "--mutable)")
    p.add_argument("--embedder", type=str, default="auto",
                   choices=["auto", "precomputed", "hash", "zoo"],
                   help="Query-embedding provider: auto (precomputed table "
                        "if present, else hash), or zoo = live encoder "
                        "models per query on the engine's device (hash "
                        "stubs for encoders without a local checkpoint)")
    p.add_argument("--coordinator", type=str, default=None,
                   help="Multi-host cluster (not ported)")
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=0)
    return p.parse_args(argv)


def main(argv=None) -> None:
    from ragroute_tpu_torch.system import ServingSystem, run_workers

    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    if args.workers > 1:
        run_workers(args, args.workers)
        logger.info("Exiting application")
        return
    system = ServingSystem(args)
    try:
        if system.frontend == "native":
            system.run_native()
        else:
            asyncio.run(system.run_forever())
    except KeyboardInterrupt:
        pass
    logger.info("Exiting application")


if __name__ == "__main__":
    main()
