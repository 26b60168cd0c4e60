"""System orchestration: build, serve, watch, shut down.

PyTorch port of :mod:`ragroute_tpu.system` for the single-device paths
(exact search and the approximate device-resident modes ``--impl ivf |
hybrid | lowrank``, ``--dtype int4``): load the world's artifacts (shards
with their extra layouts, centroids, router checkpoint, query table, doc
payloads) from the data root onto the chosen device, construct engine +
batcher + HTTP server, restart the batcher worker if it ever dies, and stop
cleanly on SIGINT/SIGTERM.

Every CLI value outside the ported slice fails at start-up with an error
naming its ROADMAP item (:func:`check_ported`); none is silently ignored.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import signal
from typing import Optional

import numpy as np
import torch

from ragroute_tpu_torch import config as cfg
from ragroute_tpu_torch.config import SHARD_PAD_MULTIPLE, WorldConfig, get_world
from ragroute_tpu_torch.engine import embedding
from ragroute_tpu_torch.engine.batcher import QueryBatcher
from ragroute_tpu_torch.engine.engine import FederatedSearchEngine
from ragroute_tpu_torch.engine.rerank import load_qrels
from ragroute_tpu_torch.engine.server import FederationServer, LLMClient
from ragroute_tpu_torch.index.native_store import make_doc_store
from ragroute_tpu_torch.index.shard import STORAGE_DTYPES, ShardSet
from ragroute_tpu_torch.index.store import MemoryDocStore
from ragroute_tpu_torch.index.synthetic import make_synthetic_world
from ragroute_tpu_torch.router.checkpoint import (load_router_npz,
                                                  params_from_jax)
from ragroute_tpu_torch.router.features import RouterBank
from ragroute_tpu_torch.router.mlp import CorpusRouter
from ragroute_tpu_torch.utils.precision import resolve_device

logger = logging.getLogger("system")

WATCHDOG_POLL_S = 1.0

# (argument, values the slice serves, ROADMAP item that ports the rest)
_UNPORTED = (
    ("mesh", (None,), "queue 1, item 14 (multi-GPU)"),
    ("coordinator", (None,), "queue 1, item 14 (multi-GPU)"),
    ("num_processes", (1,), "queue 1, item 14 (multi-GPU)"),
    ("process_id", (0,), "queue 1, item 14 (multi-GPU)"),
    ("mutable", (False,), "queue 1, item 9 (live index)"),
    ("reserve_docs", (0,), "queue 1, item 9 (live index)"),
    ("embedder", ("auto", "precomputed", "hash"),
     "queue 1, item 8 (live query encoders)"),
    ("frontend", ("aiohttp",), "queue 1, item 6 (native front-end)"),
    ("workers", (1,), "queue 1, item 6 (multi-process front-end)"),
    ("dtype", ("float32", "bfloat16", "int8", "int4"),
     "queue 1, item 10 (dtype policy)"),
    ("impl", ("auto", "exact", "chunked", "pallas", "ivf", "hybrid",
              "lowrank"), "queue 1, item 11 (host-RAM tiers)"),
    ("hbm_budget_gb", (None,), "queue 1, item 11 (host-RAM tiers)"),
    ("llm_backend", ("auto", "ollama", "openai", "echo"),
     "queue 1, item 13 (LLM stack)"),
    ("llm_checkpoint", (None,), "queue 1, item 13 (LLM stack)"),
    ("llm_max_new", (256,), "queue 1, item 13 (LLM stack)"),
    ("llm_quant", (None,), "queue 1, item 13 (LLM stack)"),
    ("llm_serving", ("batch",), "queue 1, item 13 (LLM stack)"),
    ("llm_spec_window", (0,), "queue 1, item 13 (LLM stack)"),
    ("llm_temperature", (0.0,), "queue 1, item 13 (LLM stack)"),
    ("llm_top_k", (0,), "queue 1, item 13 (LLM stack)"),
    ("llm_top_p", (1.0,), "queue 1, item 13 (LLM stack)"),
    ("llm_prefix_cache", (False,), "queue 1, item 13 (LLM stack)"),
    ("llm_kv_quant", (None,), "queue 1, item 13 (LLM stack)"),
)


def check_ported(args) -> None:
    """Raise on any CLI value the port does not serve yet (an argument the
    namespace lacks counts as its default)."""
    for name, allowed, item in _UNPORTED:
        if hasattr(args, name) and getattr(args, name) not in allowed:
            raise ValueError(
                f"--{name.replace('_', '-')} {getattr(args, name)!r} is not "
                f"ported to ragroute_tpu_torch yet (ROADMAP {item})")


def load_world_artifacts(root: str, world: WorldConfig, *,
                         dtype=torch.bfloat16, embedder: str = "auto",
                         device="cpu", ivf_clusters=None, lowrank=None):
    """Load shards / router / bank / query provider / doc store from the
    data root (layout of :func:`ragroute_tpu_torch.index.synthetic.
    save_world`). No router checkpoint: fresh params from a seeded
    generator (warning); no query table: hash embeddings.
    ``ivf_clusters`` / ``lowrank`` additionally build the layouts of the
    approximate modes (cached as ``.npz`` beside each source's
    embeddings, as :meth:`ShardSet.load` does)."""
    wroot = os.path.join(root, world.name)
    shard_set = ShardSet.load(root, world, dtype=dtype, device=device,
                              ivf_clusters=ivf_clusters, lowrank=lowrank)

    cent_path = os.path.join(wroot, "centroids.json")
    if os.path.exists(cent_path):
        with open(cent_path) as f:
            centroids = {k: np.asarray(v, np.float32)
                         for k, v in json.load(f).items()}
    else:
        logger.warning("no centroids.json under %s; using zeros", wroot)
        centroids = {s.name: np.zeros(s.embed_dim, np.float32)
                     for s in world.sources}

    threshold, scaler = None, None
    router = CorpusRouter(world.router_input_dim)
    npz_path = os.path.join(wroot, "router.npz")
    if os.path.exists(npz_path):
        params, threshold, scaler = load_router_npz(npz_path)
        router.load_state_dict(params_from_jax(params))
        router = router.to(device).eval()
    elif os.path.exists(os.path.join(wroot, "router.pth")):
        raise NotImplementedError(
            "reference torch router checkpoints (router.pth + sklearn "
            "scaler) are not ported yet (ROADMAP queue 1, item 4); convert "
            "to router.npz")
    else:
        logger.warning("no router checkpoint under %s; initializing fresh "
                       "params from seed 0", wroot)
        router = CorpusRouter.from_seed(world.router_input_dim, 0, device)
    bank = RouterBank.create(world, centroids, scaler, device=device)

    qdir = os.path.join(wroot, "queries")
    if embedder == "hash":
        provider = embedding.HashEmbeddings(world)
    elif os.path.exists(os.path.join(qdir, "encoders.json")):
        with open(os.path.join(qdir, "encoders.json")) as f:
            encoders = json.load(f)
        with open(os.path.join(qdir, "qids.json")) as f:
            qids = json.load(f)
        embs = {enc: np.load(os.path.join(qdir, f"enc_{i}.npy"))
                for i, enc in enumerate(encoders)}
        table = {qid: {enc: embs[enc][i] for enc in encoders}
                 for i, qid in enumerate(qids)}
        provider = embedding.PrecomputedEmbeddings(world, table)
    elif embedder == "precomputed":
        raise FileNotFoundError(
            f"--embedder precomputed: no query table under {qdir}")
    else:
        provider = embedding.HashEmbeddings(world)

    pay_dir = os.path.join(wroot, "payloads")
    # the C++ mmap store when it builds, else the Python jsonl store
    doc_store = make_doc_store(pay_dir) if os.path.isdir(pay_dir) else None

    relevance = {}
    qrels_path = os.path.join(wroot, "qrels.txt")
    if world.name == "feb4rag" and os.path.exists(qrels_path):
        relevance = load_qrels(qrels_path)
    return shard_set, router, bank, provider, doc_store, relevance, threshold


class ServingSystem:
    """One-stop construction + lifecycle for the serving stack."""

    def __init__(self, args):
        check_ported(args)
        self.dataset: str = args.dataset
        self.world = get_world(self.dataset)
        self.routing: str = args.routing
        self.disable_llm: bool = args.disable_llm
        self.simulate: bool = getattr(args, "simulate", False)
        self.model: str = args.model
        self.data_root: str = getattr(args, "data_root", None) or cfg.data_root()
        port = getattr(args, "port", None)
        self.port: int = cfg.HTTP_PORT if port is None else port
        self.dtype_name: str = getattr(args, "dtype", "bfloat16")
        self.impl: str = getattr(args, "impl", "auto")
        self.nprobe = getattr(args, "nprobe", None)
        self.ivf_clusters = getattr(args, "ivf_clusters", -1)
        # --impl lowrank: rank of the coarse projection (-1: by spectral
        # energy) and candidate depth k' = refine_mult * k
        self.lowrank_rank = getattr(args, "rank", None) or -1
        refine_mult = getattr(args, "refine_mult", None)
        self.k_refine = (refine_mult * self.world.k) if refine_mult else None
        self.llm_backend: str = getattr(args, "llm_backend", None) or "auto"
        self.buckets = getattr(args, "buckets", None) or cfg.BATCH_BUCKETS
        self.embedder = getattr(args, "embedder", "auto") or "auto"
        self.device = resolve_device(getattr(args, "device", None) or "cuda")
        self.server: Optional[FederationServer] = None
        self._watchdog: Optional[asyncio.Task] = None
        self._stopping = False

    def build(self) -> FederationServer:
        dtype = STORAGE_DTYPES[self.dtype_name]
        ivf_clusters = (self.ivf_clusters if self.impl in ("ivf", "hybrid")
                        else None)
        lowrank = self.lowrank_rank if self.impl == "lowrank" else None
        if self.simulate:
            # reference --simulate: tiny in-memory synthetic world, hash
            # embeddings, all sources, stage delays
            syn = make_synthetic_world(
                self.dataset, docs_per_source=SHARD_PAD_MULTIPLE,
                num_queries=4)
            shard_set = ShardSet.build(syn.world, syn.embeddings,
                                       doc_ids=syn.doc_ids, dtype=dtype,
                                       device=self.device,
                                       ivf_clusters=ivf_clusters,
                                       lowrank=lowrank)
            router = CorpusRouter.from_seed(self.world.router_input_dim, 0,
                                            self.device)
            bank = RouterBank.create(self.world, syn.centroids,
                                     device=self.device)
            provider = embedding.HashEmbeddings(self.world)
            doc_store = MemoryDocStore.from_synthetic(syn)
            relevance, threshold = {}, None
        else:
            (shard_set, router, bank, provider, doc_store, relevance,
             threshold) = load_world_artifacts(
                self.data_root, self.world, dtype=dtype,
                embedder=self.embedder, device=self.device,
                ivf_clusters=ivf_clusters, lowrank=lowrank)
        engine = FederatedSearchEngine(shard_set, router, bank,
                                       impl=self.impl, threshold=threshold,
                                       nprobe=self.nprobe,
                                       k_refine=self.k_refine)
        strategy = "all" if self.simulate else self.routing
        backend = self.llm_backend
        if backend == "auto":
            backend = ("echo" if (self.simulate or self.disable_llm)
                       else "ollama")
        llm = LLMClient(backend,
                        delay_s=cfg.LLM_DELAY if self.simulate else 0.0)
        self.server = FederationServer(
            engine, strategy=strategy, embedding_provider=provider,
            doc_store=doc_store, llm=llm, model=self.model,
            disable_llm=self.disable_llm, simulate=self.simulate,
            relevance_data=relevance, port=self.port,
            batcher=QueryBatcher(engine, strategy=strategy,
                                 buckets=self.buckets))
        return self.server

    async def start(self) -> None:
        if self.server is None:
            self.build()
        logger.info("Starting ragroute_tpu_torch with dataset %s "
                    "(routing=%s, device=%s)", self.dataset, self.routing,
                    self.device)
        await self.server.start()
        self._watchdog = asyncio.create_task(self._watch())
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(
                    sig, lambda: asyncio.create_task(self.stop()))
            except (NotImplementedError, RuntimeError):
                pass          # non-unix, or not the main thread

    async def _watch(self) -> None:
        """Restart the batcher worker if it ever dies."""
        while not self._stopping:
            await asyncio.sleep(WATCHDOG_POLL_S)
            b = self.server.batcher
            if b._task is not None and b._task.done() and not self._stopping:
                exc = b._task.exception() if not b._task.cancelled() else None
                logger.error("batch worker died (%s); restarting", exc)
                await b.start()

    async def run_forever(self) -> None:
        await self.start()
        while not self._stopping:
            await asyncio.sleep(1.0)

    async def stop(self) -> None:
        if self._stopping:
            return
        self._stopping = True
        logger.info("Shutting down ragroute_tpu_torch serving system")
        if self._watchdog:
            self._watchdog.cancel()
        if self.server:
            await self.server.stop()
        logger.info("Shutdown complete")
