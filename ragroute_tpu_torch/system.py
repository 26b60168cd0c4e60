"""System orchestration: build, serve, watch, shut down.

PyTorch port of :mod:`ragroute_tpu.system` for the single-device paths
(exact search, the approximate device-resident modes ``--impl ivf | hybrid |
lowrank``, ``--dtype int4``, the host-RAM capacity tiers ``--impl stream |
hostrefine`` with ``--hbm-budget-gb``, the live index ``--mutable``, and
on-card generation ``--llm-backend jax``): load the world's artifacts
(shards with their extra layouts, centroids, router checkpoint, query
table, doc payloads) from the data root onto the chosen device, construct
engine + batcher + generation service + HTTP server, restart the batcher
worker if it ever dies, and stop cleanly on SIGINT/SIGTERM. The server runs
on aiohttp or on the native C++ front end (``--frontend native``,
:meth:`ServingSystem.run_native`); ``--workers N`` runs N such processes on
one port (:class:`Workers`).

Every CLI value outside the ported slice fails at start-up with an error
naming its ROADMAP item (:func:`check_ported`); none is silently ignored.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import signal
import time
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
from ragroute_tpu_torch.engine.streamed import StreamedSearchEngine
from ragroute_tpu_torch.index.native_store import make_doc_store
from ragroute_tpu_torch.index.shard import STORAGE_DTYPES, ShardSet
from ragroute_tpu_torch.index.store import MemoryDocStore
from ragroute_tpu_torch.index.streamed import StreamedShardSet
from ragroute_tpu_torch.index.synthetic import make_synthetic_world
from ragroute_tpu_torch.router.checkpoint import (load_router_npz,
                                                  params_from_jax)
from ragroute_tpu_torch.router.features import RouterBank
from ragroute_tpu_torch.router.mlp import CorpusRouter
from ragroute_tpu_torch.utils.precision import resolve_device

logger = logging.getLogger("system")

WATCHDOG_POLL_S = 1.0
STREAMED_IMPLS = ("stream", "hostrefine")

# (argument, values the slice serves, ROADMAP item that ports the rest)
_UNPORTED = (
    ("mesh", (None,), "queue 1, item 14 (multi-GPU: sharded search, and "
     "the tensor-parallel decoder of llm/sharding.py)"),
    ("coordinator", (None,), "queue 1, item 14 (multi-GPU)"),
    ("num_processes", (1,), "queue 1, item 14 (multi-GPU)"),
    ("process_id", (0,), "queue 1, item 14 (multi-GPU)"),
    ("dtype", ("float32", "bfloat16", "int8", "int4"),
     "queue 1, item 10 (dtype policy)"),
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
                         device="cpu", ivf_clusters=None, lowrank=None,
                         streamed_tier: Optional[str] = None,
                         hbm_budget_bytes: Optional[int] = None,
                         row_sources=None, mutable: bool = False,
                         reserve_docs: int = 0):
    """Load shards / router / bank / query provider / doc store from the
    data root (layout of :func:`ragroute_tpu_torch.index.synthetic.
    save_world`). No router checkpoint: fresh params from a seeded
    generator (warning); no query table: hash embeddings.
    ``ivf_clusters`` / ``lowrank`` additionally build the layouts of the
    approximate modes (cached as ``.npz`` beside each source's
    embeddings, as :meth:`ShardSet.load` does). ``streamed_tier``
    ("stream" | "hostrefine") builds the host-RAM tiers instead, under
    ``hbm_budget_bytes``: rows stream from the ``embeddings.npy`` mmaps
    through the block encoder; ``row_sources`` (source name -> array or
    :class:`~ragroute_tpu_torch.index.streamed.RowSource`) overrides the
    file of each source it names, for a caller that makes rows on demand.
    ``mutable`` / ``reserve_docs`` build a live shard set
    (:meth:`ShardSet.build`)."""
    wroot = os.path.join(root, world.name)
    if streamed_tier:
        shard_set = StreamedShardSet.load(
            root, world, dtype=dtype, tier=streamed_tier,
            hbm_budget_bytes=hbm_budget_bytes, device=device,
            row_sources=row_sources)
    else:
        shard_set = ShardSet.load(root, world, dtype=dtype, device=device,
                                  ivf_clusters=ivf_clusters, lowrank=lowrank,
                                  mutable=mutable, reserve_docs=reserve_docs)

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
    if embedder == "zoo":
        # the port's own forwards on the engine's device
        provider = embedding.EncoderZooEmbeddings(world, device=device)
    elif embedder == "hash":
        provider = embedding.HashEmbeddings(world)
    elif embedder not in ("auto", "precomputed"):
        raise ValueError(
            f"unknown embedder {embedder!r} (auto|precomputed|hash|zoo)")
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

    def __init__(self, args, *, row_sources=None, llm_weights=None):
        check_ported(args)
        # rows of the host-RAM tiers made on demand (in place of the data
        # root's embeddings.npy): a corpus that never exists whole in f32
        self.row_sources = row_sources
        # --llm-backend jax: (Decoder, DecoderConfig, tokenizer) the caller
        # already holds on the device in its served form, in place of
        # --llm-checkpoint's or the demo weights (--llm-quant does not apply;
        # the other --llm-* flags do)
        self.llm_weights = llm_weights
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
        self.hbm_budget_gb = getattr(args, "hbm_budget_gb", None)
        if self.impl in STREAMED_IMPLS and getattr(args, "mesh", None):
            raise ValueError(
                f"--impl {self.impl} with --mesh is not ported to "
                "ragroute_tpu_torch yet (ROADMAP queue 1, item 14 "
                "(multi-GPU))")
        # --mutable: a live index (/docs/add, /docs/delete,
        # /admin/snapshot); ShardSet.build refuses it with the IVF and
        # low-rank layouts, which updates would leave stale
        self.mutable: bool = getattr(args, "mutable", False)
        self.reserve_docs: int = getattr(args, "reserve_docs", 0) or 0
        if self.mutable and self.impl in STREAMED_IMPLS:
            raise ValueError(
                f"--impl {self.impl} serves an immutable host-tier corpus; "
                "drop --mutable (rebuild to update)")
        # SO_REUSEPORT: set for each worker of --workers N
        self.reuse_port: bool = getattr(args, "reuse_port", False)
        self.frontend: str = getattr(args, "frontend", None) or "aiohttp"
        self.native = None     # NativeFederationServer with --frontend native
        # LLM backend: auto = reference behavior (echo when disabled or
        # simulated, otherwise ollama); jax = generation on this device
        self.llm_backend: str = getattr(args, "llm_backend", None) or "auto"
        self.llm_checkpoint = getattr(args, "llm_checkpoint", None)
        self.llm_max_new: int = getattr(args, "llm_max_new", None) or 256
        self.llm_quant = getattr(args, "llm_quant", None)
        self.llm_kv_quant = getattr(args, "llm_kv_quant", None)
        self.llm_prefix_cache = getattr(args, "llm_prefix_cache", False)

        # no falsy coercion: `or` would turn an explicit --llm-top-p 0.0
        # into "nucleus off" (the service rejects degenerate values)
        def _num(name, default):
            v = getattr(args, name, None)
            return default if v is None else v

        self.llm_temperature = _num("llm_temperature", 0.0)
        self.llm_top_k = _num("llm_top_k", 0)
        self.llm_top_p = _num("llm_top_p", 1.0)
        self.llm_serving: str = getattr(args, "llm_serving", None) or "batch"
        self.llm_spec_window: int = getattr(args, "llm_spec_window", 0) or 0
        self.buckets = getattr(args, "buckets", None) or cfg.BATCH_BUCKETS
        self.embedder = getattr(args, "embedder", "auto") or "auto"
        self.device = resolve_device(getattr(args, "device", None) or "cuda")
        self.server: Optional[FederationServer] = None
        self._watchdog: Optional[asyncio.Task] = None
        self._stopping = False

    def _probe_llm_messages(self, q: str, with_doc: bool):
        """One PROBE build of the serving prompt (the builder the query
        path uses). Two of these, one with no doc and one with a doc, give
        the shared token head for the prefix KV as their common prefix: it
        stops at the template's constant head and never takes in content of
        the variable regions, which real requests would then fail to
        extend."""
        from ragroute_tpu_torch.engine.prompts import (
            generate_llm_message, generate_llm_message_wikipedia)

        if self.dataset == "wikipedia":
            docs = [("t" + q, "body " + q)] if with_doc else []
            return generate_llm_message_wikipedia(
                q, docs, [q, "b", "c", "d"], self.model)[0]
        if with_doc:
            ctx = ([{"title": "t" + q, "content": "body " + q}]
                   if self.dataset == "medrag"
                   else [{"title": "t" + q, "text": "body " + q}])
        else:
            ctx = []
        return generate_llm_message(self.dataset, q, ctx,
                                    {"A": q, "B": "bb"}, self.model)[0]

    def _generation_service(self):
        """``--llm-backend jax``: the lockstep service over the
        checkpoint's weights (or the caller's, or the demo weights without
        either), wrapped into the continuous service with ``--llm-serving
        continuous``."""
        from ragroute_tpu_torch.llm.service import (GenerationService,
                                                    demo_service)

        kw = {"cache_dtype": "int8"} if self.llm_kv_quant == "int8" else {}
        kw.update(temperature=self.llm_temperature, top_k=self.llm_top_k,
                  top_p=self.llm_top_p)
        if self.llm_weights is not None:
            params, dcfg, tok = self.llm_weights
            service = GenerationService(params, dcfg, tok,
                                        max_new_tokens=self.llm_max_new, **kw)
        elif self.llm_checkpoint:
            service = GenerationService.from_checkpoint(
                self.llm_checkpoint, quantize=self.llm_quant,
                device=self.device, max_new_tokens=self.llm_max_new, **kw)
        else:
            service = demo_service(device=self.device,
                                   max_new_tokens=min(self.llm_max_new, 32),
                                   **kw)
        if self.llm_serving != "continuous":
            return service
        from ragroute_tpu_torch.llm.continuous import (
            ContinuousGenerationService, shared_prefix_from_messages)

        spec = self.llm_spec_window
        # shared-prefix KV: every RAG prompt of a dataset opens with the
        # same rendered head; derive it as the common prefix of two probe
        # builds of the real message builder
        prefix = None
        if self.llm_prefix_cache:
            prefix = shared_prefix_from_messages(
                service.tokenizer,
                self._probe_llm_messages("what is A?", False),
                self._probe_llm_messages("zz 42 q", True))
            logger.info("LLM shared-prefix KV: %d tokens", len(prefix))
        # a slot holds prompt + generation + the decode window
        cache_len = (service.prompt_buckets[-1] + service.max_new_tokens
                     + max(spec, 1) + 8)
        return ContinuousGenerationService(
            service.params, service.cfg, service.tokenizer,
            max_new_tokens=service.max_new_tokens,
            prompt_buckets=service.prompt_buckets, cache_len=cache_len,
            cache_dtype=service.cache_dtype,
            temperature=service.temperature, top_k=service.top_k,
            top_p=service.top_p, eos_id=service.eos_id,
            pad_id=service.pad_id, spec_window=spec, prefix_ids=prefix)

    def build(self) -> FederationServer:
        dtype = STORAGE_DTYPES[self.dtype_name]
        ivf_clusters = (self.ivf_clusters if self.impl in ("ivf", "hybrid")
                        else None)
        lowrank = self.lowrank_rank if self.impl == "lowrank" else None
        streamed = self.impl in STREAMED_IMPLS
        hbm_budget = (int(self.hbm_budget_gb * 1e9)
                      if self.hbm_budget_gb else None)
        if self.simulate:
            # reference --simulate: tiny in-memory synthetic world, hash
            # embeddings, all sources, stage delays
            syn = make_synthetic_world(
                self.dataset, docs_per_source=SHARD_PAD_MULTIPLE,
                num_queries=4)
            if streamed:
                shard_set = StreamedShardSet.build(
                    syn.world, syn.embeddings, doc_ids=syn.doc_ids,
                    dtype=dtype, tier=self.impl,
                    hbm_budget_bytes=hbm_budget, device=self.device)
            else:
                shard_set = ShardSet.build(syn.world, syn.embeddings,
                                           doc_ids=syn.doc_ids, dtype=dtype,
                                           device=self.device,
                                           ivf_clusters=ivf_clusters,
                                           lowrank=lowrank,
                                           mutable=self.mutable,
                                           reserve_docs=self.reserve_docs)
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
                ivf_clusters=ivf_clusters, lowrank=lowrank,
                streamed_tier=self.impl if streamed else None,
                hbm_budget_bytes=hbm_budget, row_sources=self.row_sources,
                mutable=self.mutable, reserve_docs=self.reserve_docs)
        if streamed:
            engine = StreamedSearchEngine(shard_set, router, bank,
                                          threshold=threshold,
                                          k_refine=self.k_refine,
                                          nprobe=self.nprobe)
        else:
            engine = FederatedSearchEngine(
                shard_set, router, bank, impl=self.impl, threshold=threshold,
                nprobe=self.nprobe, k_refine=self.k_refine)
        strategy = "all" if self.simulate else self.routing
        backend = self.llm_backend
        if backend == "auto":
            backend = ("echo" if (self.simulate or self.disable_llm)
                       else "ollama")
        if backend == "jax":
            llm = LLMClient("jax", service=self._generation_service())
        else:
            llm = LLMClient(backend,
                            delay_s=cfg.LLM_DELAY if self.simulate else 0.0)
        self.server = FederationServer(
            engine, strategy=strategy, embedding_provider=provider,
            doc_store=doc_store, llm=llm, model=self.model,
            disable_llm=self.disable_llm, simulate=self.simulate,
            relevance_data=relevance, port=self.port,
            batcher=QueryBatcher(engine, strategy=strategy,
                                 buckets=self.buckets),
            reuse_port=self.reuse_port, data_root=self.data_root)
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

    def run_native(self) -> None:
        """Serve through the native front end (``--frontend native``): the
        C++ epoll thread owns the sockets and this thread runs the engine
        loop, without asyncio. Blocks until SIGINT / SIGTERM."""
        from ragroute_tpu_torch.engine.native_frontend import \
            NativeFederationServer

        if self.server is None:
            self.build()
        native = NativeFederationServer(self.server)
        self.native = native
        native.start()
        logger.info("Starting ragroute_tpu_torch with dataset %s "
                    "(routing=%s, device=%s, native front end)",
                    self.dataset, self.routing, self.device)

        def _sig(signum, frame):
            logger.info("signal %s: shutting down the native front end",
                        signum)
            native._running = False
            if native.fe is not None:
                native.fe.shutdown()

        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                signal.signal(sig, _sig)
            except ValueError:  # not the main thread
                pass
        try:
            native.serve_forever()
        except KeyboardInterrupt:
            native.stop()
        logger.info("Shutdown complete")

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
            service = getattr(self.server.llm, "service", None)
            if service is not None:
                await service.stop()
        logger.info("Shutdown complete")


# ---------------------------------------------------------------------------
# Multi-process front end (SO_REUSEPORT workers)
# ---------------------------------------------------------------------------

def free_port(host: str = cfg.HTTP_HOST) -> int:
    """A port no socket on ``host`` holds now (the kernel's pick for port
    0, released again)."""
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def _worker_entry(args_dict: dict) -> None:
    import argparse

    system = ServingSystem(argparse.Namespace(**args_dict))
    try:
        if system.frontend == "native":
            system.run_native()
        else:
            asyncio.run(system.run_forever())
    except KeyboardInterrupt:
        pass


class Workers:
    """N full serving processes on one HTTP port through SO_REUSEPORT (the
    kernel balances connections), with the reference's child-process
    discipline: spawn, a dead-child watchdog, terminate, join, kill.

    On one CUDA card the N workers share it: each holds its own CUDA
    context and its own copy of the index, so the card's memory must hold
    N x (index + context), and their steps time-slice the same SMs. What
    they add is host parallelism (HTTP parsing, assembly) in front of the
    one card. Workers start by ``spawn`` (CUDA does not survive ``fork``),
    and :meth:`start` builds every kernel once before spawning them, so N
    processes do not each run ``nvcc`` on a cold cache.

    ``--port 0`` is resolved here to one free port, which every worker
    binds: :meth:`start` returns it and logs it. ``--mutable`` is refused:
    each worker would hold an independent index, so an update would reach
    only the worker the kernel sent it to."""

    def __init__(self, args, n_workers: int):
        if getattr(args, "mutable", False):
            raise ValueError(
                "--mutable is a single-process capability (SO_REUSEPORT "
                "workers each hold an independent index copy, so live "
                "updates would apply to only one worker); drop --workers "
                "or --mutable")
        check_ported(args)
        self.args = args
        self.n_workers = int(n_workers)
        self.port: Optional[int] = None
        self.procs = []

    def start(self) -> int:
        """Build the kernels, spawn the workers; returns the shared port."""
        import multiprocessing as mp

        d = dict(vars(self.args))
        port = d.get("port")
        if port is None:
            port = cfg.HTTP_PORT
        elif port == 0:
            port = free_port()
        d.update(port=port, reuse_port=True)
        if resolve_device(d.get("device") or "cuda").type == "cuda":
            from ragroute_tpu_torch.ops import _build

            _build.build_all(_build.kernel_sources())
        ctx = mp.get_context("spawn")
        for _ in range(self.n_workers):
            p = ctx.Process(target=_worker_entry, args=(d,))
            p.start()
            self.procs.append(p)
        self.port = port
        logger.info("started %d SO_REUSEPORT workers on port %d: %s",
                    self.n_workers, port, [p.pid for p in self.procs])
        return port

    def supervise(self) -> None:
        """Block while any worker lives, logging each one that dies."""
        reported = set()
        while any(p.is_alive() for p in self.procs):
            time.sleep(WATCHDOG_POLL_S)
            for p in self.procs:
                if not p.is_alive() and p.pid not in reported:
                    reported.add(p.pid)
                    logger.error(
                        "worker %s died (exit %s); capacity degraded to "
                        "%d/%d workers", p.pid, p.exitcode,
                        sum(q.is_alive() for q in self.procs),
                        self.n_workers)

    def stop(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.terminate()
        for p in self.procs:
            p.join(2)
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(1)


def run_workers(args, n_workers: int) -> int:
    """``--workers N``: start :class:`Workers`, supervise them until they
    end or the parent is interrupted, stop them; returns the port they
    served on."""
    workers = Workers(args, n_workers)
    port = workers.start()
    try:
        workers.supervise()
    except KeyboardInterrupt:
        pass
    finally:
        workers.stop()
    return port
