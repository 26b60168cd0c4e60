"""Offline single-process pipeline: encode -> route -> retrieve -> rerank ->
prompt, as one synchronous call.

Counterpart of :mod:`ragroute_tpu.pipeline`: the library-API equivalent of
the reference's monolithic prototypes (``med_rag.py``, ``mmlu.py``,
``feb4rag.py``, single-process versions of the whole system used for
offline evaluation), built on the engine the server runs, on the device it
is given (default the card), so results are the HTTP path's.

    pipe = OfflinePipeline.from_data_root(root, "medrag")
    out = pipe.run("What causes diabetes?", {"A": ...}, qid="q1")
    out["top_docs"], out["data_sources"], out["messages"]
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ragroute_tpu_torch.config import WorldConfig, get_world
from ragroute_tpu_torch.engine.engine import FederatedSearchEngine
from ragroute_tpu_torch.engine.prompts import (generate_llm_message,
                                               generate_llm_message_wikipedia)
from ragroute_tpu_torch.engine.rerank import rerank_feb4rag
from ragroute_tpu_torch.utils.precision import resolve_device


class OfflinePipeline:
    def __init__(
        self,
        engine: FederatedSearchEngine,
        embedding_provider,
        doc_store=None,
        *,
        strategy: str = "ragroute",
        relevance_data: Optional[Dict] = None,
        model: str = "llama3.1-8B-instruct",
    ):
        self.engine = engine
        self.world: WorldConfig = engine.world
        self.provider = embedding_provider
        self.doc_store = doc_store
        self.strategy = strategy
        self.relevance_data = relevance_data or {}
        self.model = model

    # -- constructors ------------------------------------------------------

    @classmethod
    def from_data_root(cls, root: str, dataset: str, *,
                       strategy: str = "ragroute", device="cuda",
                       **kw) -> "OfflinePipeline":
        """The world saved under ``root`` (shards, router checkpoint, query
        table, payloads, qrels), on ``device``."""
        from ragroute_tpu_torch.system import load_world_artifacts

        world = get_world(dataset)
        (shard_set, router, bank, provider, doc_store, relevance,
         threshold) = load_world_artifacts(root, world,
                                           device=resolve_device(device))
        engine = FederatedSearchEngine(shard_set, router, bank,
                                       threshold=threshold)
        return cls(engine, provider, doc_store, strategy=strategy,
                   relevance_data=relevance, **kw)

    @classmethod
    def from_synthetic(cls, dataset: str, *, strategy: str = "ragroute",
                       docs_per_source: int = 2048, num_queries: int = 64,
                       seed: int = 0, device="cuda",
                       **kw) -> "OfflinePipeline":
        """A synthetic world made in memory, a router drawn from seed 0."""
        from ragroute_tpu_torch.engine.embedding import PrecomputedEmbeddings
        from ragroute_tpu_torch.index import ShardSet, make_synthetic_world
        from ragroute_tpu_torch.index.store import MemoryDocStore
        from ragroute_tpu_torch.router import CorpusRouter, RouterBank

        dev = resolve_device(device)
        syn = make_synthetic_world(dataset, docs_per_source=docs_per_source,
                                   num_queries=num_queries, seed=seed)
        shard_set = ShardSet.build(syn.world, syn.embeddings,
                                   doc_ids=syn.doc_ids, device=dev)
        router = CorpusRouter.from_seed(syn.world.router_input_dim, 0, dev)
        bank = RouterBank.create(syn.world, syn.centroids, device=dev)
        engine = FederatedSearchEngine(shard_set, router, bank)
        return cls(engine, PrecomputedEmbeddings.from_synthetic(syn),
                   MemoryDocStore.from_synthetic(syn), strategy=strategy,
                   **kw)

    # -- main entry --------------------------------------------------------

    def run(self, question: str, options, qid: str = "") -> Dict:
        """Process one question end to end; returns the same fields as the
        HTTP response metadata plus the built LLM messages."""
        world = self.world
        if world.name == "wikipedia":
            formatted = "\n".join([question, " | ".join(options)])
        else:
            formatted = question
        embs = self.provider.embed(formatted, qid)
        batch = {enc: np.asarray(v)[None, :] for enc, v in embs.items()}
        out = self.engine.search(batch, strategy=self.strategy)

        selected = [world.sources[i].name
                    for i in range(world.num_sources) if out.mask[0, i]]

        top_docs: List = []
        if world.name == "feb4rag":
            all_ids, all_docs = [], []
            for si, src in enumerate(world.sources):
                if not out.mask[0, si]:
                    continue
                id_table = self.engine.shard_set.doc_ids.get(src.name)
                for r in range(out.shard_ids.shape[2]):
                    local = int(out.shard_ids[0, si, r])
                    all_ids.append(id_table[local] if id_table else local)
                    all_docs.append(self.doc_store.get(src.name, local)
                                    if self.doc_store else None)
            top_docs, _ = rerank_feb4rag(all_ids, all_docs, qid, world.k,
                                         self.relevance_data)
        else:
            for j in range(out.merged_shard.shape[1]):
                si = int(out.merged_shard[0, j])
                if si < 0:
                    continue
                src = world.sources[si]
                local = int(out.merged_local[0, j])
                top_docs.append(self.doc_store.get(src.name, local)
                                if self.doc_store else
                                {"source": src.name, "index": local})

        if world.name == "wikipedia":
            messages, docs_tokens = generate_llm_message_wikipedia(
                question, top_docs, options, self.model)
        else:
            messages, docs_tokens = generate_llm_message(
                world.name, question, top_docs, options, self.model)

        return {
            "question": question,
            "data_sources": selected,
            "probs": out.probs[0].tolist(),
            "top_docs": top_docs,
            "merged_scores": out.merged_score[0].tolist(),
            "messages": messages,
            "docs_tokens": docs_tokens,
            "selection_time": out.selection_time,
            "doc_select_time": out.doc_select_time,
        }
