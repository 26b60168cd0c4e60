"""HTTP federation server: the reference protocol over the PyTorch engine.

Port of :mod:`ragroute_tpu.engine.server` for the serving slice:
``GET/POST /query`` (``q``, ``choices`` as URL-encoded JSON, ``qid``) with
the reference's JSON response and metadata schema, ``POST /query/batch``,
``GET /healthz`` and ``GET /stats``. Queries are micro-batched onto one
device step (:mod:`ragroute_tpu_torch.engine.batcher`); with the LLM
disabled the merged docs' raw store lines are spliced into the response
body verbatim; on a CUDA engine the per-source response sizes are computed
on the device (``msg_base``), as the reference does on an accelerator.

Not ported yet (ROADMAP queue 1, items 6, 9 and 13): ``/docs/*``,
``/admin/snapshot``, ``/admin/profile``, SSE generation (``stream=1``).

``aiohttp`` is imported by the constructor and :meth:`start`, not at
module import.
"""

from __future__ import annotations

import asyncio
import functools
import json
import logging
import secrets
import time
import uuid
from typing import Dict, List, Optional

import numpy as np
import torch

from ragroute_tpu_torch.config import (HTTP_HOST, HTTP_PORT, LLM_DELAY,
                                 QUERY_TIMEOUT_S, WorldConfig)
from ragroute_tpu_torch.engine import llm as _llm
from ragroute_tpu_torch.engine import metrics as _metrics
from ragroute_tpu_torch.engine import prompts as _prompts
from ragroute_tpu_torch.engine import rerank as _rerank
from ragroute_tpu_torch.engine.batcher import (QueryBatcher, QueryResult,
                                               fetch_candidates_policy)
from ragroute_tpu_torch.engine.engine import FederatedSearchEngine

LLMClient = _llm.LLMClient

logger = logging.getLogger("server")

# compact separators: responses embed k full doc payloads
_dumps = functools.partial(json.dumps, separators=(",", ":"))


def _device_memory_stats(device: torch.device) -> Optional[dict]:
    """Device memory in use / peak / total (CUDA); None on the CPU."""
    if device.type != "cuda":
        return None
    _, total = torch.cuda.mem_get_info(device)
    return {str(device): {
        "bytes_in_use": torch.cuda.memory_allocated(device),
        "peak_bytes_in_use": torch.cuda.max_memory_allocated(device),
        "bytes_limit": total}}


class FederationServer:
    """aiohttp front-end over the batched engine."""

    def __init__(self, engine: FederatedSearchEngine, *,
                 strategy: str = "ragroute", embedding_provider=None,
                 doc_store=None, llm=None,
                 model: str = "llama3.1-8B-instruct",
                 disable_llm: bool = False, simulate: bool = False,
                 relevance_data: Optional[Dict] = None,
                 batcher: Optional[QueryBatcher] = None,
                 host: str = HTTP_HOST, port: int = HTTP_PORT,
                 warmup: bool = True):
        from aiohttp import web

        self._web = web
        self.engine = engine
        self.world: WorldConfig = engine.world
        self.strategy = strategy
        self.provider = embedding_provider
        self.doc_store = doc_store
        self.llm = llm or LLMClient(
            "echo", delay_s=LLM_DELAY if simulate else 0.0)
        self.model = model
        self.disable_llm = disable_llm
        self.simulate = simulate
        self.relevance_data = relevance_data or {}
        self.batcher = batcher or QueryBatcher(engine, strategy=strategy)
        # a table-backed provider uploads its whole table once; known qids
        # then cross to the device as row indices
        self._rows_provider = None
        if (hasattr(self.provider, "row_of")
                and hasattr(self.provider, "tables")
                and getattr(self.provider, "table", None)):
            engine.set_query_table(self.provider.tables())
            self._rows_provider = self.provider
        self.host = host
        self.port = port
        self.app = web.Application()
        self.app.add_routes([
            web.get("/query", self.handle_query),
            web.post("/query", self.handle_query),
            web.post("/query/batch", self.handle_query_batch),
            web.get("/healthz", self.handle_health),
            web.get("/stats", self.handle_stats),
        ])
        self.warmup = warmup
        self._runner = None
        self._site = None
        self.metrics = _metrics.ServerMetrics()
        self._size_cache: Dict[int, tuple] = {}
        self._get_doc = (functools.lru_cache(maxsize=65536)(doc_store.get)
                         if doc_store is not None else None)
        # raw response splicing (LLM disabled, score-merged worlds): the k
        # raw doc-store lines go into the body verbatim where a random
        # token stands in the serialized metadata
        self._raw_token = "rawdocs" + secrets.token_hex(16)
        self._get_raw = None
        graw = (getattr(doc_store, "get_raw", None)
                if doc_store is not None else None)
        if (graw is not None and disable_llm
                and self.world.name != "feb4rag"):
            @functools.lru_cache(maxsize=65536)
            def _raw_line(source, local):
                r = graw(source, local)
                if isinstance(r, (bytes, bytearray)):
                    r = r.decode("utf-8", "replace")
                return r.strip() if r else None

            self._get_raw = _raw_line
        # device-side response sizing on the card (the reference's rule:
        # on for accelerators, off for the CPU backend)
        if engine.device.type == "cuda" and self.world.name != "feb4rag":
            per = [self._size_tables(si)
                   for si in range(self.world.num_sources)]
            engine.set_payload_tables(per,
                                      [s.name for s in self.world.sources])

    # -- lifecycle ---------------------------------------------------------

    def _warmup(self) -> None:
        """Run every batch bucket twice before serving and record the
        second (steady-state) run as that bucket's device step time."""
        dims = {s.encoder: s.embed_dim for s in self.world.sources}
        fetch = fetch_candidates_policy(self.world)
        device_ms = {}
        for b in self.batcher.buckets:
            embs = {enc: np.zeros((b, d), dtype=np.float32)
                    for enc, d in dims.items()}
            for _ in range(2):
                t0 = time.perf_counter()
                self.engine.search(embs, strategy=self.strategy,
                                   staged=self.batcher.staged,
                                   fetch_candidates=fetch)
            device_ms[b] = (time.perf_counter() - t0) * 1e3
        self.metrics.set_device_step_ms(device_ms)
        logger.info("engine warmed for buckets %s (device step ms: %s)",
                    self.batcher.buckets,
                    {b: round(v, 2) for b, v in device_ms.items()})

    async def start(self) -> None:
        from aiohttp import web

        if self.warmup:
            await asyncio.get_running_loop().run_in_executor(
                None, self._warmup)
        await self.batcher.start()
        self._runner = web.AppRunner(self.app, access_log=None)
        await self._runner.setup()
        self._site = web.TCPSite(self._runner, self.host, self.port)
        await self._site.start()
        logger.info("HTTP server started on http://%s:%s", self.host,
                    self.bound_port)

    @property
    def bound_port(self) -> int:
        """Actual bound port (useful with port=0)."""
        if self._site and self._site._server and self._site._server.sockets:
            return self._site._server.sockets[0].getsockname()[1]
        return self.port

    async def stop(self) -> None:
        # drain HTTP first: in-flight handlers need the batcher alive
        if self._runner:
            await self._runner.cleanup()
            self._runner = None
        await self.batcher.stop()
        logger.info("Server stopped")

    # -- handlers ----------------------------------------------------------

    async def handle_health(self, request):
        return self._web.json_response({
            "status": "ok",
            "world": self.world.name,
            "strategy": self.strategy,
            "total_docs": self.engine.shard_set.total_docs,
            "index_bytes": self.engine.shard_set.index_bytes,
        })

    async def handle_stats(self, request):
        snap = self.metrics.snapshot()
        snap["device_memory"] = _device_memory_stats(self.engine.device)
        return self._web.json_response(snap)

    async def handle_query(self, request):
        web = self._web
        if request.method == "GET":
            query = request.query.get("q", "")
            choices = request.query.get("choices", "")
            question_id = request.query.get("qid", "")
        else:
            data = await request.post()
            query = data.get("q", "")
            choices = data.get("choices", "")
            question_id = data.get("qid", "")
        if not query:
            return web.Response(text="Please provide a query", status=400)
        if not choices:
            return web.Response(text="Please provide choices", status=400)
        if self.world.name == "feb4rag" and not question_id:
            return web.Response(
                text="For FeB4RAG, please provide a question ID (qid)",
                status=400)
        try:
            choices = json.loads(choices)
        except json.JSONDecodeError:
            return web.Response(text="Invalid choices format", status=400)
        if request.query.get("stream", "") in ("1", "true"):
            return web.Response(
                text="stream=1 (SSE generation) is not ported yet "
                     "(ROADMAP queue 1, item 13)", status=501)
        try:
            result = await asyncio.wait_for(
                self._process(query, choices, question_id),
                timeout=QUERY_TIMEOUT_S)
            return self._json_response(result)
        except asyncio.TimeoutError:
            logger.error("Query timed out")
            return web.Response(text="Search timed out", status=504)

    async def handle_query_batch(self, request):
        """Bulk ``/query``: body ``{"queries": [{"q", "choices", "qid"},
        ...]}``, response ``{"results": [...]}`` in input order."""
        web = self._web
        try:
            data = await request.json()
        except (json.JSONDecodeError, UnicodeDecodeError):
            return web.Response(text="Invalid JSON body", status=400)
        queries = data.get("queries") if isinstance(data, dict) else data
        if not isinstance(queries, list) or not queries:
            return web.Response(
                text="Provide a non-empty 'queries' list", status=400)

        async def one(item) -> dict:
            if not isinstance(item, dict):
                return {"error": "Each query must be an object"}
            query = item.get("q", "")
            choices = item.get("choices", "")
            question_id = str(item.get("qid", "") or "")
            if not query:
                return {"error": "Please provide a query"}
            if not choices:
                return {"error": "Please provide choices"}
            if self.world.name == "feb4rag" and not question_id:
                return {"error":
                        "For FeB4RAG, please provide a question ID (qid)"}
            if isinstance(choices, str):
                try:
                    choices = json.loads(choices)
                except json.JSONDecodeError:
                    return {"error": "Invalid choices format"}
            try:
                return await asyncio.wait_for(
                    self._process(query, choices, question_id),
                    timeout=QUERY_TIMEOUT_S)
            except asyncio.TimeoutError:
                return {"error": "Search timed out"}

        results = list(await asyncio.gather(*[one(it) for it in queries]))
        frags, owners = [], []
        for r in results:
            if isinstance(r, dict):
                raw = r.pop("__rawdocs__", None)
                if raw is not None:
                    frags.append(raw)
                    owners.append(r)
        if frags:
            body = self._splice_raw(_dumps({"results": results}), frags,
                                    owners)
            if body is not None:
                return web.Response(text=body,
                                    content_type="application/json")
        return web.json_response({"results": results}, dumps=_dumps)

    # -- core pipeline -------------------------------------------------------

    async def _process(self, query: str, choices, question_id: str) -> dict:
        query_id = str(uuid.uuid4())
        start = time.time()
        # wikipedia encodes query + choices (reference http_server.py)
        if self.world.name == "wikipedia":
            formatted_query = "\n".join([query, " | ".join(choices)])
        else:
            formatted_query = query

        t0 = time.time()
        row_of = (self.provider.row_of
                  if self.provider is self._rows_provider
                  and self._rows_provider is not None else None)
        if row_of is not None and (row := row_of(question_id)) is not None:
            embs = {"__row__": row}
        else:
            embs = self.provider.embed(formatted_query, question_id)
        embedding_time = time.time() - t0

        t0 = time.time()
        res: QueryResult = await self.batcher.submit(embs)
        batch_wait = max(0.0, (time.time() - t0)
                         - res.selection_time - res.doc_select_time)
        t_assemble = time.time()

        selected, ds_stats, top_docs, raw_docs = self._assemble_pre(
            res, query_id, question_id)
        response = {"query_id": query_id, "query": query, "answer": "dummy"}
        docs_tokens = 0
        generate_time = 0.0
        llm_wall = 0.0
        if self.disable_llm:
            response["answer"] = ""
            if self.simulate:
                t0 = time.time()
                await asyncio.sleep(LLM_DELAY)
                llm_wall = time.time() - t0
        else:
            t0 = time.time()
            if self.world.name == "wikipedia":
                messages, docs_tokens = \
                    _prompts.generate_llm_message_wikipedia(
                        query, top_docs, choices, self.model)
            else:
                messages, docs_tokens = _prompts.generate_llm_message(
                    self.world.name, query, top_docs, choices, self.model)
            llm_res = await self.llm.chat(self.model, messages)
            generate_time = (llm_res.generate_time
                             if llm_res.generate_time >= 0 else -1)
            response["answer"] = llm_res.answer
            llm_wall = time.time() - t0
        return self._finalize(
            response, res, selected=selected, ds_stats=ds_stats,
            top_docs=top_docs, raw_docs=raw_docs,
            generate_time=generate_time, docs_tokens=docs_tokens,
            start=start, embedding_time=embedding_time,
            batch_wait=batch_wait, t_assemble=t_assemble, llm_wall=llm_wall)

    def _assemble_pre(self, res: QueryResult, query_id: str,
                      question_id: str):
        """Selected source names, per-source stats (duration, serialized
        response size) and the merged top docs."""
        selected = [self.world.sources[i].name
                    for i in range(self.world.num_sources) if res.mask[i]]
        ds_stats = {}
        per_source_docs: Dict[str, List] = {}
        per_source_ids: Dict[str, List] = {}
        need_docs = self.world.name == "feb4rag"
        for si, src in enumerate(self.world.sources):
            if not res.mask[si]:
                continue
            if need_docs:
                ids, docs, scores = self._resolve_source(res, si)
                per_source_ids[src.name] = ids
                per_source_docs[src.name] = docs
                payload = {
                    "query_id": query_id, "client_id": si, "name": src.name,
                    "indices": ids, "docs": docs, "scores": scores,
                    "duration": res.doc_select_time,
                }
                msg_size = len(json.dumps(payload, default=str))
            elif res.msg_base is not None:
                msg_size = int(res.msg_base[si]) + len(query_id)
            else:
                msg_size = self._estimate_message_size(res, si, query_id)
            ds_stats[src.name] = {"duration": res.doc_select_time,
                                  "message_size": msg_size}
        raw_docs = (self._merge_top_docs_raw(res)
                    if self._get_raw is not None else None)
        top_docs = (None if raw_docs is not None else self._merge_top_docs(
            res, question_id, per_source_ids, per_source_docs))
        return selected, ds_stats, top_docs, raw_docs

    def _finalize(self, response: dict, res: QueryResult, *, selected,
                  ds_stats, top_docs, raw_docs, generate_time, docs_tokens,
                  start, embedding_time, batch_wait, t_assemble,
                  llm_wall=0.0) -> dict:
        """Attach the reference metadata schema and observe metrics."""
        e2e = time.time() - start
        self.metrics.observe_query(
            embedding=embedding_time, selection=res.selection_time,
            doc_select=res.doc_select_time, generate=generate_time,
            e2e=e2e, batch_size=res.batch_size, batch_wait=batch_wait,
            assemble=max(0.0, time.time() - t_assemble - llm_wall))
        response["metadata"] = {
            "data_sources": selected,
            "embedding_time": embedding_time,
            "selection_time": res.selection_time,
            "doc_select_time": res.doc_select_time,
            "generate_time": generate_time,
            "data_sources_stats": ds_stats,
            "top_docs": self._raw_token if raw_docs is not None else top_docs,
            "e2e_time": e2e,
            "docs_tokens": docs_tokens,
            "llm": self.model,
            "batch_size": res.batch_size,
            "routing_strategy": self.strategy,
        }
        if raw_docs is not None:
            response["__rawdocs__"] = raw_docs
        return response

    def _size_tables(self, si: int):
        """Per-source int32 length tables, indexed by local doc id: raw
        doc line bytes and id-string bytes."""
        tab = self._size_cache.get(si)
        if tab is None:
            src = self.world.sources[si]
            n = self.engine.shard_set.shards[si].n_docs
            raw_lengths = getattr(self.doc_store, "raw_lengths", None)
            rawl = raw_lengths(src.name) if raw_lengths is not None else None
            if rawl is None and hasattr(self.doc_store, "get_raw"):
                get_raw = self.doc_store.get_raw
                rawl = np.fromiter(
                    (len(r) if (r := get_raw(src.name, i)) else 4
                     for i in range(n)), dtype=np.int32, count=n)
            id_table = self.engine.shard_set.doc_ids.get(src.name)
            idl = None
            if id_table:
                idl = np.fromiter((len(str(x)) + 4 for x in id_table),
                                  dtype=np.int32, count=len(id_table))
            tab = (rawl, idl)
            self._size_cache[si] = tab
        return tab

    def _estimate_message_size(self, res: QueryResult, si: int,
                               query_id: str) -> int:
        """Serialized size of the equivalent per-source response: envelope
        + ids + scores + raw doc bytes (pad ids never read real rows)."""
        src = self.world.sources[si]
        rawl, idl = self._size_tables(si)
        ids = res.shard_ids[si]
        k = ids.shape[0]
        size = len(query_id) + len(src.name) + 96 + 20 * k
        if idl is not None:
            n = idl.shape[0]
            clipped = np.clip(ids, 0, max(n - 1, 0))
            size += int(np.where((ids >= 0) & (ids < n), idl[clipped],
                                 0).sum())
        if rawl is not None:
            n = rawl.shape[0]
            clipped = np.clip(ids, 0, max(n - 1, 0))
            size += int(np.where((ids >= 0) & (ids < n), rawl[clipped],
                                 4).sum()) + 2 * k
        return size

    def _resolve_source(self, res: QueryResult, si: int):
        """One source's k candidates as (ids, docs, scores)."""
        src = self.world.sources[si]
        id_table = self.engine.shard_set.doc_ids.get(src.name)
        ids, docs, scores = [], [], []
        for r in range(res.shard_ids.shape[1]):
            local = int(res.shard_ids[si, r])
            ids.append(id_table[local] if id_table else local)
            docs.append(self._get_doc(src.name, local)
                        if self._get_doc else None)
            scores.append(float(res.shard_scores[si, r]))
        if self.world.name == "feb4rag":
            scores = []  # parity: no scores for FeB4RAG
        return ids, docs, scores

    def _merge_top_docs_raw(self, res: QueryResult) -> Optional[str]:
        """The merged top-k as ONE pre-serialized JSON array of raw store
        lines, or None when a doc has no raw form."""
        frags = []
        for j in range(res.merged_shard.shape[0]):
            si = int(res.merged_shard[j])
            if si < 0:
                continue
            raw = self._get_raw(self.world.sources[si].name,
                                int(res.merged_local[j]))
            if raw is None:
                return None
            frags.append(raw)
        return "[" + ",".join(frags) + "]"

    def _splice_raw(self, body: str, frags: List[str],
                    owners: List[dict]) -> Optional[str]:
        """Replace each raw-token occurrence in ``body`` with its query's
        top_docs array; on a count mismatch (the token appeared in request
        text) fall back to the parsed encoding."""
        parts = body.split('"' + self._raw_token + '"')
        if len(parts) == len(frags) + 1:
            out = []
            for p, f in zip(parts, frags):
                out.append(p)
                out.append(f)
            out.append(parts[-1])
            return "".join(out)
        for owner, frag in zip(owners, frags):
            owner["metadata"]["top_docs"] = json.loads(frag)
        return None

    def _json_response(self, result):
        raw = (result.pop("__rawdocs__", None)
               if isinstance(result, dict) else None)
        if raw is not None:
            body = self._splice_raw(_dumps(result), [raw], [result])
            if body is not None:
                return self._web.Response(text=body,
                                          content_type="application/json")
        return self._web.json_response(result, dumps=_dumps)

    def _merge_top_docs(self, res: QueryResult, question_id, per_ids,
                        per_docs):
        """Global top-k docs, per world semantics."""
        if self.world.name == "feb4rag":
            all_ids, all_docs = [], []
            for name in per_ids:
                all_ids.extend(per_ids[name])
                all_docs.extend(per_docs[name])
            docs, _ = _rerank.rerank_feb4rag(
                all_ids, all_docs, question_id, self.world.k,
                self.relevance_data)
            return docs
        docs = []
        for j in range(res.merged_shard.shape[0]):
            si = int(res.merged_shard[j])
            if si < 0:
                continue
            src = self.world.sources[si]
            local = int(res.merged_local[j])
            docs.append(self._get_doc(src.name, local) if self._get_doc
                        else {"source": src.name, "index": local})
        return docs
