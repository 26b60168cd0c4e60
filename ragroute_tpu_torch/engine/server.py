"""HTTP federation server: the reference protocol over the PyTorch engine.

Port of :mod:`ragroute_tpu.engine.server`, the whole serving surface:
``GET/POST /query`` (``q``, ``choices`` as URL-encoded JSON, ``qid``) with
the reference's JSON response and metadata schema, and with ``stream=1``
as Server-Sent Events; ``POST /query/batch``; the live index's ``POST
/docs/add``, ``/docs/delete`` and ``/admin/snapshot`` (on a mutable shard
set); ``POST /admin/profile`` (a ``torch.profiler`` trace of the serving
process); ``GET /healthz`` and ``GET /stats``. Queries are micro-batched
onto one device step (:mod:`ragroute_tpu_torch.engine.batcher`); with the
LLM disabled the merged docs' raw store lines are spliced into the response
body verbatim; on a CUDA engine over immutable shards the per-source
response sizes are computed on the device (``msg_base``), as the reference
does on an accelerator. With ``--llm-backend jax`` ``/stats`` carries the
generation service's counters, as the JAX package's server does. The sync
cores of assembly and of the live-index and profile routes are shared with
the native front end (:mod:`ragroute_tpu_torch.engine.native_frontend`).

``aiohttp`` is imported by the constructor and :meth:`start`, not at
module import.
"""

from __future__ import annotations

import asyncio
import functools
import json
import logging
import os
import secrets
import tempfile
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
from ragroute_tpu_torch.index.store import OverlayDocStore

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


def profile_body(data) -> tuple:
    """Validate an ``/admin/profile`` body: ``(seconds, dir, None)`` or
    ``(None, None, error text)`` for a 400."""
    try:
        seconds = float(data.get("seconds", 2.0))
    except (TypeError, ValueError):
        return None, None, "'seconds' must be a number"
    if not (0.0 < seconds <= 60.0):
        return None, None, "'seconds' must be in (0, 60]"
    logdir = data.get("dir") or os.path.join(
        tempfile.gettempdir(), f"ragroute_profile_{int(time.time())}")
    return seconds, logdir, None


class ProfileCapture:
    """One ``torch.profiler`` capture of the serving process, written as
    ``trace.json`` (Chrome trace format) under ``logdir``. On a CUDA device
    it holds every kernel the process runs on the card (CUPTI collects the
    device activity of all threads, so the engine steps of the batcher's or
    the native loop's thread are in it); host ops are recorded for the
    thread that started the capture only. :meth:`start` and :meth:`stop`
    must run on one thread (a stop from another leaves the profiler's
    callbacks registered); :meth:`export` may run on any."""

    _primed = False

    @classmethod
    def prime(cls) -> None:
        """Touch the profiler once on the main thread. Its library sets up
        its PyTorch client on its first use, and only when that use is on
        the thread that imported torch; when the first capture ran on a
        handler or capture thread instead, its trace held no kernel of the
        serving process (read on an H100)."""
        import threading

        from torch.profiler import ProfilerActivity, profile

        if cls._primed or threading.current_thread() is not \
                threading.main_thread():
            return
        with profile(activities=[ProfilerActivity.CPU]):
            pass
        cls._primed = True

    def __init__(self, device: torch.device, logdir: str):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.logdir = logdir
        self._prof = profile(activities=acts)

    def start(self) -> None:
        self._prof.start()

    def stop(self) -> None:
        self._prof.stop()

    def export(self) -> str:
        """Write the trace; returns its path."""
        os.makedirs(self.logdir, exist_ok=True)
        path = os.path.join(self.logdir, "trace.json")
        self._prof.export_chrome_trace(path)
        return path


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
                 warmup: bool = True, reuse_port: bool = False,
                 data_root: Optional[str] = None):
        from aiohttp import web

        self._web = web
        self.engine = engine
        self.world: WorldConfig = engine.world
        self.strategy = strategy
        self.provider = embedding_provider
        # Live encoders (--embedder zoo) micro-batch through the device
        # like the search step does: concurrent arrivals share ONE padded
        # forward per encoder (EmbeddingBatcher) instead of each paying a
        # full forward alone in the executor.
        self.embed_batcher = None
        if (getattr(embedding_provider, "blocking", False)
                and hasattr(embedding_provider, "embed_many")):
            from ragroute_tpu_torch.engine.embedding import EmbeddingBatcher

            self.embed_batcher = EmbeddingBatcher(embedding_provider)
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
        self._rows_wired = False
        self._rows_provider = None
        if (hasattr(self.provider, "row_of")
                and hasattr(self.provider, "tables")
                and getattr(self.provider, "table", None)):
            engine.set_query_table(self.provider.tables())
            self._rows_wired = True
            self._rows_provider = self.provider
        self.host = host
        self.port = port
        # SO_REUSEPORT: N serving processes share one port, the kernel
        # balancing connections (system.run_workers)
        self.reuse_port = reuse_port
        self.data_root = data_root
        self.app = web.Application()
        self.app.add_routes([
            web.get("/query", self.handle_query),
            web.post("/query", self.handle_query),
            web.post("/query/batch", self.handle_query_batch),
            web.post("/docs/add", self.handle_docs_add),
            web.post("/docs/delete", self.handle_docs_delete),
            web.post("/admin/snapshot", self.handle_snapshot),
            web.post("/admin/profile", self.handle_profile),
            web.get("/healthz", self.handle_health),
            web.get("/stats", self.handle_stats),
        ])
        self.mutable = getattr(engine.shard_set, "mutable", False)
        if self.mutable:
            # a writable payload overlay: docs added at serve time resolve
            # to their payloads, and a recycled slot never shows the base
            # corpus's old payload
            self.doc_store = doc_store = OverlayDocStore(doc_store)
        self.warmup = warmup
        self._runner = None
        self._site = None
        self.metrics = _metrics.ServerMetrics()
        self._profiling = False
        ProfileCapture.prime()
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
        # on for accelerators, off for the CPU backend), for immutable
        # shards only: live adds change the sizes, and the host tables stay
        # the source of truth there
        if (engine.device.type == "cuda" and not self.mutable
                and self.world.name != "feb4rag"):
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
        if self.embed_batcher is not None:
            await self.embed_batcher.start()
        self._runner = web.AppRunner(self.app, access_log=None)
        await self._runner.setup()
        self._site = web.TCPSite(self._runner, self.host, self.port,
                                 reuse_port=self.reuse_port or None)
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
        if self.embed_batcher is not None:
            await self.embed_batcher.stop()
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
        svc = getattr(self.llm, "service", None)
        if svc is not None:  # jax backend: generation service counters
            gen = {"generated_tokens": svc.generated_tokens,
                   "batches": getattr(svc, "batches", None),
                   "chunks": getattr(svc, "chunks", None),
                   "admissions": getattr(svc, "admissions", None)}
            steps = getattr(svc, "spec_steps", 0)
            if steps:  # speculative decoding: mean tokens per verify step
                gen["spec_mean_emit"] = round(svc.spec_emitted / steps, 3)
            snap["llm"] = {k: v for k, v in gen.items() if v is not None}
        if self.embed_batcher is not None:
            eb = self.embed_batcher
            snap["embedding"] = {
                "batches": eb.batches,
                "batched_queries": eb.batched_queries,
                "mean_batch": (round(eb.batched_queries / eb.batches, 2)
                               if eb.batches else None),
            }
        if self.reuse_port:     # which of the workers on the port answered
            snap["worker_pid"] = os.getpid()
        return self._web.json_response(snap)

    async def handle_profile(self, request):
        """``POST /admin/profile``: body (optional) ``{"seconds": 2.0,
        "dir": ...}``; captures a :class:`ProfileCapture` over the window
        and answers ``{"trace_dir", "seconds"}``; 409 while a capture
        runs."""
        web = self._web
        try:
            data = await request.json() if request.can_read_body else {}
        except (json.JSONDecodeError, UnicodeDecodeError):
            return web.Response(text="Invalid JSON body", status=400)
        seconds, logdir, err = profile_body(data)
        if err is not None:
            return web.Response(text=err, status=400)
        if self._profiling:
            return web.Response(
                text="A profile capture is already running", status=409)
        self._profiling = True
        try:
            cap = ProfileCapture(self.engine.device, logdir)
            cap.start()
            try:
                await asyncio.sleep(seconds)
            finally:
                cap.stop()
            await asyncio.get_running_loop().run_in_executor(None,
                                                             cap.export)
        except (RuntimeError, OSError) as e:
            return web.Response(text=f"Profiler failed: {e}", status=500)
        finally:
            self._profiling = False
        return web.json_response({"trace_dir": logdir, "seconds": seconds},
                                 dumps=_dumps)

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
            # honoured with the LLM disabled too: the final event and
            # [DONE], with no delta events
            return await self._handle_query_sse(request, query, choices,
                                                question_id)
        try:
            result = await asyncio.wait_for(
                self._process(query, choices, question_id),
                timeout=QUERY_TIMEOUT_S)
            return self._json_response(result)
        except asyncio.TimeoutError:
            logger.error("Query timed out")
            return web.Response(text="Search timed out", status=504)

    async def _handle_query_sse(self, request, query, choices,
                                question_id):
        """``/query?stream=1``: ``{"delta": ...}`` events as the answer
        decodes (one whole-answer delta from a lockstep service), then one
        event with the whole ``/query`` body, then ``[DONE]``; a failure
        after the headers went out is an in-band ``{"error": ...}`` event
        before ``[DONE]``."""
        web = self._web
        resp = web.StreamResponse(
            headers={"Content-Type": "text/event-stream",
                     "Cache-Control": "no-cache"})
        await resp.prepare(request)

        async def cb(delta: str):
            await resp.write(
                b"data: " + _dumps({"delta": delta}).encode() + b"\n\n")

        try:
            result = await asyncio.wait_for(
                self._process(query, choices, question_id, stream_cb=cb),
                timeout=QUERY_TIMEOUT_S)
            raw = result.pop("__rawdocs__", None)
            body = _dumps(result)
            if raw is not None:
                spliced = self._splice_raw(body, [raw], [result])
                body = spliced if spliced is not None else _dumps(result)
            await resp.write(b"data: " + body.encode() + b"\n\n")
        except asyncio.TimeoutError:
            await resp.write(b'data: {"error": "Search timed out"}\n\n')
        except Exception as e:  # headers are out: report in band
            logger.exception("SSE query failed")
            await resp.write(
                b"data: " + _dumps({"error": str(e)}).encode() + b"\n\n")
        await resp.write(b"data: [DONE]\n\n")
        await resp.write_eof()
        return resp

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

    # -- live index updates ------------------------------------------------

    def _update_source_index(self, source: str) -> Optional[int]:
        for si, s in enumerate(self.world.sources):
            if s.name == source:
                return si
        return None

    def _invalidate_doc_caches(self, si: int) -> None:
        """After an update: a recycled slot must not serve the deleted
        doc's cached payload or size."""
        self._size_cache.pop(si, None)
        if self._get_doc is not None:
            self._get_doc.cache_clear()
        if self._get_raw is not None:
            self._get_raw.cache_clear()

    def docs_add_sync(self, data) -> tuple:
        """Sync core of ``POST /docs/add`` (shared with the native front
        end): ``(200, body dict)`` or ``(status, error text)``."""
        if not self.mutable:
            return 400, ("Index is immutable; start with --mutable to "
                         "enable live updates")
        if not isinstance(data, dict):
            return 400, "Invalid JSON body"
        source = data.get("source")
        docs = data.get("docs")
        si = self._update_source_index(source) if source else None
        if si is None:
            return 400, f"Unknown source {source!r}"
        if not isinstance(docs, list) or not docs:
            return 400, "Provide a non-empty 'docs' list"
        if any("embedding" not in d for d in docs):
            return 400, "Every doc needs an 'embedding'"
        try:
            embs = np.asarray([d["embedding"] for d in docs],
                              dtype=np.float32)
        except ValueError:
            return 400, "Malformed embeddings (ragged or non-numeric)"
        ids = ([d.get("id") for d in docs]
               if any("id" in d for d in docs) else None)
        try:
            # slots and payloads become visible together: a snapshot or a
            # delete between the two must not see one without the other
            with self.engine.update_lock:
                slots = self.engine.shard_set.add_docs(source, embs, ids)
                for sl, d in zip(slots, docs):
                    if "payload" in d:
                        self.doc_store.set(source, sl, d["payload"])
        except (ValueError, KeyError) as e:
            return 400, str(e)
        self._invalidate_doc_caches(si)
        return 200, {
            "added": len(slots),
            "slots": slots,
            "live_docs": self.engine.shard_set.live_docs(source),
            "free_slots": self.engine.shard_set.free_slots(source),
        }

    async def handle_docs_add(self, request):
        """``POST /docs/add``: body ``{"source": name, "docs":
        [{"embedding": [...], "id": ..., "payload": {...}}, ...]}``; needs
        a mutable shard set (``--mutable``). The next step sees the docs."""
        return await self._sync_route(request, self.docs_add_sync)

    def docs_delete_sync(self, data) -> tuple:
        """Sync core of ``POST /docs/delete`` (shared with the native front
        end)."""
        if not self.mutable:
            return 400, ("Index is immutable; start with --mutable to "
                         "enable live updates")
        if not isinstance(data, dict):
            return 400, "Invalid JSON body"
        source = data.get("source")
        si = self._update_source_index(source) if source else None
        if si is None:
            return 400, f"Unknown source {source!r}"
        try:
            with self.engine.update_lock:
                removed = self.engine.shard_set.delete_docs(
                    source, doc_ids=data.get("ids"),
                    slots=data.get("slots"))
                for sl in removed:
                    self.doc_store.delete(source, sl)
        except (ValueError, KeyError) as e:
            return 400, str(e)
        self._invalidate_doc_caches(si)
        return 200, {
            "deleted": len(removed),
            "live_docs": self.engine.shard_set.live_docs(source),
            "free_slots": self.engine.shard_set.free_slots(source),
        }

    async def handle_docs_delete(self, request):
        """``POST /docs/delete``: body ``{"source": name, "ids": [...]}`` or
        ``{"source": name, "slots": [...]}``."""
        return await self._sync_route(request, self.docs_delete_sync)

    async def _sync_route(self, request, fn):
        try:
            data = await request.json()
        except (json.JSONDecodeError, UnicodeDecodeError):
            return self._web.Response(text="Invalid JSON body", status=400)
        status, body = await asyncio.get_running_loop().run_in_executor(
            None, fn, data)
        if status != 200:
            return self._web.Response(text=body, status=status)
        return self._web.json_response(body, dumps=_dumps)

    def _raw_payload(self, source: str, slot: int) -> Optional[str]:
        """One slot's serialized payload, the store's raw bytes first."""
        fn = getattr(self.doc_store, "get_raw", None)
        raw = fn(source, slot) if fn else None
        if raw is None:
            p = self.doc_store.get(source, slot)
            return None if p is None else _dumps(p)
        return raw.decode() if isinstance(raw, (bytes, bytearray)) else raw

    def _do_snapshot(self) -> Dict[str, dict]:
        """Index and payloads written under the update lock, so both
        compact the same slot view while updates are in flight."""
        with self.engine.update_lock:
            report = self.engine.shard_set.snapshot(self.data_root)
            if self.doc_store is not None:
                pay_dir = os.path.join(
                    self.data_root, self.world.name, "payloads")
                os.makedirs(pay_dir, exist_ok=True)
                for name, info in report.items():
                    tmp = os.path.join(pay_dir, f"{name}.jsonl.tmp")
                    with open(tmp, "w") as f:
                        for s in info["slots"]:
                            raw = self._raw_payload(name, s)
                            f.write((raw if raw is not None else "null")
                                    + "\n")
                    os.replace(tmp, os.path.join(pay_dir, f"{name}.jsonl"))
        return report

    def snapshot_sync(self) -> tuple:
        """Sync core of ``POST /admin/snapshot`` (shared with the native
        front end): the live corpus (embeddings, doc ids, payload jsonl)
        written back to the data root, compacted to live docs, so the next
        start serves what this server serves now."""
        if not self.mutable:
            return 400, ("Index is immutable; start with --mutable to "
                         "enable live updates")
        if not self.data_root:
            return 400, ("Server was started without a data root; pass "
                         "data_root= (main.py wires --data-root / "
                         "$RAGROUTE_DATA automatically)")
        try:
            report = self._do_snapshot()
        except (OSError, ValueError) as e:
            return 500, f"Snapshot failed: {e}"
        return 200, {
            "data_root": self.data_root,
            "world": self.world.name,
            "sources": {n: {"live_docs": i["live_docs"]}
                        for n, i in report.items()},
        }

    async def handle_snapshot(self, request):
        """``POST /admin/snapshot``: persist the live index."""
        status, body = await asyncio.get_running_loop().run_in_executor(
            None, self.snapshot_sync)
        if status != 200:
            return self._web.Response(text=body, status=status)
        return self._web.json_response(body, dumps=_dumps)

    # -- core pipeline -------------------------------------------------------

    async def _process(self, query: str, choices, question_id: str,
                       stream_cb=None) -> dict:
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
        elif self.embed_batcher is not None:
            # live encoders: concurrent arrivals share one padded [B, L]
            # forward per encoder (weight-bound at small B)
            embs = await self.embed_batcher.submit(
                formatted_query, question_id)
        elif getattr(self.provider, "blocking", False):
            # a blocking provider without batch support runs off the event
            # loop, which would otherwise stall the batcher's collect loop
            embs = await asyncio.get_running_loop().run_in_executor(
                None, self.provider.embed, formatted_query, question_id)
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
            if stream_cb is not None:
                llm_res = None
                async for item in self.llm.chat_stream(self.model, messages):
                    if isinstance(item, str):
                        await stream_cb(item)
                    else:
                        llm_res = item
            else:
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
                      question_id: str, msg_sizes=None):
        """Selected source names, per-source stats (duration, serialized
        response size; ``msg_sizes`` [N] when the caller sized a whole
        chunk at once) and the merged top docs."""
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
            elif msg_sizes is not None:
                msg_size = int(msg_sizes[si])
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

    def _estimate_message_sizes_chunk(self, shard_ids_all: np.ndarray,
                                      qid_len: int) -> np.ndarray:
        """``[B, N]`` form of :meth:`_estimate_message_size` for a chunk of
        queries with one query-id length (one numpy pass a source)."""
        bsz, _, k = shard_ids_all.shape
        out = np.zeros((bsz, self.world.num_sources), dtype=np.int64)
        for si, src in enumerate(self.world.sources):
            rawl, idl = self._size_tables(si)
            ids = shard_ids_all[:, si, :]
            size = np.full((bsz,), qid_len + len(src.name) + 96 + 20 * k,
                           dtype=np.int64)
            if idl is not None:
                n = idl.shape[0]
                clipped = np.clip(ids, 0, max(n - 1, 0))
                size += np.where((ids >= 0) & (ids < n), idl[clipped],
                                 0).sum(axis=1)
            if rawl is not None:
                n = rawl.shape[0]
                clipped = np.clip(ids, 0, max(n - 1, 0))
                size += np.where((ids >= 0) & (ids < n), rawl[clipped],
                                 4).sum(axis=1) + 2 * k
            out[:, si] = size
        return out

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
