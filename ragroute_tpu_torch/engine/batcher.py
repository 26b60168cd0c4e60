"""Micro-batching dispatcher: many concurrent queries -> one device step.

PyTorch port of :mod:`ragroute_tpu.engine.batcher`. The dispatcher collects
concurrent queries for at most ``window_ms`` (or until the largest batch
bucket fills), pads the batch to a bucket size, runs ONE engine step in an
executor thread and resolves the per-query futures. For an engine with a
dispatch/complete split (the hostrefine capacity tier) the worker is
pipelined: batch t's host rescore runs while batch t+1's device step runs.

Every step (and every dispatch of the pipelined loop) runs on ONE thread,
the batcher's step thread (:attr:`QueryBatcher.step_executor`): the thread
that launches the kernels. ``/admin/profile`` starts and stops its capture
there, since a capture started on another thread records, now and then, no
kernel of the card.
"""

from __future__ import annotations

import asyncio
import dataclasses
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ragroute_tpu_torch.config import BATCH_BUCKETS, BATCH_WINDOW_MS, MAX_QUEUE_SIZE
from ragroute_tpu_torch.engine.engine import (FederatedSearchEngine,
                                              SearchOutput)


def fetch_candidates_policy(world) -> bool:
    """Whether serving copies the per-shard candidate SCORE matrix to the
    host: only feb4rag reads per-source scores (qrels-oracle rerank);
    ``RAGROUTE_FETCH_CANDIDATES=1`` forces the full copy."""
    return (world.name == "feb4rag"
            or os.environ.get("RAGROUTE_FETCH_CANDIDATES") == "1")


def pack_query_embs(engine, rows, denses, padded):
    """Pack one device batch from per-query (row, dense) pairs.

    An all-rows batch ships as ``{"__rows__": int32 [padded]}`` (pad rows
    gather table row 0 and are dropped at demux); any dense query makes
    the whole batch dense ``[padded, d]`` (pad rows zero)."""
    world = engine.world
    n = len(rows)
    if n and all(r is not None for r in rows):
        arr = np.zeros(padded, dtype=np.int32)
        arr[:n] = rows
        return {"__rows__": arr}
    dense = [engine.materialize_rows(r) if d is None else d
             for r, d in zip(rows, denses)]
    embs: Dict[str, np.ndarray] = {}
    for enc in world.encoders:
        dim = next(s.embed_dim for s in world.sources if s.encoder == enc)
        arr = np.zeros((padded, dim), dtype=np.float32)
        for i, qe in enumerate(dense):
            arr[i] = qe[enc]
        embs[enc] = arr
    return embs


@dataclasses.dataclass
class QueryResult:
    """One query's slice of a batched SearchOutput."""

    probs: np.ndarray                    # [N]
    mask: np.ndarray                     # [N]
    shard_scores: Optional[np.ndarray]   # [N, k] or None
    shard_ids: Optional[np.ndarray]      # [N, k] or None
    merged_score: np.ndarray             # [k]
    merged_shard: np.ndarray             # [k]
    merged_local: np.ndarray             # [k]
    merged_valid: int
    selection_time: float                # per-batch stage times (shared)
    doc_select_time: float
    batch_size: int
    msg_base: Optional[np.ndarray] = None  # [N] device response sizes


class QueryBatcher:
    """Collects queries into padded device batches (one routing strategy
    per batcher, as ``--routing`` is server-wide)."""

    def __init__(self, engine: FederatedSearchEngine, *,
                 strategy: str = "ragroute",
                 window_ms: float = BATCH_WINDOW_MS,
                 buckets: Sequence[int] = BATCH_BUCKETS,
                 max_queue: Optional[int] = None,
                 staged: Optional[bool] = None):
        self.engine = engine
        self.strategy = strategy
        self.window_s = window_ms / 1e3
        self.buckets = tuple(sorted(buckets))
        if staged is None:
            staged = os.environ.get("RAGROUTE_STAGED_TIMING", "0") == "1"
        self.staged = staged
        if max_queue is None:
            max_queue = max(MAX_QUEUE_SIZE, 2 * self.buckets[-1])
        self.queue: asyncio.Queue = asyncio.Queue(maxsize=max_queue)
        self._task: Optional[asyncio.Task] = None
        self._running = False
        # the one thread that launches the steps' kernels
        self.step_executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ragroute-step")
        self.last_step_thread: Optional[int] = None

    # -- lifecycle -------------------------------------------------------

    async def start(self) -> None:
        self._running = True
        self._task = asyncio.create_task(self._worker())

    async def stop(self) -> None:
        self._running = False
        # the task is forgotten before it is awaited: a watchdog that polls
        # ``_task.done()`` must not take a worker stopped on purpose for a
        # dead one and start a second
        task, self._task = self._task, None
        if task:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
        # fail anything still queued so its handler sees a clean error
        while True:
            try:
                _, fut = self.queue.get_nowait()
            except asyncio.QueueEmpty:
                break
            if not fut.done():
                fut.set_exception(RuntimeError("batcher stopped"))

    # -- submission ------------------------------------------------------

    async def submit(self, query_embs: Dict[str, np.ndarray]) -> QueryResult:
        """Submit one query's per-encoder embeddings; await its result."""
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        await self.queue.put((query_embs, fut))
        return await fut

    # -- worker ----------------------------------------------------------

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    async def _collect(self, batch: List[Tuple[dict, asyncio.Future]]) -> None:
        """Fill ``batch`` in place (a cancellation mid-collect leaves the
        popped items visible to the caller's cleanup)."""
        batch.append(await self.queue.get())
        deadline = time.monotonic() + self.window_s
        max_bucket = self.buckets[-1]
        while len(batch) < max_bucket:
            try:
                while len(batch) < max_bucket:
                    batch.append(self.queue.get_nowait())
                break
            except asyncio.QueueEmpty:
                pass
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                batch.append(await asyncio.wait_for(self.queue.get(),
                                                    timeout=remaining))
            except asyncio.TimeoutError:
                break

    def _run_batch(self, batch) -> Tuple[SearchOutput, int]:
        self.last_step_thread = threading.get_ident()
        rows = [qe.get("__row__") for qe, _ in batch]
        denses = [None if "__row__" in qe else qe for qe, _ in batch]
        embs = pack_query_embs(self.engine, rows, denses,
                               self._bucket(len(batch)))
        out = self.engine.search(
            embs, strategy=self.strategy, staged=self.staged,
            fetch_candidates=fetch_candidates_policy(self.engine.world))
        return out, len(batch)

    def _demux(self, out: SearchOutput, batch, n: int) -> None:
        for i, (_, fut) in enumerate(batch):
            if fut.done():
                continue
            fut.set_result(QueryResult(
                probs=out.probs[i], mask=out.mask[i],
                shard_scores=(None if out.shard_scores is None
                              else out.shard_scores[i]),
                shard_ids=(None if out.shard_ids is None
                           else out.shard_ids[i]),
                merged_score=out.merged_score[i],
                merged_shard=out.merged_shard[i],
                merged_local=out.merged_local[i],
                merged_valid=int(out.merged_valid[i]),
                selection_time=out.selection_time,
                doc_select_time=out.doc_select_time, batch_size=n,
                msg_base=(None if out.msg_base is None
                          else out.msg_base[i])))

    async def _worker(self) -> None:
        if getattr(self.engine, "supports_pipelined_dispatch", False):
            await self._worker_pipelined()
            return
        loop = asyncio.get_running_loop()
        batch: List[Tuple[dict, asyncio.Future]] = []
        try:
            while self._running:
                batch = []
                await self._collect(batch)
                try:
                    # engine.search waits on the device: keep the loop live
                    out, n = await loop.run_in_executor(
                        self.step_executor, self._run_batch, batch)
                    self._demux(out, batch, n)
                except Exception as e:  # deliver failures to every waiter
                    for _, fut in batch:
                        if not fut.done():
                            fut.set_exception(e)
                batch = []
        finally:
            for _, fut in batch:
                if not fut.done():
                    fut.set_exception(RuntimeError("batcher stopped"))

    # -- pipelined worker (hostrefine capacity tier) ---------------------

    def _dispatch_batch(self, batch):
        self.last_step_thread = threading.get_ident()
        rows = [qe.get("__row__") for qe, _ in batch]
        denses = [None if "__row__" in qe else qe for qe, _ in batch]
        embs = pack_query_embs(self.engine, rows, denses,
                               self._bucket(len(batch)))
        return self.engine.dispatch_hostrefine(
            embs, strategy=self.strategy,
            fetch_candidates=fetch_candidates_policy(self.engine.world))

    async def _worker_pipelined(self) -> None:
        """Two-phase serving loop for engines with a dispatch/complete
        split: batch t's host-side exact rescore runs while batch t+1's
        device step executes, so the steady-state rate is bounded by
        max(device, host) instead of their sum. At most one completion is
        in flight; light load degenerates to the sequential loop
        (dispatch, then complete at once)."""
        loop = asyncio.get_running_loop()
        batch: List[Tuple[dict, asyncio.Future]] = []
        prev: Optional[asyncio.Task] = None

        async def complete(handle, cbatch, n):
            try:
                out = await loop.run_in_executor(
                    None, self.engine.complete_hostrefine, handle)
                self._demux(out, cbatch, n)
            except Exception as e:
                for _, fut in cbatch:
                    if not fut.done():
                        fut.set_exception(e)

        try:
            while self._running:
                batch = []
                await self._collect(batch)
                try:
                    handle = await loop.run_in_executor(
                        self.step_executor, self._dispatch_batch, batch)
                except Exception as e:
                    for _, fut in batch:
                        if not fut.done():
                            fut.set_exception(e)
                    batch = []
                    continue
                if prev is not None:
                    await prev
                prev = loop.create_task(
                    complete(handle, batch, len(batch)))
                batch = []
        finally:
            if prev is not None:
                await prev
            for _, fut in batch:
                if not fut.done():
                    fut.set_exception(RuntimeError("batcher stopped"))
