"""Query embedding providers for the serving path.

The reference router encodes each query at serve time with per-corpus HF
torch models (``router.py:285-303``), or random vectors in simulation mode
(``router.py:286-288``). Encoding is a host-side stage here; providers are
pluggable:

* :class:`PrecomputedEmbeddings` — lookup by qid (benchmark runs over
  frozen query sets; mirrors the reference training scripts' cached ``.npy``
  query embeddings, ``train_medrag_router.py:123``).
* :class:`HashEmbeddings`   — deterministic pseudo-embeddings derived from
  the query text (the offline/simulation stand-in; unlike the reference's
  ``np.random`` embeddings these are reproducible).
* :class:`EncoderZooEmbeddings` — real encoder models via
  :mod:`ragroute_tpu_torch.encoders`, on the engine's device (hash stubs
  for the encoders without a local checkpoint).
"""

from __future__ import annotations

import asyncio
import hashlib
import time
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from ragroute_tpu_torch.config import (EMBED_BATCH_BUCKETS, EMBED_WINDOW_MS,
                                 WorldConfig)


class PrecomputedEmbeddings:
    """qid -> {encoder: [d]} lookup table.

    Unknown qids fall back to the ``fallback`` provider (hash embeddings by
    default) instead of failing: the reference encodes whatever text
    arrives and never rejects a query for being unknown.
    """

    def __init__(self, world: WorldConfig,
                 table: Mapping[str, Dict[str, np.ndarray]],
                 fallback=None):
        self.world = world
        self.table = dict(table)
        self.fallback = fallback or HashEmbeddings(world)
        self._row_index = {qid: i for i, qid in enumerate(self.table)}

    @classmethod
    def from_synthetic(cls, syn) -> "PrecomputedEmbeddings":
        table = {}
        for qi, q in enumerate(syn.questions):
            table[q["qid"]] = {
                enc: syn.query_embs[enc][qi] for enc in syn.world.encoders
            }
        return cls(syn.world, table)

    def embed(self, query: str, qid: str) -> Dict[str, np.ndarray]:
        if qid not in self.table:
            return self.fallback.embed(query, qid)
        return self.table[qid]

    # -- device-resident fast path (engine.set_query_table) -------------

    def row_of(self, qid: str):
        """Row index of ``qid`` in :meth:`tables` order, or None (fall
        back to :meth:`embed` — unknown qids keep hash semantics)."""
        return self._row_index.get(qid)

    def tables(self) -> Dict[str, np.ndarray]:
        """Stacked ``{encoder: [Q, d]}`` view of the lookup table, row
        order matching :meth:`row_of`, for one-time device upload."""
        out = {}
        for enc in self.world.encoders:
            out[enc] = np.stack(
                [embs[enc] for embs in self.table.values()]
            ).astype(np.float32, copy=False)
        return out


class HashEmbeddings:
    """Deterministic text-hash embeddings (simulation-mode stand-in)."""

    def __init__(self, world: WorldConfig):
        self.world = world
        self._dims = {s.encoder: s.embed_dim for s in world.sources}

    def embed(self, query: str, qid: str) -> Dict[str, np.ndarray]:
        out = {}
        for enc in self.world.encoders:
            seed = int.from_bytes(
                hashlib.sha256(f"{enc}::{query}".encode()).digest()[:8],
                "little")
            rng = np.random.default_rng(seed)
            out[enc] = rng.standard_normal(self._dims[enc]).astype(np.float32)
        return out


class EncoderZooEmbeddings:
    """Real query encoders (host-side model zoo)."""

    # A live model forward per query — the server dispatches blocking
    # providers to an executor so the event loop (and the micro-batcher)
    # keeps running while a query encodes.
    blocking = True

    def __init__(self, world: WorldConfig, zoo=None, device=None):
        if zoo is None:
            from ragroute_tpu_torch.encoders import EncoderZoo

            zoo = EncoderZoo(world, device=device)
        self.world = world
        self.zoo = zoo

    def embed(self, query: str, qid: str) -> Dict[str, np.ndarray]:
        return self.zoo.encode_query(query)

    def embed_many(self, queries, qids) -> list:
        """Batched encode: ONE padded forward per encoder for the whole
        batch (the serving-path win :class:`EmbeddingBatcher` exists
        for), demuxed to per-query dicts."""
        res = self.zoo.encode_queries(list(queries))
        return [{enc: res[enc][i] for enc in res}
                for i in range(len(queries))]


class EmbeddingBatcher:
    """Micro-batch concurrent query ENCODES onto the device.

    The reference encodes serve-time queries one at a time on the router
    process (``router.py:285-303``) — each arrival pays a full encoder
    forward alone. On an accelerator an encoder forward over a padded ``[B, L]``
    batch costs barely more than ``[1, L]`` (the weight stream dominates
    at small B), so concurrent queries should share one forward per
    encoder. Mirrors :class:`~ragroute_tpu_torch.engine.batcher.QueryBatcher`'s
    collect/bucket/demux design, one stage earlier in the pipeline:
    requests are padded to a BUCKET size (repeating the last text) so
    each encoder compiles one forward per bucket, never per batch size.

    Failure semantics match QueryBatcher: a batch failure is delivered
    to that batch's waiters (the worker survives); ``stop()`` fails
    queued and mid-collect requests instead of stranding their handlers.
    """

    def __init__(self, provider, *, window_ms: float = EMBED_WINDOW_MS,
                 buckets: Tuple[int, ...] = EMBED_BATCH_BUCKETS,
                 executor=None):
        if not hasattr(provider, "embed_many"):
            raise ValueError(
                f"{type(provider).__name__} has no embed_many(); "
                "EmbeddingBatcher needs a batch-capable provider")
        self.provider = provider
        # the thread the forwards launch on (None: the loop's default
        # executor); the server passes its search batcher's step thread
        self.executor = executor
        self.window_s = window_ms / 1000.0
        self.buckets = tuple(sorted(int(b) for b in buckets))
        self.queue: asyncio.Queue = asyncio.Queue()
        self._task: Optional[asyncio.Task] = None
        self._running = False
        self.batches = 0          # forwards executed
        self.batched_queries = 0  # queries they carried

    async def start(self) -> None:
        if self._task is None:
            self._running = True
            self._task = asyncio.create_task(self._worker())

    async def stop(self) -> None:
        self._running = False
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        while True:
            try:
                _, _, fut = self.queue.get_nowait()
            except asyncio.QueueEmpty:
                break
            if not fut.done():
                fut.set_exception(RuntimeError("embedding batcher stopped"))

    async def submit(self, query: str, qid: str) -> Dict[str, np.ndarray]:
        fut = asyncio.get_running_loop().create_future()
        await self.queue.put((query, qid, fut))
        return await fut

    async def _collect(self, batch: List[tuple]) -> None:
        batch.append(await self.queue.get())
        deadline = time.monotonic() + self.window_s
        while len(batch) < self.buckets[-1]:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                while (len(batch) < self.buckets[-1]
                       and not self.queue.empty()):
                    try:
                        batch.append(self.queue.get_nowait())
                    except asyncio.QueueEmpty:
                        break
                break
            try:
                batch.append(await asyncio.wait_for(
                    self.queue.get(), timeout))
            except asyncio.TimeoutError:
                break

    def _run_batch(self, batch) -> list:
        n = len(batch)
        b = next(bk for bk in self.buckets if bk >= n) \
            if n <= self.buckets[-1] else self.buckets[-1]
        texts = [q for q, _, _ in batch]
        qids = [qid for _, qid, _ in batch]
        # pad to the bucket by repeating the last text: one compiled
        # forward per (encoder, bucket), never per batch size
        texts += [texts[-1]] * (b - n)
        qids += [qids[-1]] * (b - n)
        out = self.provider.embed_many(texts, qids)
        return out[:n]

    async def _worker(self) -> None:
        loop = asyncio.get_running_loop()
        batch: List[tuple] = []
        try:
            while self._running:
                batch = []
                await self._collect(batch)
                try:
                    rows = await loop.run_in_executor(
                        self.executor, self._run_batch, batch)
                    self.batches += 1
                    self.batched_queries += len(batch)
                    for row, (_, _, fut) in zip(rows, batch):
                        if not fut.done():
                            fut.set_result(row)
                except Exception as e:
                    for _, _, fut in batch:
                        if not fut.done():
                            fut.set_exception(e)
                batch = []
        finally:
            for _, _, fut in batch:
                if not fut.done():
                    fut.set_exception(
                        RuntimeError("embedding batcher stopped"))
