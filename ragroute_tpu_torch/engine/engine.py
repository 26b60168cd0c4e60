"""Federated search engine: the route -> score -> merge device step.

PyTorch port of :mod:`ragroute_tpu.engine.engine`. For a batch of queries
the engine

1. builds router features and runs the gating MLP (batched),
2. turns the routing strategy into a boolean mask ``[B, N_sources]``,
3. scores every shard with an exact top-k (the fused CUDA kernel for large
   shards on the card) or, by ``impl``, the cluster-probed IVF search, the
   per-shard hybrid of the two, or the low-rank two-stage search, skipping
   a shard no query routes to and compacting the batch to B/4 or B/2 when
   few do,
4. gates the per-shard lists by the mask and merges them into the global
   top-k.

The reference decides skip and compaction with ``lax.cond`` on device
counts inside one compiled program. Here that is a host branch: all
``[N]`` per-shard routed counts come to the host in ONE device->host copy
per batch, and the branches launch only the kernels they need. Only
``[B, k]`` winners, the mask, the router probabilities and (optionally)
``[B, N]`` response sizes leave the device, in one coalesced copy.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ragroute_tpu_torch.config import (COMPACTION_MIN_ROWS,
                                       IVF_HYBRID_MAX_BATCH,
                                       IVF_HYBRID_MIN_DOCS,
                                       IVF_HYBRID_NPROBE_DIVISOR,
                                       IVF_NPROBE_DIVISOR,
                                       LOWRANK_REFINE_MULT, WorldConfig)
from ragroute_tpu_torch.index.shard import ShardSet
from ragroute_tpu_torch.ops.ivf_topk import ivf_topk
from ragroute_tpu_torch.ops.lowrank_topk import lowrank_topk
from ragroute_tpu_torch.ops.topk import NEG_INF, shard_topk, topk_stable
from ragroute_tpu_torch.router.features import RouterBank, build_features
from ragroute_tpu_torch.router.mlp import CorpusRouter
from ragroute_tpu_torch.router.strategies import routing_mask

Tensor = torch.Tensor

logger = logging.getLogger("engine")

IMPLS = ("auto", "exact", "chunked", "pallas", "ivf", "hybrid", "lowrank")
APPROX_IMPLS = ("ivf", "hybrid", "lowrank")


@dataclasses.dataclass
class SearchOutput:
    """Host-side result of one engine step (numpy arrays)."""

    probs: np.ndarray                    # [B, N] router probabilities
    mask: np.ndarray                     # [B, N] routing decisions
    shard_scores: Optional[np.ndarray]   # [B, N, k]; None when fetch_candidates=False
    shard_ids: Optional[np.ndarray]      # [B, N, k]; None when msg_base replaces it
    merged_score: np.ndarray             # [B, k] natural merged scores
    merged_shard: np.ndarray             # [B, k] winning shard (-1 = invalid)
    merged_local: np.ndarray             # [B, k] local doc index within shard
    merged_valid: np.ndarray             # [B] number of valid merged entries
    msg_base: Optional[np.ndarray] = None  # [B, N] response size sans qid
    selection_time: float = 0.0          # router stage (s), staged mode only
    doc_select_time: float = 0.0         # scoring + merge stage (s)


def _pack(tensors: Sequence[Tensor]):
    """The bytes of several tensors in one device buffer, and what it takes
    to view them back: ``(flat uint8 tensor, [(dtype, shape), ...])``."""
    parts = [t.contiguous() for t in tensors]
    flat = torch.cat([p.reshape(-1).view(torch.uint8) for p in parts])
    return flat, [(p.dtype, tuple(p.shape)) for p in parts]


def _unpack(host: np.ndarray, meta) -> List[np.ndarray]:
    """The arrays of a packed buffer that has reached the host."""
    out, off = [], 0
    for dtype, shape in meta:
        item = torch.empty(0, dtype=dtype)
        nbytes = int(np.prod(shape, dtype=np.int64)) * item.element_size()
        arr = host[off:off + nbytes].copy().view(   # copy: aligned
            item.numpy().dtype)
        out.append(arr.reshape(shape))
        off += nbytes
    return out


def _to_host(tensors: Sequence[Tensor]) -> List[np.ndarray]:
    """One coalesced device->host copy of several tensors: their bytes are
    packed into one device buffer, copied once, and viewed back."""
    flat, meta = _pack(tensors)
    return _unpack(flat.cpu().numpy(), meta)


class PendingSearch:
    """An in-flight batched search: launched, result copy deferred.

    Produced by :meth:`FederatedSearchEngine.search_submit`; ``wait()``
    waits on the step's CUDA event and performs the one coalesced
    device->host copy."""

    __slots__ = ("_engine", "_probs", "_mask", "_scored", "_event", "_t0",
                 "_fetch_candidates", "_done")

    def __init__(self, engine, probs, mask, scored, event, *, t0,
                 fetch_candidates):
        self._engine = engine
        self._probs = probs
        self._mask = mask
        self._scored = scored
        self._event = event
        self._t0 = t0
        self._fetch_candidates = fetch_candidates
        self._done = False

    def wait(self) -> SearchOutput:
        if self._done:
            raise RuntimeError("PendingSearch.wait() called twice")
        self._done = True
        if self._event is not None:
            self._event.synchronize()
        out = self._engine._fetch_output(
            self._probs, self._mask, self._scored,
            fetch_candidates=self._fetch_candidates, sel_t=0.0, doc_t=None,
            t0=self._t0)
        self._probs = self._mask = self._scored = None
        return out


class DoneSearch:
    """An already finished search behind the ``search_submit`` contract
    (engines whose step completes inline)."""

    __slots__ = ("_out",)

    def __init__(self, out: SearchOutput):
        self._out = out

    def wait(self) -> SearchOutput:
        return self._out


def _route_fn(world: WorldConfig, strategy: str, router: CorpusRouter,
              bank: RouterBank, query_embs: Dict[str, Tensor],
              generator: Optional[torch.Generator],
              threshold: Optional[float] = None) -> Tuple[Tensor, Tensor]:
    feats = build_features(world, bank, query_embs)
    probs = torch.sigmoid(router(feats))
    mask = routing_mask(world, strategy, probs, generator, threshold)
    return probs, mask


def gate_and_merge(world: WorldConfig, k: int, mask: Tensor,
                   per_scores: Sequence[Tensor], per_ids: Sequence[Tensor]):
    """Gate per-shard top-k lists by the routing mask and merge globally
    (ties: the lower shard, then the lower rank within a shard)."""
    bsz = per_scores[0].shape[0]
    shard_scores = torch.stack(list(per_scores), dim=1)   # [B, N, k]
    shard_ids = torch.stack(list(per_ids), dim=1)         # [B, N, k]
    l2 = world.sources[0].score_mode == "l2"
    key = -shard_scores if l2 else shard_scores
    gated = torch.where(mask[:, :, None], key, NEG_INF)
    top_key, pos = topk_stable(gated.reshape(bsz, -1), k)
    merged_local = torch.gather(shard_ids.reshape(bsz, -1), 1, pos)
    valid = top_key > NEG_INF
    merged_score = torch.where(valid, -top_key if l2 else top_key,
                               float("nan"))
    merged_shard = torch.where(valid, pos // k, -1)
    merged_valid = valid.sum(dim=1, dtype=torch.int32)
    return (shard_scores, shard_ids, merged_score, merged_shard,
            merged_local, merged_valid)


def build_payload_tables(per_source, names, k: int, device="cpu"):
    """Per-source doc-length tables for :func:`payload_base`.

    ``per_source[i]`` is ``(rawl, idl)``: int32 per-doc byte lengths of the
    raw doc-store line and of the id string (either may be ``None``), the
    tables the server's host estimator uses. Returns ``(tab [N, n_max],
    inv [N], const [N], nvalid [N])`` int32 tensors."""
    n_max = 1
    for rawl, idl in per_source:
        for t in (rawl, idl):
            if t is not None:
                n_max = max(n_max, len(t))
    n = len(per_source)
    tab = np.zeros((n, n_max), np.int32)
    inv = np.zeros((n,), np.int32)
    const = np.zeros((n,), np.int32)
    for i, (rawl, idl) in enumerate(per_source):
        const[i] = len(names[i]) + 96 + 20 * k
        if idl is not None:
            tab[i, :len(idl)] += idl
        if rawl is not None:
            tab[i, :len(rawl)] += rawl
            inv[i] = 4          # a pad id under a raw table costs "null"
            const[i] += 2 * k
    nvalid = np.array([max((len(t) for t in pair if t is not None), default=0)
                       for pair in per_source], np.int32)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (tab, inv, const, nvalid))


def payload_base(ptables, shard_ids: Tensor) -> Tensor:
    """Device-side ``[B, N]`` serialized-response size (without the query
    id's length), mirroring the server's host estimator exactly."""
    tab, inv, const, nvalid = ptables
    bsz = shard_ids.shape[0]
    n_max = tab.shape[1]
    ok = (shard_ids >= 0) & (shard_ids < nvalid[None, :, None])
    gathered = torch.gather(tab[None].expand(bsz, -1, -1), 2,
                            shard_ids.clamp(0, n_max - 1))
    per = torch.where(ok, gathered, inv[None, :, None])
    return (const[None, :] + per.sum(dim=2)).to(torch.int32)


def _score_fn(world: WorldConfig, k: int, impl: str, n_docs: Sequence[int],
              shard_arrays, query_embs: Dict[str, Tensor], mask: Tensor,
              compaction: bool, packed: Sequence[bool], ivf_arrays=None,
              nprobe: Optional[int] = None, lr_arrays=None,
              k_refine: Optional[int] = None):
    """Score all shards and merge, with routing-aware batch compaction.

    * a shard no query of the batch routes to is skipped;
    * when at most B/4 (then B/2) of the batch routes to a shard, those
      queries (routed first, stable order) are scored as a B/4 (B/2)
      batch and scattered back; the other rows get worst-score
      placeholders, which the mask gating drops.

    ``impl="ivf"`` swaps the exact scan for the cluster-probed search on
    shards that carry a balanced-IVF layout; ``impl="hybrid"`` does so only
    for small batches on large shards (``config.IVF_HYBRID_*``, decided on
    the host from the batch size and the shard's doc count);
    ``impl="lowrank"`` swaps it for the two-stage coarse scan + refine on
    shards that carry a coarse index. Skip and compaction stand in front
    of all of them unchanged.

    The per-shard routed counts come to the host in one copy."""
    bsz = mask.shape[0]
    counts = mask.sum(dim=0).tolist()                    # the one sync
    half, quarter = bsz // 2, bsz // 4
    per_scores: List[Tensor] = []
    per_ids: List[Tensor] = []
    for i, src in enumerate(world.sources):
        docs, bias, scale, center = shard_arrays[i]
        q = query_embs[src.encoder]
        cnt = counts[i]

        ivf = ivf_nprobe = lr = None
        if ivf_arrays and ivf_arrays[i] is not None:
            if impl == "ivf":
                ivf = ivf_arrays[i]
                ivf_nprobe = nprobe or max(
                    1, ivf.n_clusters // IVF_NPROBE_DIVISOR)
            elif (impl == "hybrid" and bsz <= IVF_HYBRID_MAX_BATCH
                  and n_docs[i] >= IVF_HYBRID_MIN_DOCS):
                ivf = ivf_arrays[i]
                ivf_nprobe = nprobe or max(
                    1, ivf.n_clusters // IVF_HYBRID_NPROBE_DIVISOR)
        if impl == "lowrank" and lr_arrays and lr_arrays[i] is not None:
            lr = lr_arrays[i]

        def score(qq):
            if ivf is not None:
                return ivf_topk(qq, ivf, k, mode=src.score_mode,
                                center=center, nprobe=ivf_nprobe)
            if lr is not None:
                return lowrank_topk(qq, lr, docs, k, mode=src.score_mode,
                                    valid_docs=n_docs[i], bias=bias,
                                    scale=scale, center=center,
                                    packed4=packed[i], k_refine=k_refine)
            return shard_topk(qq, docs, k, mode=src.score_mode,
                              valid_docs=n_docs[i], bias=bias, scale=scale,
                              center=center,
                              impl="auto" if impl in APPROX_IMPLS else impl,
                              packed4=packed[i])

        cb = None
        if compaction and quarter >= COMPACTION_MIN_ROWS and cnt <= quarter:
            cb = quarter
        elif compaction and half >= COMPACTION_MIN_ROWS and cnt <= half:
            cb = half
        if cnt > 0 and cb is None:
            s, idx = score(q)
        else:
            worst = float("inf") if src.score_mode == "l2" else NEG_INF
            s = torch.full((bsz, k), worst, dtype=torch.float32,
                           device=q.device)
            idx = torch.zeros((bsz, k), dtype=torch.int64, device=q.device)
            if cnt > 0:
                sel = torch.argsort((~mask[:, i]).to(torch.int8),
                                    stable=True)[:cb]
                s[sel], idx[sel] = score(q[sel])
        per_scores.append(s)
        per_ids.append(idx)
    return gate_and_merge(world, k, mask, per_scores, per_ids)


class QueryTableMixin:
    """Device-resident query table: known qids cross the host->device
    boundary as int64 row indices instead of ``[B, d]`` f32 vectors."""

    world: WorldConfig
    device: torch.device

    def set_query_table(self, tables: Dict[str, np.ndarray]) -> None:
        """Upload a row-indexed query-embedding table once (encoder ->
        ``[Q, d]`` f32); :meth:`search` then accepts
        ``{"__rows__": int [B]}``."""
        for enc in self.world.encoders:
            if enc not in tables:
                raise KeyError(f"query table missing encoder {enc!r}")
        self._qtable_host = {
            enc: np.ascontiguousarray(tables[enc], dtype=np.float32)
            for enc in self.world.encoders}
        self._qtable = {enc: torch.from_numpy(t).to(self.device)
                        for enc, t in self._qtable_host.items()}

    def materialize_rows(self, row: int) -> Dict[str, np.ndarray]:
        """Host-side dense view of one query-table row."""
        return {enc: t[row] for enc, t in self._qtable_host.items()}

    def _device_embs(self, query_embs: Dict[str, np.ndarray]
                     ) -> Dict[str, Tensor]:
        rows = query_embs.get("__rows__")
        if rows is not None:
            if getattr(self, "_qtable", None) is None:
                raise ValueError(
                    "row-indexed search needs set_query_table() first")
            idx = torch.from_numpy(np.asarray(rows, np.int64)).to(self.device)
            return {enc: t[idx.clamp(0, t.shape[0] - 1)]
                    for enc, t in self._qtable.items()}
        out = {}
        for enc in self.world.encoders:
            if enc not in query_embs:
                raise KeyError(f"missing query embeddings for encoder {enc!r}")
            out[enc] = torch.as_tensor(
                np.asarray(query_embs[enc], np.float32)).to(self.device)
        return out

    def _host_embs(self, query_embs: Dict[str, np.ndarray]
                   ) -> Dict[str, np.ndarray]:
        """Host-side f32 per-encoder embeddings for the same batch (the
        hostrefine tier's rescore needs the raw queries on the host)."""
        rows = query_embs.get("__rows__")
        if rows is not None:
            idx = np.clip(np.asarray(rows, np.int64), 0,
                          max(next(iter(self._qtable_host.values()))
                              .shape[0] - 1, 0))
            return {enc: t[idx] for enc, t in self._qtable_host.items()}
        return {enc: np.asarray(query_embs[enc], np.float32)
                for enc in self.world.encoders}


class EngineBase(QueryTableMixin):
    """What every search engine of the port shares: the router step, the
    response-size tables, the coalesced result copy and doc id lookup.
    A subclass sets ``world``, ``shard_set``, ``device``, ``router``,
    ``bank``, ``threshold``, ``_gen`` and ``_ptables``."""

    def set_payload_tables(self, per_source, names) -> None:
        """Enable device-side response sizes (``msg_base``); ``None``
        disables them (the host estimator reads fetched shard_ids)."""
        self._ptables = (None if per_source is None else
                         build_payload_tables(per_source, names,
                                              self.world.k, self.device))

    def _router_inputs(self, strategy: str):
        if self.router is not None and self.bank is not None:
            return self.router, self.bank
        if strategy == "ragroute":
            raise ValueError(
                "routing strategy 'ragroute' needs a router + bank")
        # all/random/none never read the probabilities; a fresh router
        # over a zero bank gives them the reference's shape
        if not hasattr(self, "_zero_router"):
            self._zero_router = CorpusRouter.from_seed(
                self.world.router_input_dim, 0, self.device)
            self._zero_bank = RouterBank.create(
                self.world, {s.name: np.zeros(s.embed_dim, np.float32)
                             for s in self.world.sources},
                device=self.device)
        return self._zero_router, self._zero_bank

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def _route(self, embs, strategy):
        router, bank = self._router_inputs(strategy)
        return _route_fn(self.world, strategy, router, bank, embs,
                         self._gen, self.threshold)

    def _fetch_output(self, probs, mask, scored, *, fetch_candidates: bool,
                      sel_t: float, doc_t, t0: float) -> SearchOutput:
        (shard_scores, shard_ids, merged_score, merged_shard, merged_local,
         merged_valid, msg) = scored
        names = ["probs", "mask", "merged_score", "merged_shard",
                 "merged_local", "merged_valid"]
        tensors = [probs, mask, merged_score, merged_shard, merged_local,
                   merged_valid]
        if fetch_candidates:
            names += ["shard_scores", "shard_ids"]
            tensors += [shard_scores, shard_ids]
        elif msg is not None:
            names.append("msg_base")
            tensors.append(msg)
        else:
            names.append("shard_ids")
            tensors.append(shard_ids)
        host = dict(zip(names, _to_host(tensors)))
        if doc_t is None:
            doc_t = time.perf_counter() - t0
        return SearchOutput(
            probs=host["probs"], mask=host["mask"],
            shard_scores=host.get("shard_scores"),
            shard_ids=host.get("shard_ids"),
            merged_score=host["merged_score"],
            merged_shard=host["merged_shard"],
            merged_local=host["merged_local"],
            merged_valid=host["merged_valid"], msg_base=host.get("msg_base"),
            selection_time=sel_t, doc_select_time=doc_t)

    def resolve_doc_ids(self, out: SearchOutput, row: int
                        ) -> List[Tuple[str, object]]:
        """One query's merged (shard, local) pairs as host doc ids."""
        res = []
        for j in range(out.merged_shard.shape[1]):
            si = int(out.merged_shard[row, j])
            if si < 0:
                continue
            src = self.world.sources[si]
            ids = self.shard_set.doc_ids.get(src.name)
            local = int(out.merged_local[row, j])
            res.append((src.name, ids[local] if ids else local))
        return res


class FederatedSearchEngine(EngineBase):
    """Holds the device state (shards, router) and runs search steps.

    Args:
      shard_set: the world's shards on the serving device.
      router: the gating MLP (on the same device), or ``None`` if only
        all/random/none strategies are used.
      bank: router feature bank.
      impl: top-k implementation, "auto" | "exact" | "chunked" | "pallas"
        ("auto": the fused CUDA kernel for shards above 4096 docs on the
        card; "pallas" names that kernel), or an approximate mode: "ivf"
        (needs shards built with ``ivf_clusters``), "hybrid" (IVF for
        small batches on large shards, else exact), "lowrank" (needs
        shards built with ``lowrank=``).
      seed: seeds the engine's ``torch.Generator`` (``random`` routing).
      nprobe: clusters probed per query in the IVF modes (default C/8 per
        shard for "ivf", C/32 for "hybrid").
      k_refine: candidate depth of the low-rank coarse stage (default
        ``LOWRANK_REFINE_MULT * k``).
    """

    def __init__(self, shard_set: ShardSet, router: Optional[CorpusRouter],
                 bank: Optional[RouterBank], *, impl: str = "auto",
                 seed: int = 0, threshold: Optional[float] = None,
                 compaction: bool = True, nprobe: Optional[int] = None,
                 k_refine: Optional[int] = None):
        if impl not in IMPLS:
            raise ValueError(
                f"impl {impl!r} is not one of {IMPLS} (the host-RAM tiers "
                f"'stream' and 'hostrefine' are served by "
                f"engine.streamed.StreamedSearchEngine)")
        if impl == "ivf":
            missing = [s.name for s in shard_set.shards if s.ivf is None]
            if missing:
                raise ValueError(
                    f"impl='ivf' needs shards built with ivf_clusters; "
                    f"missing balanced-IVF layout for {missing}")
        if impl == "lowrank":
            if not shard_set.lowrank_built:
                raise ValueError(
                    "impl='lowrank' needs shards built with lowrank= "
                    "(e.g. lowrank=-1 for automatic rank selection)")
            refused = [s.name for s in shard_set.shards if s.lr is None]
            if refused:
                logger.warning(
                    "lowrank: shards %s have no coarse index (a flat "
                    "spectrum at build, or a --dtype policy pick without "
                    "one); they take the exact exhaustive scan", refused)
        self.world: WorldConfig = shard_set.world
        self.shard_set = shard_set
        self.device = shard_set.device
        self.router = router
        self.bank = bank
        self.impl = impl
        self.threshold = threshold
        self.compaction = compaction
        self.nprobe = nprobe
        self.k_refine = k_refine or LOWRANK_REFINE_MULT * self.world.k
        self._ivf = (shard_set.ivf_arrays()
                     if impl in ("ivf", "hybrid") else None)
        self._lr = shard_set.lr_arrays() if impl == "lowrank" else None
        # the rows each scan covers: the doc count, or a mutable shard's
        # whole capacity (its free slots carry a -inf bias)
        self._n_docs = tuple(s.scan_docs for s in shard_set.shards)
        self._packed = tuple(s.packed4 for s in shard_set.shards)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._ptables = None
        self._step_lock = threading.Lock()

    @torch.no_grad()
    def _score(self, embs, mask):
        scored = _score_fn(self.world, self.world.k, self.impl,
                           self._n_docs, self.shard_set.arrays(), embs,
                           mask, self.compaction, self._packed, self._ivf,
                           self.nprobe, self._lr, self.k_refine)
        msg = (payload_base(self._ptables, scored[1])
               if self._ptables is not None else None)
        return scored + (msg,)

    def search(self, query_embs: Dict[str, np.ndarray], *,
               strategy: str = "ragroute", staged: bool = True,
               fetch_candidates: bool = True) -> SearchOutput:
        """Run one batched federated search.

        ``staged=True`` times routing and scoring separately (reference
        ``selection_time`` / ``doc_select_time``) with a device sync after
        each; ``staged=False`` runs them back to back and reports one time.
        ``fetch_candidates=False`` skips copying the per-shard
        ``[B, N, k]`` score matrix to the host."""
        with self._step_lock:
            embs = self._device_embs(query_embs)
            if staged:
                t0 = time.perf_counter()
                probs, mask = self._route(embs, strategy)
                self._sync()
                sel_t = time.perf_counter() - t0
                t0 = time.perf_counter()
                scored = self._score(embs, mask)
                self._sync()
                doc_t = time.perf_counter() - t0
            else:
                t0 = time.perf_counter()
                probs, mask = self._route(embs, strategy)
                scored = self._score(embs, mask)
                sel_t, doc_t = 0.0, None
            return self._fetch_output(probs, mask, scored,
                                      fetch_candidates=fetch_candidates,
                                      sel_t=sel_t, doc_t=doc_t, t0=t0)

    def search_submit(self, query_embs: Dict[str, np.ndarray], *,
                      strategy: str = "ragroute",
                      fetch_candidates: bool = True) -> PendingSearch:
        """Launch one batched search without waiting for its result.

        Routing and scoring are launched on the current stream (the
        per-shard count read is the only sync), a CUDA event marks the end
        of the step, and :meth:`PendingSearch.wait` copies the result."""
        with self._step_lock:
            embs = self._device_embs(query_embs)
            t0 = time.perf_counter()
            probs, mask = self._route(embs, strategy)
            scored = self._score(embs, mask)
            event = None
            if self.device.type == "cuda":
                event = torch.cuda.Event()
                event.record()
        return PendingSearch(self, probs, mask, scored, event, t0=t0,
                             fetch_candidates=fetch_candidates)

    # -- live updates ------------------------------------------------------

    def add_docs(self, source: str, embeddings, doc_ids=None) -> List[int]:
        """Insert documents into a mutable shard, ordered against the
        steps by the step lock (see :meth:`ShardSet.add_docs`)."""
        with self._step_lock:
            return self.shard_set.add_docs(source, embeddings, doc_ids)

    def delete_docs(self, source: str, *, doc_ids=None,
                    slots=None) -> List[int]:
        with self._step_lock:
            return self.shard_set.delete_docs(
                source, doc_ids=doc_ids, slots=slots)

    @property
    def update_lock(self):
        """The lock that orders index updates against search steps. A step
        takes it to launch its kernels and an update to queue its writes,
        both on the device's current stream, so a step launched before an
        update reads the old rows and one launched after it the new ones,
        even while a launched step is still running on the card. A caller
        that needs one consistent view across several reads (a snapshot
        and its payload compaction) holds it throughout."""
        return self._step_lock
