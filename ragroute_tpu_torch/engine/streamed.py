"""Search engines over the host-RAM capacity tiers (index/streamed.py).

PyTorch port of :mod:`ragroute_tpu.engine.streamed`: two engines behind the
interface of :class:`~ragroute_tpu_torch.engine.engine.FederatedSearchEngine`
(``search()`` + the ShardSet metadata surface), so the batcher and the HTTP
server run unchanged on corpora bigger than the device budget.

* ``tier="stream"``: route (device) -> one host read of the mask -> exact
  scan of the resident prefixes -> per-shard host-slab loop: slab j+P is
  copied to the card on a side stream (from page-locked host rows,
  ``non_blocking``) while the fused kernel scans slab j and folds it into a
  running per-shard top-k (updated in place) -> gate + cross-shard merge +
  message sizing. Two CUDA events per staging buffer order the two streams:
  the scan waits for the copy, the next copy into the buffer waits for the
  scan. Shards with no routed query in the batch skip their slabs entirely
  (the streaming tier's version of the routing saving: it saves the
  host->device traffic).

* ``tier="hostrefine"``: ONE run of launches on the current stream, with no
  host read in it, does the routing, the exact scan of fully resident
  sources and the coarse scan of every host source (exhaustive over the
  flat rank-r slab, or probed over its clustered layout), then
  (score-merged worlds) a mask-gated GLOBAL coarse cut so only ``[B, k']``
  (id, shard) candidates plus ``[B, N]`` sizes leave the card, in one
  coalesced copy; the host exact-rescores the candidates from its RAM rows
  (the stored-form arithmetic of the kernel) and merges. Per-source
  candidate mode (feb4rag's qrels rerank, or ``fetch_candidates=True``)
  refines per source instead. The step lock covers the dispatch only:
  :meth:`StreamedSearchEngine.dispatch_hostrefine` returns once the work,
  the copy of its results into page-locked host memory included, is queued,
  and :meth:`StreamedSearchEngine.complete_hostrefine` waits on its event
  and touches no stream, so batch t's rescore runs while batch t+1 scans.

Serving-metric semantics (``/stats`` + response metadata) for the
hostrefine tier differ from every other impl in two documented ways:

* ``selection_time`` is reported as 0: routing runs in the same device step
  as the scans and cannot be split out without a synchronisation.
* per-source ``message_size`` estimates derive from the COARSE-ordered
  top-k ids of each host source (the candidate traffic that actually
  leaves the card), not the final refined winners; except per-source
  candidate mode, where the refined per-source lists exist and the host
  estimator sizes from them.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ragroute_tpu_torch.config import (HOSTREFINE_KAPPA,
                                       HOSTREFINE_NPROBE_DIVISOR,
                                       HOSTREFINE_REFINE_MULT, STREAM_PREFETCH,
                                       WorldConfig)
from ragroute_tpu_torch.engine.engine import (EngineBase, SearchOutput,
                                              _pack, _unpack, gate_and_merge,
                                              payload_base)
from ragroute_tpu_torch.index.streamed import StreamedShardSet
from ragroute_tpu_torch.ops.grouped_topk import coarse_probe_topk
from ragroute_tpu_torch.ops.topk import (NEG_INF, merge_topk, shard_topk,
                                         topk_stable)

Tensor = torch.Tensor


def _key_form(scores: Tensor, mode: str) -> Tensor:
    """Natural scores as monotone "higher is better" keys, NaN as -inf."""
    key = -scores if mode == "l2" else scores
    return torch.where(torch.isnan(key), NEG_INF, key)


def _slab_merge(run_key: Tensor, run_id: Tensor, q: Tensor, docs: Tensor,
                bias: Tensor, scale: Optional[Tensor], offset: int, *,
                k: int, mode: str, packed4: bool) -> None:
    """Fold one uploaded slab into a running per-shard top-k, in place.

    Keys are monotone "higher is better" per query (natural score for
    dot/cos, negated l2): constant per-query offsets (|q|^2, centring
    restores) cancel inside one shard, so the merge is exact. Tie-break:
    the running list (earlier slabs, lower global ids) goes first into a
    stable merge."""
    s, idx = shard_topk(q, docs, k, mode=mode, bias=bias, scale=scale,
                        packed4=packed4)
    top, ids = merge_topk(run_key, run_id, _key_form(s, mode), idx + offset,
                          k)
    run_key.copy_(top)
    run_id.copy_(ids)


def _host_gate_and_merge(world: WorldConfig, k: int, mask: np.ndarray,
                         per_scores: List[np.ndarray],
                         per_ids: List[np.ndarray]):
    """Host-numpy mirror of :func:`engine.gate_and_merge` (same gating,
    same lowest-position tie-break via stable argsort)."""
    bsz = per_scores[0].shape[0]
    shard_scores = np.stack(per_scores, axis=1)          # [B, N, k]
    shard_ids = np.stack(per_ids, axis=1)
    l2 = world.sources[0].score_mode == "l2"
    key = -shard_scores if l2 else shard_scores
    key = np.where(np.isnan(key), -np.inf, key)
    gated = np.where(mask[:, :, None], key, -np.inf).reshape(bsz, -1)
    pos = np.argsort(-gated, axis=1, kind="stable")[:, :k]
    top_key = np.take_along_axis(gated, pos, axis=1)
    merged_shard = (pos // k).astype(np.int32)
    merged_local = np.take_along_axis(
        shard_ids.reshape(bsz, -1), pos, axis=1)
    valid = top_key > -np.inf
    merged_score = np.where(valid, -top_key if l2 else top_key, np.nan)
    merged_shard = np.where(valid, merged_shard, -1)
    merged_valid = valid.sum(axis=1).astype(np.int32)
    return (shard_scores, shard_ids, merged_score.astype(np.float32),
            merged_shard, merged_local.astype(np.int32), merged_valid)


class _PendingStreamed:
    """Deferred hostrefine completion (search_submit contract)."""

    __slots__ = ("_engine", "_handle", "_done")

    def __init__(self, engine, handle):
        self._engine = engine
        self._handle = handle
        self._done = False

    def wait(self) -> SearchOutput:
        if self._done:
            raise RuntimeError("wait() called twice")
        self._done = True
        out = self._engine.complete_hostrefine(self._handle)
        self._handle = None
        return out


class _DoneStreamed:
    """Already-finished search behind the search_submit contract."""

    __slots__ = ("_out",)

    def __init__(self, out):
        self._out = out

    def wait(self) -> SearchOutput:
        return self._out


class _StagingBuffer:
    """One device-side slab buffer of the stream tier with its two events:
    ``ready`` (the copy into it is done) and ``free`` (the scan that read
    it is done)."""

    def __init__(self, code_bytes: int, scale_elems: int, rows: int, device):
        self.codes = torch.empty(code_bytes, dtype=torch.uint8, device=device)
        self.bias = torch.empty(rows, dtype=torch.float32, device=device)
        self.scale = torch.empty(max(scale_elems, 1), dtype=torch.float32,
                                 device=device)
        self.ready = torch.cuda.Event()
        self.free = torch.cuda.Event()
        self.free.record()


class StreamedSearchEngine(EngineBase):
    """Serve a :class:`StreamedShardSet` (either tier)."""

    def __init__(
        self,
        shard_set: StreamedShardSet,
        router,
        bank,
        *,
        threshold: Optional[float] = None,
        seed: int = 0,
        k_refine: Optional[int] = None,
        prefetch: int = STREAM_PREFETCH,
        nprobe: Optional[int] = None,
        kappa: Optional[int] = None,
    ):
        self.world: WorldConfig = shard_set.world
        self.shard_set = shard_set
        self.device = shard_set.device
        self.router = router
        self.bank = bank
        self.tier = shard_set.tier
        # the batcher's pipelined worker keys on this: only the hostrefine
        # tier has the dispatch/complete split
        self.supports_pipelined_dispatch = self.tier == "hostrefine"
        self.threshold = threshold
        self.prefetch = max(1, int(prefetch))
        self.k_refine = int(k_refine or
                            HOSTREFINE_REFINE_MULT * self.world.k)
        # clusters probed per query on clustered coarse slabs (None =
        # C // HOSTREFINE_NPROBE_DIVISOR per source); kappa = per-pair
        # winner cap (None = HOSTREFINE_KAPPA)
        self.nprobe = nprobe
        self.kappa = int(kappa or HOSTREFINE_KAPPA)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._step_lock = threading.Lock()
        self._ptables = None
        self.last_phases: Dict[str, float] = {}
        sources = shard_set.sources
        # centres uploaded ONCE
        self._centers = tuple(
            None if s.center is None
            else torch.from_numpy(s.center).to(self.device) for s in sources)
        self._has_res = tuple(s.res_docs is not None for s in sources)
        self._has_coarse = tuple(s.coarse_docs is not None
                                 or s.coarse_cl is not None for s in sources)
        self._nprobe_of = tuple(
            None if s.coarse_cl is None else int(min(
                s.coarse_cl.n_clusters,
                max(1, self.nprobe or s.coarse_cl.n_clusters
                    // HOSTREFINE_NPROBE_DIVISOR)))
            for s in sources)
        self._modes = tuple(s.score_mode for s in sources)
        self._l2_world = self.world.sources[0].score_mode == "l2"
        self._copy_stream = None
        self._staging: List[_StagingBuffer] = []

    # -- device steps ----------------------------------------------------

    def _resident_lists(self, embs: Dict[str, Tensor], bsz: int):
        """Exact per-source key-form top-k over resident rows (+ the
        per-shard l2-centred queries, reused by the slab loop)."""
        k = self.world.k
        per_key, per_id, per_q = [], [], []
        for i, src in enumerate(self.world.sources):
            st = self.shard_set.sources[i]
            q = embs[src.encoder]
            if self._centers[i] is not None and self._modes[i] == "l2":
                q = q - self._centers[i][None, :]
            per_q.append(q)
            if not self._has_res[i]:
                per_key.append(torch.full((bsz, k), NEG_INF,
                                          dtype=torch.float32,
                                          device=self.device))
                per_id.append(torch.zeros((bsz, k), dtype=torch.int64,
                                          device=self.device))
                continue
            s, idx = shard_topk(q, st.res_docs, k, mode=self._modes[i],
                                bias=st.res_bias, scale=st.res_scale,
                                packed4=self.shard_set.packed4)
            per_key.append(_key_form(s, self._modes[i]))
            per_id.append(idx)
        return per_key, per_id, per_q

    def _finalize(self, mask: Tensor, per_key, per_id, embs):
        """Per-shard key lists to natural form (with the dot centring
        restore, which matters only ACROSS shards), then the shared
        gate + merge and the message sizes."""
        per_nat = []
        for i, src in enumerate(self.world.sources):
            key = per_key[i]
            center = self._centers[i]
            if self._modes[i] == "dot" and center is not None:
                key = key + (embs[src.encoder] @ center)[:, None]
            per_nat.append(-key if self._modes[i] == "l2" else key)
        scored = gate_and_merge(self.world, self.world.k, mask, per_nat,
                                per_id)
        msg = (payload_base(self._ptables, scored[1])
               if self._ptables is not None else None)
        return scored + (msg,)

    def _coarse_queries(self, embs: Dict[str, Tensor]):
        """Per-source projected queries + the per-query cross-shard
        constant (the centring and coarse-mean restores that make coarse
        keys comparable ACROSS shards)."""
        qt, const = [], []
        for i, src in enumerate(self.world.sources):
            st = self.shard_set.sources[i]
            center = self._centers[i]
            q = embs[src.encoder]
            if not self._has_coarse[i]:
                qt.append(None)
                const.append(None)
                continue
            if self._modes[i] == "cos":
                qn = q / torch.clamp(
                    torch.linalg.vector_norm(q, dim=1, keepdim=True),
                    min=1e-12)
                qt.append(qn @ st.basis)
                const.append(qn @ st.mu_lr)
            elif self._modes[i] == "l2":
                qc = q - center[None, :] if center is not None else q
                qt.append(2.0 * (qc @ st.basis))
                # a natural-comparable key needs -|q_c|^2 too
                const.append(2.0 * (qc @ st.mu_lr) - (qc * qc).sum(dim=1))
            else:
                qt.append(q @ st.basis)
                c = q @ st.mu_lr
                if center is not None:
                    c = c + q @ center
                const.append(c)
        return qt, const

    @torch.no_grad()
    def _hostrefine_step(self, embs: Dict[str, Tensor], strategy: str,
                         per_source: bool):
        """The hostrefine tier's device step: launches only, no host
        read."""
        world = self.world
        k, kp = world.k, self.k_refine
        probs, mask = self._route(embs, strategy)
        bsz = mask.shape[0]
        pk, pi, _ = self._resident_lists(embs, bsz)
        qt, const = self._coarse_queries(embs)
        cand_src = []            # per host source [B, kp] ids
        stats_ids = []           # per source [B, k] ids (message sizing)
        keys = []                # per host source [B, kp] global keys
        for i in range(len(world.sources)):
            if not self._has_coarse[i]:
                stats_ids.append(pi[i])
                cand_src.append(None)
                keys.append(None)
                continue
            st = self.shard_set.sources[i]
            if st.coarse_cl is not None:
                # probed scan over the clustered coarse slab; invalid
                # candidates carry id -1 (excluded downstream)
                cs, ci = coarse_probe_topk(qt[i], st.coarse_cl, kp,
                                           nprobe=self._nprobe_of[i],
                                           kappa=self.kappa)
            else:
                # clamp to the slab height (a small source with a large
                # --refine-mult), then pad back to kp with never-wins
                # sentinels for the fixed-width concat
                kp_i = min(kp, st.coarse_docs.shape[0])
                cs, ci = shard_topk(qt[i], st.coarse_docs, kp_i, mode="dot",
                                    bias=st.coarse_bias,
                                    scale=st.coarse_scale)
                if kp_i < kp:
                    pad = (0, kp - kp_i)
                    cs = torch.nn.functional.pad(cs, pad, value=float("nan"))
                    ci = torch.nn.functional.pad(ci, pad, value=-1)
            # both coarse paths size messages from clamped ids: a -1 pad
            # id must not reach the length tables
            stats_ids.append(ci[:, :k].clamp(min=0))
            cand_src.append(ci)
            keys.append(cs + const[i][:, None])
        msg = stats = None
        if self._ptables is not None and not per_source:
            msg = payload_base(self._ptables, torch.stack(stats_ids, dim=1))
        elif not per_source:
            # no payload tables: the host estimator needs per-source top-k
            # ids (coarse-ordered for host sources: the message-size
            # metric, not the ranking). Per-source candidate mode never
            # reads these: its refined per-source lists serve as shard_ids
            stats = torch.stack(stats_ids, dim=1)
        if per_source:
            cands = tuple(c for c in cand_src if c is not None)
            return probs, mask, pk, pi, cands, msg, None, stats
        # score-merged worlds: mask-gated GLOBAL coarse cut so only
        # [B, kp] (id, shard) pairs leave the card; ties to the lower
        # position (a stable sort), which keeps the lower shard
        gk, gi, gs = [], [], []
        for i in range(len(world.sources)):
            if keys[i] is None:
                continue
            kkey = torch.where(torch.isnan(keys[i]), NEG_INF, keys[i])
            gk.append(torch.where(mask[:, i:i + 1], kkey, NEG_INF))
            gi.append(cand_src[i])
            gs.append(torch.full_like(cand_src[i], i))
        top, pos = topk_stable(torch.cat(gk, dim=1), kp)
        cand_id = torch.gather(torch.cat(gi, dim=1), 1, pos)
        cand_shard = torch.gather(torch.cat(gs, dim=1), 1, pos)
        cand_shard = torch.where(top > NEG_INF, cand_shard, -1)
        return (probs, mask, pk, pi, None, msg, (cand_id, cand_shard),
                stats)

    # -- search ----------------------------------------------------------

    def search(
        self,
        query_embs: Dict[str, np.ndarray],
        *,
        strategy: str = "ragroute",
        staged: bool = True,
        fetch_candidates: bool = True,
    ) -> SearchOutput:
        if self.tier == "hostrefine":
            # dispatch takes the step lock itself; the host completion
            # phase runs outside it (see dispatch_hostrefine)
            return self.complete_hostrefine(self.dispatch_hostrefine(
                query_embs, strategy=strategy,
                fetch_candidates=fetch_candidates))
        with self._step_lock:
            return self._search_stream(
                query_embs, strategy=strategy,
                fetch_candidates=fetch_candidates)

    # -- stream tier -----------------------------------------------------

    def _staging_buffers(self) -> List[_StagingBuffer]:
        """``prefetch`` device buffers, each large enough for any slab."""
        if not self._staging:
            code_b = scale_n = rows = 0
            for s in self.shard_set.sources:
                if s.host is None or not s.n_slabs:
                    continue
                codes, _, scale = s.host.tensors
                per_row = codes[0].numel() * codes.element_size()
                code_b = max(code_b, s.slab_rows * per_row)
                rows = max(rows, s.slab_rows)
                if scale is not None:
                    scale_n = max(scale_n, s.slab_rows * scale[0].numel())
            self._copy_stream = torch.cuda.Stream(self.device)
            self._staging = [
                _StagingBuffer(code_b, scale_n, rows, self.device)
                for _ in range(self.prefetch)]
        return self._staging

    def _upload(self, buf: _StagingBuffer, slab):
        """Queue the copy of one host slab into ``buf`` on the copy stream;
        returns the device views the scan will read."""
        codes, bias, scale, off = slab
        nbytes = codes.numel() * codes.element_size()
        d_codes = buf.codes[:nbytes].view(codes.dtype).view(codes.shape)
        d_bias = buf.bias[:bias.shape[0]]
        d_scale = (None if scale is None
                   else buf.scale[:scale.numel()].view(scale.shape))
        with torch.cuda.stream(self._copy_stream):
            self._copy_stream.wait_event(buf.free)   # the last scan is done
            d_codes.copy_(codes, non_blocking=True)
            d_bias.copy_(bias, non_blocking=True)
            if scale is not None:
                d_scale.copy_(scale, non_blocking=True)
            buf.ready.record(self._copy_stream)
        return d_codes, d_bias, d_scale, off

    @torch.no_grad()
    def _search_stream(self, query_embs, *, strategy: str,
                       fetch_candidates: bool) -> SearchOutput:
        embs = self._device_embs(query_embs)
        sources = self.shard_set.sources
        cuda = self.device.type == "cuda"

        t0 = time.perf_counter()
        probs, mask = self._route(embs, strategy)
        mask_h = mask.cpu().numpy()       # the one host read before the loop
        sel_t = time.perf_counter() - t0

        t0 = time.perf_counter()
        bsz = mask.shape[0]
        per_key, per_id, per_q = self._resident_lists(embs, bsz)

        # host-slab loop: slabs of shard i are skipped entirely when no
        # query in the batch routed to i
        plan: List[Tuple[int, int]] = []
        for i, s in enumerate(sources):
            if s.host is not None and mask_h[:, i].any():
                plan.extend((i, j) for j in range(s.n_slabs))
        h2d_bytes = 0
        if cuda and plan:
            bufs = self._staging_buffers()
            main = torch.cuda.current_stream(self.device)
            puts: List = [None] * len(plan)

            def put(idx):
                i, j = plan[idx]
                return self._upload(bufs[idx % len(bufs)],
                                    sources[i].slab(j))

            for idx in range(min(self.prefetch, len(plan))):
                puts[idx] = put(idx)
        for idx, (i, j) in enumerate(plan):
            src = sources[i]
            if cuda:
                buf = bufs[idx % len(bufs)]
                codes, bias, scale, off = puts[idx]
                puts[idx] = None
                main.wait_event(buf.ready)           # the copy is done
            else:
                codes, bias, scale, off = src.slab(j)
            _slab_merge(per_key[i], per_id[i], per_q[i], codes, bias, scale,
                        off, k=self.world.k, mode=src.score_mode,
                        packed4=src.host.packed4)
            h2d_bytes += (codes.numel() * codes.element_size()
                          + bias.numel() * 4
                          + (0 if scale is None else scale.numel() * 4))
            if cuda:
                buf.free.record(main)                # the scan is queued
                nxt = idx + self.prefetch
                if nxt < len(plan):
                    puts[nxt] = put(nxt)

        scored = self._finalize(mask, per_key, per_id, embs)
        out = self._fetch_output(probs, mask, scored,
                                 fetch_candidates=fetch_candidates,
                                 sel_t=sel_t, doc_t=None, t0=t0)
        # phase telemetry: what crossed the bus for this batch
        self.last_phases = {"slabs": len(plan), "h2d_bytes": h2d_bytes,
                            "scan_merge_s": round(out.doc_select_time, 4)}
        return out

    # -- hostrefine tier -------------------------------------------------

    def dispatch_hostrefine(self, query_embs, *, strategy: str,
                            fetch_candidates: bool):
        """Queue one hostrefine device step WITHOUT fetching results.

        Returns an opaque handle for :meth:`complete_hostrefine`. The split
        exists so a serving loop can PIPELINE batches: the host-side exact
        rescore of batch t runs while the device scans batch t+1. The
        handle carries the page-locked buffer the results are copied to
        and a CUDA event recorded behind that copy."""
        # a fully resident world (every source fit the device budget) has
        # no coarse slabs: the global-cut branch would concatenate
        # nothing, so run the per-source path (exact resident merge)
        per_source = fetch_candidates or not any(self._has_coarse)
        world = self.world
        if per_source:
            need = tuple(range(len(world.sources)))
        else:
            # score-merged mode reads resident-exact lists only for sources
            # WITHOUT a coarse slab; every other pk/pi is -inf placeholder
            # padding and stays on the card
            need = tuple(i for i in range(len(world.sources))
                         if self._has_res[i] and not self._has_coarse[i])
        with self._step_lock:
            embs = self._device_embs(query_embs)
            q_host = self._host_embs(query_embs)
            t0 = time.perf_counter()
            (probs, mask, pk, pi, cands, msg, glob,
             stats) = self._hostrefine_step(embs, strategy, per_source)
            # only what the completion reads leaves the card, as one
            # buffer; the copy is queued here, behind the step, so the
            # completion waits for this batch alone and not for whatever
            # was dispatched after it
            fetch = ([probs, mask] + [pk[i] for i in need]
                     + [pi[i] for i in need]
                     + list(cands if per_source else glob))
            tail = msg if msg is not None else stats
            if tail is not None:
                fetch.append(tail)
            flat, meta = _pack(fetch)
            event = None
            if self.device.type == "cuda":
                host = torch.empty(flat.numel(), dtype=torch.uint8,
                                   pin_memory=True)
                host.copy_(flat, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
            else:
                host = flat
        layout = (need, len(cands) if per_source else 2, msg is not None,
                  msg is None and stats is not None)
        return (host, meta, layout, q_host, fetch_candidates, per_source, t0,
                event)

    def complete_hostrefine(self, handle) -> SearchOutput:
        (host, meta, layout, q_host, fetch_candidates, per_source, t0,
         event) = handle
        if event is not None:
            event.synchronize()
        return self._complete_hostrefine(
            _unpack(host.numpy(), meta), layout, q_host,
            fetch_candidates=fetch_candidates, per_source=per_source, t0=t0)

    def search_submit(self, query_embs, *, strategy: str = "ragroute",
                      staged: bool = True, fetch_candidates: bool = True):
        """Deferred-completion search: hostrefine returns right after the
        device dispatch and ``wait()`` runs the fetch and the host exact
        rescore. The stream tier's slab loop is synchronous by nature; it
        completes inline and ``wait()`` hands the result over."""
        if self.tier == "hostrefine":
            return _PendingStreamed(self, self.dispatch_hostrefine(
                query_embs, strategy=strategy,
                fetch_candidates=fetch_candidates))
        return _DoneStreamed(self.search(
            query_embs, strategy=strategy, staged=staged,
            fetch_candidates=fetch_candidates))

    def _complete_hostrefine(self, got, layout, q_host, *, fetch_candidates,
                             per_source, t0) -> SearchOutput:
        world = self.world
        k = world.k
        need, n_extra, has_msg, has_stats = layout
        t_fetch = time.perf_counter()
        probs, mask = got[0], got[1]
        pk = got[2:2 + len(need)]
        pi = got[2 + len(need):2 + 2 * len(need)]
        extra = got[2 + 2 * len(need):2 + 2 * len(need) + n_extra]
        msg_base = got[-1] if has_msg else None
        stats_ids = np.asarray(got[-1], np.int32) if has_stats else None
        # routing runs inside the device step; see the module docstring
        # for the /stats semantics of this tier
        sel_t = 0.0
        t_refine = time.perf_counter()

        # natural-form per-source lists from the device keys (resident
        # exact sources; host sources hold -inf placeholders)
        per_scores: List[Optional[np.ndarray]] = \
            [None] * len(world.sources)
        per_ids: List[Optional[np.ndarray]] = [None] * len(world.sources)
        for j, i in enumerate(need):
            src = world.sources[i]
            key = np.asarray(pk[j], np.float32)
            if self._modes[i] == "dot" and \
                    self.shard_set.sources[i].center is not None \
                    and self._has_res[i]:
                key = key + (q_host[src.encoder] @
                             self.shard_set.sources[i].center)[:, None]
            nat = -key if self._modes[i] == "l2" else key
            nat = np.where(np.isinf(nat), np.nan, nat)
            per_scores[i] = nat
            per_ids[i] = np.asarray(pi[j], np.int32)

        if per_source:
            ci = 0
            for i, src in enumerate(world.sources):
                if not self._has_coarse[i]:
                    continue
                cand = np.asarray(extra[ci], np.int32)
                ci += 1
                if not mask[:, i].any():
                    continue
                s, ids = self.shard_set.refine(
                    i, q_host[src.encoder], cand, k)
                per_scores[i], per_ids[i] = s, np.where(ids < 0, 0, ids)
            (shard_scores, shard_ids, merged_score, merged_shard,
             merged_local, merged_valid) = _host_gate_and_merge(
                world, k, mask, per_scores, per_ids)
        else:
            cand_id, cand_shard = (np.asarray(extra[0], np.int32),
                                   np.asarray(extra[1], np.int32))
            (merged_score, merged_shard, merged_local,
             merged_valid) = self._merge_global(
                q_host, mask, per_scores, per_ids, cand_id, cand_shard, k)
            shard_scores = shard_ids = None
        # phase telemetry for /stats and the measurements: device step +
        # candidate fetch against host-side refine/merge
        self.last_phases = {
            "device_and_fetch_s": round(t_fetch - t0, 4),
            "refine_merge_s": round(time.perf_counter() - t_refine, 4),
        }
        if not fetch_candidates:
            shard_scores = None
            if msg_base is not None:
                shard_ids = None
            elif shard_ids is None:
                shard_ids = stats_ids  # host message-size estimator input
        return SearchOutput(
            probs=np.asarray(probs), mask=mask,
            shard_scores=shard_scores, shard_ids=shard_ids,
            merged_score=merged_score, merged_shard=merged_shard,
            merged_local=merged_local, merged_valid=merged_valid,
            msg_base=msg_base, selection_time=sel_t,
            doc_select_time=time.perf_counter() - t0)

    def _merge_global(self, q_host, mask, per_scores, per_ids, cand_id,
                      cand_shard, k: int):
        """Score-merged mode: exact-rescore the mask-gated GLOBAL candidate
        list on its flat layout (no per-source re-packing) and merge it
        with the resident-exact per-source lists into the final [B, k].
        FAISS-parity ties: (key desc, shard asc, doc id asc) via one
        lexsort."""
        world = self.world
        bsz, kp = cand_id.shape
        l2 = self._l2_world
        flat_b = np.repeat(np.arange(bsz, dtype=np.int64), kp)
        flat_id = cand_id.reshape(-1)
        flat_sh = cand_shard.reshape(-1)
        nat_flat = np.full(bsz * kp, np.nan, np.float32)
        for i, src in enumerate(world.sources):
            if not self._has_coarse[i]:
                continue
            sel = np.flatnonzero(flat_sh == i)
            if not sel.size:
                continue
            nat_flat[sel] = self.shard_set.refine_flat(
                i, q_host[src.encoder], flat_id[sel], flat_b[sel])
        cols = [(nat_flat.reshape(bsz, kp), cand_shard, cand_id)]
        # resident-exact sources join as extra candidates (mask-gated)
        for i in range(len(world.sources)):
            if self._has_coarse[i] or not self._has_res[i]:
                continue
            s = np.where(mask[:, i:i + 1], per_scores[i], np.nan)
            cols.append((s, np.full_like(per_ids[i], i), per_ids[i]))
        nat = np.concatenate([c[0] for c in cols], axis=1)
        shard = np.concatenate([c[1] for c in cols], axis=1)
        ids = np.concatenate([c[2] for c in cols], axis=1)
        key = np.where(np.isnan(nat), -np.inf, -nat if l2 else nat)
        key = np.where(shard >= 0, key, -np.inf)
        order = np.lexsort(
            (ids, np.where(shard >= 0, shard, np.iinfo(np.int32).max),
             -key), axis=1)[:, :k]
        top_key = np.take_along_axis(key, order, axis=1)
        valid = top_key > -np.inf
        merged_score = np.where(
            valid, -top_key if l2 else top_key, np.nan).astype(np.float32)
        merged_shard = np.where(
            valid, np.take_along_axis(shard, order, axis=1), -1)
        merged_local = np.where(
            valid, np.take_along_axis(ids, order, axis=1), 0)
        return (merged_score, merged_shard.astype(np.int32),
                merged_local.astype(np.int32),
                valid.sum(axis=1).astype(np.int32))
