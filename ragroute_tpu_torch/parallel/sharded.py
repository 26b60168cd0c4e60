"""Mesh-sharded federated search: the multi-card scaling path.

PyTorch port of :mod:`ragroute_tpu.parallel.sharded`. The JAX package runs
one SPMD program under ``shard_map``; here, in one process, its body is an
explicit loop over the mesh's cells:

* the document axis of every corpus is split over the ``idx`` axis: cell
  ``(d, i)`` holds row slice ``i`` of every shard (padding rows carry the
  ``-inf`` bias) on its own device, a view where cells share a device;
* the query batch is split over the ``dp`` axis: cell ``(d, i)`` scores
  batch slice ``d``;
* each cell launches the fused top-k kernel (K1) on its slice through
  :func:`ragroute_tpu_torch.ops.topk.shard_topk`; launches are
  asynchronous, so cells on different cards run at once, each on its card's
  current stream;
* the "all-gather" is the copy of the ``[idx, B/dp, k]`` (gain, global id)
  candidates to the row's first device, then one tie-stable top-k over them
  (ties to the lower global index, as ``lax.top_k`` after JAX's
  ``all_gather``). Across processes it is a ``torch.distributed``
  all-gather over the row's process group (host tensors, gloo).

:func:`sharded_ivf_topk` splits the IVF cluster axis over ``idx``: every
cell of a row computes the same probe list, scores only the pairs whose
clusters it owns (the K3 grouped GEMM over its local slabs, then K2 per
pair), and the per-pair lists of the owners meet in the final top-k.
:class:`ShardedSearch` is the full step with the single-card engine's
interface.
"""

from __future__ import annotations

import dataclasses
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
from ragroute_tpu_torch.engine.engine import (DoneSearch, EngineBase,
                                              SearchOutput, gate_and_merge,
                                              payload_base)
from ragroute_tpu_torch.index.ivf import IVFData
from ragroute_tpu_torch.index.lowrank import LowRankData
from ragroute_tpu_torch.index.shard import ShardSet
from ragroute_tpu_torch.ops.grouped_gains import grouped_gains
from ragroute_tpu_torch.ops.ivf_topk import dispatch, probe_clusters
from ragroute_tpu_torch.ops.lowrank_topk import lowrank_topk
from ragroute_tpu_torch.ops.stream_topk import stream_topk
from ragroute_tpu_torch.ops.topk import (NEG_INF, _prepare_queries,
                                         gain_to_natural, shard_topk,
                                         topk_stable)
from ragroute_tpu_torch.parallel.mesh import Mesh

Tensor = torch.Tensor


# -- sharded arrays ------------------------------------------------------------

def _as_tensor(a) -> Tensor:
    if isinstance(a, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(a))
    return a


def _place(t: Tensor, dev: torch.device) -> Tensor:
    """``t`` on ``dev``: the tensor itself (a view) where it already lies
    there and is 16-byte aligned, else a copy."""
    t = t.contiguous()
    if t.device == dev and (dev.type != "cuda" or t.data_ptr() % 16 == 0):
        return t
    return t.to(dev, copy=t.device == dev)


class MeshRows:
    """Row slices of one ``[N, ...]`` array over a mesh's ``idx`` axis.

    ``parts[d][i]`` is slice ``i`` on cell ``(d, i)``'s device (``None`` on
    a cell another process owns). Cells of one device share one slice. The
    row axis is padded to a multiple of ``idx`` with ``pad`` (``-inf`` for
    a bias, so padding can never win)."""

    def __init__(self, mesh: Mesh, full, *, pad: float = 0.0):
        full = _as_tensor(full)
        n_idx = mesh.shape["idx"]
        n = full.shape[0]
        extra = (-n) % n_idx
        if extra:
            fill = torch.full((extra,) + tuple(full.shape[1:]), pad,
                              dtype=full.dtype, device=full.device)
            full = torch.cat([full, fill])
        self.shape = tuple(full.shape)
        self.dtype = full.dtype
        self.n_local = self.shape[0] // n_idx
        self.mesh = mesh
        self._elem = full.element_size()
        placed: Dict[Tuple[int, torch.device], Tensor] = {}
        self.parts: List[List[Optional[Tensor]]] = []
        for d, row in enumerate(mesh.devices):
            cells = []
            for i, dev in enumerate(row):
                if not mesh.local(d, i):
                    cells.append(None)
                    continue
                if (i, dev) not in placed:
                    placed[(i, dev)] = _place(
                        full[i * self.n_local:(i + 1) * self.n_local], dev)
                cells.append(placed[(i, dev)])
            self.parts.append(cells)

    @property
    def device(self) -> torch.device:
        return self.mesh.primary

    def numel(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    def element_size(self) -> int:
        return self._elem


def _replicas(mesh: Mesh, t: Optional[Tensor]):
    """``t`` on every local cell's device, ``[d][i]`` (one copy a device)."""
    if t is None:
        return None
    t = _as_tensor(t)
    placed: Dict[torch.device, Tensor] = {}
    out = []
    for d, row in enumerate(mesh.devices):
        out.append([None if not mesh.local(d, i)
                    else placed.setdefault(dev, _place(t, dev))
                    for i, dev in enumerate(row)])
    return out


@dataclasses.dataclass
class MeshLowRank:
    """A low-rank coarse index over a mesh: basis and mean replicated, the
    projected slab row-sharded like its shard."""

    basis: list
    mu: list
    docs_lr: MeshRows
    rank: int
    energy: float

    @classmethod
    def shard(cls, mesh: Mesh, lr: LowRankData) -> "MeshLowRank":
        return cls(_replicas(mesh, lr.basis), _replicas(mesh, lr.mu),
                   MeshRows(mesh, lr.docs_lr), lr.rank, lr.energy)

    def cell(self, d: int, i: int) -> LowRankData:
        return LowRankData(basis=self.basis[d][i],
                           docs_lr=self.docs_lr.parts[d][i],
                           mu=self.mu[d][i], rank=self.rank,
                           energy=self.energy)

    @property
    def nbytes(self) -> int:
        return self.docs_lr.numel() * self.docs_lr.element_size()


@dataclasses.dataclass
class MeshIVF:
    """A balanced-IVF layout over a mesh: centroids replicated, the cluster
    axis (slabs, bias, scales, permutation) split over ``idx``."""

    cells: list            # [d][i] IVFData of the local clusters, or None
    n_clusters: int
    c_local: int
    capacity: int
    packed4: bool
    nbytes: int

    @classmethod
    def shard(cls, mesh: Mesh, ivf: IVFData) -> "MeshIVF":
        n_idx = mesh.shape["idx"]
        c = ivf.n_clusters
        if c % n_idx:
            raise ValueError(f"cluster axis {c} not divisible by "
                             f"idx={n_idx}")
        cl = c // n_idx
        cent = _replicas(mesh, ivf.centroids)
        cbias = _replicas(mesh, ivf.cbias)
        placed: Dict[Tuple[int, torch.device], IVFData] = {}
        cells = []
        for d, row in enumerate(mesh.devices):
            out = []
            for i, dev in enumerate(row):
                if not mesh.local(d, i):
                    out.append(None)
                    continue
                if (i, dev) not in placed:
                    sl = slice(i * cl, (i + 1) * cl)
                    placed[(i, dev)] = dataclasses.replace(
                        ivf, centroids=cent[d][i], cbias=cbias[d][i],
                        docs=_place(ivf.docs[sl], dev),
                        bias=_place(ivf.bias[sl], dev),
                        scale=(None if ivf.scale is None
                               else _place(ivf.scale[sl], dev)),
                        perm=_place(ivf.perm[sl], dev))
                out.append(placed[(i, dev)])
            cells.append(out)
        return cls(cells, c, cl, ivf.capacity, ivf.packed4, ivf.nbytes)


# -- the candidate gather --------------------------------------------------------

def _row_group(mesh: Mesh, d: int):
    """``(group, ranks)`` of the processes that own row ``d``'s cells, or
    ``None`` where the row lies in this process alone."""
    if not mesh.multiprocess:
        return None
    from ragroute_tpu_torch.parallel.multihost import row_groups

    return row_groups(mesh)[d]


def _gather_cells(mesh: Mesh, d: int, per_cell: List[Optional[tuple]],
                  fill: Sequence[float], dev: torch.device) -> List[tuple]:
    """Every cell's tensors of row ``d`` on ``dev``: a copy where the cell
    is local, a host all-gather over the row's process group where the row
    crosses processes (cells of other processes arrive from their owner)."""
    grp = _row_group(mesh, d)
    if grp is None:
        return [tuple(t.to(dev) for t in c) for c in per_cell]
    group, ranks = grp
    n_idx = len(per_cell)
    proto = next(c for c in per_cell if c is not None)
    mine = []
    for j, p in enumerate(proto):
        stack = torch.full((n_idx,) + tuple(p.shape), fill[j],
                           dtype=p.dtype)
        for i, c in enumerate(per_cell):
            if c is not None:
                stack[i] = c[j].cpu()
        mine.append(stack)
    import torch.distributed as dist

    got = []
    for t in mine:
        outs = [torch.empty_like(t) for _ in ranks]
        dist.all_gather(outs, t, group=group)
        got.append(outs)
    cells = []
    for i in range(n_idx):
        src = ranks.index(mesh.process_of[d][i])
        cells.append(tuple(g[src][i].to(dev) for g in got))
    return cells


def _rows_of(mesh: Mesh, bsz: int):
    dp = mesh.shape["dp"]
    if bsz % dp:
        raise ValueError(f"batch size {bsz} not divisible by mesh dp={dp}; "
                         "pad the batch (the serving batcher uses "
                         "dp-multiple buckets)")
    return bsz // dp


def _row_local(mesh: Mesh, d: int) -> bool:
    return any(mesh.local(d, i) for i in range(mesh.shape["idx"]))


# -- sharded exact / low-rank top-k ---------------------------------------------

def sharded_shard_topk(
    mesh: Mesh,
    queries: Tensor,
    docs,
    bias,
    k: int,
    *,
    mode: str = "dot",
    impl: str = "auto",
    routed: Optional[Tensor] = None,
    row_counts: Optional[Sequence[int]] = None,
    scale=None,
    center: Optional[Tensor] = None,
    packed4: bool = False,
    lr=None,
    k_refine: Optional[int] = None,
) -> Tuple[Tensor, Tensor]:
    """Exact top-k over a doc-axis-sharded corpus.

    ``queries [B, d]`` split over ``dp``; ``docs`` / ``bias`` / ``scale``
    :class:`MeshRows` (or whole arrays, sharded here) split over ``idx``.
    Padding rows must carry a ``-inf`` bias. ``routed [B] bool`` enables
    routing-aware compaction per cell: when at most half of a row's batch
    routes here, only a gathered half batch is scored (and a row no query
    routes to launches nothing); ``row_counts`` gives the per-row routed
    counts already on the host. ``lr`` (:class:`MeshLowRank` or a
    :class:`LowRankData`) swaps each cell's exact scan for the two-stage
    coarse scan + refine at depth ``k_refine`` per cell. Returns the merged
    ``(scores [B, k], global indices [B, k])`` on ``queries``' device; in a
    multi-process mesh, rows of the dp rows this process owns no cell of
    hold worst-score placeholders."""
    n_idx = mesh.shape["idx"]
    if not isinstance(docs, MeshRows):
        if docs.shape[0] % n_idx:
            raise ValueError(f"doc axis {docs.shape[0]} not divisible by "
                             f"idx={n_idx}")
        docs = MeshRows(mesh, docs)
        bias = MeshRows(mesh, bias, pad=NEG_INF)
        scale = None if scale is None else MeshRows(mesh, scale)
    if isinstance(lr, LowRankData):
        lr = MeshLowRank.shard(mesh, lr)
    dot_restore = None
    if center is not None:
        # mean-centred lossy shard: l2 shifts the queries once (|q-d|^2 is
        # invariant), dot restores q.mu on the merged output
        if mode == "l2":
            queries = queries.to(torch.float32) - center
        elif mode == "dot":
            dot_restore = queries.to(torch.float32) @ center
    bsz = queries.shape[0]
    bl = _rows_of(mesh, bsz)
    l2 = mode == "l2"
    worst = float("inf") if l2 else NEG_INF
    out_dev = queries.device
    scores = torch.full((bsz, k), worst, dtype=torch.float32, device=out_dev)
    gids = torch.zeros((bsz, k), dtype=torch.int64, device=out_dev)
    if routed is not None and row_counts is None:
        row_counts = routed.reshape(mesh.shape["dp"], bl).sum(dim=1).tolist()
    half = bl // 2
    for d in range(mesh.shape["dp"]):
        if not _row_local(mesh, d):
            continue
        cnt = None if row_counts is None else int(row_counts[d])
        if cnt == 0:
            continue                       # gated out by the mask anyway
        q_row = queries[d * bl:(d + 1) * bl]
        sel = None
        if cnt is not None and half >= COMPACTION_MIN_ROWS and cnt <= half:
            r = routed[d * bl:(d + 1) * bl]
            sel = torch.argsort((~r).to(torch.int8), stable=True)[:half]
        per_cell: List[Optional[tuple]] = []
        for i, dev in enumerate(mesh.devices[d]):
            if not mesh.local(d, i):
                per_cell.append(None)
                continue
            q = (q_row if sel is None else q_row[sel]).to(dev)
            d_l = docs.parts[d][i]
            b_l = bias.parts[d][i]
            s_l = None if scale is None else scale.parts[d][i]
            if lr is not None:
                s, ix = lowrank_topk(q, lr.cell(d, i), d_l, k, mode=mode,
                                     bias=b_l, scale=s_l, packed4=packed4,
                                     k_refine=k_refine)
            else:
                s, ix = shard_topk(q, d_l, k, mode=mode, bias=b_l,
                                   scale=s_l, impl=impl, packed4=packed4)
            if sel is not None:
                full_s = torch.full((bl, k), worst, dtype=torch.float32,
                                    device=dev)
                full_i = torch.zeros((bl, k), dtype=torch.int64, device=dev)
                sel_d = sel.to(dev)
                full_s[sel_d], full_i[sel_d] = s, ix.to(torch.int64)
                s, ix = full_s, full_i
            key = -s if l2 else s
            per_cell.append((key, ix.to(torch.int64) + i * docs.n_local))
        row_dev = mesh.devices[d][0] if mesh.local(d, 0) else out_dev
        cells = _gather_cells(mesh, d, per_cell, (NEG_INF, 0), row_dev)
        keys = torch.cat([c[0] for c in cells], dim=1)
        ids = torch.cat([c[1] for c in cells], dim=1)
        top, pos = topk_stable(keys, k)
        gi = torch.gather(ids, 1, pos)
        scores[d * bl:(d + 1) * bl] = (-top if l2 else top).to(out_dev)
        gids[d * bl:(d + 1) * bl] = gi.to(out_dev)
    if dot_restore is not None:
        scores = scores + dot_restore[:, None]
    return scores, gids


# -- sharded IVF ------------------------------------------------------------------

def sharded_ivf_topk(
    mesh: Mesh,
    queries: Tensor,
    ivf,
    k: int,
    *,
    mode: str = "dot",
    nprobe: int = 8,
    center: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """Cluster-probed approximate top-k with the CLUSTER axis sharded.

    ``ivf``: a :class:`MeshIVF` (or an :class:`IVFData`, sharded here).
    Every cell of a row computes the identical probe list, scores only the
    (query, probe) pairs whose clusters it owns (K3 over its local slabs;
    blocks of foreign pairs are past the real-block count and launch no
    work), takes each owned pair's top-k1 (K2), and the owners' per-pair
    lists meet in the final top-k. Equals the single-device
    :func:`ragroute_tpu_torch.ops.ivf_topk.ivf_topk` at equal ``nprobe``."""
    if isinstance(ivf, IVFData):
        ivf = MeshIVF.shard(mesh, ivf)
    c, cl, s = ivf.n_clusters, ivf.c_local, ivf.capacity
    k1 = min(k, s)
    p = int(min(max(nprobe, -(-k // k1)), c))
    dot_restore = None
    if center is not None:
        if mode == "l2":
            queries = queries.to(torch.float32) - center
        elif mode == "dot":
            dot_restore = queries.to(torch.float32) @ center
    bsz = queries.shape[0]
    bl = _rows_of(mesh, bsz)
    out_dev = queries.device
    scores = torch.full((bsz, k), float("inf") if mode == "l2" else NEG_INF,
                        dtype=torch.float32, device=out_dev)
    gids = torch.zeros((bsz, k), dtype=torch.int64, device=out_dev)
    for d in range(mesh.shape["dp"]):
        if not _row_local(mesh, d):
            continue
        q_row = queries[d * bl:(d + 1) * bl]
        per_cell: List[Optional[tuple]] = []
        for i, dev in enumerate(mesh.devices[d]):
            loc_ivf = ivf.cells[d][i]
            if loc_ivf is None:
                per_cell.append(None)
                continue
            qr = q_row.to(dev)
            qq = _prepare_queries(qr, mode)
            probe = probe_clusters(qr, qq, loc_ivf, p, mode)  # global ids
            loc = probe - i * cl
            owned = (loc >= 0) & (loc < cl)
            key = torch.where(owned, loc, cl)      # foreign pairs sort last
            rows, blk_cluster, n_real, row_of = dispatch(
                key, cl + 1, real_clusters=cl)
            qdtype = (torch.bfloat16 if loc_ivf.docs.dtype == torch.int8
                      else loc_ivf.docs.dtype)
            gains = grouped_gains(qq.to(qdtype), loc_ivf.docs, loc_ivf.bias,
                                  loc_ivf.scale, blk_cluster, loc_ivf.packed4,
                                  rows=rows, n_real=n_real)
            gq = torch.where(owned[:, :, None], gains[row_of], NEG_INF)
            del gains
            g1, s1 = stream_topk(gq.reshape(bl * p, s), k1)
            del gq
            slot = loc.clamp(0, cl - 1).reshape(-1, 1) * s + s1.long()
            ids = loc_ivf.perm.reshape(-1)[slot].long()
            ids = torch.where(owned.reshape(-1, 1), ids, -1)
            per_cell.append((g1.reshape(bl, p, k1), ids.reshape(bl, p, k1),
                             owned))
        row_dev = mesh.devices[d][0] if mesh.local(d, 0) else out_dev
        cells = _gather_cells(mesh, d, per_cell, (NEG_INF, -1, False),
                              row_dev)
        # each pair is owned by exactly one cell: take the owner's list
        gbest, ibest = cells[0][0], cells[0][1]
        for g_c, i_c, own in cells[1:]:
            gbest = torch.where(own[:, :, None], g_c, gbest)
            ibest = torch.where(own[:, :, None], i_c, ibest)
        gf, posf = topk_stable(gbest.reshape(bl, p * k1), k)
        idx = torch.gather(ibest.reshape(bl, p * k1), 1, posf)
        idx = torch.where(gf > NEG_INF, idx, 0)
        qc = q_row.to(row_dev)
        scores[d * bl:(d + 1) * bl] = gain_to_natural(gf, qc, mode).to(
            out_dev)
        gids[d * bl:(d + 1) * bl] = idx.to(out_dev)
    if dot_restore is not None:
        scores = scores + dot_restore[:, None]
    return scores, gids


# -- the full step -----------------------------------------------------------------

class ShardedSearch(EngineBase):
    """Full federated search step over a ``(dp, idx)`` mesh.

    Same semantics and host-facing interface as
    :class:`ragroute_tpu_torch.engine.FederatedSearchEngine` (route, score,
    gate, merge; ``search()`` -> :class:`SearchOutput`; ``search_submit``,
    ``set_payload_tables``, ``device``), with every corpus's documents
    sharded over ``idx`` and the batch over ``dp``, so the batcher, both
    front ends and SSE serve it unchanged. Routing, the gate and merge and
    the host copy run on the mesh's primary device. ``impl="ivf"`` /
    ``"hybrid"`` serve the cluster-probed mode with the cluster axis
    sharded; ``"lowrank"`` the two-stage search on shards that carry a
    coarse index (exact on the others).

    The shard set's pre-sharding arrays are retired: its shards then hold
    the :class:`MeshRows` (a host-staged build, ``ShardSet.build(device=
    "host")``, never lands whole on one card). Mutable sets are refused.
    """

    def __init__(self, shard_set: ShardSet, router, bank, mesh: Mesh, *,
                 impl: str = "auto", seed: int = 0,
                 threshold: Optional[float] = None,
                 nprobe: Optional[int] = None,
                 k_refine: Optional[int] = None):
        if shard_set.mutable or any(s.mutable for s in shard_set.shards):
            raise ValueError(
                "mutable ShardSets are not servable over a mesh yet; "
                "build with mutable=False for --mesh (live updates are a "
                "single-chip capability)")
        if impl == "ivf":
            missing = [s.name for s in shard_set.shards if s.ivf is None]
            if missing:
                raise ValueError(
                    f"impl='ivf' needs shards built with ivf_clusters; "
                    f"missing balanced-IVF layout for {missing}")
        if impl == "lowrank" and not shard_set.lowrank_built:
            raise ValueError(
                "impl='lowrank' needs shards built with lowrank= "
                "(e.g. lowrank=-1 for automatic rank selection)")
        self.world: WorldConfig = shard_set.world
        self.shard_set = shard_set
        self.mesh = mesh
        self.impl = impl
        self.nprobe = nprobe
        self.threshold = threshold
        self.k_refine = k_refine or LOWRANK_REFINE_MULT * self.world.k
        self.dp = mesh.shape["dp"]
        self.n_idx = mesh.shape["idx"]
        self.device = mesh.primary
        self.router = None if router is None else router.to(self.device)
        self.bank = None if bank is None else bank.to(self.device)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._ptables = None
        self._step_lock = threading.Lock()
        self._multiprocess = mesh.multiprocess
        self.arrays = []
        for i_s, s in enumerate(shard_set.shards):
            ivf = s.ivf if impl in ("ivf", "hybrid") else None
            if ivf is not None and ivf.n_clusters % self.n_idx:
                raise ValueError(
                    f"{s.name}: IVF cluster count {ivf.n_clusters} not "
                    f"divisible by mesh idx={self.n_idx}; rebuild with a "
                    f"power-of-two --ivf-clusters")
            lr = s.lr if impl == "lowrank" else None
            sharded = dict(
                docs=MeshRows(mesh, s.docs),
                bias=MeshRows(mesh, s.bias, pad=NEG_INF),
                scale=None if s.scale is None else MeshRows(mesh, s.scale),
                center=(None if s.center is None
                        else _as_tensor(s.center).to(self.device)),
                lr=None if lr is None else MeshLowRank.shard(mesh, lr),
                ivf=None if ivf is None else MeshIVF.shard(mesh, ivf))
            self.arrays.append(sharded)
            # the originals are dropped: serving reads only the sharded
            # copies, and layouts this impl never reads go with them
            shard_set.shards[i_s] = dataclasses.replace(
                s, docs=sharded["docs"], bias=sharded["bias"],
                scale=sharded["scale"], center=sharded["center"],
                ivf=sharded["ivf"], lr=sharded["lr"])
        self._n_docs = tuple(s.n_docs for s in shard_set.shards)
        self._packed = tuple(s.packed4 for s in shard_set.shards)
        if self._multiprocess:
            from ragroute_tpu_torch.parallel.multihost import row_groups

            row_groups(mesh)        # collective: every process, in order

    def _device_embs(self, query_embs):
        embs = super()._device_embs(query_embs)
        for enc, arr in embs.items():
            _rows_of(self.mesh, arr.shape[0])
        return embs

    @torch.no_grad()
    def _score(self, embs, mask):
        world, k = self.world, self.world.k
        bsz = mask.shape[0]
        bl = bsz // self.dp
        counts = mask.reshape(self.dp, bl, -1).sum(dim=1).tolist()
        per_scores, per_ids = [], []
        for i, src in enumerate(world.sources):
            a = self.arrays[i]
            ivf = a["ivf"]
            np_i = None
            if ivf is not None:
                if self.impl == "ivf":
                    np_i = self.nprobe or max(
                        1, ivf.n_clusters // IVF_NPROBE_DIVISOR)
                elif (self.impl == "hybrid"
                      and bl <= IVF_HYBRID_MAX_BATCH
                      and self._n_docs[i] // self.n_idx
                      >= IVF_HYBRID_MIN_DOCS):
                    # the single-card rule on each cell's share of the work
                    np_i = self.nprobe or max(
                        1, ivf.n_clusters // IVF_HYBRID_NPROBE_DIVISOR)
            if np_i is not None:
                s, gi = sharded_ivf_topk(
                    self.mesh, embs[src.encoder], ivf, k,
                    mode=src.score_mode, nprobe=np_i, center=a["center"])
            else:
                s, gi = sharded_shard_topk(
                    self.mesh, embs[src.encoder], a["docs"], a["bias"], k,
                    mode=src.score_mode,
                    impl=("auto" if self.impl in ("ivf", "hybrid", "lowrank")
                          else self.impl),
                    routed=mask[:, i], row_counts=[c[i] for c in counts],
                    scale=a["scale"], center=a["center"],
                    packed4=self._packed[i], lr=a["lr"],
                    k_refine=self.k_refine)
            per_scores.append(s)
            per_ids.append(gi)
        scored = gate_and_merge(world, k, mask, per_scores, per_ids)
        msg = (payload_base(self._ptables, scored[1])
               if self._ptables is not None else None)
        return scored + (msg,)

    def _exchange_rows(self, out: SearchOutput) -> SearchOutput:
        """Multi-process: each dp row's results come from the process that
        owns the row's first cell (a host all-gather, as JAX's
        ``process_allgather``); every process returns the whole batch."""
        bl = out.merged_score.shape[0] // self.dp
        fields = [f.name for f in dataclasses.fields(SearchOutput)
                  if isinstance(getattr(out, f.name), np.ndarray)]
        mine = {d: {f: getattr(out, f)[d * bl:(d + 1) * bl] for f in fields}
                for d in range(self.dp)
                if self.mesh.process_of[d][0] == self.mesh.process_index}
        from ragroute_tpu_torch.parallel.multihost import allgather_objects

        merged = {}
        for got in allgather_objects(mine):
            merged.update(got)
        new = {f: np.concatenate([merged[d][f] for d in range(self.dp)])
               for f in fields}
        return dataclasses.replace(out, **new)

    def search(self, query_embs: Dict[str, np.ndarray], *,
               strategy: str = "ragroute", staged: bool = False,
               fetch_candidates: bool = True) -> SearchOutput:
        with self._step_lock:
            embs = self._device_embs(query_embs)
            t0 = time.perf_counter()
            probs, mask = self._route(embs, strategy)
            sel_t, doc_t = 0.0, None
            if staged:
                self._sync()
                sel_t = time.perf_counter() - t0
                t0 = time.perf_counter()
            scored = self._score(embs, mask)
            if staged:
                self._sync()
                doc_t = time.perf_counter() - t0
            out = self._fetch_output(probs, mask, scored,
                                     fetch_candidates=fetch_candidates,
                                     sel_t=sel_t, doc_t=doc_t, t0=t0)
        if self._multiprocess:
            out = self._exchange_rows(out)
        return out

    def search_submit(self, query_embs, *, strategy: str = "ragroute",
                      fetch_candidates: bool = True):
        """The ``search_submit`` contract: the mesh step completes inline
        (its row merges already wait on the cells) and ``wait()`` hands
        the result over."""
        return DoneSearch(self.search(query_embs, strategy=strategy,
                                      fetch_candidates=fetch_candidates))
