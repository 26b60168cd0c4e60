"""Cluster-probed approximate top-k as a grouped-GEMM program.

PyTorch port of ``ragroute_tpu/ops/ivf_topk.py::ivf_topk``: probe only the
``nprobe`` nearest balanced clusters per query.

1. **Probe**: the centroids' gains (gain form, so dot / cos / l2 all reduce
   to a top-``nprobe``), ties to the lower cluster.
2. **Sort**: flatten the ``[B, nprobe]`` probe lists, stable-sort by
   cluster; each cluster's run of pair rows is padded up to whole blocks of
   64 rows. No per-cluster capacity and no dropped pairs.
3. **Score**: the grouped GEMM (:func:`ragroute_tpu_torch.ops.grouped_gains.
   grouped_gains`, the K3 kernel): each block against its own cluster slab.
4. **Collect**: gather each query's probe rows into one ``[B, P*S]`` gain
   matrix, one streaming exact top-k over it
   (:func:`ragroute_tpu_torch.ops.stream_topk.stream_topk`, the K2 kernel),
   and remap winners through the cluster permutation to local doc ids.

With ``nprobe == C`` every query scores every document and the result
equals the exact path's; smaller ``nprobe`` trades recall for work.

All bookkeeping runs on the device with no host read: the block count is
sized by its static bound ``E/64 + min(E, C)`` and the true count goes to
the kernel as a device scalar, so padding blocks cost nothing.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ragroute_tpu_torch.index.ivf import IVFData
from ragroute_tpu_torch.ops.fused_topk import fused_topk
from ragroute_tpu_torch.ops.grouped_gains import GROUP_ROWS, grouped_gains
from ragroute_tpu_torch.ops.stream_topk import stream_topk
from ragroute_tpu_torch.ops.topk import (NEG_INF, _prepare_queries, _validate,
                                         gain_to_natural, topk_stable)

Tensor = torch.Tensor

PROBE_KERNEL_MAX = 64    # probes up to here go through the fused kernel


def probe_clusters(queries: Tensor, q_gain: Tensor, ivf: IVFData, p: int,
                   mode: str) -> Tensor:
    """``[B, p]`` i64 nearest clusters, best first, ties to the lower
    cluster: the fused kernel on the centroid bank for shallow probes, a
    stable sort of the ``[B, C]`` gains for deep ones."""
    if p <= PROBE_KERNEL_MAX:
        return fused_topk(queries, ivf.centroids, p, mode=mode)[1]
    cg = q_gain @ ivf.centroids.T + ivf.cbias[None, :]
    return topk_stable(cg, p)[1]


def dispatch(probe: Tensor, n_clusters: int,
             real_clusters: Optional[int] = None):
    """Block-aligned layout of the (query, probe) pairs sorted by cluster.

    Returns ``(rows [Ep] i32, blk_cluster [G] i32, n_real [1] i32,
    row_of [B, p] i64)``: the query of every padded pair row (padding rows
    name query 0), each block's cluster, the number of real blocks, and
    where pair ``(b, j)`` landed. ``real_clusters``: only the blocks of
    clusters below it count as real (the mesh path sorts the pairs a cell
    does not own into one last cluster, whose blocks the kernel skips)."""
    bsz, p = probe.shape
    dev = probe.device
    e = bsz * p
    te = GROUP_ROWS
    flat_c = probe.reshape(e)
    sc, order = torch.sort(flat_c, stable=True)              # [E] sorted
    counts = torch.bincount(flat_c, minlength=n_clusters)    # [C]
    # a cluster's run of sorted pairs starts at the count of all pairs of
    # lower clusters
    run_start = torch.cumsum(counts, dim=0) - counts         # [C]
    pos_in = torch.arange(e, device=dev) - run_start[sc]     # rank in cluster
    nblk = -(-counts // te)                                  # blocks/cluster
    blk_hi = torch.cumsum(nblk, dim=0)                       # [C] inclusive
    base_rows = (blk_hi - nblk) * te                         # padded starts
    pad_pos = base_rows[sc] + pos_in                         # [E] padded row
    n_blocks = e // te + min(e, n_clusters)   # bound on sum(ceil(count/te))
    blk_cluster = torch.searchsorted(
        blk_hi, torch.arange(n_blocks, device=dev), right=True
    ).clamp(0, n_clusters - 1).to(torch.int32)
    rows = torch.zeros(n_blocks * te, dtype=torch.int32, device=dev)
    rows[pad_pos] = (order // p).to(torch.int32)             # unique indices
    row_of = torch.empty(e, dtype=torch.int64, device=dev)
    row_of[order] = pad_pos
    last = n_clusters if real_clusters is None else real_clusters
    return (rows, blk_cluster, blk_hi[last - 1:last].to(torch.int32),
            row_of.reshape(bsz, p))


def ivf_topk(queries: Tensor, ivf: IVFData, k: int, *, mode: str = "dot",
             nprobe: int = 8, center: Optional[Tensor] = None
             ) -> Tuple[Tensor, Tensor]:
    """Approximate top-k over a balanced-IVF shard.

    Returns ``(scores [B, k], indices [B, k])`` in natural score form with
    original local doc indices (the contract of
    :func:`ragroute_tpu_torch.ops.topk.shard_topk`). Entries beyond the
    number of reachable docs come back with -inf gain (+inf distance for
    l2) and index 0."""
    _validate(mode)
    dot_restore = None
    if center is not None:
        # l2: shift queries (distance invariant); dot: score ordering is
        # invariant under doc-side centring, the per-query constant q.mu
        # is restored on the way out (see ops.topk.shard_topk)
        if mode == "l2":
            queries = queries.to(torch.float32) - center
        elif mode == "dot":
            dot_restore = queries.to(torch.float32) @ center
    bsz = queries.shape[0]
    c, _, s = ivf.docs.shape      # middle axis is d//2 when int4-packed
    k1 = min(k, s)
    p = int(min(max(nprobe, -(-k // k1)), c))
    q = _prepare_queries(queries, mode)                      # [B, d] f32
    if bsz == 0:
        return (torch.empty((0, k), dtype=torch.float32, device=q.device),
                torch.empty((0, k), dtype=torch.int64, device=q.device))

    probe = probe_clusters(queries, q, ivf, p, mode)         # [B, p]
    rows, blk_cluster, n_real, row_of = dispatch(probe, c)

    qdtype = (torch.bfloat16 if ivf.docs.dtype == torch.int8
              else ivf.docs.dtype)
    gains = grouped_gains(q.to(qdtype), ivf.docs, ivf.bias, ivf.scale,
                          blk_cluster, ivf.packed4, rows=rows, n_real=n_real)

    gq = gains[row_of]                                       # [B, P, S]
    del gains
    gf, pos = stream_topk(gq.reshape(bsz, p * s), k)
    del gq
    pos = pos.long()
    cl = torch.gather(probe, 1, pos // s)                    # [B, k]
    idx = ivf.perm.reshape(-1)[cl * s + pos % s].long()
    valid = gf > NEG_INF
    idx = torch.where(valid, idx, 0)
    out_scores = gain_to_natural(gf, queries, mode)
    if dot_restore is not None:
        out_scores = torch.where(valid, out_scores + dot_restore[:, None],
                                 out_scores)
    return out_scores, idx
