"""Two-stage exact-rescored top-k: low-rank coarse scan + full refine.

PyTorch port of ``ragroute_tpu/ops/lowrank_topk.py::lowrank_topk``, the
search behind ``impl="lowrank"`` (see
:mod:`ragroute_tpu_torch.index.lowrank` for the build):

* coarse: the exact top-k' scan (the fused kernel on the card) over the
  ``[n, r]`` projected slab, gain-form dot; the shard's own bias carries the
  l2 ``-|d|^2`` term, which stays exact full-dimension, and the ``-inf``
  padding sentinel;
* refine: one row gather of the ``k'`` candidates from the stored slab,
  exact rescore (dequant + dot + bias) in f32, final tie-stable top-k.

Refined scores are the exact stored-dtype scores in natural form, and
bit-equal duplicates order lowest index first: the coarse stage returns
ties lowest index first, so they enter the candidate list in index order
and the stable final selection keeps it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ragroute_tpu_torch.index.lowrank import LowRankData
from ragroute_tpu_torch.ops.topk import (NEG_INF, _prepare_queries,
                                         gain_to_natural, shard_topk,
                                         topk_stable)

Tensor = torch.Tensor


def lowrank_topk(queries: Tensor, lr: LowRankData, docs: Tensor, k: int, *,
                 mode: str = "dot", valid_docs: Optional[int] = None,
                 bias: Optional[Tensor] = None,
                 scale: Optional[Tensor] = None,
                 center: Optional[Tensor] = None, packed4: bool = False,
                 k_refine: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """Two-stage top-k over one shard; the signature of ``shard_topk`` plus
    the coarse index and the candidate depth ``k_refine`` (default
    ``4 * k``, clamped to the slab).

    Returns ``(scores [B, k], indices [B, k])``, scores in natural form,
    best first, as the exhaustive implementations."""
    n_pad = docs.shape[0]
    kr = int(min(k_refine or 4 * k, n_pad))
    kr = max(kr, k)

    # centre handling as in shard_topk: l2 shifts queries into the centred
    # frame (distances unchanged); dot adds the q.mu constant back to the
    # returned scores (stored rows carry only the residual)
    dot_restore = None
    if center is not None:
        if mode == "l2":
            queries = queries.to(torch.float32) - center
        elif mode == "dot":
            dot_restore = queries.to(torch.float32) @ center

    q32 = _prepare_queries(queries, mode)          # gain-form [B, d]
    qp = q32 @ lr.basis                            # [B, r]

    # coarse: gain-form dot over the projected slab with the FULL shard
    # bias. The slab is mean-centred, so coarse gains are the true gains
    # minus a per-query constant: ordering and the -inf validity sentinel
    # are unaffected, and that is all refine consumes.
    cg, cidx = shard_topk(qp, lr.docs_lr, kr, mode="dot",
                          valid_docs=valid_docs, bias=bias)

    if packed4:
        # coarse-authoritative mode for int4 stores: the coarse slab is
        # projected from the rows before quantization, so its order is
        # closer to the f32 truth than a rescore from 4-bit codes. The
        # returned scores restore the per-(query, shard) centring constant
        # q_gain . mu so cross-shard merges stay comparable; they are
        # truncation-approximate, not the stored-int4 scores.
        restore = q32 @ lr.mu                          # [B]
        head = cg[:, :k]
        top_g = torch.where(head > NEG_INF, head + restore[:, None], NEG_INF)
        s = gain_to_natural(top_g, queries, mode)
        if dot_restore is not None:
            s = s + dot_restore[:, None]
        return s, cidx[:, :k]

    # refine: gather the candidates' stored rows and rescore exactly
    # (int4 stores returned above, so the rows here are f32 / bf16 / int8
    # with at most a per-doc scale)
    bsz = queries.shape[0]
    flat = cidx.reshape(-1)
    rows = docs[flat].reshape(bsz, kr, -1).to(torch.float32)
    g = torch.einsum("bd,bkd->bk", q32, rows)
    if scale is not None:
        g = g * scale[flat].reshape(bsz, kr)
    if bias is not None:
        g = g + bias[flat].reshape(bsz, kr)
    # a candidate slot the coarse stage could not fill (fewer valid docs
    # than k') carries a junk index and a -inf coarse gain: keep it out
    g = torch.where(cg > NEG_INF, g, NEG_INF)

    top_g, pos = topk_stable(g, k)
    top_i = torch.gather(cidx, 1, pos)
    # -inf gains map to the exhaustive kernels' worst-score sentinels
    # through the same arithmetic (+inf l2 distance, -inf dot/cos score)
    s = gain_to_natural(top_g, queries, mode)
    if dot_restore is not None:
        s = s + dot_restore[:, None]
    return s, top_i
