"""The numbers that decide ``correct``, each held against its limit.

Served answers (what the timed path returned for the checked queries) are
compared with the plain reference's answers to the same queries:

* ``mask_diff``: routing decisions that differ (exact: limit 0);
* ``count_diff``: queries whose merged count differs (exact: limit 0);
* ``dup_docs``: queries that name one doc twice (exact: limit 0);
* ``score_err``: the widest gap between a served score and the reference's
  score of the same doc, over ``|q|`` times the rms norm of the doc's
  source's stored rows; a served doc that is no doc of a routed source
  reads infinite;
* ``rank_gap``: the widest gap, rank by rank, by which the reference's
  scores of the served docs lie below the reference's own top-k, in the
  same unit (how much worse the served list is than the exact one);
* ``recall_short``: one less the mean share of the reference's top-k that
  the served top-k holds.

A configuration's ``limits`` name the numbers its cells compare; the rest
are printed and not held.
"""

from __future__ import annotations

from typing import Dict

import torch


def numbers(served: Dict[str, torch.Tensor], ref_mask: torch.Tensor,
            ref_answer, ref, queries) -> Dict[str, float]:
    """Every number of the module docstring for one set of checked queries.

    ``served``: ``mask [Q, N]`` bool, ``score``, ``shard``, ``local``
    ``[Q, k]`` and ``count [Q]`` as the program returned them, on the
    reference's device. ``ref_answer``: :meth:`Reference.answer` under
    ``ref_mask``; ``ref``: the :class:`~portbench.reference.Reference`."""
    r_score, r_shard, r_local, r_count = ref_answer
    k = r_score.shape[1]
    mask, count = served["mask"].bool(), served["count"].long()
    shard, local = served["shard"].long(), served["local"].long()
    score = served["score"].float()
    out = {"mask_diff": float((mask != ref_mask).sum()),
           "count_diff": float((count != r_count).sum())}

    ranks = torch.arange(k, device=shard.device)[None, :]
    valid = ranks < count[:, None]
    key = torch.where(valid, shard * (1 << 40) + local,
                      torch.full_like(shard, -1))
    srt = torch.sort(key, dim=1).values
    dup = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
    out["dup_docs"] = float(dup.any(dim=1).sum())

    # the reference's scores of the served docs; a doc of a source the
    # reference did not route to is no answer
    in_range = valid & (shard >= 0) & (shard < ref_mask.shape[1])
    routed = torch.gather(ref_mask, 1, shard.clamp(0, ref_mask.shape[1] - 1))
    named = torch.where(in_range, shard, torch.full_like(shard, -1))
    s_ref, unit = ref.score_of(queries, named, local)
    bad = valid & (~in_range | ~routed | torch.isnan(s_ref))
    err = torch.where(valid & ~bad, (score - s_ref).abs() / unit,
                      torch.zeros_like(score))
    out["score_err"] = (float("inf") if bool(bad.any())
                        else float(err.max()) if err.numel() else 0.0)

    l2 = ref.modes[0] == "l2"
    r_valid = ranks < r_count[:, None]
    _, r_unit = ref.score_of(queries, torch.where(r_valid, r_shard, -1),
                             r_local)
    served_key = torch.where(valid & ~bad, -s_ref if l2 else s_ref,
                             torch.full_like(s_ref, float("-inf")))
    served_key = torch.sort(served_key, dim=1, descending=True).values
    ref_key = -r_score if l2 else r_score
    both = r_valid & valid
    gap = torch.where(both, (ref_key - served_key) / r_unit,
                      torch.zeros_like(ref_key))
    gap = torch.where(both & torch.isinf(served_key),
                      torch.full_like(gap, float("inf")), gap)
    out["rank_gap"] = float(gap.max()) if gap.numel() else 0.0

    r_keys = torch.where(r_valid, r_shard * (1 << 40) + r_local,
                         torch.full_like(r_shard, -2))
    hit = (r_keys[:, :, None] == key[:, None, :]).any(dim=2) & r_valid
    has = r_count > 0
    share = hit.sum(dim=1).float() / r_count.clamp(min=1).float()
    recall = float(share[has].mean()) if bool(has.any()) else 1.0
    out["recall"] = recall
    out["recall_short"] = 1.0 - recall
    return out


def verdict(values: Dict[str, float], limits: Dict[str, float]):
    """``(correct, checks)``: each limited number within its limit, and
    ``{name: {"value", "limit"}}`` in the limits' order."""
    checks = {name: {"value": values[name], "limit": limit}
              for name, limit in limits.items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
