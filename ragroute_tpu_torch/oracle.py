"""Exact f32 brute-force retrieval oracle (host-side, numpy).

The acceptance oracle for recall gating: reproduces the reference's FAISS
flat-index semantics (``ragroute/data_source.py:69-80,158-203`` — IndexFlatIP
for dot/cos worlds, IndexFlatL2 for wikipedia) in plain float32 numpy, with
lowest-document-index tie-breaking. Used by ``scripts/eval_recall.py`` and
``tests/test_recall_gate.py``; faiss itself is not in this image, so this
module IS the parity target for exactness tests.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Set, Tuple

import numpy as np


def source_scores(src, docs: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Gain-form scores of one query against one source's docs (f32)."""
    docs = np.asarray(docs, np.float32)
    q = q.astype(np.float32)
    if src.score_mode == "cos":
        dn = docs / np.maximum(
            np.linalg.norm(docs, axis=1, keepdims=True), 1e-12)
        return dn @ (q / max(np.linalg.norm(q), 1e-12))
    if src.score_mode == "l2":
        return -((docs - q) ** 2).sum(1)
    return docs @ q


def exact_oracle(
    world,
    embeddings: Mapping[str, np.ndarray],
    query_embs: Mapping[str, np.ndarray],
    k: int,
    mask: Optional[np.ndarray] = None,
) -> List[Set[Tuple[int, int]]]:
    """Exact f32 global top-k winner set per query.

    Returns one ``{(source_idx, local_doc_idx), ...}`` set per query:
    the top-k of the union of per-source top-k candidate lists, respecting
    the routing ``mask [Q, N]`` when given (reference merge semantics,
    ``http_server.py``: coordinator merges per-source k-lists).
    """
    nq = next(iter(query_embs.values())).shape[0]
    out = []
    for qi in range(nq):
        cands = []
        for si, src in enumerate(world.sources):
            if mask is not None and not mask[qi, si]:
                continue
            s = source_scores(src, embeddings[src.name],
                              query_embs[src.encoder][qi])
            order = np.argsort(-s, kind="stable")[:k]
            cands.extend((float(s[li]), si, int(li)) for li in order)
        cands.sort(key=lambda t: -t[0])
        out.append({(si, li) for _, si, li in cands[:k]})
    return out


def engine_recall(world, out, oracle: List[Set[Tuple[int, int]]]) -> float:
    """Mean winner-set recall of an engine SearchOutput vs the oracle."""
    recalls = []
    for qi, want in enumerate(oracle):
        got = {
            (int(s), int(l))
            for s, l in zip(out.merged_shard[qi], out.merged_local[qi])
            if s >= 0
        }
        if not want:
            # routing selected no sources (strategy=none / all-gated-off):
            # the engine must return nothing either
            recalls.append(1.0 if not got else 0.0)
        else:
            recalls.append(len(got & want) / len(want))
    return float(np.mean(recalls))
