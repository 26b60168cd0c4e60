"""Host-side cross-source rerank semantics.

The score-based merges (medrag descending, wikipedia ascending —
reference ``ragroute/rerank.py:3-9,28-34``) happen ON DEVICE inside the
engine's segmented top-k (:mod:`ragroute_tpu_torch.engine.engine`). This module
keeps the two pieces that are inherently host-side:

* the feb4rag **qrels-oracle rerank** (``rerank.py:12-25``): candidates are
  ordered by ground-truth relevance labels (string doc-id lookups), with
  non-labeled docs pushed to the end;
* numpy reference implementations of the score merges, used as parity
  oracles in tests and by the pure-host (simulation) path.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np


def rerank_medrag(docs: Sequence, scores: Sequence[float], k: int):
    """Descending score merge (reference ``rerank.py:3-9``)."""
    order = np.argsort(np.asarray(scores, dtype=np.float64))[::-1][:k]
    return [docs[i] for i in order], [scores[i] for i in order]


def rerank_wikipedia(docs: Sequence, scores: Sequence[float], k: int):
    """Ascending distance merge (reference ``rerank.py:28-34``)."""
    order = np.argsort(np.asarray(scores, dtype=np.float64))[:k]
    return [docs[i] for i in order], [scores[i] for i in order]


def rerank_feb4rag(
    ids: Sequence[str],
    docs: Sequence,
    query_id: str,
    k: int,
    relevance_data: Dict[str, List[Tuple[str, str]]],
):
    """Qrels-oracle rerank (reference ``rerank.py:12-25``).

    ``relevance_data`` maps query id -> list of (doc_id, relevance) pairs;
    candidates present in the qrels are ordered by descending relevance,
    everything else keeps stable order at the end. Returns
    ``(top_docs, top_ids)`` — note the reference's (docs, ids) order.
    """
    rel = relevance_data.get(str(query_id), [])
    rel_order = [d for d, _ in sorted(rel, key=lambda x: -int(x[1]))]
    sort_key = {docid: i for i, docid in enumerate(rel_order)}
    pairs = sorted(
        zip(ids, docs), key=lambda x: sort_key.get(x[0], float("inf")))
    if not pairs:
        return [], []
    sorted_ids, sorted_docs = zip(*pairs)
    return list(sorted_docs[:k]), list(sorted_ids[:k])


def load_qrels(path: str) -> Dict[str, List[Tuple[str, str]]]:
    """Load a BEIR qrels text file (reference ``http_server.py:90-96``:
    whitespace rows ``qid _ docid rel``)."""
    data: Dict[str, List[Tuple[str, str]]] = defaultdict(list)
    with open(path, "r") as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) != 4:
                continue
            qid, _, docid, rel = parts
            data[qid].append((docid, rel))
    return dict(data)
