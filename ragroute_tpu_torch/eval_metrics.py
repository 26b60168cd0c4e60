"""Retrieval quality metrics: NDCG / MAP / Recall / Precision / MRR @ k.

The port's own copy of :mod:`ragroute_tpu.eval_metrics` (numpy-free,
stdlib only), held to it by ``tests/test_torch_vendored.py``.

The reference evaluates its FeB4RAG encoders through BEIR's
``EvaluateRetrieval`` (``models/feb4rag/model_collection.py:12-131``,
``model_eval`` helper). This is the dependency-free equivalent, following
the same definitions (binary-or-graded qrels; NDCG with graded gains,
log2 discounts; MAP/recall/precision over relevant docs with rel > 0).

    results: {qid: {doc_id: score}}   (higher = better)
    qrels:   {qid: {doc_id: relevance}}
    evaluate_retrieval(qrels, results, k_values=[1, 10, 100])
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Mapping

Qrels = Mapping[str, Mapping[str, int]]
Results = Mapping[str, Mapping[str, float]]


def _ranked(docs: Mapping[str, float]) -> List[str]:
    return [d for d, _ in sorted(docs.items(), key=lambda x: -x[1])]


def _dcg(rels: Iterable[float]) -> float:
    return sum(
        (2.0 ** rel - 1.0) / math.log2(i + 2)
        for i, rel in enumerate(rels))


def evaluate_retrieval(
    qrels: Qrels,
    results: Results,
    k_values: Iterable[int] = (1, 10, 100),
) -> Dict[str, float]:
    """Mean metrics over the queries present in ``qrels``.

    Returns ``{"NDCG@k": ..., "MAP@k": ..., "Recall@k": ..., "P@k": ...,
    "MRR@k": ...}`` for each k (BEIR-style keys).
    """
    k_values = sorted(set(int(k) for k in k_values))
    agg: Dict[str, List[float]] = {
        f"{m}@{k}": []
        for k in k_values
        for m in ("NDCG", "MAP", "Recall", "P", "MRR")
    }

    for qid, rels in qrels.items():
        relevant = {d: r for d, r in rels.items() if r > 0}
        if not relevant:
            continue
        ranked = _ranked(results.get(qid, {}))
        ideal = sorted(relevant.values(), reverse=True)
        for k in k_values:
            top = ranked[:k]
            gains = [relevant.get(d, 0) for d in top]
            # NDCG@k
            idcg = _dcg(ideal[:k])
            agg[f"NDCG@{k}"].append(_dcg(gains) / idcg if idcg > 0 else 0.0)
            # Recall@k / P@k
            hits = sum(1 for d in top if d in relevant)
            agg[f"Recall@{k}"].append(hits / len(relevant))
            agg[f"P@{k}"].append(hits / k)
            # MAP@k (average precision over relevant hits in top k)
            ap, found = 0.0, 0
            for i, d in enumerate(top):
                if d in relevant:
                    found += 1
                    ap += found / (i + 1)
            # trec_eval map_cut divides by ALL relevant docs, not min(R, k)
            agg[f"MAP@{k}"].append(ap / len(relevant))
            # MRR@k
            rr = 0.0
            for i, d in enumerate(top):
                if d in relevant:
                    rr = 1.0 / (i + 1)
                    break
            agg[f"MRR@{k}"].append(rr)

    return {
        name: (sum(vals) / len(vals) if vals else 0.0)
        for name, vals in agg.items()
    }
