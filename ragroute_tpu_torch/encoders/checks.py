"""Card-side checks and timings of the query encoders, shared by
``chip_smoke.py`` (its ``encoders`` phase) and ``measure.py --encoders``.

* :func:`check_published_models`: every registry encoder at its published
  width (:mod:`ragroute_tpu_torch.encoders.published`, seeded random
  weights, bf16 on the card) over a fixed batch of query texts at each
  bucket: the shape ``[B, spec.dim]``, finite values, unit norm where the
  spec normalizes, cosine against an f32 forward of the same weights, the
  same text alone and inside the largest bucket, and each forward's
  CUDA-event and profiler device time beside its bound.
* :func:`forward_bound`: the least time the card could take for one forward
  (``max(bytes / 3.35 TB/s, operations / 989 TFLOP/s)``, bf16 peaks of one
  H100 SXM).
* :func:`oracle_lists` / :func:`served_recall`: recall of served ``/query``
  winners against the exact oracle over the embeddings the provider gives
  for the same texts, under each answer's own routing;
  :func:`source_recall`: an engine's per-source lists against the same
  oracle.
"""

from __future__ import annotations

import copy
import gc
import time
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from ragroute_tpu_torch.encoders import layers as L
from ragroute_tpu_torch.encoders import published as P

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
F32_COS_GATE = 0.99          # bf16 forward against f32 of the same weights
BUCKET_COS_GATE = 0.999      # one text alone against inside the largest bucket

QUERY_TEXTS = [
    "What is the first-line treatment for type 2 diabetes?",
    "How do mRNA vaccines trigger an immune response?",
    "Which enzyme is deficient in phenylketonuria?",
    "What are the symptoms of iron deficiency anemia?",
    "How does metformin lower blood glucose?",
    "What causes Kawasaki disease in children?",
    "Is aspirin recommended for primary prevention of heart attacks?",
    "What is the mechanism of action of beta blockers?",
    "Which bacteria cause most cases of community acquired pneumonia?",
    "How is hypertension diagnosed in adults?",
    "What does a high troponin level indicate?",
    "Can vitamin D deficiency cause muscle weakness?",
    "What is the half-life of warfarin?",
    "How do statins reduce cholesterol?",
    "Who discovered penicillin and when?",
    "What is the capital of Australia?",
    "How do solar panels convert light into electricity?",
    "Why is the sky blue during the day?",
    "What are the side effects of chemotherapy?",
    "How long does the influenza virus survive on surfaces?",
    "Which organ produces insulin?",
    "What is the difference between a virus and a bacterium?",
    "How does the keto diet affect the liver?",
    "What are the risk factors for stroke?",
    "How is tuberculosis transmitted between people?",
    "What is the normal range of blood pressure?",
    "Does coffee raise the risk of atrial fibrillation?",
    "What is the role of the hippocampus in memory?",
    "How are kidney stones treated?",
    "What is herd immunity?",
    "Which vitamins are fat soluble?",
    "What is the prognosis of pancreatic cancer?",
]


def words_of(texts: Sequence[str]) -> List[str]:
    """The lower-cased words of ``texts`` (punctuation split off), for the
    vocabularies made in code."""
    out = []
    for t in texts:
        word = []
        for ch in t.lower() + " ":
            if ch.isalnum():
                word.append(ch)
            elif word:
                out.append("".join(word))
                word = []
    return sorted(set(out))


def cosine_rows(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    return (a * b).sum(1) / np.maximum(
        np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1), 1e-30)


def forward_bound(key: str, model, batch: int, seq: int) -> Dict:
    nbytes = P.forward_bytes(model, batch, seq)
    flops = P.forward_flops(key, batch, seq)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def event_ms(fn: Callable, reps: int = 5, warmup: int = 2) -> float:
    """Median CUDA-event ms of ``fn()`` (which ends in a copy to the host)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def device_ms(fn: Callable, reps: int = 3) -> Dict:
    """Device time of one ``fn()``: the CUDA kernels a ``torch.profiler``
    window over ``reps`` calls records, summed, over ``reps``; with the
    window's wall time a call and the kernels a call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    dev = sum(e.device_time_total for e in evs) / 1e3 / reps
    return {"device_ms": dev, "wall_ms": wall,
            "kernels": sum(e.count for e in evs) / reps}


def _shapes(model) -> list:
    """Record the ``[B, L]`` of every forward of ``model``."""
    seen = []
    model.register_forward_pre_hook(
        lambda m, args: seen.append(tuple(args[0].shape)))
    return seen


def check_published_models(device, log: Callable[[str], None],
                           buckets: Sequence[int] = (1, 8, 32),
                           texts: Sequence[str] = QUERY_TEXTS,
                           card: str = "", seed: int = 0) -> List[Dict]:
    """Every registry spec on its published-width model (each model built
    once, GPT-J last, freed before the next); raises on a failed check.
    Returns one row a (model, bucket) with its times and bound."""
    texts = list(texts)
    words = words_of(texts)
    rows = []
    for key, specs in P.distinct_models().items():
        pub = P.MODELS[key]
        t0 = time.perf_counter()
        model = P.random_model(key, device, torch.bfloat16, seed)
        float(next(model.parameters()).detach().flatten()[-1])  # the fill ends
        built = time.perf_counter() - t0
        tok = P.tokenizer_for(key, words)
        dense = P.random_dense(key, device, seed)
        wide = L.cast_(copy.deepcopy(model), torch.float32)
        shapes = _shapes(model)
        how = ("seeded token ids (no SentencePiece tokenizer on this "
               "machine)" if pub.tokenizer == "seeded"
               else f"the port's {pub.tokenizer} tokenizer")
        log(f"[encoders:{key}] {P.n_params(model) / 1e6:.1f} M parameters "
            f"made on the card in {built:.2f} s (bf16; {pub.source}); "
            f"{len(specs)} spec(s); texts through {how}")
        for si, spec in enumerate(specs):
            enc = P.encoder(spec, model, tok, dense)
            enc32 = P.encoder(spec, wide, tok, dense)
            if enc.backend != f"torch:{torch.device(device).type}":
                raise AssertionError(f"{spec.name}: backend {enc.backend}")
            outs = {}
            for b in buckets:
                e = enc.encode(texts[:b])
                if e.shape != (b, spec.dim) or not np.isfinite(e).all():
                    raise AssertionError(
                        f"{spec.name} B={b}: shape {e.shape} (want "
                        f"{(b, spec.dim)}) or non-finite values")
                if spec.normalize:
                    norms = np.linalg.norm(e, axis=1)
                    if np.abs(norms - 1).max() > 1e-3:
                        raise AssertionError(f"{spec.name}: norms {norms}")
                outs[b] = e
            n32 = min(8, len(texts))
            cos32 = cosine_rows(enc.encode(texts[:n32]),
                                enc32.encode(texts[:n32]))
            same = float(cosine_rows(outs[buckets[0]][:1],
                                     outs[buckets[-1]][:1])[0])
            log(f"[encoders:{spec.name}] [B, {spec.dim}] at buckets "
                f"{list(buckets)}, finite"
                + (", unit norm" if spec.normalize else "")
                + f"; bf16 against f32 cosine min {cos32.min():.6f} (gate "
                f"{F32_COS_GATE}); text 0 alone against in bucket "
                f"{buckets[-1]}: cosine {same:.7f} (gate {BUCKET_COS_GATE})")
            if cos32.min() < F32_COS_GATE or same < BUCKET_COS_GATE:
                raise AssertionError(f"{spec.name}: cosine gate failed")
            if si:
                continue
            for b in buckets:         # timing: the model's first spec
                del shapes[:]
                ev = event_ms(lambda: enc.encode(texts[:b]))
                dv = device_ms(lambda: enc.encode(texts[:b]))
                bsz, seq = shapes[-1]
                bd = forward_bound(key, model, bsz, seq)
                row = {"model": key, "spec": spec.name, "batch": bsz,
                       "seq": seq, "event_ms": ev, **dv, **bd}
                rows.append(row)
                log(f"[encoders:{key}] B={bsz} x L={seq}: {ev:.3f} ms by "
                    f"events (encode, tokenizer to numpy), {dv['device_ms']:.3f}"
                    f" ms device in {dv['kernels']:.0f} kernels, bound "
                    f"{bd['bound_ms']:.4f} ms by {bd['bound_by']} "
                    f"({bd['bytes'] / 1e9:.3f} GB, {bd['flops'] / 1e12:.3f} "
                    f"TFLOP); {card}")
        del model, wide, enc, enc32
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def stable_topk(s: np.ndarray, k: int) -> np.ndarray:
    """``np.argsort(-s, kind="stable")[:k]`` without sorting all of ``s``:
    the k best, ties to the lower index."""
    if len(s) <= k:
        return np.argsort(-s, kind="stable")
    kth = np.partition(-s, k - 1)[k - 1]
    cand = np.nonzero(-s <= kth)[0]
    return cand[np.argsort(-s[cand], kind="stable")][:k]


def oracle_lists(world, embeddings, q_embs: Dict[str, np.ndarray], k: int,
                 chunk: int = 64) -> List[List[list]]:
    """Each query's exact f32 top-k of each source as ``[(score, source,
    doc), ...]`` lists, ``out[query][source]`` (the candidates
    ``oracle.exact_oracle`` merges, with the queries of a chunk scored in
    one product)."""
    from ragroute_tpu_torch.oracle import source_scores

    nq = next(iter(q_embs.values())).shape[0]
    out = [[None] * world.num_sources for _ in range(nq)]
    for si, src in enumerate(world.sources):
        docs = np.asarray(embeddings[src.name], np.float32)
        q = np.asarray(q_embs[src.encoder], np.float32)
        if src.score_mode == "l2":
            for qi in range(nq):
                s = source_scores(src, docs, q[qi])
                out[qi][si] = [(float(s[li]), si, int(li))
                               for li in stable_topk(s, k)]
            continue
        if src.score_mode == "cos":
            docs = docs / np.maximum(
                np.linalg.norm(docs, axis=1, keepdims=True), 1e-12)
            q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True),
                               1e-12)
        for c0 in range(0, nq, chunk):
            scores = docs @ q[c0:c0 + chunk].T
            for j in range(scores.shape[1]):
                s = scores[:, j]
                out[c0 + j][si] = [(float(s[li]), si, int(li))
                                   for li in stable_topk(s, k)]
    return out


def served_recall(world, answers: Sequence[dict], lists: List[List[list]],
                  k: int) -> float:
    """Mean recall of served ``/query`` answers against the exact oracle
    (``lists`` from :func:`oracle_lists`, one row an answer), under each
    answer's own routing (``data_sources``). Score-merged worlds: the
    global exact top-k, merged as ``oracle.exact_oracle`` merges; feb4rag:
    the reference's merge without qrels, the first k of the routed sources'
    exact top-k lists in source order."""
    names = [s.name for s in world.sources]
    rec = []
    for a, per in zip(answers, lists):
        md = a["metadata"]
        routed = [names.index(n) for n in md["data_sources"]]
        got = set()
        for d in md["top_docs"]:
            doc = d.get("_id", d.get("id"))
            src, _, idx = doc.rpartition("-doc" if "_id" in d else "_")
            got.add((names.index(src), int(idx)))
        cands = [c for si in sorted(routed) for c in per[si]]
        if world.name != "feb4rag":
            cands.sort(key=lambda t: -t[0])
        want = {(si, li) for _, si, li in cands[:k]}
        rec.append(len(got & want) / len(want) if want else float(not got))
    return float(np.mean(rec))


def source_recall(out, lists: List[List[list]]) -> float:
    """Mean recall of an engine ``SearchOutput``'s per-source candidate
    lists (``shard_ids [Q, N, k]``) against :func:`oracle_lists`, over the
    routed (query, source) pairs."""
    rec = []
    for qi, per in enumerate(lists):
        for si, want in enumerate(per):
            if not out.mask[qi, si]:
                continue
            w = {li for _, _, li in want}
            got = {int(x) for x in out.shard_ids[qi, si]}
            rec.append(len(w & got) / len(w))
    return float(np.mean(rec)) if rec else 1.0
