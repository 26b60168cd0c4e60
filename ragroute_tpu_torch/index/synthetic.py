"""Synthetic federated corpora with known ground truth.

The port's own copy of the JAX package's ``index/synthetic.py`` (numpy
only): the same seed gives the same bytes in both packages, which
``tests/test_torch_vendored.py`` holds. The block-streamed generator of the
host-RAM tiers is not ported yet (ROADMAP queue 1, item 11).

The reference snapshot's real corpora/checkpoints live on an unavailable NFS
volume (``config.py:16-24``, ``.MISSING_LARGE_BLOBS``), and its own test
harness is a simulation mode with canned docs (``data_source.py:106-111``).
This module is the stronger replacement: a deterministic generator that
produces, for any world,

* per-source document embeddings with per-source cluster structure,
* per-source centroids (the reference's ``*_stats.json`` centroid files,
  ``router.py:132-151``),
* queries with per-encoder embeddings and ground-truth relevant sources,
* doc payloads matching each world's document schema, so the full
  retrieve→rerank→prompt pipeline runs end to end.

Construction: each encoder gets a fixed random projection from a shared
latent space; each source gets a latent cluster center; documents are
projected noisy cluster samples; a query mixes 1..3 cluster centers. A
source is "relevant" iff its center is mixed in — routers can learn this,
and exact retrieval ground truth is computable by brute force.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ragroute_tpu_torch.config import WorldConfig, get_world

LATENT_DIM = 64


@dataclasses.dataclass
class SyntheticWorld:
    world: WorldConfig
    embeddings: Dict[str, np.ndarray]        # source -> [n_docs, d]
    centroids: Dict[str, np.ndarray]         # source -> [d] (mean doc emb)
    doc_payloads: Dict[str, list]            # source -> doc schema payloads
    doc_ids: Dict[str, list]                 # source -> id payloads
    query_embs: Dict[str, np.ndarray]        # encoder -> [Q, d_enc]
    relevant: np.ndarray                     # [Q, N] bool ground truth
    questions: List[dict]                    # question/options/answer dicts


def _doc_payload(world_name: str, source: str, i: int):
    """Match the per-world document schema the post-retrieval stages expect
    (medrag: title/content dicts, data_source.py:165-194; feb4rag: BEIR
    corpus entries, :143-163; wikipedia: (title, text) pairs, :196-215)."""
    if world_name == "medrag":
        return {
            "id": f"{source}_{i}",
            "title": f"{source} article {i}",
            "content": f"Synthetic {source} passage number {i}.",
        }
    if world_name == "feb4rag":
        return {
            "_id": f"{source}-doc{i}",
            "title": f"{source} doc {i}",
            "text": f"Synthetic {source} text number {i}.",
        }
    return (f"{source} page {i}", f"Synthetic wikipedia chunk {i} of cluster {source}.")


def _doc_id(world_name: str, source: str, i: int):
    """Id payloads mirroring the reference id-map entries
    (medrag metadatas {source,index}: data_source.py:73,190; feb4rag docid
    strings: :159; wikipedia local ints: :215)."""
    if world_name == "medrag":
        return {"source": f"{source}_chunk0", "index": i}
    if world_name == "feb4rag":
        return f"{source}-doc{i}"
    return i


def make_synthetic_world(
    world_name: str,
    *,
    docs_per_source: int = 4096,
    num_queries: int = 64,
    seed: int = 0,
    noise: float = 0.35,
    docs_per_source_map: Optional[Dict[str, int]] = None,
    with_payloads: bool = True,
    subclusters: int = 1,
) -> SyntheticWorld:
    """``subclusters > 1`` adds within-source topical structure: a single
    set of topic offsets is drawn in latent space and SHARED across
    sources (real federated corpora are topically aligned — a medical
    query hits the pharmacology region of every medical corpus), each
    source's docs sample from its center plus a topic offset (total
    per-source variance preserved, so router separability is unchanged),
    and each query targets ONE topic across its relevant sources. The
    default (1) keeps the original single-blob-per-source generator
    bit-for-bit — the worst case for cluster-probed search."""
    world = get_world(world_name)
    rng = np.random.default_rng(seed)
    n_src = world.num_sources

    # Per-encoder projection from the shared latent space (orthonormal-ish).
    proj: Dict[str, np.ndarray] = {}
    enc_dim = {s.encoder: s.embed_dim for s in world.sources}
    for enc in world.encoders:
        p = rng.standard_normal((LATENT_DIM, enc_dim[enc])).astype(np.float32)
        proj[enc] = p / np.sqrt(LATENT_DIM)

    # Latent cluster centers, one per source, well separated.
    centers = rng.standard_normal((n_src, LATENT_DIM)).astype(np.float32)
    centers *= 2.0

    embeddings: Dict[str, np.ndarray] = {}
    centroids: Dict[str, np.ndarray] = {}
    doc_payloads: Dict[str, list] = {}
    doc_ids: Dict[str, list] = {}
    topic_offsets = None
    if subclusters > 1:
        # shared topic offsets: scatter^2 + local^2 == noise^2 keeps the
        # source-level variance (and router separability) unchanged
        topic_offsets = (0.9 * noise) * rng.standard_normal(
            (subclusters, LATENT_DIM)).astype(np.float32)
    for si, src in enumerate(world.sources):
        n = (docs_per_source_map or {}).get(src.name, docs_per_source)
        if subclusters > 1:
            which = rng.integers(0, subclusters, n)
            z = (centers[si] + topic_offsets[which]
                 + (0.436 * noise) * rng.standard_normal(
                     (n, LATENT_DIM)).astype(np.float32))
        else:
            z = centers[si] + noise * rng.standard_normal(
                (n, LATENT_DIM)).astype(np.float32)
        emb = z @ proj[src.encoder]
        embeddings[src.name] = emb.astype(np.float32)
        centroids[src.name] = emb.mean(axis=0).astype(np.float32)
        if with_payloads:
            doc_payloads[src.name] = [
                _doc_payload(world_name, src.name, i) for i in range(n)]
            doc_ids[src.name] = [
                _doc_id(world_name, src.name, i) for i in range(n)]
        else:
            doc_payloads[src.name] = []
            doc_ids[src.name] = []

    # Queries: mix 1..3 source centers; relevance = mixed-in sources.
    relevant = np.zeros((num_queries, n_src), dtype=bool)
    latents = np.zeros((num_queries, LATENT_DIM), dtype=np.float32)
    for qi in range(num_queries):
        n_rel = int(rng.integers(1, min(3, n_src) + 1))
        chosen = rng.choice(n_src, size=n_rel, replace=False)
        relevant[qi, chosen] = True
        if subclusters > 1:
            # a query is about ONE topic, spanning its relevant sources
            mix = (centers[chosen].mean(axis=0)
                   + topic_offsets[rng.integers(0, subclusters)])
        else:
            mix = centers[chosen].mean(axis=0)
        latents[qi] = mix + 0.5 * noise * rng.standard_normal(LATENT_DIM)

    query_embs = {
        enc: (latents @ proj[enc]).astype(np.float32)
        for enc in world.encoders
    }

    letters = ["A", "B", "C", "D"]
    questions = []
    for qi in range(num_queries):
        ans = letters[int(rng.integers(0, 4))]
        questions.append({
            "qid": f"syn{qi}",
            "question": f"Synthetic question {qi} about "
                        f"{[world.sources[j].name for j in np.where(relevant[qi])[0]]}?",
            "options": {l: f"option {l} for q{qi}" for l in letters}
            if world_name == "medrag"
            else [f"option {l} for q{qi}" for l in letters],
            "answer": ans,
        })

    return SyntheticWorld(
        world=world,
        embeddings=embeddings,
        centroids=centroids,
        doc_payloads=doc_payloads,
        doc_ids=doc_ids,
        query_embs=query_embs,
        relevant=relevant,
        questions=questions,
    )


def save_world(syn: SyntheticWorld, root: str) -> str:
    """Persist a synthetic world in the framework's on-disk layout:

        <root>/<world>/<source>/{embeddings.npy, doc_ids.json}
        <root>/<world>/payloads/<source>.jsonl
        <root>/<world>/centroids.json       (the *_stats.json equivalent)
        <root>/<world>/queries/{<enc_idx>.npy, encoders.json, qids.json}
        <root>/<world>/relevant.npy         (ground-truth routing labels)
        <root>/<world>/benchmark/SYNTHETIC.json
        <root>/<world>/qrels.txt            (feb4rag: synthetic oracle qrels)
    """
    from ragroute_tpu_torch.benchmark import write_synthetic_benchmark
    from ragroute_tpu_torch.index.shard import ShardSet

    world = syn.world
    wroot = os.path.join(root, world.name)
    os.makedirs(wroot, exist_ok=True)
    for src in world.sources:
        ShardSet.save_source(root, world.name, src.name,
                             syn.embeddings[src.name],
                             doc_ids=syn.doc_ids[src.name])
        pdir = os.path.join(wroot, "payloads")
        os.makedirs(pdir, exist_ok=True)
        with open(os.path.join(pdir, f"{src.name}.jsonl"), "w") as f:
            for p in syn.doc_payloads[src.name]:
                f.write(json.dumps(p) + "\n")
    with open(os.path.join(wroot, "centroids.json"), "w") as f:
        json.dump({k: v.tolist() for k, v in syn.centroids.items()}, f)

    qdir = os.path.join(wroot, "queries")
    os.makedirs(qdir, exist_ok=True)
    encoders = list(world.encoders)
    with open(os.path.join(qdir, "encoders.json"), "w") as f:
        json.dump(encoders, f)
    for i, enc in enumerate(encoders):
        np.save(os.path.join(qdir, f"enc_{i}.npy"), syn.query_embs[enc])
    with open(os.path.join(qdir, "qids.json"), "w") as f:
        json.dump([q["qid"] for q in syn.questions], f)
    np.save(os.path.join(wroot, "relevant.npy"), syn.relevant)

    write_synthetic_benchmark(
        os.path.join(wroot, "benchmark"), syn.questions)

    if world.name == "feb4rag":
        # synthetic oracle qrels: the true top-k docs of each query get
        # graded relevance (BEIR-QRELS-RM.txt format, http_server.py:93-96)
        with open(os.path.join(wroot, "qrels.txt"), "w") as f:
            k = world.k
            for qi, q in enumerate(syn.questions):
                cands = _global_topk_ids(syn, qi, k)
                for rank, doc_id in enumerate(cands):
                    f.write(f"{q['qid']} 0 {doc_id} {k - rank}\n")
    return wroot


def _global_topk_ids(syn: SyntheticWorld, qi: int, k: int):
    """Exact global top-k doc ids for one query (brute force, host)."""
    world = syn.world
    scored = []
    for si, src in enumerate(world.sources):
        q = syn.query_embs[src.encoder][qi]
        docs = syn.embeddings[src.name]
        if src.score_mode == "cos":
            dn = docs / np.maximum(
                np.linalg.norm(docs, axis=1, keepdims=True), 1e-12)
            s = dn @ (q / max(np.linalg.norm(q), 1e-12))
        elif src.score_mode == "l2":
            s = -((docs - q) ** 2).sum(1)
        else:
            s = docs @ q
        order = np.argsort(-s, kind="stable")[:k]
        for li in order:
            scored.append((float(s[li]), syn.doc_ids[src.name][int(li)]))
    scored.sort(key=lambda t: -t[0])
    return [doc_id for _, doc_id in scored[:k]]


def contribution_labels(
    syn: SyntheticWorld, k: Optional[int] = None
) -> np.ndarray:
    """Reference-style router training labels: a source is positive iff it
    contributes at least one document to the GLOBAL top-k across all sources
    (train_medrag_router.py relevant_top_32 semantics, SURVEY §2).

    Computed by exact brute force in numpy (f32).
    """
    world = syn.world
    k = k or world.k
    nq = syn.relevant.shape[0]
    labels = np.zeros((nq, world.num_sources), dtype=bool)

    all_scores = []
    all_src = []
    for si, src in enumerate(world.sources):
        q = syn.query_embs[src.encoder]      # [Q, d]
        docs = syn.embeddings[src.name]      # [n, d]
        if src.score_mode == "cos":
            dn = docs / np.maximum(
                np.linalg.norm(docs, axis=1, keepdims=True), 1e-12)
            qn = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
            s = qn @ dn.T
        elif src.score_mode == "l2":
            s = -(
                (q * q).sum(1, keepdims=True)
                + (docs * docs).sum(1)[None, :]
                - 2.0 * q @ docs.T
            )
        else:
            s = q @ docs.T
        all_scores.append(s)
        all_src.append(np.full(s.shape[1], si))
    scores = np.concatenate(all_scores, axis=1)
    src_of = np.concatenate(all_src)
    order = np.argsort(-scores, axis=1)[:, :k]
    for qi in range(nq):
        labels[qi, np.unique(src_of[order[qi]])] = True
    return labels
