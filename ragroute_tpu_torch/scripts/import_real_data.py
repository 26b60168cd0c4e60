"""Import reference-layout corpora into the data root.

Counterpart of ``scripts/import_real_data.py``. The reference's corpora
live in its hardcoded layout (``ragroute/config.py:16-24``,
``data_source.py:45-64``); this importer converts those artifacts:

* FAISS flat index per source -> ``<world>/<source>/embeddings.npy``
  (parsed without faiss, :mod:`ragroute_tpu_torch.index.faiss_import`)
* id maps (medrag ``metadatas.jsonl`` / feb4rag ``docids.json``)
  -> ``<world>/<source>/doc_ids.json``
* corpus text in embedding-row order -> ``<world>/payloads/<source>.jsonl``
* per-source centroids (mean embedding) -> ``<world>/centroids.json``
* torch router checkpoint + sklearn scaler -> ``<world>/router.npz``
  (read without sklearn)
* FeB4RAG qrels -> ``<world>/qrels.txt``

``--encode-from-jsonl DIR`` builds the shards from raw ``<source>.jsonl``
corpora instead, encoding every document with the port's encoder forwards
on ``--device`` (default the card; the checkpoint from the local hub
cache, ``encoders/zoo.py``).

    python -m ragroute_tpu_torch.scripts.import_real_data --dataset medrag \\
        --corpus-root /mnt/.../MedRAG/corpus \\
        --router-ckpt /mnt/.../MedRAG/routing/best_model.pth \\
        --scaler /mnt/.../MedRAG/routing/preprocessed_data.pkl
"""

import argparse
import json
import os
import shutil
import time

import numpy as np

from ragroute_tpu_torch.config import DOC_SIDE_ENCODER, data_root, get_world
from ragroute_tpu_torch.index.faiss_import import read_flat_index
from ragroute_tpu_torch.index.shard import ShardSet
from ragroute_tpu_torch.utils.precision import resolve_device


def import_medrag_source(corpus_root: str, source: str, out_root: str):
    """Reference layout: <corpus>/<source>/index/ncbi/MedCPT-Article-Encoder/
    {faiss.index, metadatas.jsonl}; text in <corpus>/<source>/chunk/*.jsonl
    (data_source.py:45-48,165-194)."""
    idx_dir = os.path.join(corpus_root, source, "index",
                           "ncbi", "MedCPT-Article-Encoder")
    emb, _ = read_flat_index(os.path.join(idx_dir, "faiss.index"))
    with open(os.path.join(idx_dir, "metadatas.jsonl")) as f:
        metadatas = [json.loads(line) for line in f.read().strip().split("\n")]
    if len(metadatas) != emb.shape[0]:
        raise ValueError(f"{source}: {len(metadatas)} metadatas for "
                         f"{emb.shape[0]} index rows")
    ShardSet.save_source(out_root, "medrag", source, emb, doc_ids=metadatas)

    # payloads in embedding-row order: fetch each (chunkfile, line)
    pay_dir = os.path.join(out_root, "medrag", "payloads")
    os.makedirs(pay_dir, exist_ok=True)
    cache = {}
    with open(os.path.join(pay_dir, f"{source}.jsonl"), "w") as out:
        for m in metadatas:
            src_file, line_idx = m["source"], m["index"]
            if src_file not in cache:
                p = os.path.join(corpus_root, source, "chunk",
                                 f"{src_file}.jsonl")
                with open(p) as f:
                    cache[src_file] = f.read().strip().split("\n")
            out.write(cache[src_file][line_idx].strip() + "\n")
    return emb


def import_feb4rag_source(feb_root: str, source: str, encoder: str,
                          out_root: str):
    """Reference layout (data_source.py:49-53,143-163)."""
    idx_dir = os.path.join(feb_root, "dataset_creation", "2_search",
                           "embeddings", source)
    emb, _ = read_flat_index(
        os.path.join(idx_dir, f"{source}_{encoder}.faiss"))
    with open(os.path.join(idx_dir, f"{source}_{encoder}.docids.json")) as f:
        docids = json.load(f)
    ShardSet.save_source(out_root, "feb4rag", source, emb, doc_ids=docids)

    corpus_path = os.path.join(feb_root, "dataset_creation",
                               "original_dataset", source, source,
                               "corpus.jsonl")
    by_id = {}
    with open(corpus_path) as f:
        for line in f:
            e = json.loads(line)
            by_id[e["_id"]] = line.strip()
    pay_dir = os.path.join(out_root, "feb4rag", "payloads")
    os.makedirs(pay_dir, exist_ok=True)
    with open(os.path.join(pay_dir, f"{source}.jsonl"), "w") as out:
        for doc_id in docids:
            out.write(by_id.get(doc_id, "null") + "\n")
    return emb


def _doc_text(world_name: str, payload) -> str:
    """Raw text to embed per world schema (doc-side concat semantics:
    '{title} {text}'.strip(), reference custom_models.py:47-53,113-116;
    medrag chunks carry title/content, data_source.py:165-194)."""
    if isinstance(payload, (list, tuple)):
        return f"{payload[0]} {payload[1]}".strip()      # wikipedia pair
    if world_name == "medrag":
        return (f"{payload.get('title', '')} "
                f"{payload.get('content', payload.get('contents', ''))}"
                ).strip()
    return (f"{payload.get('title', '')} "
            f"{payload.get('text', '')}").strip()         # BEIR schema


def encode_from_jsonl(world, jsonl_dir: str, out_root: str, *,
                      doc_encoder: str = None, batch_size: int = 32,
                      prefer: str = "torch", limit: int = None,
                      device="cuda") -> dict:
    """Build a world's shards from RAW corpus jsonl by encoding doc-side.

    ``<jsonl_dir>/<source>.jsonl`` -> embeddings.npy + doc_ids.json +
    payloads/<source>.jsonl + centroids.json under the data root. Each
    source encodes with its own encoder's doc-side semantics (E5
    "passage: " prefixes, SGPT braces, instructor corpus instructions);
    ``doc_encoder`` overrides the encoder for ALL sources (medrag /
    wikipedia default to the article / context encoders that built the
    reference indexes, ``DOC_SIDE_ENCODER``). Returns ``{source: {"docs",
    "seconds" (the encode's wall time), "backend"}}``.
    """
    from ragroute_tpu_torch.encoders.zoo import (encode_corpus_batched,
                                                 load_encoder, resolve_spec)

    wroot = os.path.join(out_root, world.name)
    pay_dir = os.path.join(wroot, "payloads")
    os.makedirs(pay_dir, exist_ok=True)
    centroids = {}
    enc_cache = {}
    timings = {}
    for src in world.sources:
        path = os.path.join(jsonl_dir, f"{src.name}.jsonl")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no corpus jsonl for {world.name}/{src.name}: {path}")
        payloads, texts, ids = [], [], []
        with open(path) as f:
            for i, line in enumerate(f):
                if limit and i >= limit:
                    break
                line = line.strip()
                if not line:
                    continue
                p = json.loads(line)
                payloads.append(line)
                texts.append(_doc_text(world.name, p))
                if isinstance(p, dict):
                    ids.append(p.get("_id", p.get("id", len(ids))))
                else:
                    ids.append(len(ids))
        enc_name = (doc_encoder
                    or DOC_SIDE_ENCODER.get(world.name, src.encoder))
        if enc_name not in enc_cache:
            enc_cache[enc_name] = load_encoder(
                resolve_spec(enc_name, src.embed_dim), prefer, device)
        enc = enc_cache[enc_name]
        t0 = time.perf_counter()
        emb = encode_corpus_batched(enc, texts, batch_size) \
            .astype(np.float32)
        secs = time.perf_counter() - t0
        if emb.shape[1] != src.embed_dim:
            raise ValueError(
                f"{src.name}: encoder {enc_name} produced dim "
                f"{emb.shape[1]} != source dim {src.embed_dim}")
        ShardSet.save_source(out_root, world.name, src.name, emb,
                             doc_ids=ids)
        with open(os.path.join(pay_dir, f"{src.name}.jsonl"), "w") as out:
            out.write("\n".join(payloads) + "\n")
        centroids[src.name] = emb.mean(axis=0).tolist()
        timings[src.name] = {"docs": emb.shape[0], "seconds": secs,
                             "backend": enc.backend}
        print(f"  {src.name}: encoded {emb.shape[0]} docs in {secs:.3f} s "
              f"({emb.shape[0] / secs:.1f} docs/s; {enc_name}, backend "
              f"{enc.backend})")
    with open(os.path.join(wroot, "centroids.json"), "w") as f:
        json.dump(centroids, f)
    return timings


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", required=True,
                        choices=["medrag", "feb4rag", "wikipedia"])
    parser.add_argument("--corpus-root", required=False, default=None,
                        help="reference corpus tree root")
    parser.add_argument("--encode-from-jsonl", default=None,
                        help="Directory of raw <source>.jsonl corpora to "
                             "ENCODE into shards (instead of importing "
                             "prebuilt FAISS indexes)")
    parser.add_argument("--doc-encoder", default=None,
                        help="Override doc-side encoder name for "
                             "--encode-from-jsonl")
    parser.add_argument("--encode-batch-size", type=int, default=32)
    parser.add_argument("--encode-prefer", default="torch",
                        choices=["torch", "hash"],
                        help="torch: the port's forward from a local "
                             "checkpoint (hash stub without one); hash: "
                             "hash embeddings")
    parser.add_argument("--limit", type=int, default=None,
                        help="Max docs per source (--encode-from-jsonl)")
    parser.add_argument("--router-ckpt", default=None,
                        help="torch .pth/.pt router checkpoint")
    parser.add_argument("--scaler", default=None,
                        help="sklearn scaler pickle (medrag/wikipedia)")
    parser.add_argument("--qrels", default=None,
                        help="BEIR-QRELS-RM.txt (feb4rag)")
    parser.add_argument("--data-root", default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="encoding device for --encode-from-jsonl: cuda "
                             "(or cuda:N); cpu for tests")
    return parser, parser.parse_args(argv)


def main(argv=None):
    parser, args = parse_args(argv)
    dev = resolve_device(args.device)
    world = get_world(args.dataset)
    out_root = args.data_root or data_root()
    wroot = os.path.join(out_root, world.name)
    os.makedirs(wroot, exist_ok=True)

    if args.encode_from_jsonl:
        print(f"encoding {world.name} corpora from {args.encode_from_jsonl}")
        timings = encode_from_jsonl(
            world, args.encode_from_jsonl, out_root,
            doc_encoder=args.doc_encoder,
            batch_size=args.encode_batch_size,
            prefer=args.encode_prefer, limit=args.limit, device=dev)
        print(f"encoded {world.name} into {wroot}")
        return timings
    if not args.corpus_root:
        parser.error("--corpus-root is required unless --encode-from-jsonl")

    centroids = {}
    for src in world.sources:
        print(f"importing {src.name}...")
        if world.name == "medrag":
            emb = import_medrag_source(args.corpus_root, src.name, out_root)
        elif world.name == "feb4rag":
            emb = import_feb4rag_source(args.corpus_root, src.name,
                                        src.encoder, out_root)
        else:
            emb, _ = read_flat_index(os.path.join(
                args.corpus_root, "faiss_clusters", "normalized_indexes",
                f"faiss_index_{src.name}_normalized.index"))
            ShardSet.save_source(out_root, "wikipedia", src.name, emb)
        centroids[src.name] = emb.mean(axis=0).tolist()
        print(f"  {emb.shape[0]} docs x {emb.shape[1]}d")

    with open(os.path.join(wroot, "centroids.json"), "w") as f:
        json.dump(centroids, f)

    if args.router_ckpt:
        from ragroute_tpu_torch.router.torch_import import (
            load_sklearn_scaler, load_torch_router, save_router_npz)

        router = load_torch_router(args.router_ckpt)
        scaler = load_sklearn_scaler(args.scaler) if args.scaler else None
        save_router_npz(os.path.join(wroot, "router.npz"),
                        router.state_dict(),
                        threshold=world.router_threshold, scaler=scaler)
        print("router checkpoint imported")

    if args.qrels:
        shutil.copy(args.qrels, os.path.join(wroot, "qrels.txt"))

    print(f"imported {world.name} into {wroot}")
    return None


if __name__ == "__main__":
    main()
