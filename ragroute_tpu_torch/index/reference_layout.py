"""Write a world in the reference's on-disk layout.

The input of :mod:`ragroute_tpu_torch.scripts.import_real_data`, for
rehearsals of the import without the reference's corpora:

* :func:`write_flat_index`: a FAISS flat index file (``IxFI`` inner
  product / ``IxF2`` L2), the serialization
  :mod:`ragroute_tpu_torch.index.faiss_import` parses, made without faiss;
* :func:`write_medrag_corpus`: per source
  ``<corpus>/<source>/index/ncbi/MedCPT-Article-Encoder/{faiss.index,
  metadatas.jsonl}`` and the text in ``<corpus>/<source>/chunk/*.jsonl``
  (``data_source.py:45-48,165-194``), each row's payload at the chunk file
  and line its metadata names, in an order shuffled from a seed so that an
  importer must follow the metadata to put payloads in row order;
* :func:`write_reference_router`: ``best_model.pth`` (a ``CorpusRoutingNN``
  state dict under the reference's keys) and ``preprocessed_data.pkl`` (the
  5-tuple whose element 3 is a sklearn ``StandardScaler``, written in
  sklearn's pickle layout without sklearn).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Mapping, Sequence, Tuple

import numpy as np
import torch

from ragroute_tpu_torch.router.torch_import import dump_preprocessed_data

_FOURCC = {"ip": (b"IxFI", 0), "l2": (b"IxF2", 1)}
MEDRAG_INDEX_DIR = os.path.join("index", "ncbi", "MedCPT-Article-Encoder")


def write_flat_index(path: str, vecs: np.ndarray, metric: str = "ip") -> None:
    """``vecs`` ``[n, d]`` as a trained FAISS flat index file."""
    fourcc, metric_type = _FOURCC[metric]
    vecs = np.ascontiguousarray(vecs, np.float32)
    n, d = vecs.shape
    with open(path, "wb") as f:
        f.write(fourcc)
        f.write(struct.pack("<i", d))
        f.write(struct.pack("<q", n))
        f.write(struct.pack("<qq", 1 << 20, 1 << 20))  # deprecated dummies
        f.write(struct.pack("<b", 1))                   # is_trained
        f.write(struct.pack("<i", metric_type))
        f.write(struct.pack("<Q", vecs.nbytes))
        vecs.tofile(f)


def write_medrag_corpus(corpus_root: str,
                        embeddings: Mapping[str, np.ndarray],
                        payloads: Mapping[str, Sequence[dict]], *,
                        chunk_rows: int = 1000, seed: int = 0) -> None:
    """Each source's rows as a FAISS flat IP index, its metadatas and its
    chunk files (``chunk_rows`` payloads a file, rows shuffled)."""
    rng = np.random.default_rng(seed)
    for source, emb in embeddings.items():
        idx_dir = os.path.join(corpus_root, source, MEDRAG_INDEX_DIR)
        chunk_dir = os.path.join(corpus_root, source, "chunk")
        os.makedirs(idx_dir, exist_ok=True)
        os.makedirs(chunk_dir, exist_ok=True)
        write_flat_index(os.path.join(idx_dir, "faiss.index"), emb, "ip")
        rows = payloads[source]
        order = rng.permutation(len(rows))
        where = [None] * len(rows)
        for c in range(0, len(rows), chunk_rows):
            name = f"{source}_{c // chunk_rows:04d}"
            with open(os.path.join(chunk_dir, f"{name}.jsonl"), "w") as f:
                for line, r in enumerate(order[c:c + chunk_rows]):
                    f.write(json.dumps(rows[r]) + "\n")
                    where[r] = {"index": line, "source": name}
        with open(os.path.join(idx_dir, "metadatas.jsonl"), "w") as f:
            for m in where:
                f.write(json.dumps(m) + "\n")


def write_reference_router(out_dir: str,
                           state_dict: Mapping[str, torch.Tensor],
                           mean, scale, items: Sequence = (None,) * 4
                           ) -> Tuple[str, str]:
    """``best_model.pth`` and ``preprocessed_data.pkl`` under ``out_dir``;
    returns their paths."""
    os.makedirs(out_dir, exist_ok=True)
    pth = os.path.join(out_dir, "best_model.pth")
    torch.save({k: v.detach().cpu().clone() for k, v in state_dict.items()},
               pth)
    pkl = os.path.join(out_dir, "preprocessed_data.pkl")
    with open(pkl, "wb") as f:
        f.write(dump_preprocessed_data(items, mean, scale))
    return pth, pkl
