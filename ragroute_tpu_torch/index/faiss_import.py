"""Import FAISS flat indexes without the faiss library.

The port's own copy of :mod:`ragroute_tpu.index.faiss_import`, held to it
by ``tests/test_torch_vendored.py``.

The reference's per-source indexes are FAISS flat files
(``data_source.py:69-80`` — exact search over raw float32 vectors). To
move real corpora into this framework on machines without ``faiss-cpu``,
this module parses the IndexFlat serialization directly:

    fourcc (4 bytes: "IxFI" inner-product | "IxF2" L2 | "IxFl" generic)
    d (int32), ntotal (int64), dummy (2x int64, deprecated),
    is_trained (int8), metric_type (int32),
    codes: size (uint64), then ntotal*d float32

When ``faiss`` IS importable we use it instead (also handles IVF etc. via
``reconstruct_n``). Layout assumptions are validated against the file size
before trusting the parse.
"""

from __future__ import annotations

import os
import struct
from typing import Tuple

import numpy as np

_FLAT_FOURCC = {b"IxFI": "ip", b"IxF2": "l2", b"IxFl": "flat"}


def read_flat_index(path: str) -> Tuple[np.ndarray, str]:
    """Return ``(embeddings [n, d] float32, metric)`` from a FAISS flat
    index file. Raises ValueError for non-flat indexes."""
    try:
        import faiss  # pragma: no cover - optional

        index = faiss.read_index(path)
        vecs = index.reconstruct_n(0, index.ntotal)
        metric = "ip" if index.metric_type == faiss.METRIC_INNER_PRODUCT \
            else "l2"
        return np.asarray(vecs, np.float32), metric
    except ImportError:
        pass

    size = os.path.getsize(path)
    with open(path, "rb") as f:
        fourcc = f.read(4)
        if fourcc not in _FLAT_FOURCC:
            raise ValueError(
                f"{path}: fourcc {fourcc!r} is not a FAISS flat index "
                "(IVF/HNSW etc. need the faiss library installed)")
        d = struct.unpack("<i", f.read(4))[0]
        ntotal = struct.unpack("<q", f.read(8))[0]
        f.read(16)  # two deprecated int64 fields
        is_trained = struct.unpack("<b", f.read(1))[0]
        metric_type = struct.unpack("<i", f.read(4))[0]
        nbytes = struct.unpack("<Q", f.read(8))[0]
        header = f.tell()
        expected = ntotal * d * 4
        if nbytes != expected or size < header + expected:
            raise ValueError(
                f"{path}: layout mismatch (d={d}, ntotal={ntotal}, "
                f"codes={nbytes}, file={size}); parse with faiss instead")
        data = np.fromfile(f, dtype=np.float32, count=ntotal * d)
    metric = "ip" if metric_type == 0 else "l2"
    if not is_trained:
        raise ValueError(f"{path}: index not trained?")
    return data.reshape(ntotal, d), metric
