"""Host-side document payload stores.

The reference fetches raw doc text on the data-source process after FAISS
search (``data_source.py:143-215``: lazy in-RAM jsonl caches, corpus-file
line indexing). Here only the final merged top-k ids ever need text, so
the store is a thin host lookup applied after the device step.

Stores:

* :class:`MemoryDocStore`    — payloads held in RAM (synthetic worlds,
  small corpora).
* :class:`JsonlDirDocStore`  — lazy line-indexed jsonl corpus files with an
  in-RAM cache (the reference's medrag/feb4rag layout). A native C++
  mmap-indexed variant plugs in via :mod:`ragroute_tpu_torch.index.native_store`
  when built.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Optional, Protocol, Sequence


class DocStore(Protocol):
    def get(self, source: str, local_idx: int):
        """Return the document payload for a (source, local index) pair."""
        ...


class MemoryDocStore:
    def __init__(self, payloads: Mapping[str, Sequence]):
        self._p = payloads

    def get(self, source: str, local_idx: int):
        seq = self._p.get(source)
        if seq is None or local_idx >= len(seq):
            return None
        return seq[local_idx]

    def get_raw(self, source: str, local_idx: int) -> Optional[str]:
        """Serialized payload (enables the server's raw response
        splicing; the server LRU-caches these per (source, idx))."""
        p = self.get(source, local_idx)
        return None if p is None else json.dumps(p)

    @classmethod
    def from_synthetic(cls, syn) -> "MemoryDocStore":
        return cls(syn.doc_payloads)


class OverlayDocStore:
    """Writable overlay over any base store, for live document updates.

    Lookups hit the overlay first (payloads of docs added at serve time,
    keyed by (source, slot)), then fall through to the base store. Slots
    freed by a delete are masked so a recycled slot never leaks the old
    payload from the base store.
    """

    def __init__(self, base: Optional[DocStore] = None):
        self.base = base
        self._overlay: Dict[tuple, object] = {}

    def set(self, source: str, local_idx: int, payload) -> None:
        self._overlay[(source, local_idx)] = payload

    def delete(self, source: str, local_idx: int) -> None:
        self._overlay[(source, local_idx)] = None

    def get(self, source: str, local_idx: int):
        key = (source, local_idx)
        if key in self._overlay:
            return self._overlay[key]
        if self.base is not None:
            return self.base.get(source, local_idx)
        return None

    def raw_lengths(self, source: str):
        # message-size tables come from the base corpus; overlay docs are
        # estimated by the server's fallback path
        fn = getattr(self.base, "raw_lengths", None)
        return fn(source) if fn else None

    def get_raw(self, source: str, local_idx: int):
        if (source, local_idx) in self._overlay:
            p = self._overlay[(source, local_idx)]
            return None if p is None else json.dumps(p)
        fn = getattr(self.base, "get_raw", None)
        return fn(source, local_idx) if fn else None


class JsonlDirDocStore:
    """``<root>/<source>.jsonl`` corpora with lazy line caches.

    Mirrors the reference's ``idx2txt`` caches (``data_source.py:143-183``):
    raw lines are cached as strings, parsed only when requested.
    """

    def __init__(self, root: str):
        self.root = root
        self._cache: Dict[str, list] = {}

    def _lines(self, source: str) -> list:
        if source not in self._cache:
            path = os.path.join(self.root, f"{source}.jsonl")
            with open(path, "r") as f:
                self._cache[source] = f.read().strip().split("\n")
        return self._cache[source]

    def get(self, source: str, local_idx: int):
        lines = self._lines(source)
        if local_idx >= len(lines):
            return None
        return json.loads(lines[local_idx])
