"""ctypes bindings for the native (C++) mmap jsonl doc store.

Replaces the reference's whole-file-into-RAM corpus caches
(``data_source.py:143-183``) with an mmap + packed offset index built by
``native/docstore.cpp``: O(1) resident memory, zero-copy line access, OS
page cache for hot docs.

The shared library is built on demand with g++ (toolchain is part of the
target environment); callers should use :func:`native_available` and fall
back to :class:`ragroute_tpu_torch.index.store.JsonlDirDocStore` when a compiler
is genuinely absent.
"""

from __future__ import annotations

import ctypes
import json
import logging
import os
import subprocess
import threading
from typing import Dict, Optional

logger = logging.getLogger("native_store")

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "docstore.cpp")
_LIB_DIR = os.path.join(_REPO_ROOT, "native", "build")
_LIB = os.path.join(_LIB_DIR, "libdocstore.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _build() -> bool:
    os.makedirs(_LIB_DIR, exist_ok=True)
    # compile to a per-process temp path and publish with an atomic
    # rename: concurrent builds (--workers N boots one per process)
    # must never CDLL another process's half-written .so, and an
    # interrupted build must not leave a corrupt file that poisons
    # every later boot
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB)
        return True
    except Exception as e:
        logger.warning("native docstore build failed: %s", e)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        if not os.path.exists(_LIB) or (
            os.path.exists(_SRC)
            and os.path.getmtime(_SRC) > os.path.getmtime(_LIB)
        ):
            if not _build():
                _build_failed = True
                return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError as e:
            # a stale/corrupt .so must degrade to the Python store, not
            # crash the boot; rebuild once in case the file predates the
            # atomic-publish fix
            logger.warning("native docstore load failed (%s); rebuilding", e)
            if not _build():
                _build_failed = True
                return None
            try:
                lib = ctypes.CDLL(_LIB)
            except OSError as e2:
                logger.warning("native docstore unusable: %s", e2)
                _build_failed = True
                return None
        lib.ds_open.argtypes = [ctypes.c_char_p]
        lib.ds_open.restype = ctypes.c_void_p
        lib.ds_count.argtypes = [ctypes.c_void_p]
        lib.ds_count.restype = ctypes.c_int64
        lib.ds_get.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                               ctypes.POINTER(ctypes.c_int64)]
        lib.ds_get.restype = ctypes.c_void_p
        lib.ds_lengths.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_int32),
                                   ctypes.c_int64]
        lib.ds_lengths.restype = ctypes.c_int64
        lib.ds_close.argtypes = [ctypes.c_void_p]
        lib.ds_close.restype = None
        _lib = lib
        return lib


def native_available() -> bool:
    return _load() is not None


class NativeJsonlDocStore:
    """DocStore over ``<root>/<source>.jsonl`` files, native-indexed.

    Lazy per-source open (like the reference's lazy caches); ``get``
    returns the parsed JSON payload for a local line index.
    """

    def __init__(self, root: str):
        lib = _load()
        if lib is None:
            raise RuntimeError("native docstore unavailable (g++ missing?)")
        self._lib = lib
        self.root = root
        self._handles: Dict[str, int] = {}

    def _handle(self, source: str) -> Optional[int]:
        if source not in self._handles:
            path = os.path.join(self.root, f"{source}.jsonl")
            h = self._lib.ds_open(path.encode())
            self._handles[source] = h  # may be None/0 for missing files
        return self._handles[source]

    def count(self, source: str) -> int:
        h = self._handle(source)
        return int(self._lib.ds_count(h)) if h else 0

    def get_raw(self, source: str, local_idx: int) -> Optional[bytes]:
        h = self._handle(source)
        if not h:
            return None
        ln = ctypes.c_int64()
        ptr = self._lib.ds_get(h, local_idx, ctypes.byref(ln))
        if not ptr:
            return None
        return ctypes.string_at(ptr, ln.value)

    def get(self, source: str, local_idx: int):
        raw = self.get_raw(source, local_idx)
        if raw is None:
            return None
        return json.loads(raw)

    def raw_lengths(self, source: str):
        """All line lengths of a source as one int32 numpy array (one
        native call — used to precompute response-size tables)."""
        import numpy as np

        h = self._handle(source)
        if not h:
            return None
        n = int(self._lib.ds_count(h))
        out = np.zeros(max(n, 1), dtype=np.int32)
        got = self._lib.ds_lengths(
            h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n)
        return out[:max(int(got), 0)]

    def close(self) -> None:
        for h in self._handles.values():
            if h:
                self._lib.ds_close(h)
        self._handles.clear()

    def __del__(self):  # best-effort
        try:
            self.close()
        except Exception:
            pass


def make_doc_store(root: str):
    """Best-available jsonl doc store for a payloads directory."""
    if native_available():
        return NativeJsonlDocStore(root)
    from ragroute_tpu_torch.index.store import JsonlDirDocStore

    logger.warning("falling back to Python jsonl doc store")
    return JsonlDirDocStore(root)
