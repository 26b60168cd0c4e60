"""Build and load the port's CUDA kernels at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface and loaded with
:mod:`ctypes` (no PyTorch headers, so the build stays short). The library
lands in ``csrc/build/`` under a file name that carries a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, so a changed
source is never served stale; :func:`build_all` starts one ``nvcc`` per
source at the same time; the build
writes a per-process temporary file and renames it into place, so
concurrent builds never load a half-written library.

Nothing here runs at import time: the CPU test machine has no ``nvcc``.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Sequence, Tuple

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
BUILD_DIR = os.path.join(CSRC, "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: str
    seconds: float      # nvcc wall time; 0.0 when an existing build was reused
    ptxas: str          # nvcc's -Xptxas -v report (registers, smem, spills)


_lock = threading.Lock()
_loaded: Dict[str, Tuple[ctypes.CDLL, BuildInfo]] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin); the CUDA kernels are "
            "built at first use on a machine with the CUDA toolkit")
    return nvcc


def build(name: str) -> BuildInfo:
    """Compile ``csrc/<name>.cu`` unless a build of this exact source and
    flag set exists; return where the library is."""
    src = os.path.join(CSRC, f"{name}.cu")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
    if os.path.exists(out):
        return BuildInfo(out, 0.0, "")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) for {src}:\n{proc.stderr}")
    os.replace(tmp, out)
    return BuildInfo(out, seconds, proc.stderr)


def load(name: str) -> Tuple[ctypes.CDLL, BuildInfo]:
    """The loaded library for ``csrc/<name>.cu`` (built on first call)."""
    with _lock:
        hit = _loaded.get(name)
        if hit is None:
            info = build(name)
            hit = (ctypes.CDLL(info.path), info)
            _loaded[name] = hit
        return hit


def kernel_sources() -> Tuple[str, ...]:
    """The name of every kernel source, ``csrc/<name>.cu``."""
    return tuple(sorted(os.path.splitext(os.path.basename(p))[0]
                        for p in glob.glob(os.path.join(CSRC, "*.cu"))))


def build_all(names: Sequence[str]) -> Dict[str, BuildInfo]:
    """Compile several sources at once (one ``nvcc`` process each, all
    started together) and load them; returns each one's build report."""
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        infos = dict(zip(names, pool.map(build, names)))
    with _lock:
        for name, info in infos.items():
            if name not in _loaded:
                _loaded[name] = (ctypes.CDLL(info.path), info)
    return {name: _loaded[name][1] for name in names}
