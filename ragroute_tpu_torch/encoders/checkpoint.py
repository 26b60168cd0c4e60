"""Local checkpoint reading without ``transformers``.

The JAX package loads its encoders through ``from_pretrained(...,
local_files_only=True)``. The port reads the same files itself, so it
serves on a machine that has torch and nothing of the Hugging Face stack:

* :func:`resolve` finds a checkpoint directory: ``hf_name`` itself when it
  is a directory, else the hub cache's
  ``models--{org}--{name}/snapshots/<refs/main>/`` under ``HF_HUB_CACHE``,
  then ``HF_HOME/hub``, then ``~/.cache/huggingface/hub``;
* :func:`read_config` reads ``config.json``;
* :func:`load_state_dict` reads ``model.safetensors`` through
  :func:`read_safetensors` (an 8-byte header length, a JSON header, then the
  raw tensors), or ``pytorch_model.bin`` through ``torch.load(...,
  weights_only=True)``, sharded ``*.index.json`` checkpoints included;
* :func:`find_instructor_dense` finds an instructor checkpoint's
  sentence-transformers ``2_Dense`` module.

:func:`write_safetensors` writes the format back (tests and the chip smoke
make checkpoints with it).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Optional, Tuple

import numpy as np
import torch

SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in SAFETENSORS_DTYPES.items()}

WEIGHT_FILES = ("model.safetensors", "model.safetensors.index.json",
                "pytorch_model.bin", "pytorch_model.bin.index.json")


def hub_cache_dirs() -> list:
    """The hub caches searched, in order."""
    dirs = []
    if os.environ.get("HF_HUB_CACHE"):
        dirs.append(os.environ["HF_HUB_CACHE"])
    if os.environ.get("HF_HOME"):
        dirs.append(os.path.join(os.environ["HF_HOME"], "hub"))
    dirs.append(os.path.join(os.path.expanduser("~"), ".cache",
                             "huggingface", "hub"))
    return dirs


def hub_snapshot_dir(cache: str, hf_name: str) -> str:
    """``<cache>/models--{org}--{name}``: where a hub name lives."""
    return os.path.join(cache, "models--" + hf_name.replace("/", "--"))


def resolve(hf_name: str) -> Optional[str]:
    """The checkpoint directory of ``hf_name``, or None when no local copy
    exists (a directory, or the ``refs/main`` snapshot in a hub cache)."""
    if os.path.isdir(hf_name):
        return hf_name
    for cache in hub_cache_dirs():
        repo = hub_snapshot_dir(cache, hf_name)
        ref = os.path.join(repo, "refs", "main")
        if not os.path.isfile(ref):
            continue
        with open(ref) as f:
            commit = f.read().strip()
        snap = os.path.join(repo, "snapshots", commit)
        if os.path.isdir(snap):
            return snap
    return None


def read_config(path: str) -> dict:
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, on the CPU."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dtype = SAFETENSORS_DTYPES.get(meta["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype "
                             f"{meta['dtype']}, which the reader does not take")
        begin, end = meta["data_offsets"]
        shape = tuple(meta["shape"])
        size = dtype.itemsize
        count = int(np.prod(shape, dtype=np.int64)) if shape else 1
        if end - begin != count * size or end > len(data):
            raise ValueError(f"{path}: tensor {name!r} has offsets "
                             f"{begin}..{end} for {count} x {size} bytes")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        buf = data if begin % size == 0 else bytearray(data[begin:end])
        off = begin if buf is data else 0
        out[name] = torch.frombuffer(buf, dtype=dtype, count=count,
                                     offset=off).reshape(shape)
    return out


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor]) -> None:
    """Write ``tensors`` (any device) as one ``.safetensors`` file."""
    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        t = t.detach().contiguous().cpu()
        raw = t.view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": _DTYPE_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for raw in blobs:
            f.write(raw)


def _read_weights(path: str) -> Dict[str, torch.Tensor]:
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The checkpoint's state dict (CPU tensors) from the first weight file
    of :data:`WEIGHT_FILES` that exists; a ``*.index.json`` names the
    shards."""
    for name in WEIGHT_FILES:
        fpath = os.path.join(path, name)
        if not os.path.isfile(fpath):
            continue
        if not name.endswith(".index.json"):
            return _read_weights(fpath)
        with open(fpath) as f:
            shards = sorted(set(json.load(f)["weight_map"].values()))
        out = {}
        for shard in shards:
            out.update(_read_weights(os.path.join(path, shard)))
        return out
    raise FileNotFoundError(f"{path}: no weight file (one of {WEIGHT_FILES})")


def find_instructor_dense(hf_name: str
                          ) -> Optional[Tuple[np.ndarray, Optional[np.ndarray]]]:
    """The sentence-transformers ``2_Dense`` module of an instructor-*
    checkpoint (stack Transformer -> Pooling -> Dense; skipping it would
    serve another embedding space) as ``(kernel [d_in, d_out], bias |
    None)`` numpy arrays, or None when the checkpoint has none."""
    path = resolve(hf_name)
    if path is None:
        return None
    for name in ("2_Dense/pytorch_model.bin", "2_Dense/model.safetensors"):
        fpath = os.path.join(path, name)
        if os.path.exists(fpath):
            sd = _read_weights(fpath)
            w = sd["linear.weight"].float().numpy()      # torch [out, in]
            b = sd.get("linear.bias")
            return w.T.copy(), (None if b is None else b.float().numpy())
    return None
