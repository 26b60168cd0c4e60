"""Device-resident corpus embedding shards (immutable).

PyTorch port of :mod:`ragroute_tpu.index.shard`. A shard is a dense
``[n_pad, d]`` tensor of document embeddings on the serving device (bf16 by
default; f32 for strict parity runs; int8 with per-doc scales; int4 packed
two codes per byte with per-group scales), padded to
``SHARD_PAD_MULTIPLE`` rows whose gain-form bias is ``-inf`` so padding can
never win, plus the gain-form bias (``-|d|^2`` for l2) and, for lossy
dtypes of dot/l2 shards, the mean the stored rows were centred on.

Every host-side step (normalization, centring, quantization, packing,
padding, the bf16 cast) runs on the host and is bit-identical to the
reference's: the quantizers below are numpy copies of the reference's
(the port imports nothing of the JAX package). Only the final bytes cross
to the device.

A shard may also carry a balanced-IVF layout (``ivf``,
:mod:`ragroute_tpu_torch.index.ivf`) and a low-rank coarse index (``lr``,
:mod:`ragroute_tpu_torch.index.lowrank`) for the approximate search modes;
the flat layout is always kept. Live add/delete, snapshot and mesh builds
are not ported yet (ROADMAP queue 1, items 9 and 14).

On-disk layout (shared with the reference):

    <root>/<world>/<source>/embeddings.npy   # [n_docs, d] float32
    <root>/<world>/<source>/doc_ids.json     # list of doc id payloads
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ragroute_tpu_torch.config import (INT4_GROUP_DIMS, LOWRANK_ENERGY,
                                       SHARD_PAD_MULTIPLE, WorldConfig)
from ragroute_tpu_torch.index.ivf import (IVFData, build_ivf,
                                          ivf_fingerprint, load_ivf,
                                          save_ivf)
from ragroute_tpu_torch.index.lowrank import (LowRankData, build_lowrank,
                                              load_lowrank, save_lowrank)

logger = logging.getLogger("shard")

StorageDType = Union[torch.dtype, str]   # a torch dtype, or "int4"

STORAGE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                  "int8": torch.int8, "int4": "int4"}


def parse_storage_dtype(dtype) -> bool:
    """True when ``dtype`` is the packed-int4 marker string ``"int4"``
    (storage is int8 bytes holding two codes); rejects any other string.
    Shared by :meth:`ShardSet.build` and :func:`index.ivf.build_ivf`."""
    packed4 = isinstance(dtype, str) and dtype == "int4"
    if isinstance(dtype, str) and not packed4:
        raise ValueError(f"unknown dtype string {dtype!r} "
                         f"(only 'int4' is a string dtype)")
    return packed4


def _quantize_sym(emb: np.ndarray, levels: int,
                  mse_opt: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Per-doc symmetric quantization to ``[-levels, levels]`` codes
    (numpy copy of the reference's; see its docstring for the int4
    ``mse_opt`` clip search and norm correction)."""
    if not mse_opt:
        amax = np.abs(emb).max(axis=1)
        s_row = np.where(amax <= 0.0, 1.0, amax / float(levels))
        s_row = s_row.astype(np.float32)
        codes = np.clip(np.round(emb / s_row[:, None]),
                        -levels, levels).astype(np.int8)
        return codes, s_row
    best_err = best_codes = best_s = None
    for pct in (90.0, 95.0, 97.0, 99.0, 99.9, None):
        amax = (np.abs(emb).max(axis=1) if pct is None
                else np.percentile(np.abs(emb), pct, axis=1))
        s = np.maximum(amax / float(levels), 1e-12).astype(np.float32)
        codes = np.clip(np.round(emb / s[:, None]),
                        -levels, levels).astype(np.int8)
        err = ((codes.astype(np.float32) * s[:, None] - emb) ** 2).sum(1)
        if best_err is None:
            best_err, best_codes, best_s = err, codes, s
        else:
            m = err < best_err
            best_err = np.where(m, err, best_err)
            best_codes[m] = codes[m]
            best_s = np.where(m, s, best_s)
    deq_norm = np.linalg.norm(
        best_codes.astype(np.float32) * best_s[:, None], axis=1)
    true_norm = np.linalg.norm(emb, axis=1)
    fix = np.where(deq_norm > 0,
                   true_norm / np.maximum(deq_norm, 1e-12), 1.0)
    return best_codes, (best_s * fix).astype(np.float32)


def _quantize_sym_grouped(emb: np.ndarray, levels: int, group_dims: int
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-(doc, group) MSE-optimal quantization: ``(codes [n, d] int8,
    scales [n, G] f32)``."""
    n, d = emb.shape
    if d % group_dims:
        raise ValueError(f"dim {d} not divisible by group {group_dims}")
    g = d // group_dims
    codes, scales = _quantize_sym(
        emb.reshape(n * g, group_dims), levels, mse_opt=True)
    return codes.reshape(n, d), scales.reshape(n, g)


def _pack_int4(codes: np.ndarray) -> np.ndarray:
    """Pack int4 codes ``[n, d]`` into bytes ``[n, d/2]``: byte j carries
    dim j in its low nibble and dim j + d/2 in its high nibble."""
    n, d = codes.shape
    if d % 2:
        raise ValueError(f"int4 packing needs an even embed dim, got {d}")
    h = d // 2
    lo = codes[:, :h].astype(np.int16)
    hi = codes[:, h:].astype(np.int16)
    return (((hi << 4) | (lo & 0xF)) & 0xFF).astype(np.uint8).view(np.int8)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _to_device(arr: np.ndarray, device, dtype=None) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:      # a read-only mmap of embeddings.npy
        arr = arr.copy()
    t = torch.from_numpy(arr)
    if dtype is not None:
        t = t.to(dtype)        # host-side cast: only final bytes cross
    return t.to(device)


@dataclasses.dataclass
class DeviceShard:
    """One corpus shard on the serving device."""

    docs: torch.Tensor                 # [n_pad, d] f32/bf16/int8 ([n_pad, d/2] int4)
    bias: torch.Tensor                 # [n_pad] f32 gain-form bias, -inf on padding
    scale: Optional[torch.Tensor]      # [n_pad] (int8) or [n_pad, G] (int4) f32
    center: Optional[torch.Tensor]     # [d] f32 mean subtracted from docs
    n_docs: int
    name: str
    score_mode: str
    packed4: bool = False
    ivf: Optional[IVFData] = None      # balanced-IVF layout (approx mode)
    lr: Optional[LowRankData] = None   # low-rank coarse index, or refused

    @property
    def scan_docs(self) -> int:
        """Rows handed to the scoring kernels (immutable: the build-time
        doc count; rows past it are padding)."""
        return self.n_docs


@dataclasses.dataclass
class ShardSet:
    """All shards of a federated world + host-side doc id tables."""

    world: WorldConfig
    shards: List[DeviceShard]
    doc_ids: Dict[str, Optional[list]]
    # True when build() was asked for low-rank coarse indexes (a shard may
    # still have lr=None where the build refused a flat spectrum: it falls
    # back to the exact scan at search time)
    lowrank_built: bool = False

    @classmethod
    def build(cls, world: WorldConfig, embeddings: Mapping[str, np.ndarray],
              *, doc_ids: Optional[Mapping[str, Sequence]] = None,
              dtype: StorageDType = torch.bfloat16,
              normalize_cos: bool = True, device="cpu",
              ivf_clusters: Optional[int] = None, ivf_seed: int = 0,
              ivf_cache_dirs: Optional[Mapping[str, str]] = None,
              lowrank: Optional[int] = None,
              lowrank_energy: Optional[float] = None) -> "ShardSet":
        """Build every source's shard from ``[n_docs, d]`` float arrays
        (native dims) and place it on ``device``.

        ``dtype``: torch.float32 | torch.bfloat16 | torch.int8 | "int4".

        ``ivf_clusters``: also build a balanced-IVF layout per shard for
        ``impl="ivf"`` / ``"hybrid"``. ``0`` / ``None`` skips it; ``-1``
        uses the per-shard default cluster count (~4*sqrt(n)); a positive
        value is the cluster count C. ``ivf_seed`` seeds k-means.

        ``lowrank``: also build a rank-``r`` coarse projection per shard
        for ``impl="lowrank"``. ``0`` / ``None`` skips it; ``-1`` picks the
        rank by spectral energy (``lowrank_energy``, default
        ``config.LOWRANK_ENERGY``); a positive value is the rank. A shard
        whose spectrum is too flat gets ``lr=None``.

        ``ivf_cache_dirs``: source name -> directory of ``.npz`` layout
        caches (both kinds). The file name carries every build parameter
        and the file a fingerprint of the source embeddings; the format is
        the JAX package's, so either package reads the other's caches.
        """
        packed4 = parse_storage_dtype(dtype)
        shards: List[DeviceShard] = []
        ids: Dict[str, Optional[list]] = {}
        for src in world.sources:
            if src.name not in embeddings:
                raise KeyError(f"missing embeddings for source {src.name!r}")
            emb = np.asarray(embeddings[src.name], dtype=np.float32)
            if emb.ndim != 2 or emb.shape[1] != src.embed_dim:
                raise ValueError(f"{src.name}: embeddings shape {emb.shape} "
                                 f"!= [n, {src.embed_dim}]")
            if emb.shape[0] < world.k:
                raise ValueError(
                    f"{src.name}: only {emb.shape[0]} docs but k={world.k}; "
                    f"a shard must hold at least k documents")
            if src.score_mode == "cos" and normalize_cos:
                norms = np.linalg.norm(emb, axis=1, keepdims=True)
                emb = emb / np.maximum(norms, 1e-12)
            center = None
            if src.score_mode in ("l2", "dot") and dtype != torch.float32:
                # mean-centre lossy-dtype shards: the rounding error is
                # relative to the full magnitude, the ranking lives in the
                # residual (reference shard.py:416-433)
                mu = emb.mean(axis=0, dtype=np.float64).astype(np.float32)
                emb = emb - mu
                center = _to_device(mu, device)
            packed_rows = row_scales = None
            if packed4 and ivf_clusters:
                # quantize once: build_ivf's slot rows are these same
                # vectors rearranged, so the flat codes are handed over.
                # Shards built with an IVF layout keep per-doc scales (the
                # grouped GEMM and the flat scan score identical bytes)
                codes, row_scales = _quantize_sym(emb, 7, mse_opt=True)
                packed_rows = _pack_int4(codes)
                del codes
            cache_dir = (ivf_cache_dirs or {}).get(src.name)
            fp = (ivf_fingerprint(emb)
                  if cache_dir and (ivf_clusters or lowrank) else None)
            ivf = None
            if ivf_clusters:
                cache = None
                if cache_dir:
                    tag = "auto" if ivf_clusters < 0 else str(ivf_clusters)
                    dname = ("int4" if packed4
                             else str(dtype).replace("torch.", ""))
                    cache = os.path.join(
                        cache_dir, f"ivf_{tag}_{dname}_s{ivf_seed}.npz")
                if cache and os.path.exists(cache):
                    ivf = load_ivf(cache, expect_fingerprint=fp,
                                   device=device)
                if ivf is None:
                    t0 = time.perf_counter()
                    ivf = build_ivf(
                        emb, src.score_mode, dtype=dtype,
                        n_clusters=(None if ivf_clusters < 0
                                    else ivf_clusters),
                        seed=ivf_seed, device=device,
                        packed_rows=packed_rows, row_scales=row_scales)
                    logger.info("%s: ivf layout built in %.1f s", src.name,
                                time.perf_counter() - t0)
                    if cache:
                        os.makedirs(cache_dir, exist_ok=True)
                        save_ivf(ivf, cache, fingerprint=fp)
            n = emb.shape[0]
            n_pad = _round_up(max(n, SHARD_PAD_MULTIPLE), SHARD_PAD_MULTIPLE)
            lr = None
            if lowrank:
                energy = (LOWRANK_ENERGY if lowrank_energy is None
                          else lowrank_energy)
                cache = None
                if cache_dir:
                    tag = f"auto{energy:g}" if lowrank < 0 else str(lowrank)
                    cache = os.path.join(cache_dir, f"lr_{tag}.npz")
                if cache and os.path.exists(cache):
                    lr = load_lowrank(cache, expect_fingerprint=fp,
                                      device=device)
                if lr is None:
                    t0 = time.perf_counter()
                    lr = build_lowrank(
                        emb, n_pad=n_pad,
                        rank=(None if lowrank < 0 else lowrank),
                        energy=energy, device=device)
                    logger.info("%s: low-rank coarse index built in %.1f s",
                                src.name, time.perf_counter() - t0)
                    if cache and lr is not None:
                        os.makedirs(cache_dir, exist_ok=True)
                        save_lowrank(lr, cache, fingerprint=fp)
            if n_pad != n:
                emb = np.pad(emb, ((0, n_pad - n), (0, 0)))
            if src.score_mode == "l2":
                b_np = -np.einsum("nd,nd->n", emb, emb,
                                  dtype=np.float32, optimize=True)
            else:
                b_np = np.zeros(n_pad, np.float32)
            b_np[n:] = -np.inf
            scale = None
            if packed_rows is not None:
                # quantized above (shared with build_ivf); pad rows carry
                # code 0 / scale 1e-12, bit-identical to quantizing the
                # zero pad rows
                pad = n_pad - n
                docs = _to_device(np.pad(packed_rows, ((0, pad), (0, 0))),
                                  device)
                scale = _to_device(
                    np.pad(row_scales, (0, pad),
                           constant_values=np.float32(1e-12)), device)
            elif packed4:
                if src.embed_dim % INT4_GROUP_DIMS == 0:
                    codes, s_row = _quantize_sym_grouped(emb, 7,
                                                         INT4_GROUP_DIMS)
                else:
                    codes, s_row = _quantize_sym(emb, 7, mse_opt=True)
                docs = _to_device(_pack_int4(codes), device)
                scale = _to_device(s_row, device)
            elif dtype == torch.int8:
                codes, s_row = _quantize_sym(emb, 127)
                docs = _to_device(codes, device)
                scale = _to_device(s_row, device)
            else:
                docs = _to_device(emb, device, dtype)
            shards.append(DeviceShard(
                docs=docs, bias=_to_device(b_np, device), scale=scale,
                center=center, n_docs=n, name=src.name,
                score_mode=src.score_mode, packed4=packed4, ivf=ivf,
                lr=lr))
            ids[src.name] = (list(doc_ids[src.name])
                             if doc_ids and src.name in doc_ids else None)
        return cls(world=world, shards=shards, doc_ids=ids,
                   lowrank_built=bool(lowrank))

    @property
    def device(self) -> torch.device:
        return self.shards[0].docs.device

    @property
    def total_docs(self) -> int:
        return sum(s.n_docs for s in self.shards)

    @property
    def index_bytes(self) -> int:
        return sum(s.docs.numel() * s.docs.element_size()
                   + s.bias.numel() * 4 for s in self.shards)

    @property
    def aux_bytes(self) -> int:
        """Bytes of the extra layouts (IVF slabs, low-rank coarse slabs)
        beside the flat index that :attr:`index_bytes` counts."""
        return sum((s.ivf.nbytes if s.ivf is not None else 0)
                   + (s.lr.nbytes if s.lr is not None else 0)
                   for s in self.shards)

    def arrays(self):
        """Per shard ``(docs, bias, scale, center)``."""
        return [(s.docs, s.bias, s.scale, s.center) for s in self.shards]

    def ivf_arrays(self):
        """Per-shard balanced-IVF layouts (None where not built)."""
        return [s.ivf for s in self.shards]

    def lr_arrays(self):
        """Per-shard low-rank coarse indexes (None where not built or
        where the build refused a flat-spectrum corpus)."""
        return [s.lr for s in self.shards]

    # -- persistence --------------------------------------------------------

    @staticmethod
    def source_dir(root: str, world_name: str, source: str) -> str:
        return os.path.join(root, world_name, source)

    @classmethod
    def save_source(cls, root: str, world_name: str, source: str,
                    embeddings: np.ndarray,
                    doc_ids: Optional[Sequence] = None) -> None:
        d = cls.source_dir(root, world_name, source)
        os.makedirs(d, exist_ok=True)
        np.save(os.path.join(d, "embeddings.npy"),
                np.asarray(embeddings, np.float32))
        if doc_ids is not None:
            with open(os.path.join(d, "doc_ids.json"), "w") as f:
                json.dump(list(doc_ids), f)

    @classmethod
    def load(cls, root: str, world: WorldConfig, *,
             dtype: StorageDType = torch.bfloat16, **kw) -> "ShardSet":
        """Load every source of a world from ``<root>/<world>/<source>/``
        (IVF / low-rank layouts are cached there as ``.npz``)."""
        embeddings = {}
        doc_ids = {}
        cache_dirs = {}
        for src in world.sources:
            d = cls.source_dir(root, world.name, src.name)
            emb_path = os.path.join(d, "embeddings.npy")
            if not os.path.exists(emb_path):
                raise FileNotFoundError(
                    f"no shard data for {world.name}/{src.name} under {root} "
                    f"(expected {emb_path}); generate a synthetic world with "
                    f"ragroute_tpu_torch.index.synthetic or import corpora")
            embeddings[src.name] = np.load(emb_path, mmap_mode="r")
            cache_dirs[src.name] = d
            ids_path = os.path.join(d, "doc_ids.json")
            if os.path.exists(ids_path):
                with open(ids_path) as f:
                    doc_ids[src.name] = json.load(f)
        kw.setdefault("ivf_cache_dirs", cache_dirs)
        return cls.build(world, embeddings, doc_ids=doc_ids, dtype=dtype,
                         **kw)
