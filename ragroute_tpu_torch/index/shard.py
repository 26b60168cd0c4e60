"""Device-resident corpus embedding shards, immutable or live.

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
to the device. :func:`encode_rows` is that treatment as one function, shared
with the host-RAM tiers (:mod:`ragroute_tpu_torch.index.streamed`).

A shard may also carry a balanced-IVF layout (``ivf``,
:mod:`ragroute_tpu_torch.index.ivf`) and a low-rank coarse index (``lr``,
:mod:`ragroute_tpu_torch.index.lowrank`) for the approximate search modes;
the flat layout is always kept. A mutable shard set (``build(mutable=True,
reserve_docs=)``) takes live adds and deletes: liveness rides the bias
(``-inf`` on a free slot), the scoring kernels scan the whole capacity, and
an update is an in-place write of exactly its rows into ``docs``, ``bias``
and ``scale`` on the device's current stream, so a step queued before it
reads the old rows and one queued after it the new. :meth:`ShardSet.snapshot`
writes the live corpus back to the data root.

A shard set may mix storage dtypes: ``dtype`` and ``lowrank`` take one value
or a mapping from source name to value (the per-shard picks of
``--dtype policy``, :func:`ragroute_tpu_torch.config.store_dtype_policy`).
``device="host"`` stages the shards as CPU tensors for
:class:`ragroute_tpu_torch.parallel.ShardedSearch`, which places each
cell's row slice on its device, so a corpus never lands whole on one card.

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
from ragroute_tpu_torch.index.ivf import (IVFData, _bf16_from_bits, _np,
                                          build_ivf, ivf_fingerprint,
                                          load_ivf, save_ivf)
from ragroute_tpu_torch.index.lowrank import (LowRankData, build_lowrank,
                                              load_lowrank, save_lowrank)

logger = logging.getLogger("shard")

StorageDType = Union[torch.dtype, str]   # a torch dtype, or "int4"

STORAGE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                  "int8": torch.int8, "int4": "int4"}


def _atomic_np_save(path: str, arr: np.ndarray) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:  # a handle: np.save(str) appends .npy
        np.save(f, arr)
    os.replace(tmp, path)


def _atomic_json_dump(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def _id_key(d):
    """Hashable key for a doc-id payload (payloads may be JSON objects)."""
    try:
        hash(d)
        return d
    except TypeError:
        return json.dumps(d, sort_keys=True, default=str)


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
    # each row's magnitudes sorted once: a percentile and the max depend
    # only on a row's values, and selection in sorted rows is cheap
    mags = np.sort(np.abs(emb), axis=1)
    for pct in (90.0, 95.0, 97.0, 99.0, 99.9, None):
        amax = (mags[:, -1] if pct is None
                else np.percentile(mags, pct, axis=1))
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


def _gain_bias(emb: np.ndarray, score_mode: str) -> np.ndarray:
    """Gain-form bias of stored-form f32 rows: ``-|d|^2`` for l2, else 0."""
    if score_mode == "l2":
        return -np.einsum("nd,nd->n", emb, emb, dtype=np.float32,
                          optimize=True)
    return np.zeros(emb.shape[0], np.float32)


def encode_rows(emb: np.ndarray, score_mode: str, *, dtype: StorageDType,
                packed4: bool, center: Optional[np.ndarray] = None,
                norm_cos: bool = True
                ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Raw f32 rows into stored form: cos normalization, mean-centring, the
    l2 gain bias and the dtype's quantization, all on the host. Returns
    ``(stored, bias, scale)`` as numpy arrays; bfloat16 rows come back as
    their uint16 bit pattern (numpy has no bfloat16).

    One function for :meth:`ShardSet.build` and the host-RAM tiers
    (:mod:`ragroute_tpu_torch.index.streamed`), so host rows and device
    rows are the same bytes."""
    emb = np.asarray(emb, dtype=np.float32)
    if score_mode == "cos" and norm_cos:
        emb = emb / np.maximum(
            np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
    if center is not None:
        emb = emb - np.asarray(center, np.float32)
    bias = _gain_bias(emb, score_mode)
    scale = None
    if packed4:
        if emb.shape[1] % INT4_GROUP_DIMS == 0:
            codes, scale = _quantize_sym_grouped(emb, 7, INT4_GROUP_DIMS)
        else:
            codes, scale = _quantize_sym(emb, 7, mse_opt=True)
        stored = _pack_int4(codes)
    elif dtype == torch.int8:
        stored, scale = _quantize_sym(emb, 127)
    elif dtype == torch.bfloat16:
        # the cast goes through torch (round to nearest even)
        stored = _np(torch.from_numpy(np.ascontiguousarray(emb))
                     .to(torch.bfloat16))
    else:
        stored = emb
    return stored, bias.astype(np.float32), scale


def _per_source(value, name: str):
    """One build argument for one source: the mapping's entry (``None`` for
    a source it does not name), or the value itself."""
    if isinstance(value, Mapping):
        return value.get(name)
    return value


def _storage_dtype(dtype) -> StorageDType:
    """A torch dtype, ``"int4"``, or a name of :data:`STORAGE_DTYPES`."""
    if isinstance(dtype, str) and dtype != "int4":
        if dtype not in STORAGE_DTYPES:
            raise ValueError(f"unknown dtype string {dtype!r}")
        return STORAGE_DTYPES[dtype]
    return dtype


def _to_device(arr: np.ndarray, device) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:      # a read-only mmap of embeddings.npy
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)   # only final bytes cross


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
    mutable: bool = False              # live adds / deletes (see ShardSet)

    @property
    def scan_docs(self) -> int:
        """Rows handed to the scoring kernels: the build-time doc count for
        an immutable shard (rows past it are padding), the whole capacity
        for a mutable one, whose liveness rides the bias alone (``-inf`` on
        a free slot)."""
        return self.docs.shape[0] if self.mutable else self.n_docs

    @property
    def capacity(self) -> int:
        return self.docs.shape[0]


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
    # mutable-mode bookkeeping (build(mutable=True)): live doc counts and
    # free slot stacks per source
    _live: Optional[Dict[str, int]] = None
    _free: Optional[Dict[str, List[int]]] = None
    # snapshot(): the build-time rows (an mmap of embeddings.npy under
    # load()) and the raw f32 rows of every live added doc by slot; the
    # device rows are lossy, so a snapshot is written from these
    _orig_emb: Optional[Dict[str, np.ndarray]] = None
    _added_rows: Optional[Dict[str, Dict[int, np.ndarray]]] = None
    # build()'s normalize_cos, applied to added rows as to the corpus
    _norm_cos: bool = True

    @classmethod
    def build(cls, world: WorldConfig, embeddings: Mapping[str, np.ndarray],
              *, doc_ids: Optional[Mapping[str, Sequence]] = None,
              dtype=torch.bfloat16,
              normalize_cos: bool = True, device="cpu",
              ivf_clusters: Optional[int] = None, ivf_seed: int = 0,
              ivf_cache_dirs: Optional[Mapping[str, str]] = None,
              lowrank=None,
              lowrank_energy: Optional[float] = None,
              mutable: bool = False, reserve_docs: int = 0) -> "ShardSet":
        """Build every source's shard from ``[n_docs, d]`` float arrays
        (native dims) and place it on ``device``.

        ``dtype``: torch.float32 | torch.bfloat16 | torch.int8 | "int4", or
        a mapping from source name to one of them (a mixed set).
        ``device="host"``: CPU tensors, staged for a mesh engine.

        ``ivf_clusters``: also build a balanced-IVF layout per shard for
        ``impl="ivf"`` / ``"hybrid"``. ``0`` / ``None`` skips it; ``-1``
        uses the per-shard default cluster count (~4*sqrt(n)); a positive
        value is the cluster count C. ``ivf_seed`` seeds k-means.

        ``lowrank``: also build a rank-``r`` coarse projection per shard
        for ``impl="lowrank"``. ``0`` / ``None`` skips it; ``-1`` picks the
        rank by spectral energy (``lowrank_energy``, default
        ``config.LOWRANK_ENERGY``); a positive value is the rank; a mapping
        from source name to one of these builds only the sources it names
        with a value. A shard whose spectrum is too flat gets ``lr=None``.

        ``ivf_cache_dirs``: source name -> directory of ``.npz`` layout
        caches (both kinds). The file name carries every build parameter
        and the file a fingerprint of the source embeddings; the format is
        the JAX package's, so either package reads the other's caches.

        ``mutable``: take live adds and deletes (:meth:`add_docs`,
        :meth:`delete_docs`); ``reserve_docs`` free slots a shard beyond its
        docs (capacity ``round_up(n + reserve_docs, 512)``). Refused with
        an IVF or low-rank layout, which an update would leave stale.
        """
        if mutable and str(device) == "host":
            raise ValueError(
                "device='host' (mesh staging) and mutable live updates "
                "are incompatible: the updates are device writes")
        if str(device) == "host":
            device = "cpu"
        if mutable and ivf_clusters:
            raise ValueError(
                "mutable shards cannot carry a balanced-IVF layout "
                "(adds/deletes would leave the cluster slabs stale); "
                "build with ivf_clusters=None and rebuild the IVF layout "
                "offline when the corpus settles")
        if mutable and lowrank:
            raise ValueError(
                "mutable shards cannot carry a low-rank coarse index "
                "(adds/deletes would leave the projected slab stale); "
                "build with lowrank=None and rebuild offline when the "
                "corpus settles")
        shards: List[DeviceShard] = []
        ids: Dict[str, Optional[list]] = {}
        all_dtype, all_lowrank = dtype, lowrank
        for src in world.sources:
            dtype = _storage_dtype(_per_source(all_dtype, src.name))
            if dtype is None:
                raise KeyError(f"no storage dtype for source {src.name!r}")
            lowrank = _per_source(all_lowrank, src.name)
            packed4 = parse_storage_dtype(dtype)
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
            n_pad = _round_up(max(n + (reserve_docs if mutable else 0),
                                  SHARD_PAD_MULTIPLE), SHARD_PAD_MULTIPLE)
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
            scale = None
            if packed_rows is not None:
                # quantized above (shared with build_ivf); pad rows carry
                # code 0 / scale 1e-12, bit-identical to quantizing the
                # zero pad rows
                pad = n_pad - n
                b_np = _gain_bias(emb, src.score_mode)
                docs = _to_device(np.pad(packed_rows, ((0, pad), (0, 0))),
                                  device)
                scale = _to_device(
                    np.pad(row_scales, (0, pad),
                           constant_values=np.float32(1e-12)), device)
            else:
                # emb is already normalized, centred and padded
                stored, b_np, s_row = encode_rows(
                    emb, src.score_mode, dtype=dtype, packed4=packed4,
                    norm_cos=False)
                docs = (_bf16_from_bits(stored).to(device)
                        if dtype == torch.bfloat16
                        else _to_device(stored, device))
                if s_row is not None:
                    scale = _to_device(s_row, device)
            b_np[n:] = -np.inf
            shards.append(DeviceShard(
                docs=docs, bias=_to_device(b_np, device), scale=scale,
                center=center, n_docs=n, name=src.name,
                score_mode=src.score_mode, packed4=packed4, ivf=ivf,
                lr=lr, mutable=mutable))
            ids[src.name] = (list(doc_ids[src.name])
                             if doc_ids and src.name in doc_ids else None)
        lowrank_built = (any(all_lowrank.values())
                         if isinstance(all_lowrank, Mapping)
                         else bool(all_lowrank))
        out = cls(world=world, shards=shards, doc_ids=ids,
                  lowrank_built=lowrank_built)
        if mutable:
            out._norm_cos = normalize_cos
            out._live = {s.name: s.n_docs for s in shards}
            out._free = {s.name: list(range(s.capacity - 1, s.n_docs - 1, -1))
                         for s in shards}
            # references only: under load() these are read-only mmaps
            out._orig_emb = {s.name: embeddings[s.name] for s in shards}
            out._added_rows = {s.name: {} for s in shards}
        return out

    @property
    def device(self) -> torch.device:
        return self.shards[0].docs.device

    @property
    def total_docs(self) -> int:
        if self._live is not None:
            return sum(self._live.values())
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


    # -- live updates (mutable shards) --------------------------------------

    @property
    def mutable(self) -> bool:
        return self._free is not None

    def _mutable_index(self, source: str) -> int:
        if self._free is None:
            raise ValueError(
                "live updates need ShardSet.build(mutable=True); this set "
                "was built immutable")
        for si, s in enumerate(self.shards):
            if s.name == source:
                return si
        raise KeyError(f"unknown source {source!r}")

    def live_docs(self, source: str) -> int:
        """Current live doc count of a mutable shard."""
        self._mutable_index(source)
        return self._live[source]

    def free_slots(self, source: str) -> int:
        self._mutable_index(source)
        return len(self._free[source])

    def add_docs(self, source: str, embeddings: np.ndarray,
                 doc_ids: Optional[Sequence] = None) -> List[int]:
        """Insert documents into a live shard; returns their slots.

        The rows get the build's treatment (:func:`encode_rows`: cos
        normalization as built, the frozen build-time centre, the gain bias,
        the int8 / int4 scales) and are written in place into free slots,
        exactly ``m`` rows (``index_copy_``; no repeated slot, whose write
        order on the card would be undefined). The next step sees them."""
        si = self._mutable_index(source)
        shard = self.shards[si]
        src = self.world.sources[si]
        emb = np.asarray(embeddings, dtype=np.float32)
        if emb.ndim != 2 or emb.shape[1] != src.embed_dim:
            raise ValueError(
                f"{source}: add shape {emb.shape} != [m, {src.embed_dim}]")
        m = emb.shape[0]
        if doc_ids is not None and len(doc_ids) != m:
            raise ValueError(
                f"{source}: {len(doc_ids)} doc_ids for {m} embeddings")
        free = self._free[source]
        if m > len(free):
            raise ValueError(
                f"{source}: adding {m} docs but only {len(free)} free "
                f"slots (capacity {shard.capacity}, live "
                f"{self._live[source]}); build with a larger reserve_docs "
                f"or delete first")
        raw = emb.copy()   # the rows as given, kept for snapshot()
        dtype = "int4" if shard.packed4 else shard.docs.dtype
        stored, brows, srows = encode_rows(
            emb, src.score_mode, dtype=dtype, packed4=shard.packed4,
            center=(None if shard.center is None
                    else shard.center.cpu().numpy()),
            norm_cos=self._norm_cos)
        slots = [free.pop() for _ in range(m)]
        dev = shard.docs.device
        idx = torch.tensor(slots, dtype=torch.int64, device=dev)
        rows = (_bf16_from_bits(stored).to(dev)
                if shard.docs.dtype == torch.bfloat16
                else _to_device(stored, dev))
        shard.docs.index_copy_(0, idx, rows)
        shard.bias.index_copy_(0, idx, _to_device(brows, dev))
        if shard.scale is not None:
            shard.scale.index_copy_(0, idx, _to_device(srows, dev))
        for i, sl in enumerate(slots):
            self._added_rows[source][sl] = raw[i]

        table = self.doc_ids.get(source)
        if table is None and doc_ids is not None:
            # docs so far were named by local index; a slot freed before
            # the table existed stays None (its old index must not come
            # back as an id), and an id-less add in the reserve area keeps
            # its slot as its id
            dead = set(free) | set(slots)
            table = [None if s in dead else s for s in range(shard.n_docs)]
            table.extend([None] * (shard.capacity - len(table)))
            for s in self._added_rows[source]:
                if s not in dead and s >= shard.n_docs:
                    table[s] = s
            self.doc_ids[source] = table
        if table is not None:
            if len(table) < shard.capacity:
                table.extend([None] * (shard.capacity - len(table)))
            for sl, did in zip(
                    slots, doc_ids if doc_ids is not None else slots):
                table[sl] = did
        self._live[source] += m
        return slots

    def delete_docs(self, source: str, *,
                    doc_ids: Optional[Sequence] = None,
                    slots: Optional[Sequence[int]] = None) -> List[int]:
        """Remove documents from a live shard (by id payload or by slot):
        their bias becomes ``-inf`` in place, so no scan can select them,
        and the slots return to the free list."""
        si = self._mutable_index(source)
        shard = self.shards[si]
        table = self.doc_ids.get(source)
        if (doc_ids is None) == (slots is None):
            raise ValueError("pass exactly one of doc_ids= / slots=")
        if doc_ids is not None:
            if table is None:
                raise ValueError(
                    f"{source} has no doc-id table; delete by slots=")
            pos = {_id_key(d): i for i, d in enumerate(table)
                   if d is not None}
            missing = [d for d in doc_ids if _id_key(d) not in pos]
            if missing:
                raise KeyError(f"{source}: unknown doc ids {missing[:5]}")
            slots = [pos[_id_key(d)] for d in doc_ids]
        slots = [int(s) for s in slots]
        free_set = set(self._free[source])
        bad = [s for s in slots
               if s < 0 or s >= shard.capacity or s in free_set]
        if bad or len(set(slots)) != len(slots):
            raise ValueError(
                f"{source}: invalid/free/duplicate slots in delete: "
                f"{(bad or 'duplicates')!r:.80s}")
        if slots:
            idx = torch.tensor(slots, dtype=torch.int64,
                               device=shard.bias.device)
            shard.bias.index_fill_(0, idx, float("-inf"))
        self._free[source].extend(slots)
        if table is not None:
            for sl in slots:
                table[sl] = None
        added = self._added_rows[source]
        for sl in slots:
            added.pop(sl, None)
        self._live[source] -= len(slots)
        return slots

    def live_slots(self, source: str) -> List[int]:
        """Ascending slots of every live document of a mutable shard (the
        order :meth:`snapshot` compacts to)."""
        si = self._mutable_index(source)
        live = np.ones(self.shards[si].capacity, dtype=bool)
        live[np.asarray(self._free[source], dtype=np.int64)] = False
        return np.flatnonzero(live).tolist()

    def snapshot(self, root: str) -> Dict[str, dict]:
        """Write the live state of a mutable world back to the data root:
        ``<root>/<world>/<source>/embeddings.npy`` (the f32 rows of every
        live doc as they were given, in ascending slot order) and
        ``doc_ids.json`` where an id table exists, each through a temporary
        file and a rename, so the next :meth:`load` serves this corpus.
        Returns ``{source: {"live_docs": n, "slots": [...]}}``, the old
        slot of each new row, for compacting side tables alike."""
        if self._free is None:
            raise ValueError(
                "snapshot() needs ShardSet.build(mutable=True); immutable "
                "worlds are already durable in the data root")
        report: Dict[str, dict] = {}
        for si, shard in enumerate(self.shards):
            name = shard.name
            added = self._added_rows[name]
            slots = self.live_slots(name)
            rows = np.empty((len(slots), self.world.sources[si].embed_dim),
                            np.float32)
            slot_arr = np.asarray(slots, dtype=np.int64)
            is_added = np.isin(slot_arr, np.fromiter(added, np.int64,
                                                     len(added)))
            build_pos = np.flatnonzero(~is_added)
            if build_pos.size:
                rows[build_pos] = np.asarray(
                    self._orig_emb[name][slot_arr[build_pos]], np.float32)
            for i in np.flatnonzero(is_added):
                rows[i] = added[slots[i]]
            d = self.source_dir(root, self.world.name, name)
            os.makedirs(d, exist_ok=True)
            _atomic_np_save(os.path.join(d, "embeddings.npy"), rows)
            table = self.doc_ids.get(name)
            if table is not None:
                _atomic_json_dump(os.path.join(d, "doc_ids.json"),
                                  [table[s] for s in slots])
            report[name] = {"live_docs": len(slots), "slots": slots}
        return report

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
             dtype=torch.bfloat16, **kw) -> "ShardSet":
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
