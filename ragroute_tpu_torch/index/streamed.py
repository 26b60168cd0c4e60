"""Host-RAM corpus tiers: serve corpora bigger than the device budget.

PyTorch port of :mod:`ragroute_tpu.index.streamed`. Two tiers, both built on
the same host-resident stored-row format:

* ``tier="stream"``: the resident prefix of every shard lives in device
  memory as usual; overflow rows live in host RAM as quantized slabs that
  the engine uploads (pinned memory, asynchronous copies on a side stream,
  ``STREAM_PREFETCH`` slabs in flight) and scans with the same fused kernel,
  merging through a running top-k.

* ``tier="hostrefine"``: a rank-``r`` int8 coarse projection of EVERY row
  stays on the device; the device scans it exhaustively (or probes its
  clustered layout, :mod:`ragroute_tpu_torch.ops.grouped_topk`) and returns
  only ``[B, k']`` candidate ids per routed source; the host gathers those
  ``k'`` rows from its RAM store and rescores them EXACTLY (the stored-form
  arithmetic of the device kernel, centring restore included), then merges.
  This is the two-stage ``impl="lowrank"`` design with the refine store
  moved off the device: a true winner is lost only when it falls outside
  the coarse top-k'.

Sources small enough to fit their share of the device budget stay fully
resident and exact in both tiers (water-filling allocation, smallest
first).

The host side (encode, coarse build, rescore) is numpy, with the arithmetic
and the chunk sizes of the JAX package, so both packages build the same
bytes from the same rows. The host rows of the stream tier are allocated as
pinned torch tensors when the device is a CUDA card and exposed as numpy
views of the same memory: uploads read them without a staging copy, the
rescore fancy-indexes them.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import logging
import os
import weakref
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ragroute_tpu_torch.config import (INT4_GROUP_DIMS, LOWRANK_ENERGY,
                                       LOWRANK_MOMENT_SAMPLE_ROWS,
                                       SHARD_PAD_MULTIPLE,
                                       STREAM_HBM_BUDGET_GB, STREAM_SLAB_MB,
                                       WorldConfig, get_world)
from ragroute_tpu_torch.index.ivf import _bf16_from_bits
from ragroute_tpu_torch.index.lowrank import _pad_rank, select_rank
from ragroute_tpu_torch.index.shard import (STORAGE_DTYPES, ShardSet,
                                            _quantize_sym, encode_rows,
                                            parse_storage_dtype)

logger = logging.getLogger("streamed")

_BUILD_BLOCK = 1 << 18  # rows per host build block (f32 transient bound)
# build blocks encoded at once: numpy releases the GIL inside its kernels, and
# every block writes its own rows, so the passes of a build run in a small
# thread pool with the results taken in block order (the same bytes as one
# thread gives)
_BUILD_THREADS = min(4, os.cpu_count() or 1)
# rows encoded at a time inside a block: the f32 temporaries of a chunk stay
# under glibc's 32 MB dynamic mmap-threshold cap, so they recycle through the
# arena instead of faulting fresh pages for every pass over a block (every
# step of the encoding is row-wise: the bytes do not depend on the chunking)
_ENCODE_ROWS = 8192


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _for_blocks(n: int, fn) -> list:
    """``fn(a, b)`` over the build blocks ``[a, b)`` of ``n`` rows; the
    results in block order."""
    spans = [(a, min(a + _BUILD_BLOCK, n)) for a in range(0, n, _BUILD_BLOCK)]
    if len(spans) == 1 or _BUILD_THREADS <= 1:
        return [fn(a, b) for a, b in spans]
    with concurrent.futures.ThreadPoolExecutor(_BUILD_THREADS) as pool:
        return list(pool.map(lambda span: fn(*span), spans))


@dataclasses.dataclass
class RowSource:
    """Streaming access to one source's raw f32 rows.

    ``get(start, stop)`` returns rows ``[start:stop)`` as ``[m, d]``
    float32: an in-RAM array slice, an ``np.load(mmap_mode='r')`` view, or
    a generator that makes blocks on demand, so a corpus larger than the
    host's memory in f32 never exists as one array."""

    n_docs: int
    dim: int
    get: Callable[[int, int], np.ndarray]

    @classmethod
    def from_array(cls, arr) -> "RowSource":
        return cls(int(arr.shape[0]), int(arr.shape[1]),
                   lambda a, b: np.asarray(arr[a:b], dtype=np.float32))


def as_row_source(v) -> RowSource:
    return v if isinstance(v, RowSource) else RowSource.from_array(v)


def _unpack_int4_np(packed: np.ndarray) -> np.ndarray:
    """Host inverse of ``shard._pack_int4`` (low nibble = dim j, high =
    dim j + d//2): returns int8 codes ``[n, d]``."""
    x = packed.astype(np.int8)
    lo = ((x.astype(np.int16) << 12) >> 12).astype(np.int8)  # sign-extend
    hi = (x >> 4).astype(np.int8)
    return np.concatenate([lo, hi], axis=1)


def _rows_as_f32(raw: np.ndarray) -> np.ndarray:
    """Stored codes as f32 values (uint16 is the bit pattern of bf16)."""
    if raw.dtype == np.uint16:
        return (raw.astype(np.uint32) << 16).view(np.float32)
    return np.asarray(raw, dtype=np.float32)


@dataclasses.dataclass
class HostRows:
    """One source's stored-form rows resident in host RAM.

    ``codes`` is the same bytes a :class:`DeviceShard` would hold (f32 /
    bf16 as uint16 bits / int8 codes / packed int4), produced by the shared
    :func:`ragroute_tpu_torch.index.shard.encode_rows` so host-tier scoring
    cannot drift from the device kernel's stored form. ``tensors`` holds
    torch views of the same memory (pinned on a CUDA build of the stream
    tier) for the slab uploads."""

    codes: np.ndarray               # [n, d_store]
    bias: np.ndarray                # [n] f32 gain-form (l2: -|d|^2)
    scale: Optional[np.ndarray]     # [n] f32 dequant factors (int8/int4)
    packed4: bool
    tensors: Optional[Tuple[torch.Tensor, torch.Tensor,
                            Optional[torch.Tensor]]] = None

    @property
    def nbytes(self) -> int:
        return (self.codes.nbytes + self.bias.nbytes
                + (0 if self.scale is None else self.scale.nbytes))

    def rows_f32(self, ids: np.ndarray) -> np.ndarray:
        """Dequantized stored-form f32 rows for the given local ids (the
        exact values the device kernel scores against)."""
        raw = self.codes[ids]
        if self.packed4:
            raw = _unpack_int4_np(raw)
        out = _rows_as_f32(raw)
        if self.scale is not None:
            if self.scale.ndim == 2:   # per-group int4 scales [n, G]
                dg = out.shape[1] // self.scale.shape[1]
                out *= np.repeat(self.scale[ids], dg, axis=1)
            else:
                out *= self.scale[ids][:, None]
        return out


def _nbytes(t) -> int:
    return 0 if t is None else t.numel() * t.element_size()


@dataclasses.dataclass
class StreamSource:
    """Per-source serving state for the host-RAM tiers."""

    name: str
    score_mode: str
    encoder: str
    embed_dim: int
    n_docs: int
    center: Optional[np.ndarray]          # corpus mean (lossy l2/dot)
    # device-resident exact rows (tier "stream": the prefix; fully-fitting
    # sources in either tier: everything). None fields where absent.
    res_docs: Optional[torch.Tensor] = None    # device [n_res_pad, d_store]
    res_bias: Optional[torch.Tensor] = None    # device [n_res_pad]
    res_scale: Optional[torch.Tensor] = None   # device or None
    n_res: int = 0                        # real rows resident
    # host overflow rows (rows [n_res, n_docs): stream tier), or the WHOLE
    # corpus (hostrefine tier, for refine)
    host: Optional[HostRows] = None
    host_row0: int = 0                    # global row of host.codes[0]
    slab_rows: int = 0                    # uniform padded slab height
    n_slabs: int = 0
    # hostrefine coarse tier; the device arrays carry rank rounded up to a
    # multiple of 16 columns (zero columns, which add nothing to any gain)
    basis: Optional[torch.Tensor] = None  # device [d, rp] f32
    mu_lr: Optional[torch.Tensor] = None  # device [d] f32 coarse center
    coarse_docs: Optional[torch.Tensor] = None   # device [n_pad, rp] int8
    #                                       (flat scan; None when clustered)
    coarse_scale: Optional[torch.Tensor] = None  # device [n_pad] f32
    coarse_bias: Optional[torch.Tensor] = None   # device [n_pad] f32
    coarse_cl: Optional[object] = None    # ops.grouped_topk.ClusteredCoarse
    #                                       (probed scan; replaces the flat
    #                                       slab above when built)
    rank: int = 0

    @property
    def device_bytes(self) -> int:
        tot = sum(_nbytes(t) for t in (
            self.res_docs, self.res_bias, self.res_scale, self.coarse_docs,
            self.coarse_scale, self.coarse_bias, self.basis))
        if self.coarse_cl is not None:
            tot += self.coarse_cl.nbytes
        return tot

    def slab(self, j: int) -> Tuple[torch.Tensor, torch.Tensor,
                                    Optional[torch.Tensor], int]:
        """(codes, bias, scale, global_offset) host views of slab ``j``."""
        a = j * self.slab_rows
        b = a + self.slab_rows
        codes, bias, scale = self.host.tensors
        return (codes[a:b], bias[a:b],
                None if scale is None else scale[a:b], self.host_row0 + a)


class _ShardMeta:
    """ShardSet-compatible per-source handle (server metadata surface)."""

    __slots__ = ("name", "n_docs", "score_mode")

    def __init__(self, name, n_docs, score_mode):
        self.name = name
        self.n_docs = n_docs
        self.score_mode = score_mode


def _water_fill(sizes: List[int], budget: int) -> List[int]:
    """Allocate ``budget`` bytes over sources, smallest fully first."""
    order = sorted(range(len(sizes)), key=lambda i: sizes[i])
    alloc = [0] * len(sizes)
    remaining = budget
    for pos, i in enumerate(order):
        share = remaining // (len(sizes) - pos)
        alloc[i] = min(sizes[i], share)
        remaining -= alloc[i]
    # second pass: hand leftover (from fully-fitting small sources) to the
    # still-starved large ones, largest share first
    for i in sorted(range(len(sizes)), key=lambda i: -sizes[i]):
        if remaining <= 0:
            break
        extra = min(sizes[i] - alloc[i], remaining)
        alloc[i] += extra
        remaining -= extra
    return alloc


def _host_alloc(shape, dtype: torch.dtype, fill, pin: bool
                ) -> Tuple[torch.Tensor, np.ndarray]:
    """A host tensor (page-locked when asked) and a numpy view of its
    memory. Pinning registers the pages of a plain allocation
    (``cudaHostRegister``): the caching pinned allocator would round a
    multi-GB store up to the next power of two."""
    t = torch.empty(shape, dtype=dtype)
    t.fill_(fill)
    if pin and t.numel():
        rt = torch.cuda.cudart()
        nbytes = t.numel() * t.element_size()
        err = rt.cudaHostRegister(t.data_ptr(), nbytes, 0)
        if int(err) != 0:
            raise RuntimeError(f"cudaHostRegister of {nbytes} bytes failed: "
                               f"CUDA error {int(err)}")
        weakref.finalize(t, rt.cudaHostUnregister, t.data_ptr())
    view = (t.view(torch.int16).numpy().view(np.uint16)
            if dtype == torch.bfloat16 else t.numpy())
    return t, view


def _put(arr: np.ndarray, device, dtype: Optional[torch.dtype] = None
         ) -> torch.Tensor:
    """A host array on ``device`` (uint16 bits as bf16 when asked)."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:
        arr = arr.copy()
    if dtype == torch.bfloat16:
        return _bf16_from_bits(arr).to(device)
    return torch.from_numpy(arr).to(device)


@dataclasses.dataclass
class StreamedShardSet:
    """Host-RAM-backed shard set (interface-compatible with ShardSet where
    the serving stack reads it: ``world``, ``shards`` metadata, ``doc_ids``,
    ``total_docs``, ``index_bytes``, ``device``)."""

    world: WorldConfig
    sources: List[StreamSource]
    doc_ids: Dict[str, Optional[list]]
    tier: str                     # "stream" | "hostrefine"
    packed4: bool = False         # int4-packed stored rows (all sources)
    device: torch.device = torch.device("cpu")

    @property
    def shards(self) -> List[_ShardMeta]:
        return [_ShardMeta(s.name, s.n_docs, s.score_mode)
                for s in self.sources]

    @property
    def total_docs(self) -> int:
        return sum(s.n_docs for s in self.sources)

    @property
    def index_bytes(self) -> int:
        """Device-resident bytes."""
        return sum(s.device_bytes for s in self.sources)

    @property
    def host_bytes(self) -> int:
        return sum(s.host.nbytes for s in self.sources
                   if s.host is not None)

    # -- construction --------------------------------------------------------

    @classmethod
    def build(
        cls,
        world: WorldConfig,
        row_sources: Mapping[str, object],
        *,
        dtype="int8",
        tier: str = "stream",
        hbm_budget_bytes: Optional[int] = None,
        slab_bytes: Optional[int] = None,
        rank: Optional[int] = None,
        normalize_cos: bool = True,
        doc_ids: Optional[Mapping[str, Sequence]] = None,
        device="cpu",
        cluster_coarse: Optional[bool] = None,
    ) -> "StreamedShardSet":
        """Build the host tiers block by block (nothing ever materializes
        the full f32 corpus; the peak host transient is one build block).

        ``dtype``: stored dtype for BOTH the device-resident rows and the
        host rows: torch.int8 (or "int8") / "int4" recommended (the tiers
        exist for capacity). ``rank``: coarse projection rank for tier
        "hostrefine" (None/-1 = automatic by LOWRANK_ENERGY spectrum).
        ``cluster_coarse``: k-means-cluster the hostrefine coarse slab for
        probed scanning (ops/grouped_topk.py). None = automatic: cluster
        sources with at least HOSTREFINE_CLUSTER_MIN_DOCS host rows; True
        forces it at any size (tests); False keeps the flat exhaustive
        coarse scan."""
        if isinstance(dtype, str) and dtype != "int4":
            dtype = STORAGE_DTYPES[dtype]
        packed4 = parse_storage_dtype(dtype)
        if tier not in ("stream", "hostrefine"):
            raise ValueError(f"unknown streamed tier {tier!r}")
        budget = (int(STREAM_HBM_BUDGET_GB * 1e9)
                  if hbm_budget_bytes is None else int(hbm_budget_bytes))
        slab_b = (STREAM_SLAB_MB << 20) if slab_bytes is None \
            else int(slab_bytes)
        device = torch.device(device)
        # the stream tier uploads its host rows every batch: pin them
        pin = tier == "stream" and device.type == "cuda"

        rs = {name: as_row_source(v) for name, v in row_sources.items()}
        srcs: List[StreamSource] = []
        ids: Dict[str, Optional[list]] = {}
        store_dtype = torch.int8 if packed4 else dtype
        itemsize = torch.empty(0, dtype=store_dtype).element_size()

        def store_width(d):
            return d // 2 if packed4 else d * itemsize

        # water-fill the device budget over the EXACT-row bytes of each
        # source; coarse slabs (hostrefine) ride outside the fill (they are
        # ~d/r smaller and always resident)
        for s in world.sources:
            if s.name not in rs:
                raise KeyError(f"missing rows for source {s.name!r}")
        sizes = [rs[s.name].n_docs * (store_width(s.embed_dim) + 8)
                 for s in world.sources]
        alloc = _water_fill(sizes, budget)

        for si, src in enumerate(world.sources):
            source = rs[src.name]
            n, d = source.n_docs, source.dim
            if d != src.embed_dim:
                raise ValueError(
                    f"{src.name}: dim {d} != world {src.embed_dim}")
            if n < world.k:
                raise ValueError(
                    f"{src.name}: {n} docs < k={world.k}")
            row_b = store_width(d) + 8
            n_res = min(n, alloc[si] // row_b)
            # resident prefix: at least k rows, SHARD_PAD_MULTIPLE-aligned
            n_res = max(n_res, min(n, max(world.k, SHARD_PAD_MULTIPLE)))
            n_res = min(n, _round_up(n_res, SHARD_PAD_MULTIPLE)) \
                if n_res < n else n
            full_res = n_res >= n
            if tier == "hostrefine" and not full_res:
                n_res = 0  # coarse covers everything; host rows refine

            center = None
            if src.score_mode in ("l2", "dot") and dtype != torch.float32:
                # corpus mean over the FULL source (build pass 1): the same
                # centring ShardSet.build applies, computed streaming in f64
                acc = np.zeros(d, np.float64)
                for part in _for_blocks(n, lambda a, b: source.get(a, b).sum(
                        axis=0, dtype=np.float64)):
                    acc += part
                center = (acc / n).astype(np.float32)

            st = StreamSource(
                name=src.name, score_mode=src.score_mode,
                encoder=src.encoder, embed_dim=d, n_docs=n, center=center)

            d_store = d // 2 if packed4 else d
            # scale shape: [n] for int8 / per-doc int4; [n, G] for the
            # per-group int4 scheme (encode_rows picks it when the dim
            # divides INT4_GROUP_DIMS)
            if packed4 and d % INT4_GROUP_DIMS == 0:
                s_shape = (d // INT4_GROUP_DIMS,)
            elif packed4 or dtype == torch.int8:
                s_shape = ()
            else:
                s_shape = None

            # pass 2: encode blocks into (resident | host) destinations
            if n_res:
                n_res_pad = _round_up(n_res, SHARD_PAD_MULTIPLE)
                _, res_codes = _host_alloc((n_res_pad, d_store), store_dtype,
                                           0, False)
                res_bias = np.full(n_res_pad, -np.inf, np.float32)
                res_scale = (np.full((n_res_pad,) + s_shape, 1e-12,
                                     np.float32)
                             if s_shape is not None else None)
            n_host = n - n_res
            if n_host:
                if tier == "hostrefine":
                    slab_rows = 0
                    n_host_pad = n_host
                else:
                    slab_rows = max(SHARD_PAD_MULTIPLE,
                                    _round_up(slab_b // max(row_b, 1),
                                              SHARD_PAD_MULTIPLE))
                    # never pad a small overflow up to a full slab
                    slab_rows = min(slab_rows,
                                    _round_up(n_host, SHARD_PAD_MULTIPLE))
                    n_host_pad = _round_up(n_host, slab_rows)
                h_codes_t, h_codes = _host_alloc(
                    (n_host_pad, d_store), store_dtype, 0, pin)
                h_bias_t, h_bias = _host_alloc(
                    (n_host_pad,), torch.float32, -np.inf, pin)
                h_scale_t = h_scale = None
                if s_shape is not None:
                    h_scale_t, h_scale = _host_alloc(
                        (n_host_pad,) + s_shape, torch.float32, 1e-12, pin)
            def encode(a, b):
                rows = source.get(a, b)
                for lo in range(a, b, _ENCODE_ROWS):
                    hi = min(lo + _ENCODE_ROWS, b)
                    stored, bias, scale = encode_rows(
                        rows[lo - a:hi - a], src.score_mode, dtype=dtype,
                        packed4=packed4, center=center,
                        norm_cos=normalize_cos)
                    place(lo, hi, stored, bias, scale)

            def place(a, b, stored, bias, scale):
                if b <= n_res:
                    res_codes[a:b], res_bias[a:b] = stored, bias
                    if scale is not None:
                        res_scale[a:b] = scale
                elif a >= n_res:
                    ha, hb = a - n_res, b - n_res
                    h_codes[ha:hb], h_bias[ha:hb] = stored, bias
                    if scale is not None:
                        h_scale[ha:hb] = scale
                else:  # the rows straddle the resident boundary
                    cut = n_res - a
                    res_codes[a:n_res] = stored[:cut]
                    res_bias[a:n_res] = bias[:cut]
                    h_codes[:b - n_res] = stored[cut:]
                    h_bias[:b - n_res] = bias[cut:]
                    if scale is not None:
                        res_scale[a:n_res] = scale[:cut]
                        h_scale[:b - n_res] = scale[cut:]

            _for_blocks(n, encode)

            if n_res:
                st.res_docs = _put(res_codes, device, store_dtype)
                st.res_bias = _put(res_bias, device)
                st.res_scale = (None if res_scale is None
                                else _put(res_scale, device))
                st.n_res = n_res
                del res_codes, res_bias, res_scale
            if n_host:
                st.host = HostRows(codes=h_codes, bias=h_bias,
                                   scale=h_scale, packed4=packed4,
                                   tensors=(h_codes_t, h_bias_t, h_scale_t))
                st.host_row0 = n_res
                if tier == "stream":
                    st.slab_rows = slab_rows
                    st.n_slabs = n_host_pad // slab_rows

            if tier == "hostrefine" and n_host:
                from ragroute_tpu_torch.config import \
                    HOSTREFINE_CLUSTER_MIN_DOCS
                do_cluster = (cluster_coarse if cluster_coarse is not None
                              else (HOSTREFINE_CLUSTER_MIN_DOCS > 0
                                    and n_host
                                    >= HOSTREFINE_CLUSTER_MIN_DOCS))
                cls._build_coarse(st, source, rank, normalize_cos,
                                  center, device, cluster=do_cluster)

            logger.info(
                "%s/%s: %d docs -> resident %d rows (%.2f GB), host %d "
                "rows (%.2f GB)%s", tier, src.name, n, st.n_res,
                st.device_bytes / 1e9, n_host,
                0 if st.host is None else st.host.nbytes / 1e9,
                f", coarse r={st.rank}" if st.rank else "")
            srcs.append(st)
            ids[src.name] = (list(doc_ids[src.name])
                             if doc_ids and src.name in doc_ids else None)
        return cls(world=world, sources=srcs, doc_ids=ids, tier=tier,
                   packed4=packed4, device=device)

    @staticmethod
    def _build_coarse(st: StreamSource, source: RowSource, rank,
                      normalize_cos: bool, center, device,
                      cluster: bool = False) -> None:
        """Rank-r int8 coarse projection of EVERY row (hostrefine tier).

        Basis = top eigenvectors of the stored-form covariance (sampled),
        the recipe of :func:`index.lowrank.build_lowrank`; the coarse slab
        is centred by the sample mean (a per-query constant in every score
        mode, see lowrank.py's ordering argument) and int8 per-doc
        quantized for capacity."""
        n, d = source.n_docs, source.dim
        step = max(1, n // LOWRANK_MOMENT_SAMPLE_ROWS)
        def take(a, b):
            blk = source.get(a, b)[::step]
            if st.score_mode == "cos" and normalize_cos:
                blk = blk / np.maximum(
                    np.linalg.norm(blk, axis=1, keepdims=True), 1e-12)
            if center is not None:
                blk = blk - center
            return np.asarray(blk, np.float32)

        sample = np.concatenate(_for_blocks(n, take), axis=0)
        mu_lr = sample.mean(axis=0, dtype=np.float64).astype(np.float32)
        sample -= mu_lr
        moment = sample.T @ sample
        w, v = np.linalg.eigh(moment.astype(np.float64))
        w, v = w[::-1], v[:, ::-1]
        r = select_rank(np.maximum(w, 0.0), LOWRANK_ENERGY,
                        None if (rank is None or rank < 0) else rank)
        if r is None:
            # flat spectrum: a profitable projection does not exist; fall
            # back to a quarter of the dimension (int8 still buys capacity:
            # the tier must serve, unlike opt-in impl="lowrank")
            r = max(128, d // 4)
            logger.warning(
                "%s: flat spectrum; hostrefine coarse falls back to "
                "rank %d", st.name, r)
        basis = np.ascontiguousarray(v[:, :r]).astype(np.float32)
        del sample, moment

        n_pad = _round_up(n, SHARD_PAD_MULTIPLE)
        c_codes = np.zeros((n_pad, r), np.int8)
        c_scale = np.full(n_pad, 1e-12, np.float32)
        c_bias = np.full(n_pad, -np.inf, np.float32)

        def project(a, b):
            rows = source.get(a, b)
            for lo in range(a, b, _ENCODE_ROWS):
                hi = min(lo + _ENCODE_ROWS, b)
                blk = rows[lo - a:hi - a]
                if st.score_mode == "cos" and normalize_cos:
                    blk = blk / np.maximum(
                        np.linalg.norm(blk, axis=1, keepdims=True), 1e-12)
                if center is not None:
                    blk = blk - center
                proj = (np.asarray(blk, np.float32) - mu_lr) @ basis
                codes, scales = _quantize_sym(proj, 127)
                c_codes[lo:hi], c_scale[lo:hi] = codes, scales
            # l2 gain bias stays the EXACT full-dimension -|d|^2 (the
            # stored-form bias the host rows carry); dot/cos coarse run
            # bias-free apart from the -inf padding sentinel
            c_bias[a:b] = (st.host.bias[a - st.host_row0:b - st.host_row0]
                           if st.score_mode == "l2" else 0.0)

        _for_blocks(n, project)
        c_codes = _pad_rank(c_codes)
        st.basis = _put(_pad_rank(basis), device)
        st.mu_lr = _put(mu_lr, device)
        st.rank = r
        if cluster:
            # probed coarse: cluster-major slab replaces the flat one (same
            # codes/scales/biases permuted into slots: a full probe scores
            # the exact same values). Padded rows carry -inf bias and are
            # excluded here.
            from ragroute_tpu_torch.ops.grouped_topk import \
                cluster_coarse_slab

            st.coarse_cl = cluster_coarse_slab(
                c_codes[:n], c_scale[:n], c_bias[:n], 0, device=device)
            logger.info("%s: coarse clustered C=%d S=%d", st.name,
                        st.coarse_cl.n_clusters, st.coarse_cl.capacity)
        else:
            st.coarse_docs = _put(c_codes, device)
            st.coarse_scale = _put(c_scale, device)
            st.coarse_bias = _put(c_bias, device)

    @classmethod
    def load(cls, root: str, world: WorldConfig, *, dtype="int8",
             tier: str = "stream", row_sources=None,
             **kw) -> "StreamedShardSet":
        """Load a world from ``<root>/<world>/<source>/embeddings.npy``
        mmaps: rows stream from disk through the block encoder, so a
        corpus larger than host RAM in f32 still builds (the host keeps
        only the quantized bytes). ``row_sources`` (source name -> array or
        :class:`RowSource`) gives the rows of the sources it names in place
        of their files: a corpus whose rows are made on demand."""
        rows = dict(row_sources or {})
        doc_ids = {}
        for src in world.sources:
            d = ShardSet.source_dir(root, world.name, src.name)
            if src.name not in rows:
                emb_path = os.path.join(d, "embeddings.npy")
                if not os.path.exists(emb_path):
                    raise FileNotFoundError(
                        f"no shard data for {world.name}/{src.name} under "
                        f"{root} (expected {emb_path})")
                rows[src.name] = RowSource.from_array(
                    np.load(emb_path, mmap_mode="r"))
            ids_path = os.path.join(d, "doc_ids.json")
            if os.path.exists(ids_path):
                with open(ids_path) as f:
                    doc_ids[src.name] = json.load(f)
        return cls.build(world, rows, dtype=dtype, tier=tier,
                         doc_ids=doc_ids, **kw)

    # -- host-side exact rescoring (hostrefine tier) ------------------------

    def refine_flat(self, si: int, queries: np.ndarray,
                    flat_ids: np.ndarray, flat_q: np.ndarray,
                    chunk: int = 8192) -> np.ndarray:
        """Exact stored-form scores of a FLAT candidate list (the global
        hostrefine path): ``flat_ids[m]`` local row ids of source ``si``,
        ``flat_q[m]`` the query row of each candidate. Returns natural
        scores ``[m]`` f32.

        Scales apply to the DOTS (per-doc) rather than the gathered rows:
        one [m] multiply instead of an [m, d] pass; the per-group int4
        scheme still dequantizes rows (group scales cannot ride the dot).
        Work runs in fixed-size ``chunk`` blocks whose f32 temporaries stay
        under glibc's 32 MB dynamic mmap-threshold cap, so they recycle
        through the arena instead of faulting fresh pages per call."""
        st = self.sources[si]
        host = st.host
        q = np.asarray(queries, np.float32)
        if st.score_mode == "cos":
            q = q / np.maximum(
                np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        if st.score_mode == "l2" and st.center is not None:
            q = q - st.center
        grouped = host.scale is not None and host.scale.ndim == 2
        m = flat_ids.size
        out = np.empty(m, np.float32)
        for a in range(0, m, chunk):
            b = min(a + chunk, m)
            # candidate ids are GLOBAL row ids; host rows start at
            # host_row0: shift and bounds-mask like refine() so
            # out-of-range ids score NaN instead of reading the wrong row
            gids = flat_ids[a:b]
            ok = (gids >= st.host_row0) & (gids < st.n_docs)
            ids_c = np.where(ok, gids - st.host_row0, 0)
            qg = q[flat_q[a:b]]                           # [c, d]
            if grouped or host.packed4:
                rows = host.rows_f32(ids_c)
                dots = np.einsum("md,md->m", rows, qg)
            else:
                rows = _rows_as_f32(host.codes[ids_c])
                dots = np.einsum("md,md->m", rows, qg)
                if host.scale is not None:
                    dots *= host.scale[ids_c]
            if st.score_mode == "l2":
                qsq = np.einsum("md,md->m", qg, qg)
                vals = qsq - (2.0 * dots + host.bias[ids_c])
            elif st.score_mode == "dot" and st.center is not None:
                vals = dots + qg @ st.center
            else:
                vals = dots
            out[a:b] = np.where(ok, vals, np.nan)
        return out

    def refine(self, si: int, queries: np.ndarray, cand: np.ndarray,
               k: int, chunk: int = 64
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact-rescore coarse candidates against the host rows.

        Args:
          si: source index. queries: ``[B, d]`` f32 raw query embeddings.
          cand: ``[B, k']`` int32 global row ids (coarse winners; ids < 0
            or >= n_docs are ignored). k: final depth.

        Returns ``(scores [B, k] natural-form, ids [B, k] int32)``, best
        first with FAISS tie-breaking (the lower id wins), invalid entries
        scored NaN/-1. The arithmetic mirrors the device kernel's
        stored-form gains: stored rows are dequantized f32, l2 uses the
        stored ``-|d|^2`` bias, dot restores ``q . center``. ``chunk``
        keeps the [chunk*k', d] f32 row temporaries under glibc's 32 MB
        dynamic mmap-threshold cap (see :meth:`refine_flat`)."""
        st = self.sources[si]
        host = st.host
        bsz, kp = cand.shape
        q = np.asarray(queries, np.float32)
        if st.score_mode == "cos":
            q = q / np.maximum(
                np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        restore = None
        if st.score_mode == "dot" and st.center is not None:
            restore = q @ st.center                     # [B]
        if st.score_mode == "l2" and st.center is not None:
            q = q - st.center
        l2 = st.score_mode == "l2"
        out_s = np.full((bsz, k), np.nan, np.float32)
        out_i = np.full((bsz, k), -1, np.int32)
        for a in range(0, bsz, chunk):
            b = min(a + chunk, bsz)
            ids = cand[a:b]
            ok = (ids >= st.host_row0) & (ids < st.n_docs)
            safe = np.where(ok, ids - st.host_row0, 0)
            flat = safe.reshape(-1)
            rows = host.rows_f32(flat).reshape(b - a, kp, -1)
            dots = np.einsum("bkd,bd->bk", rows, q[a:b],
                             optimize=True)
            if l2:
                qsq = np.einsum("bd,bd->b", q[a:b], q[a:b])
                # |q-d|^2 = |q|^2 - (2 q.d + bias)   (bias = -|d|^2)
                gain = 2.0 * dots + host.bias[flat].reshape(b - a, kp)
                nat = qsq[:, None] - gain
                key = -nat
            else:
                nat = dots
                if restore is not None:
                    nat = nat + restore[a:b, None]
                key = nat
            key = np.where(ok, key, -np.inf)
            # FAISS tie-break: among equal keys the LOWER id wins; sort
            # by (-key, id) lexicographically
            order = np.lexsort((np.where(ok, ids, np.iinfo(np.int32).max),
                                -key), axis=1)[:, :k]
            kk = np.take_along_axis(key, order, axis=1)
            valid = kk > -np.inf
            out_s[a:b] = np.where(valid, (-kk if l2 else kk), np.nan)
            out_i[a:b] = np.where(
                valid, np.take_along_axis(ids, order, axis=1), -1)
        return out_s, out_i


def streamed_from_reference(fields, device="cpu") -> StreamedShardSet:
    """Carry a shard set across from the JAX package as numpy arrays.

    ``fields`` maps ``world`` (its name), ``tier``, ``packed4``,
    ``dtype_name`` ("float32" | "bfloat16" | "int8" | "int4") and
    ``sources``: one mapping per source with the field names of the JAX
    package's ``StreamSource`` (``host_codes`` / ``host_bias`` /
    ``host_scale`` for its ``HostRows``; bf16 arrays as uint16 bit views;
    ``coarse_cl`` the mapping :func:`ragroute_tpu_torch.ops.grouped_topk.
    clustered_from_reference` takes). Gives the port's shard set with the
    device arrays on ``device``."""
    from ragroute_tpu_torch.ops.grouped_topk import clustered_from_reference

    device = torch.device(device)
    dtype_name = str(fields["dtype_name"])
    packed4 = bool(fields["packed4"])
    store_dtype = torch.int8 if packed4 else STORAGE_DTYPES[dtype_name]

    def dev(a, dt=None):
        return None if a is None else _put(np.asarray(a), device, dt)

    def f32(a):
        return None if a is None else np.array(a, np.float32)

    srcs = []
    for f in fields["sources"]:
        st = StreamSource(
            name=str(f["name"]), score_mode=str(f["score_mode"]),
            encoder=str(f["encoder"]), embed_dim=int(f["embed_dim"]),
            n_docs=int(f["n_docs"]), center=f32(f.get("center")))
        if f.get("res_docs") is not None:
            st.res_docs = dev(f["res_docs"], store_dtype)
            st.res_bias = dev(f32(f["res_bias"]))
            st.res_scale = dev(f32(f.get("res_scale")))
            st.n_res = int(f["n_res"])
        if f.get("host_codes") is not None:
            src_codes = np.asarray(f["host_codes"])
            codes_t, codes = _host_alloc(src_codes.shape, store_dtype, 0,
                                         False)
            codes[...] = src_codes
            bias_t = torch.from_numpy(f32(f["host_bias"]))
            scale = f32(f.get("host_scale"))
            scale_t = None if scale is None else torch.from_numpy(scale)
            st.host = HostRows(codes=codes, bias=bias_t.numpy(), scale=scale,
                               packed4=packed4,
                               tensors=(codes_t, bias_t, scale_t))
            st.host_row0 = int(f.get("host_row0", 0))
            st.slab_rows = int(f.get("slab_rows", 0))
            st.n_slabs = int(f.get("n_slabs", 0))
        if f.get("basis") is not None:
            st.basis = dev(_pad_rank(f32(f["basis"])))
            st.mu_lr = dev(f32(f["mu_lr"]))
            st.rank = int(f["rank"])
            if f.get("coarse_cl") is not None:
                st.coarse_cl = clustered_from_reference(f["coarse_cl"],
                                                        device)
            else:
                st.coarse_docs = dev(_pad_rank(
                    np.asarray(f["coarse_docs"], np.int8)))
                st.coarse_scale = dev(f32(f["coarse_scale"]))
                st.coarse_bias = dev(f32(f["coarse_bias"]))
        srcs.append(st)
    return StreamedShardSet(
        world=get_world(str(fields["world"])), sources=srcs,
        doc_ids={s.name: None for s in srcs}, tier=str(fields["tier"]),
        packed4=packed4, device=device)
