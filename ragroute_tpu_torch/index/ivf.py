"""Balanced-IVF (cluster-probed approximate) index build.

PyTorch port of :mod:`ragroute_tpu.index.ivf`. An opt-in approximate mode
probes only the ``nprobe`` nearest document clusters per query. The build
produces a dense cluster-major layout with **balanced clusters**: k-means
learns the centroids, then documents are assigned to their nearest cluster
*subject to a fixed capacity* ``S ~ (n/C) * slack`` (greedy by preference
rank). Every cluster fits the same ``[d, S]`` slab; padding slots carry a
``-inf`` gain bias so they can never win. Search
(:mod:`ragroute_tpu_torch.ops.ivf_topk`) is then a dispatch problem: probe,
sort the (query, cluster) pairs by cluster, score them as a grouped GEMM,
collect.

k-means and the preference ranking run on the target device (Lloyd
iterations, chunked over documents so no ``[n, C]`` matrix exists); the
capacity-greedy assignment is a small host pass over the top-R cluster
preferences; the slab is laid out on the target device by pure data
movement, so its bytes equal a host build's.

The ``.npz`` cache format is the JAX package's: either package reads the
other's files. Builds sharded over a device mesh are not ported yet (ROADMAP
queue 1, item 14).
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import math
from typing import Optional

import numpy as np
import torch

logger = logging.getLogger("ivf")

KMEANS_CHUNK = 8192


@dataclasses.dataclass
class IVFData:
    """Tensors of one balanced-IVF shard on one device (cluster-major).

    ``docs`` is stored ``[C, d, S]`` (contraction on the middle axis, ``S``
    contiguous), the layout of the JAX package's files and of the grouped
    GEMM kernel's right-hand side."""

    centroids: torch.Tensor            # [C, d] f32, gain-form probe targets
    cbias: torch.Tensor                # [C] f32 (-|c|^2 for l2, zeros else)
    docs: torch.Tensor                 # [C, d, S] f32 / bf16 / int8
    bias: torch.Tensor                 # [C, S] f32 gain bias, -inf at pads
    scale: Optional[torch.Tensor]      # [C, S] f32 dequant factors (int8/int4)
    perm: torch.Tensor                 # [C, S] int32 original local doc id
    n_clusters: int
    capacity: int
    # int4 mode: docs is int8 [C, d//2, S] with two 4-bit codes per byte
    # (byte row j = dim j low nibble, dim j + d//2 high: the flat shard's
    # half-concat layout, index.shard._pack_int4)
    packed4: bool = False

    @property
    def device(self) -> torch.device:
        return self.docs.device

    def to(self, device) -> "IVFData":
        return dataclasses.replace(self, **{
            f: (None if getattr(self, f) is None
                else getattr(self, f).to(device))
            for f in ("centroids", "cbias", "docs", "bias", "scale", "perm")})

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (
            self.centroids, self.cbias, self.docs, self.bias, self.scale,
            self.perm) if t is not None)


def default_n_clusters(n: int) -> int:
    """FAISS-style sizing: ~4*sqrt(n), a power of two, bounded so each
    cluster keeps a useful number of docs."""
    c = 1 << max(4, int(round(math.log2(4.0 * math.sqrt(max(n, 16))))))
    c = int(min(c, max(16, n // 32), 4096))
    return 1 << (c.bit_length() - 1)  # round the cap down to a power of 2


def _upload_chunks(emb: np.ndarray, chunk: int, device):
    """The corpus once on the device as bf16 ``[n_chunks, chunk, d]`` plus
    row weights (0 on the zero rows that pad the last chunk). One upload
    feeds both the Lloyd iterations and the preference ranking; every
    reduction over it accumulates in f32."""
    n, d = emb.shape
    n_pad = -(-n // chunk) * chunk
    x = torch.zeros((n_pad, d), dtype=torch.bfloat16)
    for off in range(0, n, chunk):     # np.array: a read-only memmap copies
        end = min(off + chunk, n)
        x[off:end] = torch.from_numpy(
            np.array(emb[off:end], np.float32)).to(torch.bfloat16)
    wt = torch.zeros((n_pad,), dtype=torch.float32)
    wt[:n] = 1.0
    return (x.reshape(-1, chunk, d).to(device),
            wt.reshape(-1, chunk).to(device), n_pad)


def _chunk_scores(xb: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """``xb @ cent.T`` with both operands in bf16 and f32 accumulation
    (bf16 products are exact in f32)."""
    return xb.to(torch.float32) @ cent.to(torch.bfloat16).to(torch.float32).T


@torch.no_grad()
def _kmeans_device(xc: torch.Tensor, wc: torch.Tensor, emb: np.ndarray,
                   n_clusters: int, iters: int, seed: int) -> np.ndarray:
    """Lloyd iterations on the device of ``xc``; returns ``[C, d]`` float32
    centroids. Assignment is chunked over documents, so peak memory is
    ``[chunk, C]`` scores instead of ``[n, C]``."""
    d = emb.shape[1]
    dev = xc.device
    rng = np.random.default_rng(seed)
    cent = torch.from_numpy(np.asarray(
        emb[rng.choice(emb.shape[0], n_clusters, replace=False)],
        np.float32)).to(dev)
    for _ in range(iters):
        sums = torch.zeros((n_clusters, d), dtype=torch.float32, device=dev)
        counts = torch.zeros((n_clusters,), dtype=torch.float32, device=dev)
        half_sq = 0.5 * (cent * cent).sum(dim=1)
        for xb, wb in zip(xc, wc):
            # nearest centroid in l2 == argmax of x.c - |c|^2/2
            a = torch.argmax(_chunk_scores(xb, cent) - half_sq[None, :],
                             dim=1)
            sums.index_add_(0, a, xb.to(torch.float32) * wb[:, None])
            counts.index_add_(0, a, wb)
        cent = torch.where(counts[:, None] > 0,
                           sums / counts.clamp(min=1.0)[:, None], cent)
    return cent.cpu().numpy().astype(np.float32)


def _chunk_top_r(xb: torch.Tensor, c: torch.Tensor, cb: torch.Tensor,
                 r: int) -> torch.Tensor:
    """``[chunk, r]`` int32 nearest clusters of one chunk, nearest first,
    ties to the lower cluster. The slice is copied out: a view would keep
    the chunk's whole ``[chunk, C]`` sort index alive (``C / r`` times the
    bytes), and the caller holds one result per chunk of the corpus."""
    from ragroute_tpu_torch.ops.topk import topk_stable

    return topk_stable(_chunk_scores(xb, c) + cb[None, :], r)[1].to(
        torch.int32)


@torch.no_grad()
def _top_r_choices(xc: torch.Tensor, n: int, cent: np.ndarray,
                   r: int) -> np.ndarray:
    """``[n, r]`` cluster-preference ranking per doc (nearest first, ties
    to the lower cluster), on the device of ``xc``."""
    c = torch.from_numpy(np.asarray(cent, np.float32)).to(xc.device)
    cb = -0.5 * (c * c).sum(dim=1)
    tops = [_chunk_top_r(xb, c, cb, r) for xb in xc]
    return torch.cat(tops).cpu().numpy()[:n]


def _balanced_assign(choices: np.ndarray, n_clusters: int,
                     capacity: int) -> np.ndarray:
    """Capacity-constrained greedy assignment: every doc goes to its
    best-ranked cluster that still has room (rank by rank, vectorized
    per cluster); stragglers fill any remaining slots. Returns [n]
    cluster ids. Always succeeds because C*capacity >= n."""
    n, r = choices.shape
    assign = np.full(n, -1, np.int32)
    counts = np.zeros(n_clusters, np.int64)
    for rank in range(r):
        unass = np.flatnonzero(assign < 0)
        if unass.size == 0:
            break
        want = choices[unass, rank]
        order = np.argsort(want, kind="stable")
        docs_sorted = unass[order]
        want_sorted = want[order]
        first = np.searchsorted(want_sorted, np.arange(n_clusters), "left")
        last = np.searchsorted(want_sorted, np.arange(n_clusters), "right")
        room = np.minimum(last - first, capacity - counts[:n_clusters])
        # vectorized per-cluster take: a doc is taken iff its position
        # within its wanted cluster's contiguous run is below that
        # cluster's remaining room (no host loop over clusters)
        pos_in_cluster = np.arange(docs_sorted.size) - first[want_sorted]
        take_mask = pos_in_cluster < room[want_sorted]
        taken = docs_sorted[take_mask]
        assign[taken] = want_sorted[take_mask]
        np.add.at(counts, want_sorted[take_mask], 1)
    unass = np.flatnonzero(assign < 0)
    if unass.size:
        free = np.repeat(np.arange(n_clusters),
                         (capacity - counts).clip(min=0))
        assign[unass] = free[:unass.size]
    return assign


def slab_capacity(n: int, c: int, capacity_slack: float = 1.25) -> int:
    """Slots per cluster ``S``: ``ceil(n/C) * slack`` rounded up to a
    multiple of 8, or to a multiple of 128 when that costs at most 15%
    more slots (the rule of the JAX package, so caches stay
    interchangeable)."""
    cap = max(-(-n // c), int(-(-n // c) * capacity_slack))
    cap8 = max(8, -(-cap // 8) * 8)
    cap128 = -(-cap // 128) * 128
    return cap128 if cap128 <= 1.15 * cap8 else cap8


@torch.no_grad()
def build_ivf(
    emb: np.ndarray,
    mode: str,
    *,
    dtype=torch.bfloat16,
    n_clusters: Optional[int] = None,
    capacity_slack: float = 1.25,
    kmeans_iters: int = 10,
    kmeans_rank: int = 8,
    seed: int = 0,
    device="cpu",
    packed_rows: Optional[np.ndarray] = None,
    row_scales: Optional[np.ndarray] = None,
) -> IVFData:
    """Build a balanced-IVF layout for one shard on ``device``.

    Args:
      emb: ``[n, d]`` float32 document embeddings, already in the same
        space as the flat shard stores (cos-normalized / mean-centred).
      mode: "dot" | "cos" | "l2": sets the gain-form probe bias and the
        per-doc gain bias, matching :mod:`ragroute_tpu_torch.ops.topk`.
      dtype: storage dtype of the slabs (torch.float32 / torch.bfloat16 /
        torch.int8 with scales, or the string "int4" for packed-nibble
        codes, two per byte, the flat shard's half-concat layout).
      n_clusters: cluster count C (default ~4*sqrt(n), power of two).
      capacity_slack: S = ceil(n/C * slack); docs overflowing their
        nearest cluster spill to their next-preferred one.
      packed_rows / row_scales: optional precomputed int4 quantization of
        ``emb`` (``[n, d//2]`` packed bytes + ``[n]`` f32 scales, from
        ``index.shard._quantize_sym(levels=7, mse_opt=True)`` +
        ``_pack_int4``). When given with ``dtype="int4"`` the slab reuses
        these codes instead of re-running the quantizer over the slot
        matrix: ``ShardSet.build`` passes its flat-shard codes here.
    """
    from ragroute_tpu_torch.index.shard import (_pack_int4, _quantize_sym,
                                                parse_storage_dtype)

    packed4 = parse_storage_dtype(dtype)
    emb = np.asarray(emb, np.float32)
    n, d = emb.shape
    dev = torch.device(device)
    if packed4 and d % 2:
        raise ValueError(f"int4 packing needs an even embed dim, got {d}")
    use_pre = packed4 and packed_rows is not None
    if use_pre:
        packed_rows = np.asarray(packed_rows, np.int8)
        row_scales = np.asarray(row_scales, np.float32)
        if packed_rows.shape != (n, d // 2) or row_scales.shape != (n,):
            raise ValueError(
                f"packed_rows {packed_rows.shape} / row_scales "
                f"{row_scales.shape} do not match emb [{n}, {d}]")
    c = n_clusters or default_n_clusters(n)
    c = int(max(1, min(c, n)))
    cap = slab_capacity(n, c, capacity_slack)

    if c == 1:
        cent = emb.mean(axis=0, keepdims=True)
        assign = np.zeros(n, np.int32)
    else:
        xc, wc, _ = _upload_chunks(emb, KMEANS_CHUNK, dev)
        cent = _kmeans_device(xc, wc, emb, c, kmeans_iters, seed)
        choices = _top_r_choices(xc, n, cent, min(kmeans_rank, c))
        del xc, wc
        assign = _balanced_assign(choices, c, cap)

    # cluster-major dense layout. Doc order[i] (sorted by cluster, stable)
    # takes slot (cluster, rank within the cluster); the slab is filled on
    # the device by one scatter of rows and one transpose to [C, d, S].
    order = np.argsort(assign, kind="stable")
    cl_sorted = assign[order].astype(np.int64)
    first = np.searchsorted(cl_sorted, np.arange(c), "left")
    slot = cl_sorted * cap + (np.arange(n) - first[cl_sorted])
    bias = np.full((c * cap,), -np.inf, np.float32)
    perm = np.zeros((c * cap,), np.int32)
    perm[slot] = order
    bias[slot] = (-np.sum(emb * emb, axis=1)[order] if mode == "l2" else 0.0)
    slot_t = torch.from_numpy(slot).to(dev)
    order_t = torch.from_numpy(order.astype(np.int64)).to(dev)

    def slab(rows_np: np.ndarray, fill=0) -> torch.Tensor:
        """``[C, w, S]`` from per-doc rows ``[n, w]``: zero slot rows,
        scatter, transpose."""
        rows = torch.from_numpy(np.ascontiguousarray(rows_np)).to(dev)
        slots = torch.full((c * cap, rows.shape[1]), fill, dtype=rows.dtype,
                           device=dev)
        slots[slot_t] = rows[order_t]
        return slots.reshape(c, cap, -1).transpose(1, 2).contiguous()

    scale = None
    if use_pre:
        # precomputed codes fill the slab in the packed domain directly;
        # empty slots keep code 0 / scale 1e-12, bit-identical to
        # quantizing the zero pad rows
        docs = slab(packed_rows)
        s_slab = np.full((c * cap,), 1e-12, np.float32)
        s_slab[slot] = row_scales[order]
        scale = torch.from_numpy(s_slab.reshape(c, cap)).to(dev)
    elif packed4:
        # the flat int4 shard's per-doc quantizer on the slot rows, so a
        # doc's codes are identical to its flat-shard codes and full-probe
        # IVF reproduces the flat int4 scan
        rows = np.zeros((c * cap, d), np.float32)
        rows[slot] = emb[order]
        codes, s_row = _quantize_sym(rows, 7, mse_opt=True)
        packed = _pack_int4(codes)                       # [C*S, d//2]
        docs = torch.from_numpy(np.ascontiguousarray(
            packed.reshape(c, cap, d // 2).transpose(0, 2, 1))).to(dev)
        scale = torch.from_numpy(
            s_row.reshape(c, cap).astype(np.float32)).to(dev)
    else:
        docs = slab(emb)                                 # [C, d, S] f32
        if dtype == torch.int8:
            s_row = docs.abs().amax(dim=1) / 127.0       # [C, S]
            s_row = torch.where(s_row == 0.0, 1.0, s_row)
            docs = torch.clamp(torch.round(docs / s_row[:, None, :]),
                               -127, 127).to(torch.int8)
            scale = s_row.to(torch.float32)
        else:
            docs = docs.to(dtype)

    cbias = (-np.sum(cent * cent, axis=1) if mode == "l2"
             else np.zeros(c, np.float32)).astype(np.float32)
    logger.info("ivf build: n=%d C=%d S=%d (slack %.2f, %.0f%% pad)",
                n, c, cap, capacity_slack, 100.0 * (c * cap - n) / max(n, 1))
    return IVFData(
        centroids=torch.from_numpy(np.asarray(cent, np.float32)).to(dev),
        cbias=torch.from_numpy(cbias).to(dev),
        docs=docs,
        bias=torch.from_numpy(bias.reshape(c, cap)).to(dev),
        scale=scale,
        perm=torch.from_numpy(perm.reshape(c, cap)).to(dev),
        n_clusters=c,
        capacity=cap,
        packed4=packed4,
    )


# -- persistence -----------------------------------------------------------

def ivf_fingerprint(emb: np.ndarray) -> str:
    """Cheap content fingerprint of a source embedding matrix.

    The IVF npz cache stores the document vectors themselves, so a cache
    hit against regenerated embeddings of the same shape would silently
    serve stale vectors. A deterministic row subsample (~1k rows spread
    across the matrix) plus shape catches any realistic regeneration
    while staying O(MB)."""
    emb = np.asarray(emb)
    n = emb.shape[0]
    step = max(1, n // 1024)
    sample = np.ascontiguousarray(emb[::step], dtype=np.float32)
    h = hashlib.sha1()
    h.update(str(emb.shape).encode())
    h.update(sample.tobytes())
    h.update(np.float64(sample.sum(dtype=np.float64)).tobytes())
    return h.hexdigest()


def _np(t: torch.Tensor) -> np.ndarray:
    """Host numpy view of a tensor; bf16 as its uint16 bit pattern (npz
    has no bfloat16)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _bf16_from_bits(bits: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(
        np.ascontiguousarray(bits).view(np.int16)).view(torch.bfloat16)


def ivf_from_reference(fields, device="cpu") -> IVFData:
    """Carry a layout across from the JAX package: ``fields`` maps the
    field names of its ``IVFData`` to numpy arrays (bf16 ``docs`` as a
    uint16 bit view, with ``dtype_name`` "bfloat16"), exactly the keys
    :func:`save_ivf` writes; gives the port's dataclass on ``device``."""
    dtype_name = str(fields["dtype_name"])
    docs = np.asarray(fields["docs"])
    docs_t = (_bf16_from_bits(docs) if dtype_name == "bfloat16"
              else torch.from_numpy(np.ascontiguousarray(docs)))
    scale = fields.get("scale")
    if scale is not None and np.asarray(scale).size == 0:
        scale = None
    c, _, cap = docs.shape

    def t(a, dt):
        return torch.from_numpy(np.array(a, dtype=dt)).to(device)

    return IVFData(
        centroids=t(fields["centroids"], np.float32),
        cbias=t(fields["cbias"], np.float32),
        docs=docs_t.to(device),
        bias=t(fields["bias"], np.float32),
        scale=None if scale is None else t(scale, np.float32),
        perm=t(fields["perm"], np.int32),
        n_clusters=int(c), capacity=int(cap),
        packed4=dtype_name == "int4")


def save_ivf(ivf: IVFData, path: str, *,
             fingerprint: Optional[str] = None) -> None:
    """Persist a balanced-IVF layout (npz, the JAX package's keys). bf16
    docs are stored as a uint16 bit view. ``fingerprint`` (from
    :func:`ivf_fingerprint`) binds the cache to its source embeddings."""
    dtype_name = ("int4" if ivf.packed4
                  else str(ivf.docs.dtype).replace("torch.", ""))
    np.savez(
        path,
        centroids=_np(ivf.centroids),
        cbias=_np(ivf.cbias),
        docs=_np(ivf.docs),
        dtype_name=np.asarray(dtype_name),
        bias=_np(ivf.bias),
        scale=(np.zeros((0,), np.float32) if ivf.scale is None
               else _np(ivf.scale)),
        perm=_np(ivf.perm),
        fingerprint=np.asarray(fingerprint or ""),
    )


def load_ivf(path: str, expect_fingerprint: Optional[str] = None,
             device="cpu") -> Optional[IVFData]:
    """Load a layout written by :func:`save_ivf` (of either package).

    With ``expect_fingerprint`` set, returns ``None`` (with a warning)
    when the stored fingerprint is absent or differs: the caller should
    rebuild."""
    with np.load(path) as z:
        if expect_fingerprint is not None:
            stored = str(z["fingerprint"]) if "fingerprint" in z else ""
            if stored != expect_fingerprint:
                logger.warning(
                    "ivf cache %s does not match current embeddings "
                    "(stored fingerprint %r vs %r); rebuilding",
                    path, stored[:12], expect_fingerprint[:12])
                return None
        return ivf_from_reference({k: z[k] for k in z.files}, device)
