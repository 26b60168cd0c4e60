"""Fused product + streaming exact top-k over one shard (the K1 kernel).

PyTorch/CUDA counterpart of ``ragroute_tpu/ops/pallas_topk.py::pallas_topk``.
:func:`fused_topk` is the wrapper: it puts the queries in gain form, casts
them to the storage dtype of the docs, checks what the kernel takes and
launches ``csrc/fused_topk.cu``, which returns per query the k best
``(q.d) * scale + bias`` ordered by (gain desc, doc index asc) without
writing the ``[B, N]`` gains to device memory.

:func:`fused_topk_reference` is the plain PyTorch version of the same
function (f32 product on the upcast operands, then a stable sort). The
wrapper takes it only for a tensor on the CPU; for a CUDA tensor it
launches the kernel or raises.

Padding: the TPU wrapper pads queries and docs to tile multiples and folds
padded or invalid rows into a ``-inf`` bias tail. The CUDA kernel masks the
ragged query and doc edges itself, and is handed ``valid_docs`` as its row
count, so rows at or past it are never read and cannot win: the same
result without copying the shard. As in the TPU kernel, a list entry whose
gain is ``-inf`` carries index 0.

Launches (:func:`_plan`, a pure function of the shape): bf16, int8 and int4
docs (per-doc or per-group scales) take the wgmma scan
(``wgmma_topk_kernel``: a TMA ring, doc tiles of 192, 128 query rows a
block; int8 and int4 codes arrive as raw bytes and the producer's warps
turn them into bf16 tiles) up to :data:`SHALLOW_K`, and past it, at every
shard size, the same scan with its deep fold (each row a lower bound on its k-th best in a register, seeded from a
sample of the shard and shared by the row's splits through device memory;
candidates staged in shared memory and kept in device memory, cut by a
warp's radix select; the (row, split) lists merged in the same launch;
:func:`fold_takes`: up to ``deep_topk.FOLD_MAX_K``, its workspace under the
cap); f32 docs up to :data:`SHALLOW_K` take, past the crossover
:func:`f32_scan_pays`, the f32 scan (``f32_topk_kernel``: full f32 FMA on
the CUDA cores, ``csrc/f32_tile.cuh``'s product over 128 query rows and 128
docs a tile, operands by TMA into a ring, the wgmma scan's fold) and below
it the small-batch f32 scan (``f32_small_kernel``: a query tile of 8, 32 or
64 rows sized to the batch, :func:`f32_small_rows`; doc tiles of 256 by
TMA into a ring of up to 6 stages; every warp holds all the tile's rows,
so a doc value read from shared memory feeds every row; the same
branch-free fold); deeper f32 lists up to :data:`MAX_SHALLOW_K`, and int4
docs whose packed rows are not a whole number of 16 bytes (d % 32, the
TMA's row stride), take the first design (``partial_topk_kernel``, 64
query rows a block, doc tiles of 64), whose lists stop at
:data:`MAX_SHALLOW_K`;
a list the fold does not take past that, any ``k`` as the TPU kernel takes,
runs the deep launch: the same product and epilogue write a chunk of docs'
gains to a workspace in device memory, every run of 8,192 docs is cut to
its best ``k`` and the lists merge (``csrc/deep_topk.cuh``). The
workspaces (the fold's candidates, sample words and running lists; the
deep launch's gains, lists and running lists) stay under ``deep_topk.WORKSPACE_CAP`` = 256 MiB:
the fold in fewer splits, the deep launch in chunks of docs and, where even
one run's chunk for every query row would not fit, query rows in slices
(:func:`ragroute_tpu_torch.ops.deep_topk.fused_plan`).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ragroute_tpu_torch.ops import deep_topk
from ragroute_tpu_torch.ops.topk import (NEG_INF, _prepare_queries, _validate,
                                         doc_bias, gain_to_natural,
                                         topk_stable, unpack_int4)

Tensor = torch.Tensor

TILE_Q = 64          # query rows per block (csrc/fused_topk.cu TQ)
TILE_D = 64          # docs per tile (TD)
MAX_SHALLOW_K = deep_topk.SHALLOW_MAX   # deepest list of the shallow launch
MAX_SPLITS = 512
BLOCKS_PER_SM = 4    # split target: enough blocks to fill every SM
# deep lists (k > 64): every split fills its own k-deep lists by serial
# inserts, about k * (1 + ln(docs per split / k)) of them per query row, so
# fewer and longer splits cost less than they lose in parallelism
DEEP_BLOCKS_PER_SM = 2
SHALLOW_K = 64       # topk_merge.cuh KSHALLOW
# the wgmma scan and its deep fold: query rows a block (csrc/fused_topk.cu:
# 64 a consumer warp group), docs a tile (WTD), and the most waves of one
# block an SM their split plans weigh (a block takes the whole SM's shared
# memory). The scan takes lists up to SHALLOW_K: past it, its one consumer
# group of 64 rows with lists in shared memory lost to the deep fold, and to
# the deep launch, at every shard, width and depth read (``measure.py
# --kernels``, readings in PERF.md: bf16 over 104,857 to 734,003 docs at d =
# 128, 512 and 768, k' = 65 to 256; int8 over hostrefine's coarse slab), so
# it was removed. The fold takes every list past SHALLOW_K it takes
# (fold_takes), at every shard size. Its first design lost to the deep
# launch below about 400,000 docs: each (row, split) let every finite gain
# in until its first cut, a cut stalls both consumer groups, and the split
# lists merged in a second launch (device ms at B = 512, k' = 128, d = 128,
# fold / deep launch: 83,886 docs 0.92 / 0.37, 104,857 0.97 / 0.44, 125,829
# 1.00 / 0.55; measure.py's switch rows before this design). Now a row's
# owner seeds the row's bound from a sample of the shard
# (deep_topk.fold_sample_tiles), the bound is shared by the row's splits,
# and their lists merge in the same launch. Device ms, deep launch / fold,
# in two rounds of turns (H100 80GB HBM3, 700.00 W; measure.py's
# DECODE_DEEP_TIMER; each tree's first process, which builds the kernels,
# set aside, PERF.md): d = 128, k' = 128: 83,886 docs 0.353 to 0.356 /
# 0.427 to 0.429, 104,857 0.427 to 0.428 / 0.482 to 0.493, 125,829 0.532 to
# 0.551 / 0.479 to 0.525; k' = 256: 0.388 to 0.389 / 0.553 to 0.560, 0.468
# to 0.486 / 0.600 to 0.606, 0.595 to 0.603 / 0.647 to 0.663; d = 768, k' =
# 128: 125,829 1.065 to 1.068 / 0.690 to 0.704, 262,144 2.161 to 2.202 /
# 1.419 to 1.439. The deep launch stays faster at d = 128 over 83,886 and
# 104,857 docs at k' = 128 and over all three at k' = 256 (the fold's fixed
# cost of a launch, about 0.26 ms, and about 13 us a tile of a split,
# PERF.md); the plan takes the fold there too, one route at every shard
# size: a regression of about 0.12 ms a low-rank step on the small shards,
# against 0.93 ms gained on pubmed's (PERF.md section 5).
W_TILE_Q = 128
W_TILE_D = deep_topk.FOLD_TILE     # csrc/fused_topk.cu WTD
W_MAX_WAVES = 8
# the f32 scan (csrc/fused_topk.cu F_*): 128 query rows and 128 docs a
# tile, a ring of up to 6 stages of a [128 x 32] f32 query box and doc box
# (TMA), beside the rows' lists and candidate buffers of 32; one block an
# SM, so its splits are planned as the wgmma scan's
F32_TILE_Q = 128
F32_TILE_D = 128
F32_MAX_STAGES = 6
F32_STAGE_BYTES = 2 * 128 * 32 * 4
F32_CAP = 32                      # a row's candidate buffer (W_CAP)
# the small-batch f32 scan (csrc/fused_topk.cu S_*): query tiles of 8, 32 or
# 64 rows (a template argument each), doc tiles of 256 (a [256 x 32] f32 doc
# box a stage beside the [rows x 32] query box), up to 6 stages, each row's
# candidate buffer of 64 (a step adds at most 32)
F32S_ROWS = (8, 32, 64)
F32S_TILE_D = 256
F32S_MAX_STAGES = 6
F32S_CAP = 64


def f32_scan_pays(bsz: int) -> bool:
    """Whether the f32 scan (128-row tiles) beats the small-batch scan at
    ``bsz`` query rows: past one small-batch tile of 64 rows. Up to 64 rows
    the small-batch scan reads the docs once for its one query tile; from
    65 it takes two tiles, and each tile re-reads the docs (device ms over
    734,003 x 768 f32, k = 32, small-batch / f32 scan: B = 8 0.77 / 3.45,
    64 2.01 / 3.61, 65 3.82 / 3.62, 96 3.83 / 3.68, 128 3.82 / 3.77; over
    104,857 docs 64 0.47 / 0.68, 65 0.73 / 0.69, 96 0.73 / 0.73, 128 0.73 /
    0.77; H100 80GB HBM3 at 700 W, ``measure.py --kernels``, PERF.md)."""
    return bsz > F32S_ROWS[-1]


def f32_small_rows(bsz: int) -> int:
    """The small-batch scan's query tile at ``bsz`` rows: the least of
    :data:`F32S_ROWS` that holds them (8 for the batcher's buckets 1 and 8,
    32 for 32), and 64 rows a tile past 64."""
    return next((t for t in F32S_ROWS if bsz <= t), F32S_ROWS[-1])


def f32_small_smem_bytes(rows: int, stages: int, k: int) -> int:
    """Shared memory of the small-batch scan (``s_smem_bytes`` in the
    source): the ring (a 32 KB doc box and a [rows x 32] query box a
    stage), the rows' lists of ``k``, their buffers and counts, the
    barriers, 1024 bytes to align the ring."""
    return (stages * (F32S_TILE_D + rows) * 32 * 4
            + rows * ((k + F32S_CAP) * 8 + 4) + 2 * stages * 8 + 1024)


def f32_small_stages(rows: int, k: int) -> int:
    """The small-batch scan's ring at ``rows`` a tile and depth ``k``: as
    many stages as fit, at most :data:`F32S_MAX_STAGES` (6 at 8 rows, 5 at
    32, 4 at 64)."""
    return max(n for n in range(2, F32S_MAX_STAGES + 1)
               if f32_small_smem_bytes(rows, n, k) <= SMEM_OPTIN)


SMEM_OPTIN = 232_448              # shared memory a block of an H100 may take
_F32, _BF16, _I8 = 0, 1, 2
_DOC_TYPES = {torch.float32: _F32, torch.bfloat16: _BF16, torch.int8: _I8}
_INT4_PER_DOC, _INT4_PER_GROUP = 3, 4    # csrc DocType kI4, kI4G


def scan_takes(d: int, doc_type: int) -> bool:
    """Whether the wgmma scan takes docs of width ``d`` and ``doc_type``
    (csrc DocType): bf16 and int8 at every width the kernel takes, int4
    where a packed row is a whole number of 16 bytes (``d % 32``: the
    TMA's row stride); f32 never (TF32 would change its answers)."""
    if doc_type in (_INT4_PER_DOC, _INT4_PER_GROUP):
        return d % 32 == 0
    return doc_type in (_BF16, _I8)


def f32_smem_bytes(stages: int, k: int) -> int:
    """Shared memory of the f32 scan (``f_smem_bytes`` in the source): the
    ring, the 128 rows' lists of ``k``, their candidate buffers and counts,
    the barriers, 1024 bytes to align the ring."""
    return (stages * F32_STAGE_BYTES + F32_TILE_Q * ((k + F32_CAP) * 8 + 4)
            + 2 * stages * 8 + 1024)


def f32_stages(k: int) -> int:
    """The f32 scan's ring at depth ``k``: as many stages as fit, at most
    :data:`F32_MAX_STAGES` (5 at k <= 32, 4 at k = 64)."""
    return max(n for n in range(2, F32_MAX_STAGES + 1)
               if f32_smem_bytes(n, k) <= SMEM_OPTIN)


def gain_form(queries: Tensor, docs: Tensor, *, mode: str,
              bias: Optional[Tensor] = None, packed4: bool = False
              ) -> Tuple[Tensor, Optional[Tensor]]:
    """The kernel's operands: gain-form queries cast to the docs' compute
    dtype (bf16 for int8 docs) and the f32 gain-form bias."""
    _validate(mode)
    d = queries.shape[1]
    if packed4:
        if docs.shape[1] * 2 != d:
            raise ValueError(
                f"packed4 docs width {docs.shape[1]} != d/2 = {d // 2}")
        if bias is None and mode == "l2":
            raise ValueError("packed4 l2 shards must pass the precomputed "
                             "bias (it cannot be derived from packed bytes)")
    q = _prepare_queries(queries, mode)
    if bias is None:
        b = None if packed4 else doc_bias(docs, mode)
    else:
        b = bias.to(torch.float32)
    compute = torch.bfloat16 if docs.dtype == torch.int8 else docs.dtype
    return q.to(compute), b


def fused_topk_reference(q: Tensor, docs: Tensor, k: int, *,
                         valid_docs: Optional[int] = None,
                         bias: Optional[Tensor] = None,
                         scale: Optional[Tensor] = None,
                         packed4: bool = False) -> Tuple[Tensor, Tensor]:
    """Plain version of the kernel: gain-form ``q`` (already cast to the
    docs' compute dtype) against ``docs``; returns ``(gains [B, k] f32,
    indices [B, k] i64)`` best first, ties to the lower index, index 0 on
    ``-inf`` entries."""
    n = docs.shape[0]
    if packed4:
        docs = unpack_int4(docs)
        if scale is not None and scale.dim() == 2:
            # per-group dequant before the product, in the compute dtype,
            # as the TPU kernel does it
            g = scale.shape[1]
            docs = (docs.to(q.dtype).reshape(n, g, -1)
                    * scale[:, :, None].to(q.dtype)).reshape(n, -1)
            scale = None
    gains = q.to(torch.float32) @ docs.to(torch.float32).T
    if scale is not None:
        gains = gains * scale[None, :]
    if bias is not None:
        gains = gains + bias[None, :]
    if valid_docs is not None and valid_docs < n:
        gains[:, valid_docs:] = NEG_INF
    top_g, top_i = topk_stable(gains, k)
    return top_g, torch.where(torch.isneginf(top_g), 0, top_i)


def _lib():
    from ragroute_tpu_torch.ops import _build

    lib, _ = _build.load("fused_topk")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.fused_topk_launch.argtypes = [vp] * 8 + [ci] * 8 + [vp]
        lib.fused_topk_launch.restype = ci
        lib.fused_topk_deep_launch.argtypes = [vp] * 11 + [ci] * 8 + [vp]
        lib.fused_topk_deep_launch.restype = ci
        lib.fused_topk_wgmma_launch.argtypes = [vp] * 8 + [ci] * 8 + [vp]
        lib.fused_topk_wgmma_launch.restype = ci
        lib.fused_topk_fold_launch.argtypes = [vp] * 12 + [ci] * 10 + [vp]
        lib.fused_topk_fold_launch.restype = ci
        lib.fused_topk_f32_launch.argtypes = [vp] * 8 + [ci] * 7 + [vp]
        lib.fused_topk_f32_launch.restype = ci
        lib.fused_topk_f32_small_launch.argtypes = [vp] * 8 + [ci] * 8 + [vp]
        lib.fused_topk_f32_small_launch.restype = ci
        lib._argtypes_set = True
    return lib


class Plan(NamedTuple):
    """How one call runs: ``kernel`` is ``"wgmma"`` (the scan),
    ``"fold"`` (the scan with the deep fold), ``"f32"`` (the f32 scan),
    ``"f32_small"`` (the small-batch f32 scan), ``"shallow"`` (the first
    design) or ``"deep"`` (the gains' round trip through device memory);
    ``splits`` doc splits of ``tiles_per_split`` tiles of ``tile_d`` docs
    (unused by the deep launch); the fold's ``cap`` candidate slots a
    (row, split). The small-batch scan's query tile is
    :func:`f32_small_rows` of the batch."""
    kernel: str
    splits: int
    tiles_per_split: int
    tile_d: int
    cap: int = 0


def fold_takes(bsz: int, d: int, k: int, doc_type: int,
               cap: Optional[int] = None) -> bool:
    """Whether the deep fold takes a list of ``k`` over docs the scan
    takes: past :data:`SHALLOW_K` up to ``deep_topk.FOLD_MAX_K``, with the
    workspace of one split under ``cap`` (default
    ``deep_topk.WORKSPACE_CAP``)."""
    cap = deep_topk.WORKSPACE_CAP if cap is None else cap
    return (scan_takes(d, doc_type)
            and SHALLOW_K < k <= deep_topk.FOLD_MAX_K
            and deep_topk.fold_bytes(bsz, 1, k) <= cap)


def _wave_splits(n_tiles: int, n_qtiles: int, sms: int,
                 max_splits: int = MAX_SPLITS) -> Tuple[int, int]:
    """``(splits, tiles a split)`` of the wgmma launches, whose blocks take
    a whole SM: the split count of at most :data:`W_MAX_WAVES` waves that
    finishes soonest (waves times tiles a split), the fewest splits among
    equals, at most ``max_splits``."""
    best = None
    for waves in range(1, W_MAX_WAVES + 1):
        # the split counts that fill these waves, and the largest that
        # stays inside them
        for want in (-(-waves * sms // n_qtiles), waves * sms // n_qtiles):
            want = max(1, min(n_tiles, max_splits, want))
            per = -(-n_tiles // want)
            splits = -(-n_tiles // per)
            cost = -(-n_qtiles * splits // sms) * per
            if best is None or cost < best[0]:
                best = (cost, splits, per)
    return best[1], best[2]


def _plan(bsz: int, n_rows: int, d: int, k: int, doc_type: int, sms: int,
          kernel: Optional[str] = None, cap: Optional[int] = None) -> Plan:
    """The launch for ``bsz`` queries over ``n_rows`` docs of width ``d``
    and ``doc_type`` (csrc DocType) at depth ``k`` on a card of ``sms``
    SMs, with ``cap`` bytes of workspace (default
    ``deep_topk.WORKSPACE_CAP``); a pure function of these. ``kernel``
    names one to plan for instead of choosing (the measurements time the
    launches against each other at one shape); a launch the shape does not
    fit raises. Lists past :data:`SHALLOW_K` take the deep fold where it
    takes them (:func:`fold_takes`), at every shard size, else the deep
    launch; shallower lists
    take the wgmma scan where it takes the docs; f32 docs up to
    :data:`SHALLOW_K` the f32 scan where it pays (:func:`f32_scan_pays`)
    and the small-batch f32 scan below it; else the first design. The doc
    splits fill the card at small and large batch alike: the first
    design's blocks are small (several an SM); the wgmma launches' and the
    f32 scans' take a whole SM (:func:`_wave_splits`), the fold's also no
    more than its workspace allows."""
    if kernel is None:
        if k > SHALLOW_K and fold_takes(bsz, d, k, doc_type, cap):
            kernel = "fold"
        elif k > MAX_SHALLOW_K:
            kernel = "deep"
        elif doc_type == _F32 and k <= SHALLOW_K:
            kernel = "f32" if f32_scan_pays(bsz) else "f32_small"
        elif not scan_takes(d, doc_type):
            kernel = "shallow"
        elif k > SHALLOW_K:     # the fold's workspace over the cap
            kernel = "deep"
        else:
            kernel = "wgmma"
    elif kernel == "wgmma" and (k > SHALLOW_K or not scan_takes(d, doc_type)):
        raise ValueError(f"fused_topk: the wgmma scan does not take k={k} "
                         f"over doc type {doc_type} at d={d}")
    elif kernel in ("f32", "f32_small") and (k > SHALLOW_K
                                             or doc_type != _F32):
        raise ValueError(f"fused_topk: the f32 scan does not take k={k} "
                         f"over doc type {doc_type}")
    elif kernel == "fold" and not fold_takes(bsz, d, k, doc_type, cap):
        raise ValueError(f"fused_topk: the deep fold does not take k={k} "
                         f"over doc type {doc_type} at d={d}, B={bsz}")
    if kernel == "deep":
        return Plan("deep", 1, 1, 0)
    if kernel == "fold":
        n_tiles = -(-n_rows // W_TILE_D)
        rows = deep_topk.fold_bytes(bsz, 0, k)
        limit = ((deep_topk.WORKSPACE_CAP if cap is None else cap) - rows) \
            // (deep_topk.fold_bytes(bsz, 1, k) - rows)
        splits, per = _wave_splits(n_tiles, -(-bsz // W_TILE_Q), sms,
                                   min(MAX_SPLITS, limit))
        wide = deep_topk.fold_bytes(bsz, splits, k, per) <= (
            deep_topk.WORKSPACE_CAP if cap is None else cap)
        return Plan("fold", splits, per, W_TILE_D,
                    deep_topk.fold_cap(k, per if wide else None))
    if kernel == "wgmma":
        n_tiles = -(-n_rows // W_TILE_D)
        splits, per = _wave_splits(n_tiles, -(-bsz // W_TILE_Q), sms)
        return Plan("wgmma", splits, per, W_TILE_D)
    if kernel == "f32":
        n_tiles = -(-n_rows // F32_TILE_D)
        splits, per = _wave_splits(n_tiles, -(-bsz // F32_TILE_Q), sms)
        return Plan("f32", splits, per, F32_TILE_D)
    if kernel == "f32_small":
        rows = f32_small_rows(bsz)
        n_tiles = -(-n_rows // F32S_TILE_D)
        splits, per = _wave_splits(n_tiles, -(-bsz // rows), sms)
        return Plan("f32_small", splits, per, F32S_TILE_D)
    n_qtiles = -(-bsz // TILE_Q)
    n_tiles = -(-n_rows // TILE_D)
    per_sm = BLOCKS_PER_SM if k <= SHALLOW_K else DEEP_BLOCKS_PER_SM
    splits = max(1, min(n_tiles, MAX_SPLITS,
                        math.ceil(per_sm * sms / n_qtiles)))
    per = -(-n_tiles // splits)
    return Plan("shallow", -(-n_tiles // per), per, TILE_D)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    """The card's SM count (asked once: a decode step launches the kernel
    hundreds of times)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(q: Tensor, docs: Tensor, k: int, n_rows: int,
            bias: Optional[Tensor], scale: Optional[Tensor],
            packed4: bool = False,
            workspace_cap: Optional[int] = None,
            kernel: Optional[str] = None) -> Tuple[Tensor, Tensor]:
    bsz, d = q.shape
    dev = docs.device
    grouped = scale is not None and scale.dim() == 2
    for name, t in (("q", q), ("bias", bias), ("scale", scale)):
        if t is not None and t.device != dev:
            raise ValueError(f"fused_topk: {name} on {t.device}, docs on {dev}")
    if docs.dtype not in _DOC_TYPES:
        raise TypeError(f"fused_topk: docs dtype {docs.dtype} not supported "
                        "by the kernel (float32, bfloat16, int8)")
    if n_rows < 1:
        raise ValueError("fused_topk: the shard has no valid rows")
    if k < 1:
        raise ValueError(f"fused_topk: need k >= 1, got k={k}")
    if packed4 and docs.dtype != torch.int8:
        raise TypeError("fused_topk: packed4 docs must be int8 bytes")
    if grouped and not packed4:
        raise ValueError("per-group scales are an int4 (packed4) format")
    if d % 16 or docs.shape[1] != (d // 2 if packed4 else d):
        raise ValueError(f"fused_topk: kernel needs docs [N, d] (or "
                         f"[N, d/2] packed) with d % 16 == 0 matching "
                         f"queries; got docs {tuple(docs.shape)}, queries "
                         f"{tuple(q.shape)}")
    n_groups = scale.shape[1] if grouped else 0
    if grouped and (d % n_groups or (d // n_groups) % 8):
        raise ValueError(f"fused_topk: {n_groups} scale groups do not cut "
                         f"d={d} into slices of a multiple of 8 dims")
    if not docs.is_contiguous() or docs.data_ptr() % 16:
        raise ValueError("fused_topk: docs must be contiguous and 16-byte "
                         "aligned")
    for name, t, dims in (("bias", bias, 1),
                          ("scale", scale, 2 if grouped else 1)):
        if t is not None and (t.dtype != torch.float32 or t.dim() != dims
                              or t.shape[0] < n_rows
                              or not t.is_contiguous()):
            raise ValueError(f"fused_topk: {name} must be a contiguous "
                             f"float32 tensor over the shard's rows")
    q = q.contiguous()
    if q.data_ptr() % 16:       # the wgmma scan's TMA reads need 16 bytes
        q = q.clone()
    doc_type = ((_INT4_PER_GROUP if grouped else _INT4_PER_DOC) if packed4
                else _DOC_TYPES[docs.dtype])
    plan = _plan(bsz, n_rows, d, k, doc_type, _sm_count(dev), kernel,
                 workspace_cap)
    if plan.kernel == "deep":
        return _launch_deep(q, docs, k, n_rows, bias, scale, n_groups,
                            doc_type, workspace_cap)
    if plan.kernel == "fold":
        return _launch_fold(q, docs, k, n_rows, bias, scale, n_groups,
                            doc_type, plan)
    splits, per = plan.splits, plan.tiles_per_split
    part_g = torch.empty((bsz, splits, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((bsz, splits, k), dtype=torch.int32, device=dev)
    out_g = torch.empty((bsz, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((bsz, k), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = (q.data_ptr(), docs.data_ptr(),
            None if bias is None else bias.data_ptr(),
            None if scale is None else scale.data_ptr(),
            part_g.data_ptr(), part_i.data_ptr(), out_g.data_ptr(),
            out_i.data_ptr())
    if plan.kernel == "wgmma":
        err = _lib().fused_topk_wgmma_launch(*ptrs, bsz, n_rows, d, k,
                                             n_groups, splits, per, doc_type,
                                             stream)
    elif plan.kernel == "f32":
        err = _lib().fused_topk_f32_launch(*ptrs, bsz, n_rows, d, k, splits,
                                           per, f32_stages(k), stream)
    elif plan.kernel == "f32_small":
        rows = f32_small_rows(bsz)
        err = _lib().fused_topk_f32_small_launch(
            *ptrs, bsz, n_rows, d, k, rows, splits, per,
            f32_small_stages(rows, k), stream)
    else:
        err = _lib().fused_topk_launch(*ptrs, bsz, n_rows, d, k, n_groups,
                                       splits, per, doc_type, stream)
    if err != 0:
        raise RuntimeError(f"fused_topk {plan.kernel} launch failed for "
                           f"queries [{bsz}, {d}] over docs [{n_rows}, "
                           f"{docs.shape[1]}] {docs.dtype} k={k}: CUDA error "
                           f"{err}")
    fused_topk.launches += 1
    fused_topk.wgmma_launches += plan.kernel == "wgmma"
    fused_topk.f32_launches += plan.kernel == "f32"
    fused_topk.f32_small_launches += plan.kernel == "f32_small"
    return out_g, out_i


_FOLD_SCRATCH: Dict[Tuple[torch.device, int], Tuple[Tensor, Tensor,
                                                      Tensor]] = {}


def _fold_scratch(dev: torch.device, stream: int, bsz: int
                  ) -> Tuple[Tensor, Tensor, Tensor]:
    """The deep fold's row state for launches on ``stream``: each row's
    shared bound (int64 words), merged splits and lock (int32), ``bsz``
    rows or more, zero. The launches of one stream run in order and each
    leaves the state at zero (a row's last split clears it), so it is made
    once and grown only for a larger batch, as K2's collect keeps its
    counters (``stream_topk._collect_scratch``)."""
    key = (dev, stream)
    have = _FOLD_SCRATCH.get(key)
    if have is None or have[0].numel() < bsz:
        rows = max(bsz, 512, 0 if have is None else have[0].numel())
        have = (torch.zeros(rows, dtype=torch.int64, device=dev),
                torch.zeros(rows, dtype=torch.int32, device=dev),
                torch.zeros(rows, dtype=torch.int32, device=dev))
        _FOLD_SCRATCH[key] = have
    return have


def _launch_fold(q: Tensor, docs: Tensor, k: int, n_rows: int,
                 bias: Optional[Tensor], scale: Optional[Tensor],
                 n_groups: int, doc_type: int,
                 plan: Plan) -> Tuple[Tensor, Tensor]:
    """The deep fold (lists past :data:`SHALLOW_K` over docs the scan
    takes), operands checked by :func:`_launch`: one scan launch whose rows
    keep their candidates in ``cand`` (``[B, splits, cap]`` 64-bit words)
    and merge their (row, split) lists into ``run`` (``[B, k]`` words) in
    the same launch."""
    bsz, d = q.shape
    dev = docs.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    cand = torch.empty((bsz, plan.splits, plan.cap), dtype=torch.int64,
                       device=dev)
    sample = deep_topk.fold_sample_tiles(k)
    samp = torch.empty((bsz, sample * W_TILE_D), dtype=torch.int64,
                       device=dev)
    run = torch.empty((bsz, k), dtype=torch.int64, device=dev)
    seed, count, lock = _fold_scratch(dev, stream, bsz)
    out_g = torch.empty((bsz, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((bsz, k), dtype=torch.int64, device=dev)
    err = _lib().fused_topk_fold_launch(
        q.data_ptr(), docs.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if scale is None else scale.data_ptr(), cand.data_ptr(),
        samp.data_ptr(), run.data_ptr(), seed.data_ptr(), count.data_ptr(),
        lock.data_ptr(), out_g.data_ptr(), out_i.data_ptr(), bsz, n_rows, d,
        k, n_groups, plan.splits, plan.tiles_per_split, plan.cap, sample,
        doc_type, stream)
    if err != 0:
        # a launch that did not run to its end may leave the state dirty
        _FOLD_SCRATCH.pop((dev, stream), None)
        raise RuntimeError(f"fused_topk fold launch failed for queries "
                           f"[{bsz}, {d}] over docs [{n_rows}, "
                           f"{docs.shape[1]}] {docs.dtype} k={k}: CUDA error "
                           f"{err}")
    fused_topk.launches += 1
    fused_topk.fold_launches += 1
    return out_g, out_i


def _launch_deep(q: Tensor, docs: Tensor, k: int, n_rows: int,
                 bias: Optional[Tensor], scale: Optional[Tensor],
                 n_groups: int, doc_type: int,
                 cap: Optional[int]) -> Tuple[Tensor, Tensor]:
    """The deep launch (lists the fold and the first design do not take),
    operands checked by :func:`_launch`."""
    bsz, d = q.shape
    dev = docs.device
    p = deep_topk.fused_plan(bsz, n_rows, k, cap)

    def words(n):
        return torch.empty((p.rows, max(1, n)), dtype=torch.int64, device=dev)

    ws_g = torch.empty((p.rows, p.chunk), dtype=torch.float32, device=dev)
    ws_a, ws_b, run0, run1 = (words(p.entries), words(p.entries),
                              words(2 * k), words(2 * k))
    out_g = torch.empty((bsz, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((bsz, k), dtype=torch.int64, device=dev)
    err = _lib().fused_topk_deep_launch(
        q.data_ptr(), docs.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if scale is None else scale.data_ptr(), ws_g.data_ptr(),
        ws_a.data_ptr(), ws_b.data_ptr(), run0.data_ptr(), run1.data_ptr(),
        out_g.data_ptr(), out_i.data_ptr(), bsz, n_rows, d, k, n_groups,
        doc_type, p.rows, p.chunk,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_topk deep launch failed: "
                           f"{deep_topk.describe(err)}")
    fused_topk.launches += 1
    fused_topk.deep_launches += 1
    return out_g, out_i


def fused_topk(queries: Tensor, docs: Tensor, k: int, *, mode: str = "dot",
               valid_docs: Optional[int] = None,
               bias: Optional[Tensor] = None,
               scale: Optional[Tensor] = None,
               packed4: bool = False,
               workspace_cap: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """Exact top-k of ``score(q, d)`` over a shard, fused on the card.

    Args as :func:`ragroute_tpu.ops.pallas_topk.pallas_topk`: ``queries``
    ``[B, d]``; ``docs`` ``[N, d]`` (f32 / bf16 / int8, or int4-packed
    ``[N, d/2]`` with ``packed4``); ``bias`` the gain-form ``[N]`` bias;
    ``scale`` the per-doc ``[N]`` (or per-group ``[N, G]`` for int4)
    dequantization factor; ``valid_docs`` the number of real rows;
    ``workspace_cap`` the deep launch's workspace in bytes (default
    ``deep_topk.WORKSPACE_CAP``).

    Returns ``(scores [B, k], indices [B, k])`` in natural score form, best
    first. A CUDA tensor runs the kernel (the launch :func:`_plan` picks
    from the shape); a CPU tensor runs :func:`fused_topk_reference`.
    """
    bsz = queries.shape[0]
    n = docs.shape[0]
    valid = n if valid_docs is None else int(valid_docs)
    q, b = gain_form(queries, docs, mode=mode, bias=bias, packed4=packed4)
    if docs.is_cuda:
        if bsz == 0:
            gains = torch.empty((0, k), dtype=torch.float32,
                                device=docs.device)
            idx = torch.empty((0, k), dtype=torch.int64, device=docs.device)
        else:
            gains, idx = _launch(q, docs, k, min(valid, n), b,
                                 None if scale is None
                                 else scale.to(torch.float32),
                                 packed4=packed4,
                                 workspace_cap=workspace_cap)
    else:
        gains, idx = fused_topk_reference(q, docs, k, valid_docs=valid,
                                          bias=b, scale=scale,
                                          packed4=packed4)
    return gain_to_natural(gains, queries, mode), idx


fused_topk.launches = 0   # kernel launches since the count was last reset
fused_topk.deep_launches = 0   # of which deep launches
fused_topk.wgmma_launches = 0  # of which the wgmma scan
fused_topk.fold_launches = 0   # of which the scan with the deep fold
fused_topk.f32_launches = 0    # of which the f32 scan
fused_topk.f32_small_launches = 0   # of which the small-batch f32 scan
