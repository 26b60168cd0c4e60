"""Kernel-against-plain checks for the hand-written kernels on the card.

Shared by the card-only tests (``tests/test_torch_kernel.py``) and
``chip_smoke.py``: both run the wrappers on CUDA tensors, which launches
``csrc/fused_topk.cu``, ``csrc/stream_topk.cu``, ``csrc/grouped_gains.cu``
and ``csrc/grouped_pair_topk.cu``, and hold each against its plain version
on the same device and the same operands.

Fused top-k (:func:`fused_topk` against :func:`fused_topk_reference`):

* :func:`exact_cases`: integer-valued data in [-4, 4] (queries of norm 4
  for cos, power-of-two scales), so every product and sum is exact in any
  order: indices and scores must be equal. Duplicate doc rows put ties
  across tile, split and k boundaries. f32 / bf16 / int8 / int4 with
  per-doc and per-group scales, k from 10 to 160.
* :func:`wgmma_exact_cases`: the same kind of data through the wgmma scan
  (bf16 docs, k 10 to 64): a partial query block, partial doc tiles,
  contraction chunks past d, a -inf bias tail, ``valid_docs < N`` and
  splits of several tiles; :func:`quant_exact_cases` the same for int8
  docs and int4 docs with no, per-doc and per-group scales (a packed row
  of 32, 48 and 96 bytes: raw boxes past the row, and its two halves).
* :func:`f32_exact_cases`: the same kind of data through the f32 scan (f32
  docs, k 1 to 64; B = 200) or the small-batch f32 scan (B in
  :data:`F32_SMALL_BATCHES`): a partial query tile, partial doc tiles,
  contraction chunks past d, dot / l2 / cos, a -inf bias tail,
  ``valid_docs < N``, per-doc scales and splits of several tiles.
* :func:`deep_exact_cases`: the same kind of data past the shallow depth
  (k 161 to 1,100 over 20,000 docs, three select runs), through the deep
  launch, with chunks of docs and slices of query rows forced by a small
  workspace cap (``Case.cap``).
* :func:`fold_exact_cases`: the same kind of data through the wgmma scan's
  deep fold (k 65 to 1,024; bf16, int8 and int4 docs): gains that tie by
  the thousand, so every row's candidates overflow and are cut many times;
  a partial query block, partial doc tiles, splits of several tiles, one
  split forced by the workspace cap, lists longer than the valid rows, a
  -inf bias tail and ``valid_docs < N``.
* :func:`mutable_exact_cases`: the same kind of data over a live shard's
  rows (a capacity on the 512-row grid, every row scanned, ``-inf`` bias
  holes anywhere: scattered, in runs, on one copy of a duplicated row, a
  free tail, a shard with fewer live rows than k), each case named with
  the launch it must be held on: the wgmma scan (bf16, int8, int4 per-doc
  and per-group), the f32 scan, the first design, the deep fold and the
  deep launch.
* :func:`compare_tolerant`: the path's shapes (bf16 operands, different
  summation order): scores within ``1e-3 * max|score|``, winner-set recall,
  and every disagreement a near-tie at the k boundary.

Streaming top-k (:func:`stream_topk` against :func:`stream_topk_reference`):
:func:`stream_exact_cases` (ties across group, split and k boundaries,
``-inf`` entries and rows, rows shorter than 2k or off the 16-byte grid,
sorted runs, long rows cut into splits: the select path's runs and the
collect's, whose rows sit off the 16-byte grid; deep lists from 161 to ``k =
M`` over one run and over runs merged), :func:`stream_runs_case` (the
probed collect's sorted runs) and :func:`stream_path_case`; the kernel does no
arithmetic, so both must come out equal.

Grouped gains (:func:`grouped_gains` against :func:`grouped_gains_reference`):
:func:`grouped_exact_cases` (integer data, every slab type, ``S`` from 8 to
328: one to four column tiles, ragged ones, two passes of the wgmma kernel;
the row table and the real-block count) come out equal, through the plan
and through each kernel by name (:func:`run_grouped_kernel`);
:func:`grouped_path_case` (bf16, int8 or int4 slabs) is held within ``1e-3
* max|gain|``.

Grouped pair top-k (:func:`grouped_pair_topk` against
:func:`grouped_pair_topk_reference`): :func:`pair_exact_cases` (integer
data: one tile and two, ``S`` off the 128 grid, an empty cluster, a block of
padding rows, equal gains across a tile boundary, an l2-style bias,
``ranks`` 1 to 64, and deep ranks 200 and 256 through the deep launch,
one of them in chunks of two blocks) come out equal in gains, and in slots
where the gain is finite; :func:`pair_path_case` is held within ``1e-4``
relative, with at most a millionth of its clearly ordered slots differing (near-ties at a
tile's rank cut), each differing slot carrying the gain written for it.
:func:`run_pair_kernel` takes the launch to run (``"wgmma"``, ``"shallow"``,
``"deep"``) in place of the wrapper's plan.

:func:`k1_bound` to :func:`k4_bound` give the least time an H100 SXM could
take for a call, from the data-sheet peaks below.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ragroute_tpu_torch.index.shard import _pack_int4
from ragroute_tpu_torch.ops import deep_topk
from ragroute_tpu_torch.ops.fused_topk import _launch as _fused_launch
from ragroute_tpu_torch.ops.fused_topk import _plan as _fused_plan
from ragroute_tpu_torch.ops.fused_topk import (TILE_D, fused_topk,
                                               fused_topk_reference,
                                               gain_form)
from ragroute_tpu_torch.ops.grouped_gains import _plan as _grouped_plan
from ragroute_tpu_torch.ops.grouped_gains import (GROUP_ROWS, grouped_gains,
                                                  grouped_gains_reference)
from ragroute_tpu_torch.ops.grouped_topk import _launch as _pair_launch
from ragroute_tpu_torch.ops.grouped_topk import _plan as _pair_plan
from ragroute_tpu_torch.ops.grouped_topk import (PAIR_ROWS, ClusteredCoarse,
                                                 grouped_pair_topk,
                                                 grouped_pair_topk_reference,
                                                 probe_dispatch, tiling)
from ragroute_tpu_torch.ops import stream_topk as _stream
from ragroute_tpu_torch.ops.stream_topk import (stream_topk,
                                                stream_topk_reference)
from ragroute_tpu_torch.ops.topk import NEG_INF, gain_to_natural

Tensor = torch.Tensor

# H100 SXM data-sheet peaks (dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12,
              torch.int8: 989e12}   # int8 / int4 codes are multiplied as bf16


@dataclasses.dataclass
class Case:
    name: str
    queries: Tensor
    docs: Tensor
    k: int
    mode: str
    bias: Optional[Tensor] = None
    scale: Optional[Tensor] = None
    valid_docs: Optional[int] = None
    packed4: bool = False
    cap: Optional[int] = None       # deep launches: workspace cap to run at


FOLD_KS = (65, 128, 160, 256, 600, 1024)


def fold_exact_cases(device, *, bsz: int = 150, seed: int = 7
                     ) -> Iterator[Case]:
    """Exact-arithmetic cases of the deep fold (k in :data:`FOLD_KS`):
    integer data in [-4, 4] at d = 64, so gains tie by the thousand and a
    row's candidate buffer overflows and is cut many times; 150 query rows
    (a second, partial block of 128); 845 docs (partial doc tiles) and
    20,000 (splits of several tiles); duplicate rows either side of the tile
    boundaries. bf16 dot, int8 with power-of-two per-doc scales and int4
    with per-group scales at every k up to the docs; over 845 docs also
    bf16 l2, a -inf bias tail and ``valid_docs < N``; a list past the 900
    valid rows of 20,000; and one split forced by the workspace cap."""
    rng = np.random.default_rng(seed)
    d = 64
    for rows in (3 * 256 + 77, 20_000):
        docs = rng.integers(-4, 5, (rows, d)).astype(np.float32)
        for src, dsts in ((7, (191, 192, 383, 384, 575, 576, rows - 1)),
                          (11, (100, 101, 767, 768, rows - 2))):
            docs[list(dsts)] = docs[src]

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        q = t(rng.integers(-4, 5, (bsz, d)).astype(np.float32))
        scale = t((2.0 ** rng.integers(-3, 2, rows)).astype(np.float32))
        gscale = t((2.0 ** rng.integers(-3, 2, (rows, d // 16))
                    ).astype(np.float32))
        bf16 = t(docs).to(torch.bfloat16)
        int8 = t(docs.astype(np.int8))
        packed = t(_pack_int4(docs.astype(np.int8)))
        tail = torch.zeros(rows, dtype=torch.float32, device=device)
        tail[rows - 300:] = NEG_INF
        for k in (k for k in FOLD_KS if k <= rows):
            name = f"fold-n{rows}"
            yield Case(f"{name}-bf16-dot-k{k}", q, bf16, k, "dot")
            yield Case(f"{name}-int8-dot-k{k}", q, int8, k, "dot",
                       scale=scale)
            yield Case(f"{name}-int4-group-dot-k{k}", q, packed, k, "dot",
                       scale=gscale, packed4=True)
            if rows > 1000:
                continue
            yield Case(f"{name}-bf16-l2-k{k}", q, bf16, k, "l2")
            yield Case(f"{name}-bf16-inf-tail-k{k}", q, bf16, k, "dot",
                       bias=tail)
            yield Case(f"{name}-int8-valid-k{k}", q, int8, k, "dot",
                       scale=scale, valid_docs=rows - 200)
    yield Case("fold-n20000-bf16-dot-k1024-valid900", q, bf16, 1024, "dot",
               valid_docs=900)
    yield Case("fold-n20000-bf16-dot-k256-one-split", q, bf16, 256, "dot",
               cap=deep_topk.fold_bytes(bsz, 1, 256))


# the low-rank world's three small coarse shards (medrag's textbooks,
# statpearls and wikipedia at rank 128), which the deep fold takes
SMALL_SHARDS = (83_886, 104_857, 125_829)


def small_shard_exact_cases(device, *, bsz: int = 512, d: int = 128,
                            seed: int = 12) -> Iterator[Case]:
    """Exact-arithmetic cases of the deep fold at the shapes of
    :data:`SMALL_SHARDS` (B = 512, rank 128): integer data in [-4, 4], made
    on the card, so that gains tie by the thousand and the k'-th best ties
    across splits; bf16 docs at k' = 128 and 256, int8 docs with
    power-of-two per-doc scales at k' = 128, and bf16 docs with a -inf bias
    on their last 1,000 rows."""
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randint(-4, 5, (bsz, d), generator=g, device=device).float()
    for n in SMALL_SHARDS:
        codes = torch.randint(-4, 5, (n, d), generator=g, device=device,
                              dtype=torch.int8)
        bf16 = codes.to(torch.bfloat16)
        for k in (128, 256):
            yield Case(f"small-n{n}-bf16-k{k}", q, bf16, k, "dot")
        if n == SMALL_SHARDS[1]:
            scale = 2.0 ** torch.randint(-3, 2, (n,), generator=g,
                                         device=device).float()
            yield Case(f"small-n{n}-int8-k128", q, codes, 128, "dot",
                       scale=scale)
        if n == SMALL_SHARDS[0]:
            tail = torch.zeros(n, dtype=torch.float32, device=device)
            tail[n - 1000:] = NEG_INF
            yield Case(f"small-n{n}-bf16-inf-tail-k128", q, bf16, 128, "dot",
                       bias=tail)


def one_lane_exact_cases(device, *, bsz: int = 512, d: int = 128,
                         seed: int = 13) -> Iterator[Case]:
    """Exact-arithmetic cases of the deep fold whose candidates all fall to
    one lane of a row's quad: a -inf bias but at positions 0 and 1 mod 8
    (and there on a random 30% too), so that lane nears its quarter of the
    buffer while the row holds fewer than k' words, which must be packed
    and bound nothing. Integer data in [-4, 4] (gains tied by the
    thousand), B = 512, rank 128: k' = 128 over 300,000 docs (splits of
    more than ``deep_topk.FOLD_SHORT_TILES`` tiles: the 4k buffer), k' =
    256 and k' = 600 (no sample, the buffers packed after the scan) over
    83,886."""
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randint(-4, 5, (bsz, d), generator=g, device=device).float()
    for n, ks in ((300_000, (128,)), (SMALL_SHARDS[0], (256, 600))):
        docs = torch.randint(-4, 5, (n, d), generator=g, device=device,
                             dtype=torch.int8).to(torch.bfloat16)
        pos = torch.arange(n, device=device)
        keep = (pos % 8 < 2) & (torch.rand(n, generator=g, device=device)
                                > 0.3)
        bias = torch.where(keep, 0.0, NEG_INF).float()
        for k in ks:
            yield Case(f"one-lane-n{n}-bf16-k{k}", q, docs, k, "dot",
                       bias=bias)


DEEP_KS = (161, 256, 600, 1100)
F32_KS = (1, 10, 32, 64)
# the small-batch f32 scan's batches: the batcher's buckets 1, 8 and 32, and
# its largest tile
F32_SMALL_BATCHES = (1, 8, 32, 64)


def f32_exact_cases(device, *, bsz: int = 200, seed: int = 9
                    ) -> Iterator[Case]:
    """Exact-arithmetic cases of the f32 scans (f32 docs, k in
    :data:`F32_KS`): integer data in [-4, 4] (cos queries of norm 4,
    power-of-two per-doc scales), so every sum is exact in any order; 200
    query rows (a second, partial query tile of 128; the plan takes the f32
    scan there), or ``bsz`` of :data:`F32_SMALL_BATCHES` (the small-batch
    scan's tiles of 8, 32 and 64 rows, partial at B = 1); 845 docs (a
    partial doc tile) at d 64, 80 (a contraction chunk past the columns)
    and 96; duplicate rows on both sides of the tile boundaries; at every k:
    dot, l2, cos, a -inf bias tail, ``valid_docs < N`` and a per-doc scale;
    and many docs at d = 64, where splits span several tiles (20,000 at B =
    200; 100,000 for the small-batch scan's tiles of 256)."""
    rng = np.random.default_rng(seed)
    many = 20_000 if bsz > F32_SMALL_BATCHES[-1] else 100_000
    for d, rows in ((64, 845), (80, 845), (96, 845), (64, many)):
        docs = rng.integers(-4, 5, (rows, d)).astype(np.float32)
        for src, dsts in ((7, (127, 128, 255, 256, 383, 384, rows - 1)),
                          (11, (511, 512, 639, 640, 767, 768))):
            docs[list(dsts)] = docs[src]
        q_cos = np.zeros((bsz, d), np.float32)
        for i in range(bsz):
            q_cos[i, rng.choice(d, 16, replace=False)] = rng.choice(
                [-1.0, 1.0], 16)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        q = t(rng.integers(-4, 5, (bsz, d)).astype(np.float32))
        f32 = t(docs)
        scale = t((2.0 ** rng.integers(-3, 2, rows)).astype(np.float32))
        tail = torch.zeros(rows, dtype=torch.float32, device=device)
        tail[rows - 100:] = NEG_INF
        for k in F32_KS:
            name = f"f32-d{d}-n{rows}"
            yield Case(f"{name}-dot-k{k}", q, f32, k, "dot")
            if rows > 1000:
                continue
            yield Case(f"{name}-l2-k{k}", q, f32, k, "l2")
            yield Case(f"{name}-cos-k{k}", t(q_cos), f32, k, "cos")
            yield Case(f"{name}-inf-tail-k{k}", q, f32, k, "dot", bias=tail)
            yield Case(f"{name}-valid-k{k}", q, f32, k, "dot",
                       valid_docs=rows - 200)
            yield Case(f"{name}-scale-k{k}", q, f32, k, "dot", scale=scale)


def exact_cases(device, *, bsz: int = 37, n: int = 3 * TILE_D + 17,
                d: int = 64, seed: int = 0) -> Iterator[Case]:
    """Exact-arithmetic cases: k 10 and 32 x modes dot/l2/cos x f32, bf16,
    int8 with scale; one with invalid tail rows; deep lists (k 128 and 160);
    int4-packed docs with no scale, per-doc scales and per-group scales."""
    rng = np.random.default_rng(seed)
    docs = rng.integers(-4, 5, (n, d)).astype(np.float32)
    # duplicate rows: ties across tile (63|64, 127|128), split and k
    # boundaries, on top of the many natural ties of small integer sums
    for src, dsts in ((3, (40, 63, 64, 100, 128, 150, 199, 208)),
                      (10, (62, 65, 127, 129, 130, 191, 192)),
                      (17, (18, 19, 20, 126, 190, 200, 201, 202))):
        docs[list(dsts)] = docs[src]
    q_int = rng.integers(-4, 5, (bsz, d)).astype(np.float32)
    # cos: 16 entries of +-1 give norm 4, so normalized queries are exact
    q_cos = np.zeros((bsz, d), np.float32)
    for i in range(bsz):
        pos = rng.choice(d, 16, replace=False)
        q_cos[i, pos] = rng.choice([-1.0, 1.0], 16)
    scale = (2.0 ** rng.integers(-3, 2, n)).astype(np.float32)
    to = dict(device=device)
    for k in (10, 32):
        for mode in ("dot", "l2", "cos"):
            q = torch.from_numpy(q_cos if mode == "cos" else q_int).to(**to)
            for dt in (torch.float32, torch.bfloat16):
                yield Case(f"{dt}-{mode}-k{k}", q,
                           torch.from_numpy(docs).to(**to).to(dt), k, mode)
            yield Case(f"int8-scale-{mode}-k{k}", q,
                       torch.from_numpy(docs).to(**to).to(torch.int8), k,
                       mode, scale=torch.from_numpy(scale).to(**to))
    yield Case("bf16-dot-k32-valid", torch.from_numpy(q_int).to(**to),
               torch.from_numpy(docs).to(**to).to(torch.bfloat16), 32, "dot",
               valid_docs=n - 9)
    for k in (128, 160):
        for dt in (torch.float32, torch.bfloat16):
            yield Case(f"{dt}-dot-k{k}", torch.from_numpy(q_int).to(**to),
                       torch.from_numpy(docs).to(**to).to(dt), k, "dot")
    # int4: codes in [-4, 4] packed two a byte; power-of-two scales keep
    # the bf16 dequant of the per-group form exact
    packed = torch.from_numpy(_pack_int4(docs.astype(np.int8))).to(**to)
    l2_bias = torch.from_numpy(-(docs * docs).sum(axis=1)).to(**to)
    gscale = (2.0 ** rng.integers(-3, 2, (n, d // 16))).astype(np.float32)
    for name, sc in (("none", None), ("doc", scale), ("group", gscale)):
        sc_t = None if sc is None else torch.from_numpy(sc).to(**to)
        yield Case(f"int4-{name}-dot-k32", torch.from_numpy(q_int).to(**to),
                   packed, 32, "dot", scale=sc_t, packed4=True)
        yield Case(f"int4-{name}-cos-k10", torch.from_numpy(q_cos).to(**to),
                   packed, 10, "cos", scale=sc_t, packed4=True)
    yield Case("int4-none-l2-k128", torch.from_numpy(q_int).to(**to), packed,
               128, "l2", bias=l2_bias, packed4=True)


WGMMA_KS = (10, 32, 64)


def wgmma_exact_cases(device, *, bsz: int = 150, n: int = 3 * 256 + 77,
                      seed: int = 5) -> Iterator[Case]:
    """Exact-arithmetic cases of the wgmma scan (bf16 docs, k up to 64):
    integer data in [-4, 4], 150 query rows (a second, partial block of
    128), 845 docs (a partial last tile of 256 and of 128), d 64, 80 (a
    contraction chunk past the columns) and 192 (three chunks); duplicate
    rows on both sides of the tile boundaries; at every k in
    :data:`WGMMA_KS`: dot, l2 (bias), a -inf bias tail and ``valid_docs <
    N``; and 20,000 docs, where splits span several tiles."""
    rng = np.random.default_rng(seed)
    for d, rows in ((64, n), (80, n), (192, n), (64, 20_000)):
        docs = rng.integers(-4, 5, (rows, d)).astype(np.float32)
        for src, dsts in ((7, (127, 128, 255, 256, 257, 511, 512, 767)),
                          (11, (383, 384, 640, 768, 769, rows - 1))):
            docs[list(dsts)] = docs[src]
        q = torch.from_numpy(rng.integers(-4, 5, (bsz, d)).astype(np.float32)
                             ).to(device)
        bf16 = torch.from_numpy(docs).to(device).to(torch.bfloat16)
        tail = torch.zeros(rows, dtype=torch.float32, device=device)
        tail[rows - 100:] = NEG_INF
        for k in WGMMA_KS:
            yield Case(f"wgmma-d{d}-n{rows}-dot-k{k}", q, bf16, k, "dot")
            if rows != n:
                continue
            yield Case(f"wgmma-d{d}-l2-k{k}", q, bf16, k, "l2")
            yield Case(f"wgmma-d{d}-inf-tail-k{k}", q, bf16, k, "dot",
                       bias=tail)
            yield Case(f"wgmma-d{d}-valid-k{k}", q, bf16, k, "dot",
                       valid_docs=rows - 200)


def quant_exact_cases(device, *, bsz: int = 150, n: int = 3 * 256 + 77,
                      seed: int = 6) -> Iterator[Case]:
    """Exact-arithmetic cases of the wgmma scan over int8 and int4 docs (k
    up to 64): integer codes in [-4, 4], power-of-two per-doc and
    per-group scales (16 dims a group), so that every product, dequant and
    sum is exact; 150 query rows, 845 docs (partial doc tiles), duplicate
    rows on both sides of the tile boundaries. d 64 (an int4 row of 32
    bytes: a raw box past it), 96 (48 bytes) and 192 (96 bytes: the two
    halves in different boxes); 80 for int8 only (int4 rows of 40 bytes
    keep the first design). At every k of :data:`WGMMA_KS`: int8 dot and l2
    with scales, int4 with no, per-doc and per-group scales, a -inf bias
    tail and ``valid_docs < N``; and 20,000 docs at d = 128, where splits
    span several tiles."""
    rng = np.random.default_rng(seed)
    for d, rows in ((64, n), (96, n), (192, n), (80, n), (128, 20_000)):
        docs = rng.integers(-4, 5, (rows, d)).astype(np.float32)
        for src, dsts in ((7, (127, 128, 191, 192, 383, 384, 575, 576)),
                          (11, (255, 256, 640, 767, 768, rows - 1))):
            docs[list(dsts)] = docs[src]

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        q = t(rng.integers(-4, 5, (bsz, d)).astype(np.float32))
        scale = t((2.0 ** rng.integers(-3, 2, rows)).astype(np.float32))
        gscale = t((2.0 ** rng.integers(-3, 2, (rows, d // 16))
                    ).astype(np.float32))
        int8 = t(docs.astype(np.int8))
        packed = t(_pack_int4(docs.astype(np.int8))) if d % 32 == 0 else None
        tail = torch.zeros(rows, dtype=torch.float32, device=device)
        tail[rows - 100:] = NEG_INF
        for k in WGMMA_KS:
            name = f"quant-d{d}-n{rows}"
            yield Case(f"{name}-int8-dot-k{k}", q, int8, k, "dot",
                       scale=scale)
            if packed is not None:
                yield Case(f"{name}-int4-group-dot-k{k}", q, packed, k,
                           "dot", scale=gscale, packed4=True)
            if rows != n:
                continue
            yield Case(f"{name}-int8-l2-k{k}", q, int8, k, "l2", scale=scale)
            yield Case(f"{name}-int8-inf-tail-k{k}", q, int8, k, "dot",
                       bias=tail, scale=scale)
            yield Case(f"{name}-int8-valid-k{k}", q, int8, k, "dot",
                       scale=scale, valid_docs=rows - 200)
            if packed is None:
                continue
            yield Case(f"{name}-int4-none-dot-k{k}", q, packed, k, "dot",
                       packed4=True)
            yield Case(f"{name}-int4-doc-dot-k{k}", q, packed, k, "dot",
                       scale=scale, packed4=True)
            yield Case(f"{name}-int4-group-inf-tail-k{k}", q, packed, k,
                       "dot", bias=tail, scale=gscale, packed4=True)
            yield Case(f"{name}-int4-doc-valid-k{k}", q, packed, k, "dot",
                       scale=scale, packed4=True, valid_docs=rows - 200)


def deep_exact_cases(device, *, bsz: int = 37, n: int = 20_000, d: int = 64,
                     seed: int = 3) -> Iterator[Case]:
    """Exact-arithmetic cases of the deep launch (k past 160): integer data
    in [-4, 4] over 20,000 docs (three select runs of 8,192), duplicate
    rows either side of the run boundaries, so that ties cross runs, merges
    and the k boundary. bf16 dot at k 161, 256, 600, 1,100; f32, int8 with
    power-of-two scales (l2), int4 with per-group scales; 1,100 past 1,000
    valid rows; a -inf bias tail; chunks of one run and slices of 10 query
    rows forced by a small workspace cap."""
    rng = np.random.default_rng(seed)
    docs = rng.integers(-4, 5, (n, d)).astype(np.float32)
    for src, dsts in ((5, (8190, 8191, 8192, 8193, 16383, 16384, 19999)),
                      (9, (100, 8000, 8200, 12000, 16390))):
        docs[list(dsts)] = docs[src]
    q = torch.from_numpy(rng.integers(-4, 5, (bsz, d)).astype(np.float32)
                         ).to(device)
    scale = torch.from_numpy((2.0 ** rng.integers(-3, 2, n)).astype(
        np.float32)).to(device)
    bf16 = torch.from_numpy(docs).to(device).to(torch.bfloat16)
    for k in DEEP_KS:
        yield Case(f"deep-bf16-dot-k{k}", q, bf16, k, "dot")
    yield Case("deep-f32-dot-k256", q, torch.from_numpy(docs).to(device),
               256, "dot")
    yield Case("deep-int8-scale-l2-k300", q,
               torch.from_numpy(docs).to(device).to(torch.int8), 300, "l2",
               scale=scale)
    gscale = torch.from_numpy((2.0 ** rng.integers(-3, 2, (n, d // 16)))
                              .astype(np.float32)).to(device)
    packed = torch.from_numpy(_pack_int4(docs.astype(np.int8))).to(device)
    yield Case("deep-int4-group-dot-k600", q, packed, 600, "dot",
               scale=gscale, packed4=True)
    yield Case("deep-bf16-dot-k1100-valid1000", q, bf16, 1100, "dot",
               valid_docs=1000)
    tail = torch.zeros(n, dtype=torch.float32, device=device)
    tail[n - 5000:] = NEG_INF
    yield Case("deep-bf16-dot-k256-inf-tail", q, bf16, 256, "dot", bias=tail)
    # chunks of one run, a running merge each, and slices of 10 rows
    per_row = 4 * deep_topk.RUN + deep_topk.WORD * 4 * 600
    yield Case("deep-bf16-dot-k600-chunks-slices", q, bf16, 600, "dot",
               cap=10 * per_row)


def live_bias(n: int, *, holes: float = 0.3, free_tail: int = 0,
              seed: int = 0, device="cpu") -> Tensor:
    """A live shard's ``[n]`` bias: 0 on live rows, ``-inf`` on a
    ``holes`` share of the rows at random, on one run of rows in the
    middle and on the last ``free_tail`` rows (the reserve)."""
    rng = np.random.default_rng(seed)
    b = np.where(rng.random(n) < holes, NEG_INF, 0.0).astype(np.float32)
    b[n // 5:n // 5 + n // 8] = NEG_INF
    if free_tail:
        b[n - free_tail:] = NEG_INF
    return torch.from_numpy(b).to(device)


def mutable_exact_cases(device, *, bsz: int = 150, seed: int = 11
                        ) -> Iterator[Tuple[Case, str]]:
    """Exact-arithmetic cases over a mutable shard's rows: integer data in
    [-4, 4], the whole capacity scanned (``valid_docs`` unset) and liveness
    carried by ``-inf`` bias holes (:func:`live_bias`), duplicate rows with
    one copy dead; each yielded with the launch it runs on
    (``run_kernel``'s names): the wgmma scan over bf16 / int8 / int4
    (per-doc and per-group), l2 holes over bf16, the f32 scan, the
    small-batch f32 scan (8 query rows), the first design, the deep fold
    and the deep launch, over 1,536 and 20,480 rows,
    and a shard of 1,536 rows with 40 live at k past 40 (the -inf entries
    carry index 0)."""
    rng = np.random.default_rng(seed)
    d = 64

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    q = t(rng.integers(-4, 5, (bsz, d)).astype(np.float32))
    for n, tail in ((1536, 136), (20_480, 2_048)):
        docs = rng.integers(-4, 5, (n, d)).astype(np.float32)
        for src, dsts in ((5, (6, 300, 301, 700, 1023, 1024)),
                          (9, (10, 11, 255, 256, 1400, n - 1))):
            docs[list(dsts)] = docs[src]
        bias = live_bias(n, free_tail=tail, seed=n, device=device)
        bias[6] = NEG_INF                   # one copy of a duplicate dead
        bias[10] = 0.0
        scale = t((2.0 ** rng.integers(-3, 2, n)).astype(np.float32))
        gscale = t((2.0 ** rng.integers(-3, 2, (n, d // 16))
                    ).astype(np.float32))
        f32 = t(docs)
        bf16 = f32.to(torch.bfloat16)
        int8 = t(docs.astype(np.int8))
        packed = t(_pack_int4(docs.astype(np.int8)))
        l2 = bias - t((docs * docs).sum(axis=1))
        name = f"live-n{n}"
        if n == 1536:
            for k in WGMMA_KS:
                yield Case(f"{name}-bf16-k{k}", q, bf16, k, "dot",
                           bias=bias), "wgmma"
            yield Case(f"{name}-bf16-l2-k32", q, bf16, 32, "dot",
                       bias=l2), "wgmma"
            yield Case(f"{name}-int8-k32", q, int8, 32, "dot", bias=bias,
                       scale=scale), "wgmma"
            yield Case(f"{name}-int4-doc-k32", q, packed, 32, "dot",
                       bias=bias, scale=scale, packed4=True), "wgmma"
            yield Case(f"{name}-int4-group-k64", q, packed, 64, "dot",
                       bias=bias, scale=gscale, packed4=True), "wgmma"
            for k in (32, 64):
                yield Case(f"{name}-f32-k{k}", q, f32, k, "dot",
                           bias=bias), "f32"
                yield Case(f"{name}-f32-b8-k{k}", q[:8], f32, k, "dot",
                           bias=bias), "f32_small"
            yield Case(f"{name}-f32-k32", q, f32, 32, "dot",
                       bias=bias), "shallow"
            yield Case(f"{name}-bf16-k128", q, bf16, 128, "dot",
                       bias=bias), "shallow"
            yield Case(f"{name}-int8-k100", q, int8, 100, "dot", bias=bias,
                       scale=scale), "shallow"
            few = torch.full_like(bias, NEG_INF)
            few[torch.randperm(n, generator=torch.Generator().manual_seed(
                seed))[:40].to(device)] = 0.0
            for route, k in (("wgmma", 64), ("f32", 64), ("f32_small", 64),
                             ("shallow", 100), ("fold", 128), ("deep", 200)):
                docs_k = f32 if route.startswith("f32") else bf16
                yield Case(f"{name}-40-live-{route}-k{k}",
                           q[:8] if route == "f32_small" else q, docs_k, k,
                           "dot", bias=few), route
        else:
            for k in (128, 256):
                yield Case(f"{name}-bf16-k{k}", q, bf16, k, "dot",
                           bias=bias), "fold"
            yield Case(f"{name}-int8-k128", q, int8, 128, "dot", bias=bias,
                       scale=scale), "fold"
            yield Case(f"{name}-int4-group-k256", q, packed, 256, "dot",
                       bias=bias, scale=gscale, packed4=True), "fold"
            yield Case(f"{name}-bf16-k300", q, bf16, 300, "dot",
                       bias=bias), "deep"
            yield Case(f"{name}-f32-k200", q, f32, 200, "dot",
                       bias=bias), "deep"


def run_kernel(case: Case, kernel: Optional[str] = None
               ) -> Tuple[Tensor, Tensor]:
    """The wrapper on CUDA tensors: launches the kernel. ``kernel`` names
    the launch (``"wgmma"``, ``"fold"``, ``"f32"``, ``"f32_small"``,
    ``"shallow"``, ``"deep"``) in place of the
    wrapper's plan, to time the launches against each other at one
    shape."""
    if kernel is None:
        return fused_topk(case.queries, case.docs, case.k, mode=case.mode,
                          valid_docs=case.valid_docs, bias=case.bias,
                          scale=case.scale, packed4=case.packed4,
                          workspace_cap=case.cap)
    q, b = gain_form(case.queries, case.docs, mode=case.mode, bias=case.bias,
                     packed4=case.packed4)
    n = case.docs.shape[0]
    valid = n if case.valid_docs is None else min(case.valid_docs, n)
    g, i = _fused_launch(q, case.docs, case.k, valid, b, case.scale,
                         packed4=case.packed4, workspace_cap=case.cap,
                         kernel=kernel)
    return gain_to_natural(g, case.queries, case.mode), i


def run_plain(case: Case, q_chunk: Optional[int] = None
              ) -> Tuple[Tensor, Tensor]:
    """The plain version on the same device and operands. ``q_chunk`` runs
    it over that many query rows at a time (rows are independent; the
    ``[B, N]`` gains and their sort of a 5.9 M-row slab do not fit at once)."""
    q, b = gain_form(case.queries, case.docs, mode=case.mode, bias=case.bias,
                     packed4=case.packed4)
    parts = [fused_topk_reference(qc, case.docs, case.k,
                                  valid_docs=case.valid_docs, bias=b,
                                  scale=case.scale, packed4=case.packed4)
             for qc in q.split(q_chunk or q.shape[0])]
    g = torch.cat([p[0] for p in parts])
    i = torch.cat([p[1] for p in parts])
    return gain_to_natural(g, case.queries, case.mode), i


def run_pair(case: Case, q_chunk: Optional[int] = None
             ) -> Tuple[Tuple[Tensor, Tensor], Tuple[Tensor, Tensor]]:
    """(kernel scores, indices), (plain scores, indices) for one case."""
    return run_kernel(case), run_plain(case, q_chunk)


def compare_tolerant(kernel: Tuple[Tensor, Tensor],
                     plain: Tuple[Tensor, Tensor], *, rel: float = 1e-3,
                     lower_is_better: bool = False) -> Dict[str, float]:
    """Scores within ``rel * max|score|``; winner-set recall; every doc in
    only one of the two sets scores within that tolerance of the row's
    k-th plain score (a near-tie)."""
    ks, ki = (t.cpu() for t in kernel)
    ps, pi = (t.cpu() for t in plain)
    tol = rel * float(ps.abs().max())
    max_abs = float((ks - ps).abs().max())
    hits, bad = 0, 0
    for r in range(pi.shape[0]):
        want, got = set(pi[r].tolist()), set(ki[r].tolist())
        hits += len(want & got)
        kth = float(ps[r, -1])
        for j, doc in enumerate(ki[r].tolist()):
            if doc not in want and abs(float(ks[r, j]) - kth) > tol:
                bad += 1
        for j, doc in enumerate(pi[r].tolist()):
            if doc not in got and abs(float(ps[r, j]) - kth) > tol:
                bad += 1
    return {"tol": tol, "max_abs_err": max_abs,
            "recall": hits / pi.numel(), "non_tie_mismatches": bad,
            "ok": max_abs <= tol and bad == 0}


def path_case(device, *, bsz: int = 512, n: int = 734_003, d: int = 768,
              k: int = 32, seed: int = 0, dtype=torch.bfloat16) -> Case:
    """The serving path's shape: one centred dot shard (the medrag pubmed
    shard at the benchmark's size, bf16 or ``dtype``), made on the card."""
    g = torch.Generator(device=device).manual_seed(seed)
    docs = torch.randn((n, d), generator=g, device=device)
    docs = (docs - docs.mean(dim=0)).to(dtype)
    queries = torch.randn((bsz, d), generator=g, device=device)
    bias = torch.zeros(n, dtype=torch.float32, device=device)
    return Case(f"path-{str(dtype)[6:]}-dot", queries, docs, k, "dot",
                bias=bias)


def cuda_time_ms(fn, *, warmup: int = 3, reps: int = 10) -> float:
    """Median CUDA-event time of ``fn()`` in ms (after warm-up runs)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def int4_path_case(device, *, grouped: bool, bsz: int = 512,
                   n: int = 734_003, d: int = 768, k: int = 32,
                   group_dims: int = 128, seed: int = 1) -> Case:
    """The flat int4 shard at the serving path's shape: random packed
    nibbles with per-doc ``[N]`` or per-group ``[N, d/group_dims]`` scales,
    made on the card."""
    g = torch.Generator(device=device).manual_seed(seed)
    docs = torch.randint(-128, 128, (n, d // 2), generator=g, device=device,
                         dtype=torch.int16).to(torch.int8)
    shape = (n, d // group_dims) if grouped else (n,)
    scale = 0.01 + 0.01 * torch.rand(shape, generator=g, device=device)
    queries = torch.randn((bsz, d), generator=g, device=device)
    bias = torch.zeros(n, dtype=torch.float32, device=device)
    return Case(f"path-int4-{'group' if grouped else 'doc'}", queries, docs,
                k, "dot", bias=bias, scale=scale, packed4=True)


def int8_path_case(device, *, n: int, d: int, k: int, bsz: int = 512,
                   pad_tail: int = 0, seed: int = 6) -> Case:
    """An int8 dot shard with per-doc scales as the host tiers scan it,
    made on the card: random codes, f32 queries (the wrapper rounds them to
    bf16), a zero bias with ``-inf`` on the last ``pad_tail`` rows (the
    padding of a coarse slab)."""
    g = torch.Generator(device=device).manual_seed(seed)
    docs = torch.randint(-127, 128, (n, d), generator=g, device=device,
                         dtype=torch.int16).to(torch.int8)
    scale = 0.005 + 0.005 * torch.rand(n, generator=g, device=device)
    queries = torch.randn((bsz, d), generator=g, device=device)
    bias = torch.zeros(n, dtype=torch.float32, device=device)
    if pad_tail:
        bias[n - pad_tail:] = NEG_INF
    return Case(f"path-int8-d{d}-k{k}", queries, docs, k, "dot", bias=bias,
                scale=scale)


def fused_plan_of(case: Case) -> str:
    """The launch the wrapper's plan takes for the case (it depends on the
    shape alone, not on the SM count)."""
    bsz, d = case.queries.shape
    n = case.valid_docs or case.docs.shape[0]
    if case.packed4:
        doc_type = 4 if case.scale is not None and case.scale.dim() == 2 else 3
    else:
        doc_type = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}[
            case.docs.dtype]
    return _fused_plan(bsz, n, d, case.k, doc_type, 132, cap=case.cap).kernel


def k1_bound(case: Case) -> Dict[str, float]:
    """Least time for one fused top-k call: every operand read once and the
    lists written once at the HBM rate, against ``2 * B * N * d``
    operations at the peak rate of the product's operand type. The deep
    launch, where the wrapper's plan takes it, also writes its f32 gains
    out and reads them back, ``8 * B * N`` bytes the function itself does
    not need: they stay out of ``bound_ms`` and go to ``workspace_bytes``
    and ``design_floor_ms``. The deep fold makes no such round trip."""
    bsz, d = case.queries.shape
    n = case.valid_docs or case.docs.shape[0]
    deep = fused_plan_of(case) == "deep"
    q_bytes = 4 if case.docs.dtype == torch.float32 else 2
    nbytes = (bsz * d * q_bytes
              + n * case.docs.shape[1] * case.docs.element_size()
              + sum(t[:n].numel() * 4 for t in (case.bias, case.scale)
                    if t is not None)
              + bsz * case.k * 12)
    return _bound(nbytes, 2.0 * bsz * n * d, PEAK_FLOPS[case.docs.dtype],
                  8 * bsz * n if deep else 0)


def _bound(nbytes: float, flops: float, peak: float,
           workspace: float = 0) -> Dict[str, float]:
    """``bound_ms`` from the function's own bytes and operations; with a
    ``workspace`` (bytes a design moves through device memory on top of
    them), ``design_floor_ms`` is the same bound with those bytes added."""
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * flops / peak
    out = {"bound_ms": max(by_bytes, by_ops),
           "bound_by": "bytes" if by_bytes >= by_ops else "operations",
           "bytes": float(nbytes), "flops": float(flops)}
    if workspace:
        out["workspace_bytes"] = float(workspace)
        out["design_floor_ms"] = max(
            1e3 * (nbytes + workspace) / HBM_BYTES_PER_S, by_ops)
    return out


# ---- streaming top-k over stored gains --------------------------------------

def stream_exact_cases(device, *, bsz: int = 37, m: int = 5000,
                       seed: int = 0) -> Iterator[Tuple[str, Tensor, int]]:
    """``(name, gains [B, M], k)``: small integers, so every value ties
    with many others across 32-wide groups, splits and the k boundary;
    scattered ``-inf`` entries, a row of nothing but ``-inf`` and a row
    with fewer finite entries than k."""
    rng = np.random.default_rng(seed)
    g = rng.integers(-3, 4, (bsz, m)).astype(np.float32)
    g[rng.random((bsz, m)) < 0.2] = -np.inf
    g[5] = -np.inf
    g[6] = -np.inf
    g[6, [7, 1300, 4999]] = [1.0, 1.0, 2.0]
    g[7, :] = 0.0                      # all tied: positions 0..k-1 win
    gains = torch.from_numpy(g).to(device)
    for k in (1, 10, 32, 128, 160) + DEEP_KS + (m,):
        yield f"stream-int-k{k}", gains, k
    yield "stream-one-row", gains[:1, :1031].contiguous(), 32
    # fewer positions than 2k, and rows off the 16-byte grid (M % 4 != 0)
    yield "stream-m200-k128", gains[:, :200].contiguous(), 128
    yield "stream-m161-k160", gains[:, :161].contiguous(), 160
    yield "stream-m4097-k128", gains[:, :4097].contiguous(), 128
    yield "stream-runs-k128", stream_runs_case(device, bsz=bsz, runs=64,
                                               seed=seed + 1), 128
    # long rows cut into runs: selects merged across splits (deep list)
    # and the collect (shallow lists: 10 splits a row at k = 1, 7 at k = 32
    # and 64, merged in the launch; rows of 20,003 positions, so every row
    # but the first starts off the 16-byte grid), ties across the splits,
    # rows of -inf and all tied
    wide = torch.from_numpy(np.ascontiguousarray(
        np.tile(g, (1, 5))[:9, :20_003])).to(device)
    yield "stream-split-select-k160", wide, 160
    for k in (1, 32, 64):
        yield f"stream-split-collect-k{k}", wide, k
    # deep lists over three runs merged, to k = M
    for k in (161, 1100, wide.shape[1]):
        yield f"stream-split-deep-k{k}", wide, k


def stream_plan_of(gains: Tensor, k: int) -> str:
    """The path the wrapper's plan takes for ``gains`` (on the card) at
    depth ``k``: ``"select"`` or ``"collect"``."""
    bsz, m = gains.shape
    path = _stream.plan(bsz, m, k, _stream._sm_count(gains.device)).path
    return "collect" if path == _stream.COLLECT else "select"


def stream_runs_case(device, *, bsz: int = 512, runs: int = 512, kw: int = 8,
                     pad_share: float = 0.1, seed: int = 9) -> Tensor:
    """The probed coarse scan's kept gains as K4 leaves them: ``runs`` runs
    of ``kw`` a row, each sorted descending with its unfilled slots
    (``-inf``, a ``pad_share`` of them) at its tail; gains on a 1/8 grid, so
    values tie within and across runs and across the k' boundary."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.round(torch.randn((bsz, runs, kw), generator=g, device=device)
                    * 8) / 8
    pads = torch.rand((bsz, runs, kw), generator=g, device=device) < pad_share
    x = x.masked_fill_(pads, NEG_INF).sort(dim=-1, descending=True).values
    return x.reshape(bsz, runs * kw).contiguous()


def stream_path_case(device, *, bsz: int = 512, m: int = 131_072,
                     pad_share: float = 0.2, seed: int = 2) -> Tensor:
    """The collect of the cluster-probed search at the medrag pubmed
    defaults: 512 probes of 256 slots a query, a fifth of them empty
    (``-inf``) as the capacity slack leaves them."""
    g = torch.Generator(device=device).manual_seed(seed)
    gains = torch.randn((bsz, m), generator=g, device=device)
    pads = torch.rand((bsz, m), generator=g, device=device) < pad_share
    return gains.masked_fill_(pads, NEG_INF)


def k2_bound(gains: Tensor, k: int) -> Dict[str, float]:
    """Least time for one streaming top-k call: the gains read once and the
    lists written once; one comparison per entry counts as an f32
    operation."""
    bsz, m = gains.shape
    return _bound(bsz * m * 4 + bsz * k * 8, float(bsz * m),
                  PEAK_FLOPS[torch.float32])


# ---- grouped gains -------------------------------------------------------------

@dataclasses.dataclass
class GroupedCase:
    name: str
    q: Tensor                   # [B, d] (with rows) or [Ep, d]
    docs: Tensor                # [C, d, S] or [C, d/2, S] packed
    bias: Tensor
    scale: Optional[Tensor]
    blk_cluster: Tensor
    packed4: bool = False
    rows: Optional[Tensor] = None
    n_real: Optional[Tensor] = None

    @property
    def real_rows(self) -> int:
        """Pair rows the kernel writes (one host read)."""
        g = self.blk_cluster.shape[0]
        return GROUP_ROWS * (g if self.n_real is None
                             else min(g, int(self.n_real)))


def run_grouped_kernel(case: GroupedCase, kernel: Optional[str] = None
                       ) -> Tensor:
    """The wrapper on CUDA tensors; ``kernel`` names the launch
    (``"wgmma"``, ``"f32"``, ``"first"``) in place of its plan."""
    return grouped_gains(case.q, case.docs, case.bias, case.scale,
                         case.blk_cluster, case.packed4, rows=case.rows,
                         n_real=case.n_real, kernel=kernel)


def grouped_plan_of(case: GroupedCase) -> str:
    """The kernel the wrapper's plan takes for the case."""
    _, _, s = case.docs.shape
    doc_type = 3 if case.packed4 else {torch.float32: 0, torch.bfloat16: 1,
                                       torch.int8: 2}[case.docs.dtype]
    return _grouped_plan(case.blk_cluster.shape[0], case.q.shape[1], s,
                         doc_type, 132).kernel


def grouped_takes(case: GroupedCase, kernel: str) -> bool:
    """Whether the named kernel takes the case's slab type."""
    f32 = case.docs.dtype == torch.float32
    return kernel == "first" or (kernel == "f32") == f32


def run_grouped_plain(case: GroupedCase, n_blocks: Optional[int] = None
                      ) -> Tensor:
    """The plain version, over the first ``n_blocks`` blocks when given."""
    g = case.blk_cluster.shape[0] if n_blocks is None else n_blocks
    rows, q = case.rows, case.q
    if rows is not None:
        rows = rows[:g * GROUP_ROWS]
    else:
        q = q[:g * GROUP_ROWS]
    return grouped_gains_reference(q, case.docs, case.bias, case.scale,
                                   case.blk_cluster[:g], case.packed4, rows)


# (S, d) of the exact cases: one column tile; two, the second ragged; the
# served 104 and 256; 328 (two passes of the wgmma kernel, three of the f32
# kernel); depths of one to three 64-deep chunks, the last one partial
GROUPED_SHAPES = ((8, 64), (72, 64), (104, 192), (256, 160), (328, 96))
GROUPED_S = tuple(s for s, _ in GROUPED_SHAPES)


def grouped_exact_cases(device, *, c: int = 5, bsz: int = 23, seed: int = 0
                        ) -> Iterator[GroupedCase]:
    """Integer data, so the product is exact in any order: f32 / bf16 /
    int8 / int4 slabs at every (S, d) of :data:`GROUPED_SHAPES` (int4 rows
    of 32 to 96 bytes: its two halves in one chunk, or in several with a
    partial last one), blocks that repeat and reorder clusters,
    power-of-two scales, ``-inf`` bias on empty slots; each with pair rows
    given directly, with the row table, and with a real-block count below
    the grid's."""
    for s, d in GROUPED_SHAPES:
        yield from _grouped_exact(device, c, d, s, bsz, seed + s)


def _grouped_exact(device, c: int, d: int, s: int, bsz: int, seed: int
                   ) -> Iterator[GroupedCase]:
    rng = np.random.default_rng(seed)
    blk = np.array([3, 0, 0, 4, 1, 3, 2], np.int32)
    g = blk.shape[0]
    ep = g * GROUP_ROWS
    slab = rng.integers(-4, 5, (c, d, s)).astype(np.float32)
    q = rng.integers(-4, 5, (bsz, d)).astype(np.float32)
    rows = rng.integers(0, bsz, ep).astype(np.int32)
    bias = rng.integers(-8, 9, (c, s)).astype(np.float32)
    bias[rng.random((c, s)) < 0.2] = -np.inf
    scale = (2.0 ** rng.integers(-3, 2, (c, s))).astype(np.float32)
    # [C, d, S] codes packed along d: byte row j = dims j (low), j + d/2
    packed = _pack_int4(slab.transpose(0, 2, 1).reshape(c * s, d)
                        .astype(np.int8)).reshape(c, s, d // 2)
    packed = np.ascontiguousarray(packed.transpose(0, 2, 1))

    def t(a):
        return torch.from_numpy(a).to(device)

    kinds = (("f32", t(slab), torch.float32, None, False),
             ("bf16", t(slab).to(torch.bfloat16), torch.bfloat16, None, False),
             ("int8", t(slab).to(torch.int8), torch.bfloat16, t(scale), False),
             ("int4", t(packed), torch.bfloat16, t(scale), True))
    for name, docs, qdt, sc, p4 in kinds:
        qt = t(q).to(qdt)
        common = dict(docs=docs, bias=t(bias), scale=sc, blk_cluster=t(blk),
                      packed4=p4)
        yield GroupedCase(f"grouped-{name}-s{s}-direct",
                          qt[t(rows).long()], **common)
        yield GroupedCase(f"grouped-{name}-s{s}-rows", qt, rows=t(rows),
                          **common)
        yield GroupedCase(f"grouped-{name}-s{s}-rows-nreal", qt, rows=t(rows),
                          n_real=torch.tensor([g - 2], dtype=torch.int32,
                                              device=device), **common)


def grouped_path_case(device, *, bsz: int = 512, c: int = 4096,
                      d: int = 768, s: int = 256, nprobe: int = 512,
                      seed: int = 3, slab: str = "bf16") -> GroupedCase:
    """The scoring of the cluster-probed search at the medrag pubmed
    defaults (4,096 clusters of 256 slots, 512 probes a query), with the
    search's own dispatch of a random probe list; ``slab`` "bf16", "int8"
    (random codes, a scale a slot) or "int4" (random packed bytes
    ``[C, d/2, S]``, a scale a slot)."""
    from ragroute_tpu_torch.ops.ivf_topk import dispatch

    g = torch.Generator(device=device).manual_seed(seed)
    scale = None
    if slab == "bf16":
        docs = torch.randn((c, d, s), generator=g, device=device,
                           dtype=torch.bfloat16)
    else:
        rows_d = d // 2 if slab == "int4" else d
        docs = torch.randint(-128, 128, (c, rows_d, s), generator=g,
                             device=device, dtype=torch.int16).to(torch.int8)
        scale = 0.005 + 0.005 * torch.rand((c, s), generator=g,
                                           device=device)
    bias = torch.zeros((c, s), dtype=torch.float32, device=device)
    bias.masked_fill_(torch.rand((c, s), generator=g, device=device) < 0.2,
                      NEG_INF)
    q = torch.randn((bsz, d), generator=g, device=device).to(torch.bfloat16)
    probe = torch.rand((bsz, c), generator=g, device=device).topk(
        nprobe, dim=1)[1]
    rows, blk_cluster, n_real, _ = dispatch(probe, c)
    return GroupedCase(f"path-grouped-{slab}", q, docs, bias, scale,
                       blk_cluster, packed4=slab == "int4", rows=rows,
                       n_real=n_real)


def compare_grouped(kernel: Tensor, plain: Tensor, *, rel: float = 1e-3
                    ) -> Dict[str, float]:
    """``-inf`` in the same places; finite gains within
    ``rel * max|gain|`` (bf16 products are exact in f32, the sums differ
    only in their order)."""
    inf_k, inf_p = torch.isneginf(kernel), torch.isneginf(plain)
    finite = ~inf_p
    tol = rel * float(plain[finite].abs().max())
    err = float((kernel[finite] - plain[finite]).abs().max())
    same_inf = bool(torch.equal(inf_k, inf_p))
    return {"tol": tol, "max_abs_err": err, "same_inf": same_inf,
            "ok": same_inf and err <= tol}


def k3_bound(case: GroupedCase) -> Dict[str, float]:
    """Least time for this call's data: the queries, the tables, the slab,
    bias and scale rows of every distinct probed cluster once, the real
    rows of the output once; ``2 * rows * d * S`` operations."""
    real = case.real_rows
    blocks = real // GROUP_ROWS
    _, ds, s = case.docs.shape
    d = case.q.shape[1]
    clusters = int(torch.unique(case.blk_cluster[:blocks]).numel())
    per_cluster = (ds * s * case.docs.element_size()
                   + s * 4 * (1 if case.scale is None else 2))
    q_rows = case.q.shape[0] if case.rows is not None else real
    nbytes = (q_rows * d * case.q.element_size() + clusters * per_cluster
              + blocks * 4 + (real * 4 if case.rows is not None else 0)
              + real * s * 4)
    return _bound(nbytes, 2.0 * real * d * s, PEAK_FLOPS[case.docs.dtype])


# ---- grouped pair top-k ------------------------------------------------------

@dataclasses.dataclass
class PairCase:
    name: str
    q: Tensor                   # [B, r] bf16 (with rows) or [Ep, r]
    cc: ClusteredCoarse
    blk_cluster: Tensor
    kappa: int
    rows: Optional[Tensor] = None
    n_real: Optional[Tensor] = None
    n_pairs: Optional[int] = None   # (query, probe) pairs among the rows
    cap: Optional[int] = None       # deep ranks: workspace cap to run at

    @property
    def real_rows(self) -> int:
        """Pair rows the kernel writes (one host read)."""
        g = self.blk_cluster.shape[0]
        return PAIR_ROWS * (g if self.n_real is None
                            else min(g, int(self.n_real)))


def run_pair_kernel(case: PairCase, kernel: Optional[str] = None
                    ) -> Tuple[Tensor, Tensor]:
    """The wrapper on CUDA tensors; ``kernel`` names the launch in place of
    the wrapper's plan."""
    if kernel is None:
        return grouped_pair_topk(case.q, case.cc, case.blk_cluster,
                                 case.kappa, rows=case.rows,
                                 n_real=case.n_real, workspace_cap=case.cap)
    return _pair_launch(case.q, case.cc, case.blk_cluster, case.kappa,
                        case.rows, case.n_real, case.cap, kernel)


def pair_plan_of(case: PairCase) -> str:
    """The launch the wrapper's plan takes for the case."""
    _, r, s = case.cc.docs.shape
    _, _, ranks, kw = tiling(s, case.kappa)
    return _pair_plan(r, ranks, kw)


def pair_takes(case: PairCase, kernel: Optional[str]) -> bool:
    """Whether the named launch (None: the plan's) takes the case."""
    _, r, s = case.cc.docs.shape
    _, _, ranks, kw = tiling(s, case.kappa)
    try:
        _pair_plan(r, ranks, kw, kernel)
    except ValueError:
        return False
    return True


def run_pair_plain(case: PairCase, n_blocks: Optional[int] = None
                   ) -> Tuple[Tensor, Tensor]:
    """The plain version, over the first ``n_blocks`` blocks when given."""
    g = case.blk_cluster.shape[0] if n_blocks is None else n_blocks
    rows, q = case.rows, case.q
    if rows is not None:
        rows = rows[:g * PAIR_ROWS]
    else:
        q = q[:g * PAIR_ROWS]
    return grouped_pair_topk_reference(q, case.cc, case.blk_cluster[:g],
                                       case.kappa, rows)


def _coarse(docs, bias, scale, device) -> ClusteredCoarse:
    c, r, s = docs.shape
    return ClusteredCoarse(
        centroids=torch.zeros((c, r), device=device),
        cbias=torch.zeros(c, device=device), docs=docs.to(device),
        bias=bias.to(device), scale=scale.to(device),
        perm=torch.arange(c * s, dtype=torch.int32,
                          device=device).reshape(c, s),
        n_clusters=c, capacity=s)


def pair_exact_cases(device, *, c: int = 4, r: int = 32, bsz: int = 19,
                     seed: int = 0) -> Iterator[PairCase]:
    """Integer codes, rows and biases with power-of-two scales, so every
    gain is exact in any summation order and many gains tie: ``S`` of 72
    (one tile, off the 128 grid), 1,024 (one full tile), 1,096 (two tiles,
    the second ragged) and 2,056 (three); cluster 2 is empty (all ``-inf``);
    the slots either side of the 1,024 boundary carry the same codes;
    the bias is an l2-style negative integer; the last block's rows all
    name query 0 (padding); ``kappa`` from 1 to 128 (``ranks`` 1 to 64: up
    to 8 the wgmma kernel takes them, lists of 1, 2, 4 and 8 a thread; the
    first design keeps its lists in registers to 16, deeper in local memory)
    and the deep ranks 200 (more than a 128-slot tile holds, and over three
    tiles) and 256 (also in chunks of two blocks); pair rows given directly,
    by the row table, and with a real-block count below the grid's."""
    rng = np.random.default_rng(seed)
    blk = np.array([3, 0, 2, 1, 0, 3], np.int32)
    g = blk.shape[0]
    ep = g * PAIR_ROWS
    q = torch.from_numpy(rng.integers(-4, 5, (bsz, r)).astype(np.float32))
    q = q.to(torch.bfloat16).to(device)
    rows_np = rng.integers(0, bsz, ep).astype(np.int32)
    rows_np[-PAIR_ROWS:] = 0
    rows = torch.from_numpy(rows_np).to(device)
    blk_t = torch.from_numpy(blk).to(device)
    for s, kappas in ((72, (1, 8, 40, 200)), (1024, (3, 16)),
                      (1096, (1, 2, 4, 8, 11, 128, 512)),
                      (2056, (8, 48, 600))):
        docs = rng.integers(-4, 5, (c, r, s)).astype(np.int8)
        if s > 1030:
            docs[:, :, 1024:1030] = docs[:, :, 1018:1024]
        bias = -rng.integers(0, 40, (c, s)).astype(np.float32)
        bias[rng.random((c, s)) < 0.1] = -np.inf
        bias[2] = -np.inf
        scale = (2.0 ** rng.integers(-2, 2, (c, s))).astype(np.float32)
        cc = _coarse(torch.from_numpy(docs), torch.from_numpy(bias),
                     torch.from_numpy(scale), device)
        for kappa in kappas:
            common = dict(cc=cc, blk_cluster=blk_t, kappa=kappa)
            yield PairCase(f"pair-S{s}-kappa{kappa}-direct",
                           q[rows.long()].contiguous(), **common)
            yield PairCase(f"pair-S{s}-kappa{kappa}-rows", q, rows=rows,
                           **common)
            yield PairCase(f"pair-S{s}-kappa{kappa}-rows-nreal", q, rows=rows,
                           n_real=torch.tensor([g - 2], dtype=torch.int32,
                                               device=device), **common)
            if kappa == 512:      # deep ranks in chunks of two blocks
                tds, _, ranks, kw = tiling(s, kappa)
                plan = deep_topk.pair_plan(g, s, tds, ranks, kw)
                yield PairCase(
                    f"pair-S{s}-kappa{kappa}-rows-nreal-chunks", q, rows=rows,
                    n_real=torch.tensor([g - 1], dtype=torch.int32,
                                        device=device),
                    cap=2 * plan.workspace_bytes // plan.blocks, **common)


def pair_gains_of(case: PairCase, rows_e: Tensor, slots: Tensor) -> Tensor:
    """Gains of given slots recomputed in plain f32 arithmetic: entry ``m``
    is pair row ``rows_e[m]`` against slot ``slots[m]`` of its block's
    cluster (product summed in f32, ``* scale`` and ``+ bias`` rounded
    separately)."""
    cl = case.blk_cluster[rows_e // PAIR_ROWS].long()
    qrow = rows_e if case.rows is None else case.rows[rows_e].long()
    sl = slots.long()
    codes = case.cc.docs[cl, :, sl].to(torch.float32)           # [m, r]
    dots = (case.q[qrow].to(torch.float32) * codes).sum(dim=1)
    return dots * case.cc.scale[cl, sl] + case.cc.bias[cl, sl]


def compare_pair(kernel: Tuple[Tensor, Tensor], plain: Tuple[Tensor, Tensor],
                 *, rel: float = 0.0, slot_share: float = 1e-6,
                 case: Optional[PairCase] = None) -> Dict[str, float]:
    """``-inf`` in the same places; finite gains within ``rel`` relative
    (equal at ``rel == 0``); slots equal where the gain is finite. At
    ``rel > 0`` a slot is compared where the row's neighbouring gains are
    further apart than the tolerance (two offers closer than the summation
    noise may come out in either order), and at most ``slot_share`` of
    those (rounded up: nine of 8.3 M) may still differ: a near-tie at a
    tile's rank cut lets the two versions keep different slots whose gains
    agree within the tolerance. With ``case``, every finite entry whose
    slot differs from the plain version's, clearly ordered or not, is held
    to its own claim: the gain of the kernel's slot, recomputed in plain
    f32 arithmetic, must lie within the tolerance of the gain the kernel
    wrote there, so only true near-ties are excused and a slot that does
    not carry its gain fails."""
    kg, ki = kernel
    pg, pi = plain
    fin = torch.isfinite(pg)
    same_inf = bool(torch.equal(torch.isneginf(kg), torch.isneginf(pg)))
    tol = rel * (1.0 + pg.abs())
    err = (kg - pg).abs()
    max_abs = float(err[fin].max()) if bool(fin.any()) else 0.0
    close = bool((err[fin] <= tol[fin]).all())
    clear = fin.clone()
    if rel > 0:
        gap = (pg[:, 1:] - pg[:, :-1]).abs() > 2 * tol[:, 1:]
        clear[:, 1:] &= gap
        clear[:, :-1] &= gap
    compared = int(clear.sum())
    differ = int((ki[clear] != pi[clear]).sum())
    slots_ok = differ <= (math.ceil(slot_share * compared) if rel > 0 else 0)
    res = {"max_abs_err": max_abs, "same_inf": same_inf, "close": close,
           "slots_compared": compared, "slots_differ": differ}
    if case is not None:
        swapped = (fin & torch.isfinite(kg) & (ki != pi)).nonzero()
        e, j = swapped[:, 0], swapped[:, 1]
        own = pair_gains_of(case, e, ki[e, j])
        wrong = int(((own - kg[e, j]).abs() > tol[e, j]).sum())
        res.update(slots_swapped=int(e.numel()), swapped_wrong_gain=wrong)
        slots_ok = slots_ok and wrong == 0
    res["ok"] = same_inf and close and slots_ok
    return res


def pair_path_case(device, *, bsz: int = 512, c: int = 4096, r: int = 128,
                   s: int = 1584, nprobe: int = 512, kappa: int = 8,
                   seed: int = 5) -> PairCase:
    """The probed coarse scan at the serving shape: 4,096 clusters of 1,584
    int8 slots at rank 128 (about 5.9 M rows, a tenth of the slots empty as
    the capacity slack leaves them), 512 queries probing 512 clusters each,
    through the search's own dispatch of a random probe list."""
    g = torch.Generator(device=device).manual_seed(seed)
    docs = torch.randint(-127, 128, (c, r, s), generator=g, device=device,
                         dtype=torch.int16).to(torch.int8)
    scale = 0.005 + 0.005 * torch.rand((c, s), generator=g, device=device)
    bias = torch.zeros((c, s), dtype=torch.float32, device=device)
    bias.masked_fill_(torch.rand((c, s), generator=g, device=device) < 0.1,
                      NEG_INF)
    q = torch.randn((bsz, r), generator=g, device=device).to(torch.bfloat16)
    probe = torch.rand((bsz, c), generator=g, device=device).topk(
        nprobe, dim=1)[1]
    rows, blk_cluster, n_real, _ = probe_dispatch(probe, c)
    return PairCase("path-pair-int8", q, _coarse(docs, bias, scale, device),
                    blk_cluster, kappa, rows=rows, n_real=n_real,
                    n_pairs=bsz * nprobe)


def k4_bound(case: PairCase) -> Dict[str, float]:
    """Least time for this call's data: the queries, the tables, the slab,
    bias and scale rows of every distinct probed cluster once, the real
    rows of both outputs once; ``2 * pairs * r * S`` operations at the bf16
    rate (the int8 codes are multiplied as bf16) over the (query, probe)
    pairs the function needs. The rows that pad each cluster's pairs to
    whole blocks name query 0 and nothing collects them: their operations
    are reported as ``padded_flops`` and do not enter the bound. Deep ranks
    (past 160) also write the real rows' f32 gains out and read them back:
    that round trip stays out of ``bound_ms`` and goes to
    ``workspace_bytes`` and ``design_floor_ms``."""
    real = case.real_rows
    blocks = real // PAIR_ROWS
    _, r, s = case.cc.docs.shape
    kw = tiling(s, case.kappa)[3]
    clusters = int(torch.unique(case.blk_cluster[:blocks]).numel())
    q_rows = case.q.shape[0] if case.rows is not None else real
    ranks = tiling(s, case.kappa)[2]
    nbytes = (q_rows * r * 2 + clusters * (r * s + 8 * s) + blocks * 4
              + (real * 4 if case.rows is not None else 0) + real * kw * 8)
    pairs = real if case.n_pairs is None else case.n_pairs
    out = _bound(nbytes, 2.0 * pairs * r * s, PEAK_FLOPS[torch.int8],
                 8 * real * s if ranks > deep_topk.SHALLOW_MAX else 0)
    out["padded_flops"] = 2.0 * real * r * s
    return out
