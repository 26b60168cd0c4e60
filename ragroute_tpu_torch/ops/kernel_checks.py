"""Kernel-against-plain checks for the hand-written kernels on the card.

Shared by the card-only tests (``tests/test_torch_kernel.py``) and
``chip_smoke.py``: both run the wrappers on CUDA tensors, which launches
``csrc/fused_topk.cu``, ``csrc/stream_topk.cu`` and
``csrc/grouped_gains.cu``, and hold each against its plain version on the
same device and the same operands.

Fused top-k (:func:`fused_topk` against :func:`fused_topk_reference`):

* :func:`exact_cases`: integer-valued data in [-4, 4] (queries of norm 4
  for cos, power-of-two scales), so every product and sum is exact in any
  order: indices and scores must be equal. Duplicate doc rows put ties
  across tile, split and k boundaries. f32 / bf16 / int8 / int4 with
  per-doc and per-group scales, k from 10 to 160.
* :func:`compare_tolerant`: the path's shapes (bf16 operands, different
  summation order): scores within ``1e-3 * max|score|``, winner-set recall,
  and every disagreement a near-tie at the k boundary.

Streaming top-k (:func:`stream_topk` against :func:`stream_topk_reference`):
:func:`stream_exact_cases` (ties across group, split and k boundaries,
``-inf`` entries and rows) and :func:`stream_path_case`; the kernel does no
arithmetic, so both must come out equal.

Grouped gains (:func:`grouped_gains` against :func:`grouped_gains_reference`):
:func:`grouped_exact_cases` (integer data, every slab type, ``S`` not a
multiple of 64, the row table and the real-block count) come out equal;
:func:`grouped_path_case` is held within ``1e-3 * max|gain|``.

:func:`k1_bound`, :func:`k2_bound` and :func:`k3_bound` give the least time
an H100 SXM could take for a call, from the data-sheet peaks below.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ragroute_tpu_torch.index.shard import _pack_int4
from ragroute_tpu_torch.ops.fused_topk import (TILE_D, fused_topk,
                                               fused_topk_reference,
                                               gain_form)
from ragroute_tpu_torch.ops.grouped_gains import (GROUP_ROWS, grouped_gains,
                                                  grouped_gains_reference)
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


def run_kernel(case: Case) -> Tuple[Tensor, Tensor]:
    """The wrapper on CUDA tensors: launches the kernel."""
    return fused_topk(case.queries, case.docs, case.k, mode=case.mode,
                      valid_docs=case.valid_docs, bias=case.bias,
                      scale=case.scale, packed4=case.packed4)


def run_plain(case: Case) -> Tuple[Tensor, Tensor]:
    """The plain version on the same device and operands."""
    q, b = gain_form(case.queries, case.docs, mode=case.mode, bias=case.bias,
                     packed4=case.packed4)
    g, i = fused_topk_reference(q, case.docs, case.k,
                                valid_docs=case.valid_docs, bias=b,
                                scale=case.scale, packed4=case.packed4)
    return gain_to_natural(g, case.queries, case.mode), i


def run_pair(case: Case) -> Tuple[Tuple[Tensor, Tensor], Tuple[Tensor, Tensor]]:
    """(kernel scores, indices), (plain scores, indices) for one case."""
    return run_kernel(case), run_plain(case)


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
              k: int = 32, seed: int = 0) -> Case:
    """The serving path's shape: one centred bf16 dot shard (the medrag
    pubmed shard at the benchmark's size), made on the card."""
    g = torch.Generator(device=device).manual_seed(seed)
    docs = torch.randn((n, d), generator=g, device=device)
    docs = (docs - docs.mean(dim=0)).to(torch.bfloat16)
    queries = torch.randn((bsz, d), generator=g, device=device)
    bias = torch.zeros(n, dtype=torch.float32, device=device)
    return Case("path-bf16-dot", queries, docs, k, "dot", bias=bias)


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


def k1_bound(case: Case) -> Dict[str, float]:
    """Least time for one fused top-k call: every operand read once and the
    lists written once at the HBM rate, against ``2 * B * N * d``
    operations at the peak rate of the product's operand type."""
    bsz, d = case.queries.shape
    n = case.valid_docs or case.docs.shape[0]
    q_bytes = 4 if case.docs.dtype == torch.float32 else 2
    nbytes = (bsz * d * q_bytes
              + n * case.docs.shape[1] * case.docs.element_size()
              + sum(t[:n].numel() * 4 for t in (case.bias, case.scale)
                    if t is not None)
              + bsz * case.k * 12)
    return _bound(nbytes, 2.0 * bsz * n * d, PEAK_FLOPS[case.docs.dtype])


def _bound(nbytes: float, flops: float, peak: float) -> Dict[str, float]:
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * flops / peak
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": float(nbytes), "flops": float(flops)}


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
    for k in (1, 10, 32, 128, 160):
        yield f"stream-int-k{k}", gains, k
    yield "stream-one-row", gains[:1, :1031].contiguous(), 32


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


def run_grouped_kernel(case: GroupedCase) -> Tensor:
    return grouped_gains(case.q, case.docs, case.bias, case.scale,
                         case.blk_cluster, case.packed4, rows=case.rows,
                         n_real=case.n_real)


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


def grouped_exact_cases(device, *, c: int = 5, d: int = 64, s: int = 72,
                        bsz: int = 23, seed: int = 0
                        ) -> Iterator[GroupedCase]:
    """Integer data, so the product is exact in any order: f32 / bf16 /
    int8 / int4 slabs of ``S = 72`` slots (two column tiles, the second
    ragged), blocks that repeat and reorder clusters, power-of-two scales,
    ``-inf`` bias on empty slots; each with pair rows given directly, with
    the row table, and with a real-block count below the grid's."""
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
        yield GroupedCase(f"grouped-{name}-direct", qt[t(rows).long()],
                          **common)
        yield GroupedCase(f"grouped-{name}-rows", qt, rows=t(rows), **common)
        yield GroupedCase(f"grouped-{name}-rows-nreal", qt, rows=t(rows),
                          n_real=torch.tensor([g - 2], dtype=torch.int32,
                                              device=device), **common)


def grouped_path_case(device, *, bsz: int = 512, c: int = 4096,
                      d: int = 768, s: int = 256, nprobe: int = 512,
                      seed: int = 3) -> GroupedCase:
    """The scoring of the cluster-probed search at the medrag pubmed
    defaults (4,096 clusters of 256 slots, 512 probes a query, bf16
    slabs), with the search's own dispatch of a random probe list."""
    from ragroute_tpu_torch.ops.ivf_topk import dispatch

    g = torch.Generator(device=device).manual_seed(seed)
    docs = torch.randn((c, d, s), generator=g, device=device,
                       dtype=torch.bfloat16)
    bias = torch.zeros((c, s), dtype=torch.float32, device=device)
    bias.masked_fill_(torch.rand((c, s), generator=g, device=device) < 0.2,
                      NEG_INF)
    q = torch.randn((bsz, d), generator=g, device=device).to(torch.bfloat16)
    probe = torch.rand((bsz, c), generator=g, device=device).topk(
        nprobe, dim=1)[1]
    rows, blk_cluster, n_real, _ = dispatch(probe, c)
    return GroupedCase("path-grouped-bf16", q, docs, bias, None, blk_cluster,
                       rows=rows, n_real=n_real)


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
