"""Probed coarse scan: grouped GEMM with a fused rank-capped top extraction
(the K4 kernel).

PyTorch/CUDA counterpart of ``ragroute_tpu/ops/grouped_topk.py``. The
hostrefine tier's exhaustive rank-r coarse scan pays for every gain it
forms, so the lever left is FEWER gains. This module prunes the coarse slab
with cluster probing:

* the coarse rows are k-means-clustered at build time into a dense
  cluster-major slab ``[C, r, S]`` (int8 codes, the same per-doc scales and
  gain biases as the flat coarse slab, permuted into slots);
* per query, a small ``[B, C]`` probe ranks clusters and keeps the top
  ``nprobe``;
* the (query, probed cluster) pairs are laid out block-diagonally by cluster
  WITHOUT a sort: probe membership is a dense ``[B, C]`` mask, so pair
  positions fall out of an exclusive cumsum over the batch axis;
* :func:`grouped_pair_topk` runs each block of :data:`PAIR_ROWS` pair rows
  against its cluster's slab and keeps, per row, at most ``ranks`` winners
  per tile of the slot axis; the gains never reach device memory (at
  B = 512, 512 probes and 1,584 slots that matrix would be 1.7 GB a batch);
* the per-pair winners are gathered per query and merged to the final
  ``[B, k']`` with :func:`ragroute_tpu_torch.ops.stream_topk.stream_topk`.

What :func:`grouped_pair_topk` computes (the kernel and
:func:`grouped_pair_topk_reference` alike):

* block ``i`` of ``PAIR_ROWS`` bf16 pair rows belongs to cluster
  ``blk_cluster[i]``; gain = ``(row . codes) * scale + bias``, the product
  summed in f32, the multiply and the add rounded separately;
* the slot axis is cut into tiles of ``tds = min(round_up(S, 128), 1024)``
  slots; ``n_tiles = ceil(S / tds)``, ``ranks = ceil(kappa / n_tiles)``,
  ``kw = ranks * n_tiles`` (:func:`tiling`). These are part of the
  function's definition: which candidates the rank cap drops depends on
  the tile boundaries;
* per (row, tile) the ``ranks`` largest gains, ties to the lowest slot, are
  offered best first, tiles in ascending order, to the row's sorted list of
  ``kw`` entries; an offer lands after the entries equal to it and ``-inf``
  never enters. The list can hold every offer, so the result is the stable
  descending sort of the offers; unfilled entries read ``-inf`` with an
  arbitrary slot (compare slots only where the gain is finite).

Recall property: the probe drops clusters (``nprobe / C``) and the rank cap
drops winners concentrated beyond ``ranks`` in one tile; with
``nprobe == C`` and ``kappa >= kp`` the candidate set matches the flat
coarse scan's up to that concentration. The hostrefine exact rescore is
unchanged downstream.

On a CUDA tensor :func:`grouped_pair_topk` launches
``csrc/grouped_pair_topk.cu`` or raises; on a CPU tensor it runs the plain
version. Which launch (:func:`_plan`, a pure function of the shape): up to
:data:`W_MAX_RANKS` winners a (row, tile) and :data:`W_MAX_KW` a row over
slabs of depth up to :data:`W_MAX_DEPTH` (the serving caps and rank) the
wgmma kernel (``pair_wgmma_kernel``: the block's query rows resident in
shared memory, the slab converted to bf16 by the producer warps, each
thread's best kept in registers); up to :data:`MAX_SHALLOW_RANKS` the first
design, which keeps each row's winners in its thread; past that, any
``ranks`` as the TPU kernel takes, the deep launch writes the scaled and
biased gains of a chunk of pair blocks to device memory and selects and
merges them there
(``csrc/deep_topk.cuh``), in chunks that keep the workspace under
``deep_topk.WORKSPACE_CAP``
(:func:`ragroute_tpu_torch.ops.deep_topk.pair_plan`).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ragroute_tpu_torch.ops import deep_topk
from ragroute_tpu_torch.ops.stream_topk import stream_topk
from ragroute_tpu_torch.ops.topk import NEG_INF, topk_stable

Tensor = torch.Tensor

PAIR_ROWS = 256          # pair rows per block (csrc/grouped_pair_topk.cu TE)
MAX_SHALLOW_RANKS = deep_topk.SHALLOW_MAX   # deepest per-thread tile list
RANK_ALIGN = 16          # depth multiple the kernel takes
# the wgmma kernel: deepest tile list (PW_MAX_RANKS: a thread's lists stay
# in registers), longest running list (PW_MAX_KW: kept in shared memory)
# and slab depth kept resident in shared memory (PW_MAX_R)
W_MAX_RANKS = 8
W_MAX_KW = 16
W_MAX_DEPTH = 128


@dataclasses.dataclass
class ClusteredCoarse:
    """Cluster-major layout of a hostrefine coarse slab on one device."""

    centroids: Tensor    # [C, r] f32 probe targets (projected space)
    cbias: Tensor        # [C] f32 mean gain bias per cluster
    docs: Tensor         # [C, r, S] int8 codes
    bias: Tensor         # [C, S] f32 gain bias, -inf at empty slots
    scale: Tensor        # [C, S] f32 per-doc dequant factors
    perm: Tensor         # [C, S] int32 global row id per slot, -1 if empty
    n_clusters: int
    capacity: int

    _FIELDS = ("centroids", "cbias", "docs", "bias", "scale", "perm")

    @property
    def device(self) -> torch.device:
        return self.docs.device

    def to(self, device) -> "ClusteredCoarse":
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in self._FIELDS})

    @property
    def nbytes(self) -> int:
        return sum(getattr(self, f).numel() * getattr(self, f).element_size()
                   for f in self._FIELDS)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def tiling(s: int, kappa: int) -> Tuple[int, int, int, int]:
    """``(tds, n_tiles, ranks, kw)`` for a slab of ``s`` slots and a
    per-pair winner cap ``kappa`` (see the module docstring)."""
    tds = min(_round_up(s, 128), 1024)
    n_tiles = _round_up(s, tds) // tds
    ranks = max(1, -(-int(kappa) // n_tiles))
    return tds, n_tiles, ranks, ranks * n_tiles


def grouped_pair_topk_reference(q: Tensor, cc: ClusteredCoarse,
                                blk_cluster: Tensor, kappa: int,
                                rows: Optional[Tensor] = None,
                                chunk: int = 32) -> Tuple[Tensor, Tensor]:
    """Plain version: per block a bf16 product summed in f32, scale, bias,
    per tile a stable descending sort cut to ``ranks``, the tiles' offers
    merged in tile order by one more stable sort. Returns ``(gains
    [Ep, kw] f32, slots [Ep, kw] i32)``, slot 0 on ``-inf`` entries."""
    c, r, s = cc.docs.shape
    if rows is not None:
        q = q[rows.long()]
    ep = q.shape[0]
    g = ep // PAIR_ROWS
    tds, n_tiles, ranks, kw = tiling(s, kappa)
    s_pad = n_tiles * tds
    cl_all = blk_cluster.long().clamp(0, c - 1)
    qb = q.to(torch.bfloat16).to(torch.float32).reshape(g, PAIR_ROWS, r)
    out_g = torch.empty((g, PAIR_ROWS, kw), dtype=torch.float32,
                        device=q.device)
    out_i = torch.empty((g, PAIR_ROWS, kw), dtype=torch.int32,
                        device=q.device)
    base = (torch.arange(n_tiles, device=q.device) * tds)[None, None, :, None]
    for g0 in range(0, g, chunk):        # bounds the [g, 256, S] f32 gains
        cl = cl_all[g0:g0 + chunk]
        gains = torch.bmm(qb[g0:g0 + chunk], cc.docs[cl].to(torch.float32))
        gains = gains * cc.scale[cl][:, None, :] + cc.bias[cl][:, None, :]
        if s_pad != s:
            gains = torch.nn.functional.pad(gains, (0, s_pad - s),
                                            value=NEG_INF)
        tiles = gains.reshape(-1, PAIR_ROWS, n_tiles, tds)
        if ranks > tds:      # more winners a tile than slots: -inf offers
            tiles = torch.nn.functional.pad(tiles, (0, ranks - tds),
                                            value=NEG_INF)
        tg, ti = topk_stable(tiles, ranks)          # [g, 256, n_tiles, ranks]
        offers_g = tg.reshape(-1, PAIR_ROWS, kw)
        offers_i = (ti + base).reshape(-1, PAIR_ROWS, kw)
        top, pos = topk_stable(offers_g, kw)
        slot = torch.gather(offers_i, 2, pos)
        out_g[g0:g0 + chunk] = top
        out_i[g0:g0 + chunk] = torch.where(torch.isneginf(top), 0,
                                           slot).to(torch.int32)
    return out_g.reshape(ep, kw), out_i.reshape(ep, kw)


def _lib():
    from ragroute_tpu_torch.ops import _build

    lib, _ = _build.load("grouped_pair_topk")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.grouped_pair_topk_launch.argtypes = [vp] * 9 + [ci] * 7 + [vp]
        lib.grouped_pair_topk_launch.restype = ci
        lib.grouped_pair_topk_deep_launch.argtypes = ([vp] * 13 + [ci] * 8
                                                      + [vp])
        lib.grouped_pair_topk_deep_launch.restype = ci
        lib.grouped_pair_topk_wgmma_launch.argtypes = ([vp] * 9 + [ci] * 7
                                                       + [vp])
        lib.grouped_pair_topk_wgmma_launch.restype = ci
        lib._argtypes_set = True
    return lib


def _plan(r: int, ranks: int, kw: int, kernel: Optional[str] = None) -> str:
    """The launch for slabs of depth ``r`` at ``ranks`` winners a (row,
    tile) and ``kw`` a row: ``"wgmma"``, ``"shallow"`` (the first design)
    or ``"deep"``; a pure function of these. ``kernel`` names one to run
    instead of choosing (the measurements time the launches against each
    other at one shape); a launch that does not take the shape raises."""
    fits = {"wgmma": (ranks <= W_MAX_RANKS and kw <= W_MAX_KW
                      and r <= W_MAX_DEPTH),
            "shallow": ranks <= MAX_SHALLOW_RANKS, "deep": True}
    if kernel is None:
        return next(name for name, ok in fits.items() if ok)
    if not fits[kernel]:
        raise ValueError(f"grouped_pair_topk: the {kernel} launch does not "
                         f"take depth {r} at {ranks} ranks")
    return kernel


def grouped_pair_topk(q: Tensor, cc: ClusteredCoarse, blk_cluster: Tensor,
                      kappa: int, *, rows: Optional[Tensor] = None,
                      n_real: Optional[Tensor] = None,
                      workspace_cap: Optional[int] = None
                      ) -> Tuple[Tensor, Tensor]:
    """Per-pair-row rank-capped winners over each row's cluster slab.

    ``q``: ``[Ep, r]`` bf16 pair rows (block-diagonal by cluster), or
    ``[B, r]`` bf16 queries with ``rows [Ep]`` i32 naming each pair row's
    query (the kernel then gathers the rows itself and the ``[Ep, r]`` copy
    is never made). ``blk_cluster [G]`` i32 names each block's cluster,
    ``G = Ep / PAIR_ROWS``. ``n_real`` (a device i32): the number of real
    blocks; blocks at or past it return at once and their output rows are
    left unwritten (nothing collects them). No host read.
    ``workspace_cap``: the deep launch's workspace in bytes (default
    ``deep_topk.WORKSPACE_CAP``).

    Returns ``(gains [Ep, kw] f32, slots [Ep, kw] i32)``, best first, slots
    within the row's cluster."""
    g = blk_cluster.shape[0]
    ep = g * PAIR_ROWS
    c, r, s = cc.docs.shape
    if (rows.shape[0] if rows is not None else q.shape[0]) != ep:
        raise ValueError(f"grouped_pair_topk: {g} blocks need {ep} pair rows")
    if q.shape[1] != r:
        raise ValueError(f"grouped_pair_topk: slab depth {r} does not match "
                         f"the rows' {q.shape[1]}")
    if not cc.docs.is_cuda:
        return grouped_pair_topk_reference(q, cc, blk_cluster, kappa, rows)
    return _launch(q, cc, blk_cluster, kappa, rows, n_real, workspace_cap)


def _launch(q: Tensor, cc: ClusteredCoarse, blk_cluster: Tensor, kappa: int,
            rows: Optional[Tensor], n_real: Optional[Tensor],
            workspace_cap: Optional[int] = None,
            kernel: Optional[str] = None) -> Tuple[Tensor, Tensor]:
    """Checks the operands and launches the kernel :func:`_plan` picks, or
    the one ``kernel`` names."""
    g = blk_cluster.shape[0]
    ep = g * PAIR_ROWS
    c, r, s = cc.docs.shape
    dev = cc.docs.device
    tds, n_tiles, ranks, kw = tiling(s, kappa)
    if cc.docs.dtype != torch.int8 or q.dtype != torch.bfloat16:
        raise TypeError(f"grouped_pair_topk: the kernel takes bf16 rows and "
                        f"int8 slabs, got {q.dtype} and {cc.docs.dtype}")
    if r % RANK_ALIGN or s % 8:
        raise ValueError(
            f"grouped_pair_topk: kernel needs r % {RANK_ALIGN} == 0 and "
            f"S % 8 == 0; got r={r}, S={s}")
    for name, t, shape in (("blk_cluster", blk_cluster, (g,)),
                           ("rows", rows, (ep,)), ("n_real", n_real, None)):
        if t is not None and (t.dtype != torch.int32 or t.device != dev
                              or not t.is_contiguous()
                              or (shape is not None
                                  and tuple(t.shape) != shape)):
            raise ValueError(f"grouped_pair_topk: {name} must be a "
                             f"contiguous int32 tensor on {dev}")
    for name, t in (("bias", cc.bias), ("scale", cc.scale)):
        if (t.dtype != torch.float32 or t.device != dev
                or tuple(t.shape) != (c, s) or not t.is_contiguous()):
            raise ValueError(f"grouped_pair_topk: {name} must be a "
                             f"contiguous [C, S] float32 tensor on {dev}")
    if (q.device != dev or not cc.docs.is_contiguous()
            or cc.docs.data_ptr() % 16):
        raise ValueError("grouped_pair_topk: q and the slab must be on one "
                         "device, the slab contiguous and 16-byte aligned")
    launch = _plan(r, ranks, kw, kernel)
    q = q.contiguous()
    if q.data_ptr() % 16:       # the wgmma kernel's row copies take 16 bytes
        q = q.clone()
    out_g = torch.empty((ep, kw), dtype=torch.float32, device=dev)
    out_i = torch.empty((ep, kw), dtype=torch.int32, device=dev)
    ptrs = (q.data_ptr(), cc.docs.data_ptr(), cc.bias.data_ptr(),
            cc.scale.data_ptr(), blk_cluster.data_ptr(),
            None if rows is None else rows.data_ptr(),
            None if n_real is None else n_real.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    if launch == "deep":
        p = deep_topk.pair_plan(g, s, tds, ranks, kw, cap=workspace_cap)
        rows_c = p.blocks * PAIR_ROWS
        ws_g = torch.empty((rows_c, s), dtype=torch.float32, device=dev)
        ws = [torch.empty((rows_c, max(1, n)), dtype=torch.int64, device=dev)
              for n in (p.entries, p.entries, kw)]
        err = _lib().grouped_pair_topk_deep_launch(
            *ptrs, ws_g.data_ptr(), *(w.data_ptr() for w in ws),
            out_g.data_ptr(), out_i.data_ptr(), g, c, r, s, tds, ranks, kw,
            p.blocks, stream)
    else:
        fn = (_lib().grouped_pair_topk_wgmma_launch if launch == "wgmma"
              else _lib().grouped_pair_topk_launch)
        err = fn(*ptrs, out_g.data_ptr(), out_i.data_ptr(), g, c, r, s, tds,
                 ranks, kw, stream)
    if err != 0:
        what = (deep_topk.describe(err) if launch == "deep"
                else f"CUDA error {err}")
        raise RuntimeError(f"grouped_pair_topk {launch} launch failed: "
                           f"{what}")
    grouped_pair_topk.launches += 1
    grouped_pair_topk.deep_launches += launch == "deep"
    grouped_pair_topk.wgmma_launches += launch == "wgmma"
    return out_g, out_i


grouped_pair_topk.launches = 0   # kernel launches since the last reset
grouped_pair_topk.deep_launches = 0   # of which deep (ranks > 160)
grouped_pair_topk.wgmma_launches = 0  # of which the wgmma kernel


def probe_dispatch(probe: Tensor, n_clusters: int):
    """Sort-free block-diagonal layout of the (query, probed cluster)
    pairs.

    Probe membership is a dense ``[B, C]`` mask; the position of pair
    ``(b, c)`` inside cluster ``c``'s run is an exclusive cumsum over the
    batch axis. Returns ``(pair_q [Ep] i32, blk_cluster [G] i32, n_real [1]
    i32, pair_pos [B, P] i64)``: the query of every padded pair row
    (padding rows name query 0), each block's cluster, the number of real
    blocks, and where pair ``(b, j)`` landed. ``G`` is the static bound
    ``(B * P) // PAIR_ROWS + min(B * P, C)`` on ``sum(ceil(count /
    PAIR_ROWS))``; nothing is read back to the host."""
    bsz, p = probe.shape
    dev = probe.device
    c = n_clusters
    mask = torch.zeros((bsz, c), dtype=torch.int32, device=dev)
    mask.scatter_(1, probe, 1)
    counts = mask.sum(dim=0)                                  # [C]
    pos = torch.cumsum(mask, dim=0) - mask                    # [B, C] excl.
    nblk = -(-counts // PAIR_ROWS)                            # blocks/cluster
    blk_hi = torch.cumsum(nblk, dim=0)                        # [C] inclusive
    base_rows = (blk_hi - nblk) * PAIR_ROWS                   # [C]
    n_blocks = (bsz * p) // PAIR_ROWS + min(bsz * p, c)
    pair_pos = base_rows[probe] + torch.gather(pos, 1, probe)  # [B, P]
    pair_q = torch.zeros(n_blocks * PAIR_ROWS, dtype=torch.int32, device=dev)
    pair_q[pair_pos.reshape(-1)] = torch.arange(
        bsz, dtype=torch.int32, device=dev).repeat_interleave(p)
    blk_cluster = torch.searchsorted(
        blk_hi, torch.arange(n_blocks, device=dev), right=True
    ).clamp(0, c - 1).to(torch.int32)
    return pair_q, blk_cluster, blk_hi[-1:].to(torch.int32), pair_pos


def coarse_probe_topk(qt: Tensor, cc: ClusteredCoarse, kp: int, *,
                      nprobe: int, kappa: int = 16) -> Tuple[Tensor, Tensor]:
    """Probed top-``kp`` over a clustered coarse slab.

    Args:
      qt: ``[B, r]`` f32 projected queries (the rows the flat coarse scan
        feeds ``shard_topk``).
      kp: candidate depth per query (the hostrefine k').
      nprobe: clusters probed per query.
      kappa: target per-(query, cluster) winner cap, realized as
        ``ceil(kappa / n_tiles)`` ranks per slab tile.

    Returns ``(keys [B, kp] f32 gain form, ids [B, kp] int64 global row
    ids, -1 where invalid)``: the contract of the flat coarse scan's
    output fed through the row-id map."""
    bsz, _ = qt.shape
    c, _, s = cc.docs.shape
    p = int(min(max(nprobe, 1), c))
    kappa = int(min(kappa, s, kp))

    # 1. probe: gain-form cluster ranking, ties to the lower cluster (a
    # stable sort; torch.topk promises no order among ties)
    cg = (qt @ cc.centroids.T).to(torch.float32) + cc.cbias[None, :]
    probe = topk_stable(cg, p)[1]                             # [B, P]

    # 2. sort-free block-diagonal dispatch
    pair_q, blk_cluster, n_real, pair_pos = probe_dispatch(probe, c)

    # 3. fused grouped GEMM + rank-capped per-row top extraction (the rows
    # are rounded to bf16 here; the kernel gathers them by the row table)
    og, oi = grouped_pair_topk(qt.to(torch.bfloat16), cc, blk_cluster, kappa,
                               rows=pair_q, n_real=n_real)
    kw = og.shape[1]                 # realized per-pair width

    # 4. collect: each query's P pair rows -> [B, P*kw] -> top-kp
    row_of = pair_pos.reshape(-1)
    pg = og[row_of].reshape(bsz, p * kw)
    pi = oi[row_of].reshape(bsz, p * kw)
    kp_eff = min(kp, p * kw)
    keys, posk = stream_topk(pg, kp_eff)
    posk = posk.long()
    slot = torch.gather(pi, 1, posk).long()                   # [B, kp]
    cl = torch.gather(probe, 1, posk // kw)
    gid = cc.perm.reshape(-1)[cl * s + slot].long()
    gid = torch.where(keys > NEG_INF, gid, -1)
    if kp_eff < kp:
        keys = torch.nn.functional.pad(keys, (0, kp - kp_eff), value=NEG_INF)
        gid = torch.nn.functional.pad(gid, (0, kp - kp_eff), value=-1)
    return keys, gid


def slab_capacity(n: int, c: int, capacity_slack: float = 1.1) -> int:
    """Slots per cluster: ``ceil(n / C) * slack`` rounded up to 8."""
    cap = max(-(-n // c), int(-(-n // c) * capacity_slack))
    return max(8, -(-cap // 8) * 8)


def layout_slab(codes: np.ndarray, scales: np.ndarray, bias: np.ndarray,
                row0: int, assign: np.ndarray, cent: np.ndarray, c: int,
                cap: int, device="cpu") -> ClusteredCoarse:
    """The cluster-major slab of a given assignment: row ``order[i]``
    (sorted by cluster, stable) takes slot (cluster, rank within the
    cluster); codes, scales and biases move unchanged, so a full probe
    scores the values of the flat coarse scan. The slab is filled on
    ``device`` by one scatter and one transpose (pure data movement)."""
    n, r = codes.shape
    dev = torch.device(device)
    order = np.argsort(assign, kind="stable")
    cl_sorted = assign[order].astype(np.int64)
    first = np.searchsorted(cl_sorted, np.arange(c), "left")
    slot = cl_sorted * cap + (np.arange(n) - first[cl_sorted])
    s_slab = np.full((c * cap,), 1e-12, np.float32)
    b_slab = np.full((c * cap,), -np.inf, np.float32)
    perm = np.full((c * cap,), -1, np.int32)
    s_slab[slot] = scales[order]
    b_slab[slot] = bias[order]
    perm[slot] = order + row0
    slot_t = torch.from_numpy(slot).to(dev)
    order_t = torch.from_numpy(order.astype(np.int64)).to(dev)
    rows = torch.from_numpy(np.ascontiguousarray(codes)).to(dev)
    slots = torch.zeros((c * cap, r), dtype=torch.int8, device=dev)
    slots[slot_t] = rows[order_t]
    del rows
    docs = slots.reshape(c, cap, r).transpose(1, 2).contiguous()
    del slots
    b_slab = b_slab.reshape(c, cap)
    # probe bias: per-cluster mean of real gain biases (l2 worlds carry
    # -|d|^2 here; dot/cos carry 0) so probe ranking sees the same
    # systematic offset the scan will
    finite = np.where(np.isfinite(b_slab), b_slab, 0.0)
    cnt = np.isfinite(b_slab).sum(axis=1).clip(min=1)
    cbias = (finite.sum(axis=1) / cnt).astype(np.float32)

    def t(a):
        return torch.from_numpy(np.array(a)).to(dev)   # the arrays are small

    return ClusteredCoarse(
        centroids=t(np.asarray(cent, np.float32)), cbias=t(cbias), docs=docs,
        bias=t(b_slab), scale=t(s_slab.reshape(c, cap)),
        perm=t(perm.reshape(c, cap)), n_clusters=c, capacity=cap)


def cluster_coarse_slab(codes: np.ndarray, scales: np.ndarray,
                        bias: np.ndarray, row0: int, *,
                        n_clusters: Optional[int] = None,
                        capacity_slack: float = 1.1, kmeans_iters: int = 10,
                        seed: int = 0, device="cpu") -> ClusteredCoarse:
    """Build the cluster-major layout from a flat coarse slab.

    ``codes [n, r]`` int8 / ``scales [n]`` / ``bias [n]`` are the flat
    coarse arrays (:meth:`index.streamed.StreamedShardSet._build_coarse`,
    host copies); ``row0`` is the global row id of ``codes[0]``. k-means
    runs on the DEQUANTIZED rows (quantization noise is far below cluster
    geometry) with the Lloyd iterations of :mod:`index.ivf` on ``device``."""
    from ragroute_tpu_torch.index.ivf import (KMEANS_CHUNK, _balanced_assign,
                                              _kmeans_device, _top_r_choices,
                                              _upload_chunks,
                                              default_n_clusters)

    n, _ = codes.shape
    deq = codes.astype(np.float32) * scales[:, None].astype(np.float32)
    c = int(max(1, min(n_clusters or default_n_clusters(n), n)))
    cap = slab_capacity(n, c, capacity_slack)
    if c == 1:
        cent = deq.mean(axis=0, keepdims=True).astype(np.float32)
        assign = np.zeros(n, np.int32)
    else:
        xc, wc, _ = _upload_chunks(deq, KMEANS_CHUNK, torch.device(device))
        cent = _kmeans_device(xc, wc, deq, c, kmeans_iters, seed)
        choices = _top_r_choices(xc, n, cent, min(8, c))
        del xc, wc
        assign = _balanced_assign(choices, c, cap)
    del deq
    return layout_slab(codes, scales, bias, row0, assign, cent, c, cap,
                       device)


def clustered_from_reference(fields, device="cpu") -> ClusteredCoarse:
    """Carry a layout across from the JAX package: ``fields`` maps the
    array names of its ``ClusteredCoarse`` to numpy arrays. The depth axis
    is padded with zero columns to a multiple of :data:`RANK_ALIGN` (the
    kernel's grid; a zero column adds nothing to any gain)."""
    docs = np.asarray(fields["docs"], np.int8)
    cent = np.asarray(fields["centroids"], np.float32)
    c, r, cap = docs.shape
    pad = -r % RANK_ALIGN
    if pad:
        docs = np.pad(docs, ((0, 0), (0, pad), (0, 0)))
        cent = np.pad(cent, ((0, 0), (0, pad)))

    def t(a, dt):
        return torch.from_numpy(np.array(a, dtype=dt)).to(device)

    return ClusteredCoarse(
        centroids=t(cent, np.float32), cbias=t(fields["cbias"], np.float32),
        docs=t(docs, np.int8), bias=t(fields["bias"], np.float32),
        scale=t(fields["scale"], np.float32),
        perm=t(fields["perm"], np.int32), n_clusters=int(c),
        capacity=int(cap))
