"""Exact streaming top-k over a stored gain matrix (the K2 kernel).

PyTorch/CUDA counterpart of
``ragroute_tpu/ops/pallas_topk.py::pallas_stream_topk``. :func:`stream_topk`
takes gain-form scores ``[B, M]`` f32 and returns per row the ``k`` best
``(gain, position)`` ordered by (gain desc, position asc); rows or entries
the caller wants ignored carry ``-inf`` and never displace anything. A list
slot nothing filled comes back as ``(-inf, 0)``.

On a CUDA tensor the wrapper launches ``csrc/stream_topk.cu`` or raises; on
a CPU tensor it runs :func:`stream_topk_reference`, the plain PyTorch
version (a stable descending sort, sliced). Up to :data:`MAX_SHALLOW_K`,
:func:`plan` picks the kernel's path and its split of the positions from
the shape alone: a radix select a block for short rows and lists deeper
than :data:`SHALLOW_K`, the collect for long rows with a shallow list
(persistent warps over (row, split) items planned as whole waves of the
resident warps, 16-byte loads, the split lists merged in the same launch
by the warp that finishes a row last, through a counter a row that the
kernel leaves at zero: :func:`_collect_scratch`). A deeper list, any ``k <= M``
as the TPU kernel takes, runs the deep launch (``csrc/deep_topk.cuh``):
runs of at most 8,192 positions selected and sorted a block each, their
lists merged in pairs, rows in slices that keep the workspace under
``deep_topk.WORKSPACE_CAP``
(:func:`ragroute_tpu_torch.ops.deep_topk.stream_plan`).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ragroute_tpu_torch.ops import deep_topk
from ragroute_tpu_torch.ops.topk import topk_stable

Tensor = torch.Tensor

MAX_SHALLOW_K = deep_topk.SHALLOW_MAX   # deepest list of the shallow paths
SHALLOW_K = 64           # topk_merge.cuh KSHALLOW: deepest list a warp streams
SELECT_CHUNK = 8192      # csrc/stream_topk.cu SEL_CHUNK_MAX: keys a select run
SMEM_LIMIT = 232_448     # bytes of shared memory a block may use (H100)
MIN_CHUNK = 1024         # the collect: positions per split at least
# the collect (csrc/stream_topk.cu C_*): warps a block, resident blocks an
# SM, positions a warp reads a round (8 16-byte loads a lane), list entries
# the row's last warp reads a round in its merge, a warp's candidate buffer
COLLECT_WARPS = 8
COLLECT_BLOCKS_PER_SM = 4
COLLECT_ROUND = 1024
MERGE_ROUND = 256
COLLECT_CAP = 32
SELECT, COLLECT = 0, 1   # the kernel's paths


def stream_topk_reference(gains: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """Plain version: ``(top gains [B, k] f32, positions [B, k] i32)``."""
    top_g, pos = topk_stable(gains.to(torch.float32), k)
    pos = torch.where(torch.isneginf(top_g), 0, pos)
    return top_g, pos.to(torch.int32)


def _lib():
    from ragroute_tpu_torch.ops import _build

    lib, _ = _build.load("stream_topk")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.stream_topk_launch.argtypes = [vp] * 5 + [ci] * 5 + [vp]
        lib.stream_topk_launch.restype = ci
        lib.stream_topk_deep_launch.argtypes = [vp] * 6 + [ci] * 5 + [vp]
        lib.stream_topk_deep_launch.restype = ci
        lib.stream_topk_collect_launch.argtypes = [vp] * 6 + [ci] * 6 + [vp]
        lib.stream_topk_collect_launch.restype = ci
        lib._argtypes_set = True
    return lib


class Plan(NamedTuple):
    path: int        # SELECT or COLLECT
    splits: int      # runs a row is cut into
    chunk: int       # positions a run; the last may be shorter, none empty
    grid: int = 0    # the collect's persistent blocks


@functools.lru_cache(maxsize=None)
def plan(bsz: int, m: int, k: int, sms: int) -> Plan:
    """The kernel's path and split of ``[bsz, m]`` at depth ``k`` on a card
    with ``sms`` SMs.

    A list deeper than ``SHALLOW_K``, or a row short enough for one select
    run (``m <= SELECT_CHUNK``), takes the select path: runs of at most
    ``SELECT_CHUNK`` positions, one block each, merged by a second launch
    when a row has several. A long row with a shallow list takes the
    collect (:func:`collect_plan`)."""
    if k > SHALLOW_K or m <= SELECT_CHUNK:
        chunk = -(-m // -(-m // SELECT_CHUNK))
        return Plan(SELECT, -(-m // chunk), chunk)
    return collect_plan(bsz, m, k, sms)


def collect_plan(bsz: int, m: int, k: int, sms: int) -> Plan:
    """The collect's split: runs of a whole number of ``COLLECT_ROUND``
    positions, at least ``MIN_CHUNK`` unless a row is one run, as
    (row, split) items over the card's resident warps (``sms *
    COLLECT_BLOCKS_PER_SM * COLLECT_WARPS``) in whole waves. Its cost in
    rounds of loads a warp waits on: the waves times a run's rounds, plus
    the rounds in which a row's last warp reads every split's list (``splits
    * k`` entries, ``MERGE_ROUND`` a round); the cheapest, the fewest splits
    among equals. At [512, 131,072] that is 8 splits of 16,384: 4,096 items
    in one wave of 4,224 warps."""
    if k > SHALLOW_K:
        raise ValueError(f"stream_topk: the collect takes k <= {SHALLOW_K}, "
                         f"got k={k}")
    warps = sms * COLLECT_BLOCKS_PER_SM * COLLECT_WARPS
    best = None
    for want in range(1, max(1, min(m // MIN_CHUNK, warps)) + 1):
        chunk = -(-(-(-m // want)) // COLLECT_ROUND) * COLLECT_ROUND
        splits = -(-m // chunk)
        waves = -(-bsz * splits // warps)
        cost = waves * (chunk // COLLECT_ROUND) + (
            -(-splits * k // MERGE_ROUND) if splits > 1 else 0)
        if best is None or (cost, splits) < best[:2]:
            best = (cost, splits, chunk)
    _, splits, chunk = best
    grid = min(sms * COLLECT_BLOCKS_PER_SM,
               -(-bsz * splits // COLLECT_WARPS))
    return Plan(COLLECT, splits, chunk, grid)


def smem_bytes(p: Plan, k: int) -> int:
    """Shared memory of one block of the plan's kernel."""
    if p.path == SELECT:   # the run's keys; the histogram and winners static
        return 4 * p.chunk + 4 * (256 + 2 * 8 + 10) + 8 * MAX_SHALLOW_K
    # the collect: each warp's round stage, list and buffer
    return COLLECT_WARPS * (COLLECT_ROUND * 4 + (k + COLLECT_CAP) * 8)


_SCRATCH: Dict[Tuple[torch.device, int], Tuple[Tensor, Tensor, Tensor]] = {}


def _collect_scratch(dev: torch.device, stream: int, bsz: int, lists: int
                     ) -> Tuple[Tensor, Tensor, Tensor]:
    """The collect's scratch for launches on ``stream``: the split lists'
    gains and positions (``lists`` entries or more, f32 and int32) and the
    counters of finished splits (``bsz`` or more int32). The launches of
    one stream run in order, and each leaves every counter at zero (a
    row's last warp resets its count), so the scratch is made once, the
    counters zeroed when made, and grown only for a larger call. The
    collect is host-bound: made per call instead (two ``torch.empty`` and a
    ``torch.zeros`` fill), the ivf collect [512, 131,072] k=32 took 0.205 to
    0.230 ms by CUDA events against 0.174 to 0.181 (NVIDIA H100 80GB HBM3,
    700.00 W; ``measure.SMALL_F32_COLLECT_TIMER``, in turns)."""
    key = (dev, stream)
    have = _SCRATCH.get(key)
    if have is None or have[0].numel() < lists or have[2].numel() < bsz:
        n = max(lists, 0 if have is None else have[0].numel())
        rows = max(bsz, 512, 0 if have is None else have[2].numel())
        have = (torch.empty(n, dtype=torch.float32, device=dev),
                torch.empty(n, dtype=torch.int32, device=dev),
                torch.zeros(rows, dtype=torch.int32, device=dev))
        _SCRATCH[key] = have
    return have


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_topk(gains: Tensor, k: int, *,
                workspace_cap: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """Exact top-k over ``gains [B, M]``: ``(top gains [B, k] f32,
    positions [B, k] i32)``, best first, ties to the lower position.
    ``workspace_cap``: the deep launch's workspace in bytes (default
    ``deep_topk.WORKSPACE_CAP``)."""
    if gains.dim() != 2:
        raise ValueError(f"stream_topk: gains must be [B, M], got "
                         f"{tuple(gains.shape)}")
    bsz, m = gains.shape
    if not 1 <= k <= m:
        raise ValueError(f"stream_topk: need 1 <= k <= M, got k={k}, M={m}")
    if not gains.is_cuda:
        return stream_topk_reference(gains, k)
    if m >= 2 ** 31:
        raise ValueError("stream_topk: positions are int32")
    dev = gains.device
    g = gains.to(torch.float32).contiguous()
    out_g = torch.empty((bsz, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((bsz, k), dtype=torch.int32, device=dev)
    if bsz == 0:
        return out_g, out_i
    if k > MAX_SHALLOW_K:
        _launch_deep(g, k, out_g, out_i, workspace_cap)
        stream_topk.launches += 1
        stream_topk.deep_launches += 1
        return out_g, out_i
    _launch(g, k, plan(bsz, m, k, _sm_count(dev)), out_g, out_i)
    return out_g, out_i


def _launch(g: Tensor, k: int, p: Plan, out_g: Tensor,
            out_i: Tensor) -> None:
    """One launch of the plan's path into ``out_g`` / ``out_i`` (``k <=
    MAX_SHALLOW_K``; ``g`` contiguous f32 on the card)."""
    bsz, m = g.shape
    dev = g.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    if p.path == COLLECT:
        part_g, part_i, done = _collect_scratch(dev, stream, bsz,
                                                bsz * p.splits * k)
        err = _lib().stream_topk_collect_launch(
            g.data_ptr(), part_g.data_ptr(), part_i.data_ptr(),
            out_g.data_ptr(), out_i.data_ptr(), done.data_ptr(), bsz, m, k,
            p.splits, p.chunk, p.grid, stream)
    else:
        part_g = part_i = None
        if p.splits > 1:
            part_g = torch.empty((bsz, p.splits, k), dtype=torch.float32,
                                 device=dev)
            part_i = torch.empty((bsz, p.splits, k), dtype=torch.int32,
                                 device=dev)
        err = _lib().stream_topk_launch(
            g.data_ptr(), None if part_g is None else part_g.data_ptr(),
            None if part_i is None else part_i.data_ptr(), out_g.data_ptr(),
            out_i.data_ptr(), bsz, m, k, p.splits, p.chunk, stream)
    if err != 0:
        raise RuntimeError(f"stream_topk kernel launch failed: CUDA error "
                           f"{err}")
    stream_topk.launches += 1
    stream_topk.collect_launches += p.path == COLLECT


stream_topk.launches = 0   # kernel launches since the count was last reset
stream_topk.deep_launches = 0   # of which deep launches (k > MAX_SHALLOW_K)
stream_topk.collect_launches = 0   # of which the collect (long rows, k <= 64)


def _launch_deep(g: Tensor, k: int, out_g: Tensor, out_i: Tensor,
                 cap: Optional[int]) -> None:
    """The deep launch (``k > MAX_SHALLOW_K``) into ``out_g`` / ``out_i``."""
    bsz, m = g.shape
    p = deep_topk.stream_plan(bsz, m, k, cap)
    ws = [None, None, None]
    if p.splits > 1:       # one run a row needs no workspace
        ws = [torch.empty((p.rows, n), dtype=torch.int64, device=g.device)
              for n in (p.entries, p.entries, k)]
    err = _lib().stream_topk_deep_launch(
        g.data_ptr(), *(None if w is None else w.data_ptr() for w in ws),
        out_g.data_ptr(), out_i.data_ptr(), bsz, m, k, p.run, p.rows,
        torch.cuda.current_stream(g.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stream_topk deep launch failed: "
                           f"{deep_topk.describe(err)}")
