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
than a warp streams, warps that stream the row for long rows with a shallow
list. A deeper list, any ``k <= M`` as the TPU kernel takes, runs the deep
launch (``csrc/deep_topk.cuh``): runs of at most 8,192 positions selected
and sorted a block each, their lists merged in pairs, rows in slices that
keep the workspace under ``deep_topk.WORKSPACE_CAP``
(:func:`ragroute_tpu_torch.ops.deep_topk.stream_plan`).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from ragroute_tpu_torch.ops import deep_topk
from ragroute_tpu_torch.ops.topk import topk_stable

Tensor = torch.Tensor

MAX_SHALLOW_K = deep_topk.SHALLOW_MAX   # deepest list of the shallow paths
SHALLOW_K = 64           # topk_merge.cuh KSHALLOW: deepest list a warp streams
SELECT_CHUNK = 8192      # csrc/stream_topk.cu SEL_CHUNK_MAX: keys a select run
SMEM_LIMIT = 232_448     # bytes of shared memory a block may use (H100)
MIN_CHUNK = 1024         # warp path: positions per split at least (x 256)
WARPS_PER_SM = 16        # warp path split target: warps in flight an SM
WARP, SELECT = 0, 1      # the kernel's paths (stream_topk_launch's `path`)


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
        lib.stream_topk_launch.argtypes = [vp] * 5 + [ci] * 6 + [vp]
        lib.stream_topk_launch.restype = ci
        lib.stream_topk_deep_launch.argtypes = [vp] * 6 + [ci] * 5 + [vp]
        lib.stream_topk_deep_launch.restype = ci
        lib._argtypes_set = True
    return lib


class Plan(NamedTuple):
    path: int        # WARP or SELECT
    splits: int      # runs a row is cut into (merged by a second kernel)
    chunk: int       # positions a run; the last may be shorter, none empty


def plan(bsz: int, m: int, k: int, sms: int) -> Plan:
    """The kernel's path and split of ``[bsz, m]`` at depth ``k`` on a card
    with ``sms`` SMs.

    A list deeper than a warp streams well (``k > SHALLOW_K``), or a row
    short enough for one select run (``m <= SELECT_CHUNK``), takes the
    select path: runs of at most ``SELECT_CHUNK`` positions, one block
    each. A long row with a shallow list takes the warp path: enough
    (row, split) warps to fill the card at small batch, never splits
    shorter than ``MIN_CHUNK``, split starts on the 256-position grid."""
    if k > SHALLOW_K or m <= SELECT_CHUNK:
        chunk = -(-m // -(-m // SELECT_CHUNK))
        return Plan(SELECT, -(-m // chunk), chunk)
    want = max(1, math.ceil(WARPS_PER_SM * sms / bsz))
    splits = max(1, min(want, m // MIN_CHUNK))
    chunk = -(-(-(-m // splits)) // 256) * 256
    return Plan(WARP, -(-m // chunk), chunk)


def smem_bytes(p: Plan, k: int) -> int:
    """Shared memory of one block of the plan's kernel."""
    if p.path == SELECT:   # the run's keys; the histogram and winners static
        return 4 * p.chunk + 4 * (256 + 2 * 8 + 10) + 8 * MAX_SHALLOW_K
    return 4 * k * 8       # four warps' lists of (gain, position)


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
    p = plan(bsz, m, k, _sm_count(dev))
    part_g = part_i = None
    if p.splits > 1:
        part_g = torch.empty((bsz, p.splits, k), dtype=torch.float32,
                             device=dev)
        part_i = torch.empty((bsz, p.splits, k), dtype=torch.int32,
                             device=dev)
    err = _lib().stream_topk_launch(
        g.data_ptr(), None if part_g is None else part_g.data_ptr(),
        None if part_i is None else part_i.data_ptr(),
        out_g.data_ptr(), out_i.data_ptr(), bsz, m, k, p.splits, p.chunk,
        p.path, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stream_topk kernel launch failed: CUDA error "
                           f"{err}")
    stream_topk.launches += 1
    return out_g, out_i


stream_topk.launches = 0   # kernel launches since the count was last reset
stream_topk.deep_launches = 0   # of which deep launches (k > MAX_SHALLOW_K)


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
