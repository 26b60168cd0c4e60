"""Exact streaming top-k over a stored gain matrix (the K2 kernel).

PyTorch/CUDA counterpart of
``ragroute_tpu/ops/pallas_topk.py::pallas_stream_topk``. :func:`stream_topk`
takes gain-form scores ``[B, M]`` f32 and returns per row the ``k`` best
``(gain, position)`` ordered by (gain desc, position asc); rows or entries
the caller wants ignored carry ``-inf`` and never displace anything. A list
slot nothing filled comes back as ``(-inf, 0)``.

On a CUDA tensor the wrapper launches ``csrc/stream_topk.cu`` or raises; on
a CPU tensor it runs :func:`stream_topk_reference`, the plain PyTorch
version (a stable descending sort, sliced).
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from ragroute_tpu_torch.ops.topk import topk_stable

Tensor = torch.Tensor

MAX_K = 160              # topk_merge.cuh KMAX
ROWS_PER_BLOCK = 4       # csrc/stream_topk.cu WARPS
MIN_CHUNK = 1024         # positions per split at least (a multiple of 256)
WARPS_PER_SM = 16        # split target: warps in flight on every SM


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
        lib._argtypes_set = True
    return lib


def _splits(bsz: int, m: int, device: torch.device) -> Tuple[int, int]:
    """(splits, positions per split): enough (row, split) warps to fill the
    card at small batch, never splits shorter than ``MIN_CHUNK``."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = max(1, math.ceil(WARPS_PER_SM * sms / bsz))
    splits = max(1, min(want, m // MIN_CHUNK))
    chunk = -(-(-(-m // splits)) // 256) * 256
    return -(-m // chunk), chunk


def stream_topk(gains: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """Exact top-k over ``gains [B, M]``: ``(top gains [B, k] f32,
    positions [B, k] i32)``, best first, ties to the lower position."""
    if gains.dim() != 2:
        raise ValueError(f"stream_topk: gains must be [B, M], got "
                         f"{tuple(gains.shape)}")
    bsz, m = gains.shape
    if not 1 <= k <= m:
        raise ValueError(f"stream_topk: need 1 <= k <= M, got k={k}, M={m}")
    if not gains.is_cuda:
        return stream_topk_reference(gains, k)
    if k > MAX_K:
        raise ValueError(f"stream_topk: kernel supports k <= {MAX_K}, "
                         f"got k={k}")
    if m >= 2 ** 31:
        raise ValueError("stream_topk: positions are int32")
    dev = gains.device
    g = gains.to(torch.float32).contiguous()
    out_g = torch.empty((bsz, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((bsz, k), dtype=torch.int32, device=dev)
    if bsz == 0:
        return out_g, out_i
    splits, chunk = _splits(bsz, m, dev)
    part_g = torch.empty((bsz, splits, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((bsz, splits, k), dtype=torch.int32, device=dev)
    err = _lib().stream_topk_launch(
        g.data_ptr(), part_g.data_ptr(), part_i.data_ptr(),
        out_g.data_ptr(), out_i.data_ptr(), bsz, m, k, splits, chunk,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stream_topk kernel launch failed: CUDA error "
                           f"{err}")
    stream_topk.launches += 1
    return out_g, out_i


stream_topk.launches = 0   # kernel launches since the count was last reset
