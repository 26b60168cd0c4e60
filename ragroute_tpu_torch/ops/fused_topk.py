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
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ragroute_tpu_torch.ops.topk import (NEG_INF, _prepare_queries, _validate,
                                         doc_bias, gain_to_natural,
                                         topk_stable, unpack_int4)

Tensor = torch.Tensor

TILE_Q = 64          # query rows per block (csrc/fused_topk.cu TQ)
TILE_D = 64          # docs per tile (TD)
MAX_K = 160          # topk_merge.cuh KMAX
MAX_SPLITS = 512
BLOCKS_PER_SM = 4    # split target: enough blocks to fill every SM
# deep lists (k > 64): every split fills its own k-deep lists by serial
# inserts, about k * (1 + ln(docs per split / k)) of them per query row, so
# fewer and longer splits cost less than they lose in parallelism
DEEP_BLOCKS_PER_SM = 2
SHALLOW_K = 64       # topk_merge.cuh KSHALLOW
_DOC_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_INT4_PER_DOC, _INT4_PER_GROUP = 3, 4    # csrc DocType kI4, kI4G


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
        lib._argtypes_set = True
    return lib


def _splits(bsz: int, n_rows: int, k: int,
            device: torch.device) -> Tuple[int, int]:
    """(doc splits, tiles per split): enough blocks to fill the card at
    small and large batch alike."""
    n_qtiles = -(-bsz // TILE_Q)
    n_tiles = -(-n_rows // TILE_D)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per_sm = BLOCKS_PER_SM if k <= SHALLOW_K else DEEP_BLOCKS_PER_SM
    splits = max(1, min(n_tiles, MAX_SPLITS,
                        math.ceil(per_sm * sms / n_qtiles)))
    per = -(-n_tiles // splits)
    return -(-n_tiles // per), per


def _launch(q: Tensor, docs: Tensor, k: int, n_rows: int,
            bias: Optional[Tensor], scale: Optional[Tensor],
            packed4: bool = False) -> Tuple[Tensor, Tensor]:
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
    if not 1 <= k <= MAX_K:
        raise ValueError(f"fused_topk: kernel supports 1 <= k <= {MAX_K}, "
                         f"got k={k}")
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
    splits, per = _splits(bsz, n_rows, k, dev)
    part_g = torch.empty((bsz, splits, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((bsz, splits, k), dtype=torch.int32, device=dev)
    out_g = torch.empty((bsz, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((bsz, k), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().fused_topk_launch(
        q.data_ptr(), docs.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if scale is None else scale.data_ptr(),
        part_g.data_ptr(), part_i.data_ptr(), out_g.data_ptr(),
        out_i.data_ptr(), bsz, n_rows, d, k, n_groups, splits, per,
        (_INT4_PER_GROUP if grouped else _INT4_PER_DOC) if packed4
        else _DOC_TYPES[docs.dtype], stream)
    if err != 0:
        raise RuntimeError(f"fused_topk kernel launch failed: CUDA error {err}")
    fused_topk.launches += 1
    return out_g, out_i


def fused_topk(queries: Tensor, docs: Tensor, k: int, *, mode: str = "dot",
               valid_docs: Optional[int] = None,
               bias: Optional[Tensor] = None,
               scale: Optional[Tensor] = None,
               packed4: bool = False) -> Tuple[Tensor, Tensor]:
    """Exact top-k of ``score(q, d)`` over a shard, fused on the card.

    Args as :func:`ragroute_tpu.ops.pallas_topk.pallas_topk`: ``queries``
    ``[B, d]``; ``docs`` ``[N, d]`` (f32 / bf16 / int8, or int4-packed
    ``[N, d/2]`` with ``packed4``); ``bias`` the gain-form ``[N]`` bias;
    ``scale`` the per-doc ``[N]`` (or per-group ``[N, G]`` for int4)
    dequantization factor; ``valid_docs`` the number of real rows.

    Returns ``(scores [B, k], indices [B, k])`` in natural score form, best
    first. A CUDA tensor runs the kernel (k up to 160; deeper raises); a
    CPU tensor runs :func:`fused_topk_reference`.
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
                                 packed4=packed4)
    else:
        gains, idx = fused_topk_reference(q, docs, k, valid_docs=valid,
                                          bias=b, scale=scale,
                                          packed4=packed4)
    return gain_to_natural(gains, queries, mode), idx


fused_topk.launches = 0   # kernel launches since the count was last reset
