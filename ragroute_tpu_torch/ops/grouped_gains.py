"""Grouped GEMM of cluster-aligned pair blocks (the K3 kernel).

PyTorch/CUDA counterpart of ``ragroute_tpu/ops/ivf_topk.py::_grouped_gains``.
The sorted (query, probed cluster) pairs of a batch are padded so that each
cluster's rows fill whole blocks of :data:`GROUP_ROWS`; block ``i``
multiplies its rows by the slab of cluster ``blk_cluster[i]``:

    out[i * 64 + r, :] = (q[row] @ docs[c]) * scale[c] + bias[c]

with ``docs [C, d, S]`` (``[C, d/2, S]`` bytes when int4-packed: byte row
``j`` holds dim ``j`` in its low nibble and dim ``j + d/2`` in its high
nibble), the scale multiply and the bias add rounded separately, and
``bias`` ``-inf`` on empty slots.

Two things the TPU kernel leaves to its caller are optional arguments here,
because on this card they are the larger part of the traffic:

* ``rows [Ep]``: the query row of every pair row. The kernel then gathers
  from ``q [B, d]`` itself and the ``[Ep, d]`` copy is never made.
* ``n_real`` (a device i32): the number of real blocks. Blocks past it (the
  padding up to the static bound on the block count) return at once and
  their output rows are left unwritten; nothing collects them. The count
  stays on the device: no host read.

On a CUDA tensor the wrapper launches ``csrc/grouped_gains.cu`` or raises;
on a CPU tensor it runs :func:`grouped_gains_reference`. Which kernel a call
launches is :func:`_plan`, a pure function of the shape: bf16, int8 and int4
slabs take ``grouped_wgmma_kernel`` (a persistent block an SM, wgmma fed by a
ring of query chunks and slab chunks, passes of up to 256 columns) wherever
its ring fits the block's shared memory, f32 slabs ``grouped_f32_kernel``
(``csrc/f32_tile.cuh``, full f32 FMA); the first design
(``grouped_gains_kernel``, one block a 64-column tile) takes what the ring
does not fit and stays reachable by name for the measurements.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from ragroute_tpu_torch.ops.fused_topk import SMEM_OPTIN, _sm_count
from ragroute_tpu_torch.ops.topk import unpack_int4

Tensor = torch.Tensor

GROUP_ROWS = 64          # pair rows per block (csrc/grouped_gains.cu TE)
_F32, _BF16, _I8, _INT4 = 0, 1, 2, 3      # csrc DocType
_DOC_TYPES = {torch.float32: _F32, torch.bfloat16: _BF16, torch.int8: _I8}
# grouped_wgmma_kernel (csrc/grouped_gains.cu GW_*): 64-deep contraction
# chunks, B tiles of 64 slab columns, at most 4 a pass (the widest wgmma,
# 256 columns), 2 to 8 ring stages; int8 / int4 also 2 to 8 staging slots
GW_K = 64
GW_COLS = 64
GW_MAX_TILES = 4
GW_MAX_STAGES = 8
GW_MAX_STAGING = 8
# grouped_f32_kernel: 128 slab columns a block, a ring of 3 stages of a
# [64 x 36] query chunk and a [32 x 128] slab chunk (f32)
GF_COLS = 128
GF_STAGES = 3
GF_STAGE_BYTES = (GROUP_ROWS * 36 + 32 * GF_COLS) * 4


def gw_stage_bytes(tiles: int) -> int:
    """One ring stage of the wgmma kernel: the 64 query rows' 64-deep chunk
    and ``tiles`` [64 x 64] slab tiles, bf16."""
    return GROUP_ROWS * 128 + tiles * GW_K * 128


def gw_staging_bytes(tiles: int) -> int:
    """One staging slot (int8 / int4): the query rows' pieces, the raw slab
    chunk (64 byte rows x 64 ``tiles``), the bias and scale columns."""
    return GROUP_ROWS * 128 + GW_K * GW_COLS * tiles + 2 * GW_COLS * tiles * 4


def gw_ahead(stages: int) -> int:
    """bf16: chunks a producer thread has in flight past the one it
    publishes, at most ``stages - 2`` (issuing chunk ``i + ahead`` waits for
    the stage the consumer frees once it is done with chunk ``i + ahead -
    stages + 1``, which must already be published). int8 / int4 copy into
    their staging ring instead, ``staging - 1`` chunks ahead."""
    return stages - 2


def gw_smem_bytes(tiles: int, stages: int, staging: int = 0) -> int:
    """Shared memory of the wgmma kernel (``gw_smem_bytes`` in the source):
    the ring, each stage's bias and scale columns, the staging ring (int8 /
    int4), the barriers, 1024 bytes of alignment."""
    return (stages * (gw_stage_bytes(tiles) + 2 * GW_COLS * tiles * 4)
            + staging * gw_staging_bytes(tiles) + 2 * stages * 8 + 1024)


def gw_rings(tiles: int, raw: bool, smem_optin: int = SMEM_OPTIN
             ) -> Tuple[int, int]:
    """``(stages, staging)`` of the wgmma kernel: bf16 the deepest ring that
    fits (its lookahead, ``stages - 2``, is the copies in flight); int8 /
    int4 the deepest staging ring (their copies in flight), then the
    deepest ring beside it; ``(0, 0)`` where nothing fits."""
    for staging in (range(GW_MAX_STAGING, 1, -1) if raw else (0,)):
        for stages in range(GW_MAX_STAGES, 1, -1):
            if gw_smem_bytes(tiles, stages, staging) <= smem_optin:
                return stages, staging
    return 0, 0


class Plan(NamedTuple):
    """How one call runs: ``kernel`` is ``"wgmma"``, ``"f32"`` or
    ``"first"``; ``grid`` blocks (the wgmma kernel's persistent ones, at
    most one an SM); ``stages`` of its ring and ``staging`` slots of its
    staging ring (int8 / int4); ``tiles`` slab tiles of 64 columns a pass
    and ``passes`` passes over S; ``smem`` bytes a block."""
    kernel: str
    grid: int
    stages: int
    tiles: int
    passes: int
    smem: int
    staging: int = 0


def _plan(g: int, d: int, s: int, doc_type: int, sms: int,
          kernel: Optional[str] = None,
          smem_optin: int = SMEM_OPTIN) -> Plan:
    """The launch for ``g`` pair blocks against slabs of depth ``d`` and
    ``s`` slots of ``doc_type`` (csrc DocType) on a card of ``sms`` SMs
    whose blocks may take ``smem_optin`` bytes of shared memory; a pure
    function of these. bf16, int8 and int4 slabs take the wgmma kernel with
    the rings of :func:`gw_rings`, or the first design where not even two
    stages fit; f32 slabs take the f32 kernel.
    ``kernel`` names one to plan for instead of choosing (the measurements
    time the kernels against each other); a kernel the shape does not fit
    raises."""
    if d < 16 or d % 16 or s < 8 or s % 8 or g < 1:
        raise ValueError(f"grouped_gains: the kernels need d % 16 == 0 and "
                         f"S % 8 == 0, got d={d}, S={s}, {g} blocks")
    tiles = min(GW_MAX_TILES, -(-s // GW_COLS))
    stages, staging = gw_rings(tiles, doc_type in (_I8, _INT4), smem_optin)
    if kernel is None:
        kernel = ("f32" if doc_type == _F32 else
                  "wgmma" if stages else "first")
    elif kernel == "wgmma" and (doc_type == _F32 or not stages):
        raise ValueError(f"grouped_gains: the wgmma kernel does not take "
                         f"doc type {doc_type} at S={s} under {smem_optin} "
                         f"bytes of shared memory")
    elif kernel == "f32" and doc_type != _F32:
        raise ValueError(f"grouped_gains: the f32 kernel does not take doc "
                         f"type {doc_type}")
    if kernel == "wgmma":
        passes = -(-s // (GW_COLS * tiles))
        return Plan("wgmma", min(g * passes, sms), stages, tiles, passes,
                    gw_smem_bytes(tiles, stages, staging), staging)
    if kernel == "f32":
        passes = -(-s // GF_COLS)
        return Plan("f32", g * passes, GF_STAGES, 0, passes,
                    GF_STAGES * GF_STAGE_BYTES)
    if kernel != "first":
        raise ValueError(f"grouped_gains: no kernel named {kernel!r}")
    passes = -(-s // 64)
    return Plan("first", g * passes, 0, 0, passes, 0)


def grouped_gains_reference(q: Tensor, docs: Tensor, bias: Tensor,
                            scale: Optional[Tensor], blk_cluster: Tensor,
                            packed4: bool = False,
                            rows: Optional[Tensor] = None,
                            chunk: int = 512) -> Tensor:
    """Plain version: f32 product of every block with its cluster's slab
    (operands upcast), then ``* scale + bias``. Returns ``[Ep, S]`` f32."""
    c, _, s = docs.shape
    if rows is not None:
        q = q[rows.long()]
    ep, d = q.shape
    g = ep // GROUP_ROWS
    cl_all = blk_cluster.long().clamp(0, c - 1)
    qb = q.reshape(g, GROUP_ROWS, d)
    out = torch.empty((g, GROUP_ROWS, s), dtype=torch.float32,
                      device=docs.device)
    for g0 in range(0, g, chunk):        # bounds the gathered f32 slabs
        cl = cl_all[g0:g0 + chunk]
        slabs = docs[cl]                                 # [g, ds, S]
        if packed4:
            slabs = unpack_int4(slabs, dim=1)            # [g, d, S]
        gains = torch.bmm(qb[g0:g0 + chunk].to(torch.float32),
                          slabs.to(torch.float32))       # [g, 64, S]
        if scale is not None:
            gains = gains * scale[cl][:, None, :]
        out[g0:g0 + chunk] = gains + bias[cl][:, None, :]
    return out.reshape(ep, s)


def _lib():
    from ragroute_tpu_torch.ops import _build

    lib, _ = _build.load("grouped_gains")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.grouped_gains_launch.argtypes = [vp] * 8 + [ci] * 5 + [vp]
        lib.grouped_gains_launch.restype = ci
        lib.grouped_gains_wgmma_launch.argtypes = ([vp] * 8 + [ci] * 8
                                                   + [vp])
        lib.grouped_gains_wgmma_launch.restype = ci
        lib.grouped_gains_f32_launch.argtypes = [vp] * 8 + [ci] * 5 + [vp]
        lib.grouped_gains_f32_launch.restype = ci
        lib._argtypes_set = True
    return lib


def grouped_gains(q: Tensor, docs: Tensor, bias: Tensor,
                  scale: Optional[Tensor], blk_cluster: Tensor,
                  packed4: bool = False, *, rows: Optional[Tensor] = None,
                  n_real: Optional[Tensor] = None,
                  kernel: Optional[str] = None) -> Tensor:
    """Dense gains ``[Ep, S]`` f32 for cluster-aligned pair blocks.

    ``q``: ``[Ep, d]`` pair rows, or ``[B, d]`` queries with ``rows [Ep]``
    i32; f32 for f32 slabs, bf16 for bf16 / int8 / int4 slabs.
    ``blk_cluster [G]`` i32 with ``G = Ep / 64``. See the module docstring
    for ``rows`` and ``n_real``; ``kernel`` names the launch in place of
    :func:`_plan`'s choice (the measurements)."""
    g = blk_cluster.shape[0]
    ep = g * GROUP_ROWS
    c, ds, s = docs.shape
    d = q.shape[1]
    if (rows.shape[0] if rows is not None else q.shape[0]) != ep:
        raise ValueError(f"grouped_gains: {g} blocks need {ep} pair rows")
    if ds != (d // 2 if packed4 else d):
        raise ValueError(f"grouped_gains: slab depth {ds} does not match "
                         f"d={d} (packed4={packed4})")
    if not docs.is_cuda:
        return grouped_gains_reference(q, docs, bias, scale, blk_cluster,
                                       packed4, rows)
    dev = docs.device
    if docs.dtype not in _DOC_TYPES or (packed4 and docs.dtype != torch.int8):
        raise TypeError(f"grouped_gains: slab dtype {docs.dtype} not "
                        "supported by the kernel")
    want_q = torch.float32 if docs.dtype == torch.float32 else torch.bfloat16
    if q.dtype != want_q:
        raise TypeError(f"grouped_gains: q must be {want_q} for "
                        f"{docs.dtype} slabs, got {q.dtype}")
    if d % 16 or s % 8 or s < 8:
        raise ValueError(f"grouped_gains: kernel needs d % 16 == 0 and "
                         f"S % 8 == 0, got d={d}, S={s}")
    ints = (("blk_cluster", blk_cluster, (g,)), ("rows", rows, (ep,)),
            ("n_real", n_real, None))
    for name, t, shape in ints:
        if t is not None and (t.dtype != torch.int32 or t.device != dev
                              or not t.is_contiguous()
                              or (shape is not None
                                  and tuple(t.shape) != shape)):
            raise ValueError(f"grouped_gains: {name} must be a contiguous "
                             f"int32 tensor on {dev}")
    for name, t in (("bias", bias), ("scale", scale)):
        if t is not None and (t.dtype != torch.float32 or t.device != dev
                              or tuple(t.shape) != (c, s)
                              or not t.is_contiguous()):
            raise ValueError(f"grouped_gains: {name} must be a contiguous "
                             f"[C, S] float32 tensor on {dev}")
    if q.device != dev or not docs.is_contiguous() or docs.data_ptr() % 16:
        raise ValueError("grouped_gains: q and docs must be on one device, "
                         "docs contiguous and 16-byte aligned")
    q = q.contiguous()
    if q.data_ptr() % 16:        # 16-byte copies of the query rows
        q = q.clone()
    doc_type = _INT4 if packed4 else _DOC_TYPES[docs.dtype]
    plan = _plan(g, d, s, doc_type, _sm_count(dev), kernel)
    out = torch.empty((ep, s), dtype=torch.float32, device=dev)
    ptrs = (q.data_ptr(), docs.data_ptr(), bias.data_ptr(),
            None if scale is None else scale.data_ptr(),
            blk_cluster.data_ptr(), None if rows is None else rows.data_ptr(),
            None if n_real is None else n_real.data_ptr(), out.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _lib()
    if plan.kernel == "wgmma":
        err = lib.grouped_gains_wgmma_launch(*ptrs, g, c, d, s, doc_type,
                                             plan.grid, plan.stages,
                                             plan.staging, stream)
    elif plan.kernel == "f32":
        err = lib.grouped_gains_f32_launch(*ptrs, g, c, d, s, plan.stages,
                                           stream)
    else:
        err = lib.grouped_gains_launch(*ptrs, g, c, d, s, doc_type, stream)
    if err != 0:
        raise RuntimeError(f"grouped_gains {plan.kernel} launch failed for "
                           f"{g} blocks over slabs {tuple(docs.shape)} "
                           f"{docs.dtype}: CUDA error {err}")
    grouped_gains.launches += 1
    grouped_gains.wgmma_launches += plan.kernel == "wgmma"
    grouped_gains.f32_launches += plan.kernel == "f32"
    return out


grouped_gains.launches = 0   # kernel launches since the count was last reset
grouped_gains.wgmma_launches = 0   # of which grouped_wgmma_kernel
grouped_gains.f32_launches = 0     # of which grouped_f32_kernel
