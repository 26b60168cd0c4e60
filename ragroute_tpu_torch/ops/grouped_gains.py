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
on a CPU tensor it runs :func:`grouped_gains_reference`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ragroute_tpu_torch.ops.topk import unpack_int4

Tensor = torch.Tensor

GROUP_ROWS = 64          # pair rows per block (csrc/grouped_gains.cu TE)
_DOC_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_INT4 = 3


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
        lib._argtypes_set = True
    return lib


def grouped_gains(q: Tensor, docs: Tensor, bias: Tensor,
                  scale: Optional[Tensor], blk_cluster: Tensor,
                  packed4: bool = False, *, rows: Optional[Tensor] = None,
                  n_real: Optional[Tensor] = None) -> Tensor:
    """Dense gains ``[Ep, S]`` f32 for cluster-aligned pair blocks.

    ``q``: ``[Ep, d]`` pair rows, or ``[B, d]`` queries with ``rows [Ep]``
    i32; f32 for f32 slabs, bf16 for bf16 / int8 / int4 slabs.
    ``blk_cluster [G]`` i32 with ``G = Ep / 64``. See the module docstring
    for ``rows`` and ``n_real``."""
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
    out = torch.empty((ep, s), dtype=torch.float32, device=dev)
    err = _lib().grouped_gains_launch(
        q.data_ptr(), docs.data_ptr(), bias.data_ptr(),
        None if scale is None else scale.data_ptr(), blk_cluster.data_ptr(),
        None if rows is None else rows.data_ptr(),
        None if n_real is None else n_real.data_ptr(), out.data_ptr(),
        g, c, d, s, _INT4 if packed4 else _DOC_TYPES[docs.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"grouped_gains kernel launch failed: CUDA error "
                           f"{err}")
    grouped_gains.launches += 1
    return out


grouped_gains.launches = 0   # kernel launches since the count was last reset
