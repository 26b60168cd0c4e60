"""Peaks of one NVIDIA H100 SXM and the least time of a kernel's work.

A frozen copy of the port's arithmetic (``ops/kernel_checks.py``:
``HBM_BYTES_PER_S``, ``PEAK_FLOPS``, ``_bound``, ``k1_bound``,
``k3_bound``), counted from what the work needs: the queries a source is
routed, never the rows a launch pads to. Published data-sheet peaks, dense,
at the 700 W limit; int8 and int4 codes are multiplied as bf16 by the
port's kernels, so they take the bf16 peak.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 989e12,
              "int4": 989e12}
ROW_BYTES = {"float32": 4.0, "bfloat16": 2.0, "int8": 1.0, "int4": 0.5}


def bound_s(nbytes: float, flops: float, peak: float) -> float:
    """The larger of bytes at the HBM rate and operations at the peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / peak)


def k1_bound_s(rows: int, n: int, d: int, k: int, dtype: str) -> float:
    """One fused top-k over a flat shard: the query rows, the shard's rows,
    bias (and scale where quantized) read once, the lists written once,
    against ``2 * rows * n * d`` operations."""
    if rows <= 0:
        return 0.0
    q_bytes = 4 if dtype == "float32" else 2
    per_doc = 4 + (4 if dtype in ("int8", "int4") else 0)
    nbytes = rows * d * q_bytes + n * (d * ROW_BYTES[dtype] + per_doc) \
        + rows * k * 12
    return bound_s(nbytes, 2.0 * rows * n * d, PEAK_FLOPS[dtype])


def k3_bound_s(rows: int, probes: int, clusters: int, slots: int, d: int,
               dtype: str) -> float:
    """The grouped gains over a balanced-IVF shard: each routed query
    against ``probes`` cluster slabs of ``slots`` rows. The queries, the
    slab, bias (and scale) of each probed cluster once (at most every
    cluster), the gains written once; ``2 * pairs * d * slots``
    operations."""
    pairs = rows * probes
    if pairs <= 0:
        return 0.0
    q_bytes = 4 if dtype == "float32" else 2
    per_cluster = d * slots * ROW_BYTES[dtype] + slots * 4 * (
        2 if dtype in ("int8", "int4") else 1)
    nbytes = (rows * d * q_bytes + min(clusters, pairs) * per_cluster
              + pairs * slots * 4)
    return bound_s(nbytes, 2.0 * pairs * d * slots, PEAK_FLOPS[dtype])
