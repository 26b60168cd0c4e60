"""K1 (``csrc/fused_topk.cu``, via ``ops/fused_topk.py``): the least time of
the traced window's scans over K1's device time. Each source's scan is
counted from the queries routed to it (``portbench.roofline.k1_bound_s``),
not from the rows a launch pads to.

K1's device time is every launch of K1's launcher: the scans and
``merge_splits_kernel`` (``csrc/topk_merge.cuh``), which merges a scan's
split lists. K2's launcher (``csrc/stream_topk.cu``) launches that merge
too, so a cell that runs K2 beside K1 cannot tell the two apart by name: the
cells this metric names run no K2."""

from portbench.roofline import k1_bound_s

KERNELS = ("wgmma_topk_kernel", "partial_topk_kernel", "f32_topk_kernel",
           "f32_small_kernel", "chunk_gains_kernel", "merge_splits_kernel")


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    device_s = t.seconds_of(KERNELS)
    if device_s <= 0:
        return None
    k = ctx.cfg["world"]["k"]
    least = 0.0
    for b in ctx.traced.batches:
        for name, routed in b.routed.items():
            s = ctx.shapes[name]
            least += k1_bound_s(routed, s["n"], s["d"], k, s["dtype"])
    return 100.0 * least / device_s
