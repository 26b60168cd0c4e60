"""K3 (``csrc/grouped_gains.cu``, via ``ops/grouped_gains.py``): the least
time of the traced window's grouped gains over K3's device time. Each
source's call is counted from the queries routed to it times its probes
(``portbench.roofline.k3_bound_s``), not from padded blocks."""

from portbench.roofline import k3_bound_s

KERNELS = ("grouped_wgmma_kernel", "grouped_gains_kernel",
           "grouped_f32_kernel")


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    device_s = t.seconds_of(KERNELS)
    if device_s <= 0:
        return None
    least = 0.0
    for b in ctx.traced.batches:
        for name, routed in b.routed.items():
            s = ctx.shapes[name]
            if "probes" in s:
                least += k3_bound_s(routed, s["probes"], s["clusters"],
                                    s["slots"], s["d"], s["dtype"])
    return 100.0 * least / device_s
