"""The routed scan's useful operations over the measured window, against
the card's dense bf16 peak: for each completed query, 2 x d x the docs of
every source its routing picked, whatever computes them. Only for exact
scans, where that count is the work done."""

from portbench.roofline import PEAK_FLOPS


def read(ctx):
    w = ctx.window
    flops = 0.0
    for b in w.batches:
        for name, routed in b.routed.items():
            s = ctx.shapes[name]
            flops += 2.0 * routed * s["d"] * s["n"]
    return 100.0 * flops / (w.seconds * PEAK_FLOPS["bfloat16"])
