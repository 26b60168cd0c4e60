"""The 95th percentile of every batch's time in the measured window, from
its launch (``search_submit``) to the end of its ``wait()``: with batches
in flight, the wait behind the batch ahead is part of it."""

import statistics


def read(ctx):
    ms = [1e3 * (b.done - b.launch) for b in ctx.window.batches]
    if len(ms) < 20:
        return None
    return statistics.quantiles(ms, n=20, method="inclusive")[18]
