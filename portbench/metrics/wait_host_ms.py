"""Host milliseconds in ``wait()`` (the wait for the step, the one result
copy and its unpacking), the mean over the measured window's batches."""


def read(ctx):
    b = ctx.window.batches
    return 1e3 * sum(x.done - x.waiting for x in b) / len(b) if b else None
