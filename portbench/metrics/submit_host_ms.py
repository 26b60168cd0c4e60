"""Host milliseconds in ``search_submit`` (router and score launches, the
routed-count read), the mean over the measured window's batches."""


def read(ctx):
    b = ctx.window.batches
    return 1e3 * sum(x.launched - x.launch for x in b) / len(b) if b else None
