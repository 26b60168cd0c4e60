"""Queries completed over the measured window's seconds, every batch from
the first launch to the last answer."""


def read(ctx):
    w = ctx.window
    return w.queries / w.seconds
