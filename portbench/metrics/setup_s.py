"""Seconds from the start of the process to the first timed batch: the
world made from the seed, the program's build and layouts, kernel builds
where a checkout has none yet, and the warm-up of every batch shape."""


def read(ctx):
    return ctx.setup_s
