"""The mean share of the plain reference's top-k, under the same routing,
that the served top-k holds, over the checked queries."""


def read(ctx):
    return ctx.check.get("recall")
