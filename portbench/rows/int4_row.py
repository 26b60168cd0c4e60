"""Rows as int4 codes with one scale a row (largest magnitude over 7):
the int8 configurations' control, a step below int8."""

from portbench.rows import symmetric

LOSSY = True


def encode(x):
    return symmetric.encode(x, 7)
