"""Rows kept in f32, as given."""

LOSSY = False


def encode(x):
    return x, None
