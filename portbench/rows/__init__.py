"""Stored forms of document rows, one module a form, found by name.

Each module gives ``LOSSY`` (rows of a lossy form are stored mean-centred
for dot and l2 scores, as the port stores them) and ``encode(x)``: f32 rows
``[n, d]`` in, ``(mat [n, d] f32, scale [n] f32 or None)`` out, such that a
query's gain on row i is ``(q . mat[i]) * scale[i]``. The plain reference
reads the configuration's form; its control reads the form one step below.
"""
