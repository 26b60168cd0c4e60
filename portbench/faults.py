"""Faults planted in the program, for the readings a limit is set from and
for the harness's tests: each a context manager under which the program
runs with the fault."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def half_probes():
    """The IVF search probes half the clusters it should: its answers are
    the wrong docs with their true scores."""
    from ragroute_tpu_torch.engine import engine

    saved = engine.IVF_NPROBE_DIVISOR
    engine.IVF_NPROBE_DIVISOR = 2 * saved
    try:
        yield
    finally:
        engine.IVF_NPROBE_DIVISOR = saved


FAULTS = {"half_probes": half_probes}
