"""One reader a metric, found by the metric's name in ``BENCHMARK.json``
before its first dot: ``qps.ivf`` is the quantity ``qps.py`` reads, named
apart for cells whose runs spread more and so take a bound of their own.

Each module has ``read(ctx) -> float | None``. ``ctx`` (``portbench.run.
Context``) carries the cell's configuration and traffic, the layout facts
of the built program, the measured window's batches, the traced window's
batches and reduced trace (``--trace 1`` only), the set-up time and the
check's numbers. A reader that finds nothing to read returns ``None`` and
the metric is left out of the result's line.
"""
