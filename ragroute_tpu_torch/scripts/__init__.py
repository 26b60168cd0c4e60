"""The port's offline entry points, each run as
``python -m ragroute_tpu_torch.scripts.<name>``: ``make_synthetic_data``,
``train_router``, ``eval_recall``, ``import_real_data`` and
``profile_http``. Each takes its JAX twin's flags (``scripts/<name>.py``)
plus ``--device`` (default ``cuda``)."""
