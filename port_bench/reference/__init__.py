"""Plain references that decide a run's ``correct``.

Plain PyTorch, numpy and scipy only: nothing here imports ``jax``, the
JAX package or anything of the port. The references work out again
everything the port derives (the padded cube, the multilooked cube, the
decision thresholds) from the inputs the benchmark made.
"""
