"""The general code of the port's benchmark: it reads ``BENCHMARK.json``
and the files it names, makes the traffic, drives the cell, reads the
trace and judges the outputs. Whatever belongs to one configuration,
traffic mix, stage or metric lives in a file of its own, found by name
(``configs/``, ``generators/``, ``traffic/``, ``workloads/``,
``stages/``, ``metrics/``, ``roofline/``), so a new cell needs new files
only."""
