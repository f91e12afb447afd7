"""The benchmark of ``byteps_tpu_torch``, the port: one command runs one
cell once (``portbench/run.py``). Every cell, configuration, traffic mix,
limit and per-layer metric is a file found by the name ``BENCHMARK.json``
gives it."""
