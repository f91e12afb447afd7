"""``peak_mem_gib`` in the PS cells, read the same way (``metrics/peak_mem_gib.py``);
a name of its own so that it moves ``samples_per_s.ps``, the PS cells'
throughput under a bound of its own."""

from portbench.metrics.peak_mem_gib import read  # noqa: F401
