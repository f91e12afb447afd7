"""``mfu`` in the PS cells, read the same way (``metrics/mfu.py``);
a name of its own so that it moves ``samples_per_s.ps``, the PS cells'
throughput under a bound of its own."""

from portbench.metrics.mfu import read  # noqa: F401
