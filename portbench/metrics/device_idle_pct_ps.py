"""``device_idle_pct`` in the PS cells, read the same way (``metrics/device_idle_pct.py``);
a name of its own so that it moves ``samples_per_s.ps``, the PS cells'
throughput under a bound of its own."""

from portbench.metrics.device_idle_pct import read  # noqa: F401
