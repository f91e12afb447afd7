"""byteps_tpu_torch.monitor — live metrics, health, and straggler detection.

New scope (no reference equivalent): the reference's only runtime
observability is the post-hoc Chrome-trace timeline (``BYTEPS_TRACE_*``,
docs/timeline.md). This package is the *live* counterpart — the signal
you need while the job runs to tune partition size, credits, and
compression, and to spot sick nodes before they stall the fleet:

- ``metrics``  — snapshot of the C core's lock-free metric registry
  (per-stage counters/gauges/latency histograms + van wire bytes, async
  staleness, queue occupancy, scheduler heartbeat ages) plus a small
  Python-side registry for step-level metrics, and Prometheus text
  exposition over both.
- ``http``     — per-role background HTTP endpoint (``/metrics``,
  ``/healthz``), started automatically by every node when
  ``BYTEPS_MONITOR_ON=1`` on ``BYTEPS_MONITOR_PORT + node_id``.
- ``top``      — ``python -m byteps_tpu_torch.monitor.top``: scrape every role
  endpoint, compute per-worker push-latency skew, flag stragglers and
  dead/stale heartbeats.
- ``insight``  — ``python -m byteps_tpu_torch.monitor.insight``: live
  per-round bottleneck attribution from the scheduler's fleet round
  table (``/rounds``): names the dominant stage, classifies the fleet
  state (wire-bound / sum-bound / straggler-skewed / retry-degraded /
  healthy), flags EWMA regressions, and emits advisory tuning hints.

See docs/monitoring.md for the endpoint layout, metric catalog, and
straggler thresholds.
"""

from byteps_tpu_torch.monitor.metrics import (  # noqa: F401
    inc_counter,
    observe_histo,
    parse_prometheus,
    prometheus_text,
    set_gauge,
    snapshot,
)
from byteps_tpu_torch.monitor.http import (  # noqa: F401
    MonitorServer,
    maybe_start_monitor,
)
