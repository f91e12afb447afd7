"""Metric snapshot + Prometheus text exposition.

Two registries feed one exposition:

- the C core's lock-free registry (per-stage counters / gauges /
  fixed-bucket latency histograms, instrumented in worker.cc, server.cc,
  van.cc — see csrc/metrics.h), read in one call via
  ``bps_metrics_snapshot`` together with the live node state that used
  to be three ad-hoc C APIs (van wire bytes, async staleness, scheduler
  dead nodes) and the scheduled-queue occupancy;
- a small Python-side registry (``set_gauge`` / ``inc_counter`` /
  ``observe_histo``) for step-level metrics recorded by training
  callbacks — kept in Python so float values (examples/sec) survive and
  so the monitor endpoint still serves when the C core is idle.

Exposition follows the Prometheus text format (v0.0.4): counters end in
``_total``, histograms expose cumulative ``_bucket{le=...}`` series plus
``_sum``/``_count``. Durations are microseconds, carried in the metric
name (``*_us``) rather than rescaled — operators grep the same unit the
timeline shows.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

_ROLE_NAMES = {0: "scheduler", 1: "server", 2: "worker", 3: "replica"}

_py_lock = threading.Lock()
_py_counters: Dict[str, float] = {}
_py_gauges: Dict[str, float] = {}
_py_histos: Dict[str, Dict[str, float]] = {}  # name -> {sum, count}


def inc_counter(name: str, delta: float = 1.0) -> None:
    with _py_lock:
        _py_counters[name] = _py_counters.get(name, 0.0) + delta


def set_gauge(name: str, value: float) -> None:
    with _py_lock:
        _py_gauges[name] = float(value)


def observe_histo(name: str, value: float) -> None:
    """Python-side sum/count observation (no buckets — bucketed latency
    histograms live in the C registry; use ffi.metrics_observe for
    those)."""
    with _py_lock:
        h = _py_histos.setdefault(name, {"sum": 0.0, "count": 0.0})
        h["sum"] += float(value)
        h["count"] += 1.0


def snapshot() -> dict:
    """Combined telemetry snapshot: the C core's registry + node state,
    with the Python-side registry merged under ``py_counters`` /
    ``py_gauges`` / ``py_histograms``."""
    from byteps_tpu_torch.core.ffi import metrics_snapshot
    snap = metrics_snapshot()
    with _py_lock:
        snap["py_counters"] = dict(_py_counters)
        snap["py_gauges"] = dict(_py_gauges)
        snap["py_histograms"] = {k: dict(v) for k, v in _py_histos.items()}
    return snap


def _fmt(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def prometheus_text(snap: Optional[dict] = None) -> str:
    """Render a snapshot dict as Prometheus text exposition."""
    if snap is None:
        snap = snapshot()
    lines: List[str] = []

    def scalar(name: str, kind: str, value, labels: str = "") -> None:
        lines.append(f"# TYPE {name} {kind}")
        lines.append(f"{name}{labels} {_fmt(value)}")

    node = snap.get("node", {})
    role = _ROLE_NAMES.get(node.get("role", -1), "none")
    scalar("bps_up", "gauge", 1 if node.get("inited") else 0,
           f'{{role="{role}",node_id="{node.get("id", -1)}"}}')

    for name, v in sorted(snap.get("counters", {}).items()):
        scalar(name, "counter", v)
    for name, v in sorted(snap.get("gauges", {}).items()):
        scalar(name, "gauge", v)
    for name, h in sorted(snap.get("histograms", {}).items()):
        lines.append(f"# TYPE {name} histogram")
        cum = 0
        for bound, count in zip(h["bounds_us"], h["buckets"]):
            cum += count
            lines.append(f'{name}_bucket{{le="{bound}"}} {cum}')
        cum += h["buckets"][-1]
        lines.append(f'{name}_bucket{{le="+Inf"}} {cum}')
        lines.append(f"{name}_sum {h['sum']}")
        lines.append(f"{name}_count {h['count']}")

    van = snap.get("van", {})
    scalar("bps_van_sent_bytes_total", "counter", van.get("sent_bytes", 0))
    scalar("bps_van_recv_bytes_total", "counter", van.get("recv_bytes", 0))

    stale = snap.get("staleness", {})
    scalar("bps_async_staleness_mean", "gauge", stale.get("mean", 0))
    scalar("bps_async_staleness_max", "gauge", stale.get("max", 0))
    scalar("bps_async_staleness_samples", "gauge", stale.get("samples", 0))

    queue = snap.get("queue", {})
    scalar("bps_queue_pending", "gauge", queue.get("pending", 0))
    scalar("bps_queue_inflight_bytes", "gauge",
           queue.get("inflight_bytes", 0))
    scalar("bps_queue_credit_budget_bytes", "gauge",
           queue.get("credit_budget_bytes", 0))

    # Multi-tenant series: one labeled sample per tenant from
    # the accounting registry + the address-book roster (scheduler).
    tenants = snap.get("tenants", {}) or {}
    stats = tenants.get("stats", {}) or {}
    if stats:
        for metric, kind in (("bps_tenant_push_bytes_total", "counter"),
                             ("bps_tenant_reply_bytes_total", "counter"),
                             ("bps_tenant_ops_total", "counter"),
                             ("bps_tenant_sum_us_total", "counter"),
                             ("bps_tenant_dispatched_total", "counter"),
                             ("bps_tenant_queue_depth", "gauge"),
                             ("bps_tenant_starve_us", "gauge")):
            field = metric.replace("bps_tenant_", "").replace("_total",
                                                              "")
            field = {"push_bytes": "push_bytes",
                     "reply_bytes": "reply_bytes", "ops": "ops",
                     "sum_us": "sum_us", "dispatched": "dispatched",
                     "queue_depth": "queue_depth",
                     "starve_us": "starve_us"}[field]
            lines.append(f"# TYPE {metric} {kind}")
            for tid in sorted(stats, key=int):
                lines.append(
                    f'{metric}{{tenant="{tid}"}} '
                    f'{_fmt(stats[tid].get(field, 0))}')
    roster = tenants.get("roster", {}) or {}
    if roster:
        for metric, field in (("bps_tenant_workers", "workers"),
                              ("bps_tenant_weight", "weight")):
            lines.append(f"# TYPE {metric} gauge")
            for tid in sorted(roster, key=int):
                lines.append(f'{metric}{{tenant="{tid}"}} '
                             f'{_fmt(roster[tid].get(field, 0))}')

    ages = snap.get("heartbeat_age_ms", {})
    if ages:
        lines.append("# TYPE bps_heartbeat_age_ms gauge")
        for nid, age in sorted(ages.items(), key=lambda kv: int(kv[0])):
            lines.append(f'bps_heartbeat_age_ms{{node="{nid}"}} {_fmt(age)}')
    dead = snap.get("dead_nodes", [])
    scalar("bps_dead_nodes", "gauge", len(dead))
    if dead:
        lines.append("# TYPE bps_node_dead gauge")
        for nid in dead:
            lines.append(f'bps_node_dead{{node="{nid}"}} 1')

    for name, v in sorted(snap.get("py_counters", {}).items()):
        scalar(name, "counter", v)
    for name, v in sorted(snap.get("py_gauges", {}).items()):
        scalar(name, "gauge", v)
    for name, h in sorted(snap.get("py_histograms", {}).items()):
        scalar(f"{name}_sum", "gauge", h["sum"])
        scalar(f"{name}_count", "gauge", h["count"])

    return "\n".join(lines) + "\n"


def parse_prometheus(text: str
                     ) -> Dict[str, Dict[Tuple[Tuple[str, str], ...], float]]:
    """Parse Prometheus text exposition into
    ``{metric: {((label, value), ...): sample}}`` (empty tuple for
    unlabelled samples). Strict about line shape — the monitor tests use
    this as the 'Prometheus-parseable' oracle; a malformed line raises."""
    out: Dict[str, Dict[Tuple[Tuple[str, str], ...], float]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name_part, _, value_part = line.rpartition(" ")
        if not name_part:
            raise ValueError(f"malformed exposition line: {line!r}")
        value = float(value_part)  # raises on garbage
        labels: Tuple[Tuple[str, str], ...] = ()
        name = name_part
        if "{" in name_part:
            if not name_part.endswith("}"):
                raise ValueError(f"malformed labels: {line!r}")
            name, _, lbl = name_part[:-1].partition("{")
            pairs = []
            for item in lbl.split(","):
                k, _, v = item.partition("=")
                if not (v.startswith('"') and v.endswith('"')):
                    raise ValueError(f"malformed label value: {line!r}")
                pairs.append((k, v[1:-1]))
            labels = tuple(pairs)
        if not name or not name[0].isalpha():
            raise ValueError(f"malformed metric name: {line!r}")
        out.setdefault(name, {})[labels] = value
    return out
