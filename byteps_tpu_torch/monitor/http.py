"""Background-thread HTTP endpoint serving /metrics and /healthz.

Every role (worker, server, scheduler) starts one automatically when
``BYTEPS_MONITOR_ON=1``; the port is ``BYTEPS_MONITOR_PORT + node_id``
(scheduler 0, servers 1..S, workers S+1..S+W — postoffice.h id layout),
so one env var covers a co-located fleet and ``monitor.top`` can derive
every endpoint from the topology alone.

The endpoint must never take the job down: bind failures log a warning
and disable monitoring for this process; request handling errors return
500 to the scraper and nothing to the training loop.
"""

from __future__ import annotations

import http.server
import json
import threading
import time
from typing import Optional

from byteps_tpu_torch.monitor import metrics as _metrics


class _Handler(http.server.BaseHTTPRequestHandler):
    server_version = "byteps-monitor/1.0"

    def do_GET(self):  # noqa: N802 (http.server API)
        try:
            if self.path.split("?")[0] == "/metrics":
                body = _metrics.prometheus_text().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
                code = 200
            elif self.path.split("?")[0] == "/rounds":
                # Per-round introspection snapshot: this
                # rank's round ring; on the scheduler, also the fleet
                # round table + per-rank EWMA baselines ingested from
                # heartbeat summaries. `python -m
                # byteps_tpu_torch.monitor.insight --watch` polls this.
                # Elastic membership context rides along so
                # the insight classifier can call an epoch-change round
                # `resizing` instead of misreading it as skew.
                from byteps_tpu_torch.core.ffi import round_summary
                doc = round_summary()
                gauges = _metrics.snapshot().get("gauges", {})
                doc["epoch"] = int(gauges.get("bps_membership_epoch", 0))
                doc["resizing"] = int(gauges.get("bps_fleet_resizing", 0))
                doc["fleet_workers"] = int(
                    gauges.get("bps_fleet_workers", 0))
                body = json.dumps(doc).encode()
                ctype = "application/json"
                code = 200
            elif self.path.split("?")[0] == "/tenants":
                # Multi-tenant snapshot: this role's tenant
                # identity, per-tenant accounting (servers: bytes /
                # ops / engine queue depth / DRR dispatch), and the
                # address-book roster. `starved` applies the
                # BYTEPS_TENANT_STARVE_MS threshold (default 2000) to
                # the raw starvation age the C side reports.
                import os as _os

                from byteps_tpu_torch.core.ffi import tenant_summary
                doc = tenant_summary()
                starve_ms = float(
                    _os.environ.get("BYTEPS_TENANT_STARVE_MS", "2000")
                    or 2000)
                for st in (doc.get("stats", {}) or {}).values():
                    st["starved"] = (
                        st.get("starve_us", 0) / 1000.0 > starve_ms)
                body = json.dumps(doc).encode()
                ctype = "application/json"
                code = 200
            elif self.path.split("?")[0] == "/events":
                # Fleet event journal: this rank's local
                # lifecycle-event ring; on the scheduler, also the
                # clock-aligned fleet timeline and per-gauge history
                # rings. `python -m byteps_tpu_torch.monitor.incident` reads
                # this to render a post-mortem; monitor.top's ticker
                # tails it.
                from byteps_tpu_torch.core.ffi import events_summary
                body = json.dumps(events_summary()).encode()
                ctype = "application/json"
                code = 200
            elif self.path.split("?")[0] == "/healthz":
                snap = _metrics.snapshot()
                dead = snap.get("dead_nodes", [])
                node = snap.get("node", {})
                counters = snap.get("counters", {})
                gauges = snap.get("gauges", {})
                # RECOVERING covers both flavours: a server rank being
                # hot-replaced (bps_recovering), a restarted scheduler
                # collecting its re-registration quorum
                # (bps_sched_recovering), and a node parked on a lost
                # scheduler (bps_sched_lost).
                recovering = bool(gauges.get("bps_recovering", 0)
                                  or gauges.get("bps_sched_recovering", 0)
                                  or gauges.get("bps_sched_lost", 0))
                healthy = bool(node.get("inited")) and not dead
                # Fleet state: RECOVERING while a server rank is being
                # hot-replaced (healthy-but-paused, NOT degraded — the
                # scheduler is coordinating; 200 so orchestrators don't
                # kill a fleet that is saving itself).
                state = ("RECOVERING" if recovering
                         else "OK" if healthy else "DEGRADED")
                body = {
                    "status": "ok" if healthy else "degraded",
                    "state": state,
                    "inited": bool(node.get("inited")),
                    "role": node.get("role"),
                    "node_id": node.get("id"),
                    "dead_nodes": dead,
                    # Transient-fault telemetry (docs/troubleshooting.md
                    # failure model): a climbing retry/reconnect rate is
                    # the early-warning signal BEFORE a node goes dead.
                    "retries": int(counters.get("bps_retries_total", 0)),
                    "reconnects": int(
                        counters.get("bps_reconnects_total", 0)),
                    # Wire integrity: sequence-cursor frame
                    # accounting (gaps = frames lost between stamping
                    # and this receiver, dups = duplicate deliveries)
                    # plus the CRC data plane — failed verifications,
                    # quarantine trips (flaky-link force-re-dials), and
                    # the persistently-corrupting-link flag that
                    # precedes the named fail-stop.
                    "seq_gaps": int(
                        counters.get("bps_seq_gaps_total", 0)),
                    "seq_dups": int(
                        counters.get("bps_seq_dups_total", 0)),
                    "crc_fails": int(
                        counters.get("bps_crc_fail_total", 0)),
                    "crc_quarantines": int(
                        counters.get("bps_crc_quarantine_total", 0)),
                    "corrupting": bool(
                        gauges.get("bps_link_corrupting", 0)),
                    # Hot-replacement telemetry: completed recoveries and
                    # the fleet membership epoch (bumped per recovery).
                    "recoveries": int(
                        counters.get("bps_recoveries_total", 0)),
                    "epoch": int(gauges.get("bps_membership_epoch", 0)),
                    # Elastic membership: LIVE worker count
                    # (the node section tracks joins/leaves/shrinks)
                    # plus the scheduler's change-in-flight flag.
                    "workers": int(node.get("num_workers", 0)),
                    "resizing": bool(
                        gauges.get("bps_fleet_resizing", 0)),
                    "joins": int(
                        counters.get("bps_worker_joins_total", 0)),
                    "leaves": int(
                        counters.get("bps_worker_leaves_total", 0)),
                    # Scheduler fail-over: parked flag on
                    # every role; the restarted scheduler additionally
                    # reports its re-registration progress so an
                    # operator can see `reregistered/expected` converge
                    # toward quorum during the outage.
                    "sched_lost": bool(gauges.get("bps_sched_lost", 0)),
                    "sched_recovering": bool(
                        gauges.get("bps_sched_recovering", 0)),
                    "sched_recoveries": int(
                        counters.get("bps_sched_recoveries_total", 0)),
                    "reregistered": int(
                        gauges.get("bps_sched_rereg", 0)),
                    "expected": int(
                        gauges.get("bps_sched_rereg_expected", 0)),
                    # Versioned snapshot serving: the
                    # committed cut this node serves, its lag behind
                    # the primary (replicas; 0 on a primary), and read
                    # traffic. -1 snapshot_version = nothing committed
                    # yet (or serving disabled).
                    "snapshot_version": int(
                        gauges.get("bps_snapshot_version", -1)),
                    "replica_lag_rounds": int(
                        gauges.get("bps_replica_lag_rounds", 0)),
                    "snap_pulls": int(
                        counters.get("bps_snap_pulls_total", 0)),
                    "uptime_s": round(
                        time.monotonic() - self.server.started_at, 3),
                }
                if "bps_ckpt_version" in gauges:
                    # Durable checkpoints: only present when
                    # the writer is armed (BYTEPS_CKPT_DIR) — an unarmed
                    # fleet's health document stays byte-identical to
                    # the pre-checkpoint one. lag_rounds is the distance
                    # between the newest committed snapshot and the
                    # newest sealed spill: a climbing lag means the disk
                    # can't keep up and a crash now loses that many
                    # rounds.
                    body.update({
                        "ckpt_version": int(
                            gauges.get("bps_ckpt_version", -1)),
                        "ckpt_lag_rounds": int(
                            gauges.get("bps_ckpt_lag_rounds", 0)),
                        "ckpt_spills": int(
                            counters.get("bps_ckpt_spills_total", 0)),
                        "ckpt_failures": int(
                            counters.get("bps_ckpt_failures_total", 0)),
                        "ckpt_spill_ms": int(
                            gauges.get("bps_ckpt_spill_ms", 0)),
                    })
                body = json.dumps(body).encode()
                ctype = "application/json"
                code = 200 if healthy else 503
            else:
                body, ctype, code = b"not found\n", "text/plain", 404
        except Exception as e:  # scrape must not kill the job
            body = f"snapshot failed: {e}\n".encode()
            ctype, code = "text/plain", 500
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):  # noqa: N802 (http.server API)
        # POST /events: journal one event from outside the C hot paths
        # (insight posts its classification flips here so regressions
        # land on the same incident timeline as the lifecycle events
        # they explain). Body: {"type": name-or-code, "a0","a1","a2"}.
        try:
            if self.path.split("?")[0] != "/events":
                body, code = b"not found\n", 404
            else:
                n = int(self.headers.get("Content-Length", 0) or 0)
                doc = json.loads(self.rfile.read(n).decode() or "{}")
                from byteps_tpu_torch.core.ffi import events_emit
                events_emit(doc["type"], int(doc.get("a0", 0)),
                            int(doc.get("a1", 0)), int(doc.get("a2", 0)))
                body, code = b"ok\n", 200
        except Exception as e:  # a bad post must not kill the job
            body, code = f"event rejected: {e}\n".encode(), 400
        self.send_response(code)
        self.send_header("Content-Type", "text/plain")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # silence per-request stderr noise
        pass


class MonitorServer:
    """ThreadingHTTPServer on a daemon thread; stop() joins it."""

    def __init__(self, port: int, host: str = "0.0.0.0"):
        self._httpd = http.server.ThreadingHTTPServer((host, port),
                                                     _Handler)
        self._httpd.daemon_threads = True
        self._httpd.started_at = time.monotonic()
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="bps-monitor",
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


def maybe_start_monitor(node_id: int) -> Optional[MonitorServer]:
    """Start the endpoint for this node iff BYTEPS_MONITOR_ON; returns
    None (monitoring off or port taken) otherwise. Never raises — the
    monitor is best-effort by contract."""
    import logging

    from byteps_tpu_torch.config import load_config

    try:
        cfg = load_config()
        if not cfg.monitor_on:
            return None
        srv = MonitorServer(cfg.monitor_port + node_id)
        logging.getLogger("byteps_tpu_torch.monitor").info(
            "monitor endpoint on :%d (/metrics, /healthz, /events)",
            srv.port)
        return srv
    except Exception as e:
        logging.getLogger("byteps_tpu_torch.monitor").warning(
            "monitor endpoint disabled: %s", e)
        return None
