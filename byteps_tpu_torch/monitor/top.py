"""Fleet scraper + straggler/health detector.

``python -m byteps_tpu_torch.monitor.top`` polls every role's monitor endpoint
(derived from the topology env — DMLC_NUM_WORKER / DMLC_NUM_SERVER /
BYTEPS_MONITOR_PORT — or given explicitly with ``--endpoints``) and
reports, per worker: push throughput, wire bytes, queue occupancy, and
mean push latency; fleet-wide: heartbeat freshness and dead nodes.

Straggler rule (docs/monitoring.md): a worker is flagged when its mean
push latency exceeds ``BYTEPS_STRAGGLER_FACTOR`` (default 2.0) times the
fleet's LOW-median of worker means, and is above an absolute 1 ms floor.
The low-median (lower of the two middle values) keeps the baseline
anchored to the healthy majority even in 2-worker fleets, where a plain
median would average the straggler in. Heartbeat health comes from the
scheduler endpoint: an age past PS_HEARTBEAT_TIMEOUT is stale; ids in
``bps_dead_nodes`` are already declared dead.

The launcher and later fault-tolerance PRs consume the same ``analyze``
output programmatically.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
import urllib.request
from typing import Dict, List, Optional, Tuple

DEFAULT_TIMEOUT_S = 2.0


def fleet_endpoints(host: str, base_port: int, num_workers: int,
                    num_servers: int, num_replicas: int = 0
                    ) -> Dict[str, str]:
    """role-name -> host:port for every node, from the postoffice id
    layout (scheduler 0, servers 1..S, workers S+1..S+W). Read replicas
    draw fresh ranks from the same elastic allocator workers
    use, so a fleet launched with replicas has them at S+W+1..S+W+R —
    valid as long as no elastic joins raced the replica registrations
    (use --endpoints for exotic topologies)."""
    eps = {"scheduler": f"{host}:{base_port}"}
    for s in range(num_servers):
        eps[f"server{s}"] = f"{host}:{base_port + 1 + s}"
    for w in range(num_workers):
        eps[f"worker{w}"] = f"{host}:{base_port + 1 + num_servers + w}"
    for r in range(num_replicas):
        eps[f"replica{r}"] = (
            f"{host}:{base_port + 1 + num_servers + num_workers + r}")
    return eps


def scrape(endpoint: str, timeout: float = DEFAULT_TIMEOUT_S
           ) -> Optional[dict]:
    """Fetch + parse one endpoint's /metrics; None when unreachable."""
    from byteps_tpu_torch.monitor.metrics import parse_prometheus
    try:
        with urllib.request.urlopen(f"http://{endpoint}/metrics",
                                    timeout=timeout) as r:
            return parse_prometheus(r.read().decode())
    except (OSError, ValueError):
        return None


def scrape_events(endpoint: str, since_us: int = 0, limit: int = 10,
                  timeout: float = DEFAULT_TIMEOUT_S) -> List[dict]:
    """Tail the fleet event journal from one endpoint's
    /events — newest `limit` timeline entries newer than `since_us`
    (aligned us), so repeated polls render a scrolling ticker instead
    of reprinting history. [] when unreachable or journal off."""
    try:
        with urllib.request.urlopen(f"http://{endpoint}/events",
                                    timeout=timeout) as r:
            doc = json.loads(r.read().decode())
    except (OSError, ValueError):
        return []
    evs = doc.get("timeline") or doc.get("events") or []
    fresh = [e for e in evs if e.get("ts_us", 0) > since_us]
    return fresh[-limit:]


def _sample(metrics: dict, name: str, default: float = 0.0) -> float:
    series = metrics.get(name)
    if not series:
        return default
    return next(iter(series.values()))


def _rank_key(name: str):
    """Numeric rank ordering for role rows: worker10 sorts after
    worker2, not between worker1 and worker2 (stable scripting order
    for --json consumers and the tenant fleet tests)."""
    head = name.rstrip("0123456789")
    tail = name[len(head):]
    return (head, int(tail) if tail else -1)


def _tenant_rows(scrapes: Dict[str, Optional[dict]],
                 starve_ms: float = 2000.0) -> Dict[str, dict]:
    """Per-tenant accounting aggregated across the SERVER scrapes
    (bps_tenant_* labeled series) plus worker count / weight
    from any role that carries the address-book roster gauges. A
    tenant is STARVED when any server reports queued work unserved for
    longer than BYTEPS_TENANT_STARVE_MS."""
    rows: Dict[str, dict] = {}

    def row(tid: str) -> dict:
        return rows.setdefault(tid, {
            "push_bytes": 0, "reply_bytes": 0, "ops": 0,
            "queue_depth": 0, "dispatched": 0, "starve_us": 0,
            "workers": 0, "weight": 0, "starved": False,
        })

    for name, m in scrapes.items():
        if m is None:
            continue
        is_server = name.startswith("server")
        for metric, field in (("bps_tenant_push_bytes_total",
                               "push_bytes"),
                              ("bps_tenant_reply_bytes_total",
                               "reply_bytes"),
                              ("bps_tenant_ops_total", "ops"),
                              ("bps_tenant_queue_depth", "queue_depth"),
                              ("bps_tenant_dispatched_total",
                               "dispatched"),
                              ("bps_tenant_starve_us", "starve_us")):
            if not is_server:
                continue  # engine accounting lives on servers
            for labels, v in (m.get(metric) or {}).items():
                tid = dict(labels).get("tenant")
                if tid is None:
                    continue
                r = row(tid)
                if field == "starve_us":
                    r[field] = max(r[field], int(v))
                else:
                    r[field] += int(v)
        for metric, field in (("bps_tenant_workers", "workers"),
                              ("bps_tenant_weight", "weight")):
            for labels, v in (m.get(metric) or {}).items():
                tid = dict(labels).get("tenant")
                if tid is not None:
                    row(tid)[field] = max(row(tid)[field], int(v))
    for r in rows.values():
        r["starved"] = (r["queue_depth"] > 0
                        and r["starve_us"] / 1000.0 > starve_ms)
    return rows


def _replica_rows(scrapes: Dict[str, Optional[dict]],
                  lag_rounds: int = 8) -> Dict[str, dict]:
    """Per-replica snapshot-serving state: the committed
    snapshot version this replica serves, how many rounds it trails its
    primary (bps_replica_lag_rounds, stamped from every delta reply),
    and its read traffic. A replica is REPLICA-LAGGING when the lag
    exceeds BYTEPS_REPLICA_LAG_ROUNDS — readers pinned there see stale
    (but still never-torn) cuts."""
    rows: Dict[str, dict] = {}
    for name, m in scrapes.items():
        if not name.startswith("replica") or m is None:
            continue
        lag = int(_sample(m, "bps_replica_lag_rounds"))
        rows[name] = {
            "snapshot_version": int(_sample(m, "bps_snapshot_version",
                                            -1)),
            "lag_rounds": lag,
            "snap_pulls": int(_sample(m, "bps_snap_pulls_total")),
            "lagging": lag > lag_rounds,
        }
    return rows


def _ckpt_rows(scrapes: Dict[str, Optional[dict]],
               lag_warn: int = 8) -> Dict[str, dict]:
    """Per-server durable-checkpoint state: the newest sealed
    spill version, how many committed snapshot versions the writer
    trails the training watermark, and spill traffic. A server is
    CKPT-LAGGING when the lag exceeds BYTEPS_CKPT_LAG_WARN — the disk is
    not keeping up, and a full-fleet loss right now costs that many
    rounds of progress. Servers without the writer armed (no
    bps_ckpt_version series) are omitted, so checkpoint-less fleets get
    an unchanged report."""
    rows: Dict[str, dict] = {}
    for name, m in scrapes.items():
        if not name.startswith("server") or m is None:
            continue
        if "bps_ckpt_version" not in m:
            continue
        lag = int(_sample(m, "bps_ckpt_lag_rounds"))
        rows[name] = {
            "ckpt_version": int(_sample(m, "bps_ckpt_version", -1)),
            "lag_rounds": lag,
            "spills": int(_sample(m, "bps_ckpt_spills_total")),
            "failures": int(_sample(m, "bps_ckpt_failures_total")),
            "spill_ms": int(_sample(m, "bps_ckpt_spill_ms")),
            "lagging": lag > lag_warn,
        }
    return rows


def analyze(scrapes: Dict[str, Optional[dict]],
            straggler_factor: float = 2.0,
            heartbeat_timeout_s: float = 30.0) -> dict:
    """Turn per-role scrapes into a health report. ``scrapes`` maps role
    names (workerN / serverN / scheduler) to parsed metrics (None =
    endpoint unreachable)."""
    workers: Dict[str, dict] = {}
    for name, m in scrapes.items():
        if not name.startswith("worker") or m is None:
            continue
        count = _sample(m, "bps_push_us_count")
        workers[name] = {
            "push_mean_us": (_sample(m, "bps_push_us_sum") / count
                             if count else 0.0),
            "push_count": int(count),
            "push_bytes": int(_sample(m, "bps_push_bytes_total")),
            "pull_bytes": int(_sample(m, "bps_pull_bytes_total")),
            "queue_pending": int(_sample(m, "bps_queue_pending")),
            "inflight_bytes": int(_sample(m, "bps_queue_inflight_bytes")),
            "credit_budget_bytes": int(
                _sample(m, "bps_queue_credit_budget_bytes")),
            # Transient-fault telemetry: nonzero means this worker is
            # absorbing faults in-band (resends / re-dialled server
            # connections) — the flag to investigate a link or peer
            # BEFORE the node goes dead.
            "retries": int(_sample(m, "bps_retries_total")),
            "reconnects": int(_sample(m, "bps_reconnects_total")),
            # Wire integrity: receive-side frame accounting.
            # gaps/dups come from the per-connection seq cursor; CRC
            # fails are frames dropped on a checksum mismatch;
            # quarantines are flaky-link force-re-dials; corrupting is
            # the persistently-corrupting-link flag that precedes the
            # named fail-stop.
            "seq_gaps": int(_sample(m, "bps_seq_gaps_total")),
            "seq_dups": int(_sample(m, "bps_seq_dups_total")),
            "crc_fails": int(_sample(m, "bps_crc_fail_total")),
            "crc_quarantines": int(
                _sample(m, "bps_crc_quarantine_total")),
            "corrupting": bool(_sample(m, "bps_link_corrupting")),
            # Hot-replacement telemetry: server recoveries this worker
            # re-seeded, and whether one is in progress right now.
            "recoveries": int(_sample(m, "bps_recoveries_total")),
            "recovering": bool(_sample(m, "bps_recovering")),
            # Scheduler fail-over: 1 while this worker is
            # PARKED on a lost scheduler (data plane still draining,
            # control plane frozen, re-dialling the endpoint).
            "sched_lost": bool(_sample(m, "bps_sched_lost")),
            "sched_recoveries": int(
                _sample(m, "bps_sched_recoveries_total")),
            # Trace health: drop-oldest overwrites in the main
            # trace ring mean the timeline is missing events — raise
            # BYTEPS_TRACE_RING_EVENTS or narrow the step window.
            "trace_dropped": int(_sample(m, "bps_trace_dropped_total")),
            "flight_dumps": int(_sample(m, "bps_flight_dumps_total")),
            # Quantized wire: encoded bytes that crossed the
            # wire and raw-minus-encoded savings, both legs. The
            # compression ratio column is (wire + saved) / wire.
            "quant_wire_bytes": int(
                _sample(m, "bps_quant_bytes_on_wire_total")),
            "quant_saved_bytes": int(
                _sample(m, "bps_quant_bytes_saved_total")),
        }
        qw = workers[name]["quant_wire_bytes"]
        qs = workers[name]["quant_saved_bytes"]
        workers[name]["quant_ratio"] = (
            round((qw + qs) / qw, 2) if qw > 0 else 1.0)
        # Last completed round's stage breakdown: the
        # BOTTLENECK column + fleet-state header come from these
        # gauges through the same insight classifier the /rounds
        # watcher uses.
        rec = {
            "round": int(_sample(m, "bps_round_last", -1)),
            "parts": int(_sample(m, "bps_round_parts")),
            "queue_us": _sample(m, "bps_round_queue_us"),
            "comp_us": _sample(m, "bps_round_comp_us"),
            "push_us": _sample(m, "bps_round_push_us"),
            "sum_us": _sample(m, "bps_round_sum_us"),
            "wire_ack_us": _sample(m, "bps_round_wire_ack_us"),
            "pull_us": _sample(m, "bps_round_pull_us"),
            "dec_us": _sample(m, "bps_round_dec_us"),
            "wire_bytes": int(_sample(m, "bps_round_wire_bytes")),
            "wire_msgs": int(_sample(m, "bps_round_wire_msgs")),
            "retries": int(_sample(m, "bps_round_retries")),
            "parked": int(_sample(m, "bps_round_parked")),
        }
        workers[name]["round"] = rec
        if rec["round"] >= 0:
            from byteps_tpu_torch.monitor import insight
            stage, share = insight.dominant_stage(rec)
            workers[name]["bottleneck"] = stage
            workers[name]["bottleneck_share"] = round(share, 2)
        else:
            workers[name]["bottleneck"] = "-"
            workers[name]["bottleneck_share"] = 0.0

    # A worker actively riding the retry layer is flagged separately
    # from stragglers: its latency may still look healthy while its
    # connection quality is not.
    retrying = sorted((n for n, w in workers.items()
                       if w["retries"] > 0 or w["reconnects"] > 0),
                      key=_rank_key)
    corrupting = sorted((n for n, w in workers.items()
                         if w["corrupting"]), key=_rank_key)
    trace_dropping = sorted((n for n, w in workers.items()
                             if w["trace_dropped"] > 0),
                            key=_rank_key)

    stragglers: List[str] = []
    active = {n: w["push_mean_us"] for n, w in workers.items()
              if w["push_count"] > 0}
    baseline_us = statistics.median_low(list(active.values())) \
        if active else 0.0
    for name, mean_us in active.items():
        if mean_us >= 1000.0 and mean_us > straggler_factor * baseline_us:
            stragglers.append(name)

    stale_nodes: List[int] = []
    dead_nodes: List[int] = []
    epoch = 0
    recovering = any(w.get("recovering") for w in workers.values())
    recoveries = 0
    fleet_workers = 0
    resizing = False
    joins = leaves = 0
    # Scheduler fail-over: the fleet counts as
    # SCHED-RECOVERING when any node is parked on a lost scheduler OR
    # a restarted scheduler is still collecting its quorum.
    sched_recovering = any(w.get("sched_lost") for w in workers.values())
    sched_recoveries = 0
    sched_rereg = sched_rereg_expected = 0
    sched = scrapes.get("scheduler")
    if sched:
        for labels in sched.get("bps_node_dead", {}):
            dead_nodes.append(int(dict(labels)["node"]))
        for labels, age_ms in sched.get("bps_heartbeat_age_ms",
                                        {}).items():
            if age_ms > heartbeat_timeout_s * 1000.0:
                stale_nodes.append(int(dict(labels)["node"]))
        # Recovery state is authoritative at the scheduler: the
        # membership epoch climbs once per hot replacement, and
        # bps_recovering is 1 while the fleet is paused for one.
        epoch = int(_sample(sched, "bps_membership_epoch"))
        recovering = recovering or bool(_sample(sched, "bps_recovering"))
        recoveries = int(_sample(sched, "bps_recoveries_total"))
        # Elastic worker membership: the LIVE fleet size and
        # whether a join/leave/shrink is committing right now.
        fleet_workers = int(_sample(sched, "bps_fleet_workers"))
        resizing = bool(_sample(sched, "bps_fleet_resizing"))
        joins = int(_sample(sched, "bps_worker_joins_total"))
        leaves = int(_sample(sched, "bps_worker_leaves_total"))
        sched_recovering = sched_recovering or bool(
            _sample(sched, "bps_sched_recovering"))
        sched_recoveries = int(
            _sample(sched, "bps_sched_recoveries_total"))
        sched_rereg = int(_sample(sched, "bps_sched_rereg"))
        sched_rereg_expected = int(
            _sample(sched, "bps_sched_rereg_expected"))

    # Fleet state: classify the workers' last-round records
    # with the same rules the /rounds watcher applies.
    fleet_state = "idle"
    fleet_bottleneck = "-"
    round_recs = {n: w["round"] for n, w in workers.items()
                  if w.get("round", {}).get("round", -1) >= 0}
    if round_recs:
        from byteps_tpu_torch.monitor import insight
        rep = insight.classify(round_recs,
                               straggler_factor=straggler_factor,
                               resizing=resizing,
                               crc_fails=sum(w["crc_fails"]
                                             for w in workers.values()))
        fleet_state = rep["state"]
        fleet_bottleneck = rep["dominant"]
    elif resizing:
        fleet_state = "resizing"

    import os as _os
    tenants = _tenant_rows(
        scrapes,
        starve_ms=float(_os.environ.get("BYTEPS_TENANT_STARVE_MS",
                                        "2000") or 2000))
    replicas = _replica_rows(
        scrapes,
        lag_rounds=int(_os.environ.get("BYTEPS_REPLICA_LAG_ROUNDS",
                                       "8") or 8))
    ckpt = _ckpt_rows(
        scrapes,
        lag_warn=int(_os.environ.get("BYTEPS_CKPT_LAG_WARN", "8") or 8))

    return {
        "workers": workers,
        # Snapshot-serving replicas (docs/serving.md).
        "replicas": replicas,
        "lagging_replicas": sorted(
            (n for n, r in replicas.items() if r["lagging"]),
            key=_rank_key),
        # Durable checkpoints (docs/checkpoint.md).
        "ckpt": ckpt,
        "lagging_ckpt": sorted(
            (n for n, r in ckpt.items() if r["lagging"]),
            key=_rank_key),
        # Multi-tenant rows (docs/multitenancy.md).
        "tenants": tenants,
        "starved_tenants": sorted(
            (t for t, r in tenants.items() if r["starved"]), key=int),
        "baseline_push_us": baseline_us,
        "stragglers": sorted(stragglers, key=_rank_key),
        "retrying": retrying,
        # Wire integrity: workers observing a persistently
        # corrupting link (bps_link_corrupting set — the named
        # fail-stop is imminent or already under way).
        "corrupting": corrupting,
        "trace_dropping": trace_dropping,
        "stale_nodes": sorted(stale_nodes),
        "dead_nodes": sorted(dead_nodes),
        "unreachable": sorted((n for n, m in scrapes.items()
                               if m is None), key=_rank_key),
        # Hot-replacement fleet state (docs/monitoring.md "Recovery").
        "epoch": epoch,
        "recovering": recovering,
        "recoveries": recoveries,
        # Elastic membership (docs/elasticity.md).
        "fleet_workers": fleet_workers,
        "resizing": resizing,
        "joins": joins,
        "leaves": leaves,
        # Scheduler fail-over (docs/troubleshooting.md).
        "sched_recovering": sched_recovering,
        "sched_recoveries": sched_recoveries,
        "sched_reregistered": sched_rereg,
        "sched_expected": sched_rereg_expected,
        # Per-round insight (docs/monitoring.md "Round insight").
        "fleet_state": fleet_state,
        "fleet_bottleneck": fleet_bottleneck,
    }


def _print_report(report: dict, as_json: bool) -> None:
    if as_json:
        print(json.dumps(report))
        return
    print(f"{'worker':<10} {'push/s':>8} {'push MB':>9} {'pull MB':>9} "
          f"{'q-ratio':>7} {'mean push':>10} {'queue':>6} {'credit':>14} "
          f"{'rtry':>5} {'reconn':>6} {'gap/dup':>8} {'crc':>5} "
          f"{'BOTTLENECK':>14} flags")
    if report.get("fleet_workers"):
        extra = ""
        if report.get("joins") or report.get("leaves"):
            extra = (f"; {report.get('joins', 0)} join(s), "
                     f"{report.get('leaves', 0)} leave(s)")
        print(f"fleet: {report['fleet_workers']} worker(s)"
              + (" — RESIZING (membership change committing)"
                 if report.get("resizing") else "") + extra)
    if report.get("sched_recovering"):
        print(f"fleet: SCHED-RECOVERING (scheduler lost/restarting; "
              f"{report.get('sched_reregistered', 0)}/"
              f"{report.get('sched_expected', 0)} node(s) "
              "re-registered; data plane draining against the last "
              "committed address book)")
    if report.get("recovering"):
        print(f"fleet: RECOVERING (membership epoch {report['epoch']}; "
              "a server rank is being hot-replaced)")
    elif report.get("epoch"):
        print(f"fleet: epoch {report['epoch']} "
              f"({report.get('recoveries', 0)} recovery(ies) completed)")
    if report.get("fleet_state", "idle") != "idle":
        print(f"fleet: {report['fleet_state'].upper()} "
              f"(round bottleneck: {report['fleet_bottleneck']}; "
              "details: python -m byteps_tpu_torch.monitor.insight)")
    tenants = report.get("tenants") or {}
    # Tenant rows only when some job actually registered a tenant (a
    # legacy fleet's single implicit tenant 0 row would be noise).
    if any(t != "0" for t in tenants):
        print(f"{'tenant':<10} {'weight':>6} {'workers':>7} "
              f"{'push MB':>9} {'reply MB':>9} {'ops':>8} {'queued':>6} "
              f"{'served MB':>9} flags")
        for tid in sorted(tenants, key=int):
            r = tenants[tid]
            flags = "STARVED" if r["starved"] else ""
            print(f"t{tid:<9} {r['weight']:>6} {r['workers']:>7} "
                  f"{r['push_bytes'] / 1e6:>9.2f} "
                  f"{r['reply_bytes'] / 1e6:>9.2f} {r['ops']:>8} "
                  f"{r['queue_depth']:>6} "
                  f"{r['dispatched'] / 1e6:>9.2f} {flags}")
    for name in sorted(report["workers"], key=_rank_key):
        w = report["workers"][name]
        flags = []
        if name in report["stragglers"]:
            flags.append("STRAGGLER")
        if name in report.get("retrying", []):
            flags.append("RETRYING")
        if name in report.get("trace_dropping", []):
            flags.append("TRACE-DROPPING")
        if w.get("recovering"):
            flags.append("RECOVERING")
        elif w.get("recoveries"):
            flags.append(f"RECOVERED×{w['recoveries']}")
        if w.get("corrupting"):
            flags.append("CORRUPTING")
        credit = (f"{w['inflight_bytes'] >> 10}/"
                  f"{w['credit_budget_bytes'] >> 10}K")
        qratio = (f"{w['quant_ratio']:.1f}x"
                  if w.get("quant_wire_bytes") else "-")
        gapdup = f"{w.get('seq_gaps', 0)}/{w.get('seq_dups', 0)}"
        bneck = w.get("bottleneck", "-")
        if bneck != "-":
            bneck = f"{bneck}({w.get('bottleneck_share', 0) * 100:.0f}%)"
        print(f"{name:<10} {w['push_count']:>8} "
              f"{w['push_bytes'] / 1e6:>9.2f} {w['pull_bytes'] / 1e6:>9.2f} "
              f"{qratio:>7} "
              f"{w['push_mean_us'] / 1e3:>8.2f}ms {w['queue_pending']:>6} "
              f"{credit:>14} {w.get('retries', 0):>5} "
              f"{w.get('reconnects', 0):>6} {gapdup:>8} "
              f"{w.get('crc_fails', 0):>5} {bneck:>14} "
              f"{' '.join(flags)}")
    replicas = report.get("replicas") or {}
    if replicas:
        print(f"{'replica':<10} {'snap-ver':>9} {'lag':>5} "
              f"{'snap pulls':>10} flags")
        for name in sorted(replicas, key=_rank_key):
            r = replicas[name]
            flags = "REPLICA-LAGGING" if r["lagging"] else ""
            print(f"{name:<10} {r['snapshot_version']:>9} "
                  f"{r['lag_rounds']:>5} {r['snap_pulls']:>10} {flags}")
    ckpt = report.get("ckpt") or {}
    if ckpt:
        print(f"{'server':<10} {'ckpt-ver':>9} {'lag':>5} {'spills':>7} "
              f"{'fail':>5} {'spill ms':>8} flags")
        for name in sorted(ckpt, key=_rank_key):
            r = ckpt[name]
            flags = "CKPT-LAGGING" if r["lagging"] else ""
            print(f"{name:<10} {r['ckpt_version']:>9} "
                  f"{r['lag_rounds']:>5} {r['spills']:>7} "
                  f"{r['failures']:>5} {r['spill_ms']:>8} {flags}")
    for kind in ("retrying", "corrupting", "stale_nodes", "dead_nodes",
                 "unreachable", "starved_tenants", "lagging_replicas",
                 "lagging_ckpt"):
        if report.get(kind):
            print(f"{kind}: {report[kind]}")
    # Journal ticker: fresh fleet lifecycle events since the
    # last poll, on the scheduler timebase. A pause that never resumes,
    # a death, a quarantine — they land here the poll after they
    # happen, without waiting for a gauge to move.
    roles = {0: "sched", 1: "server", 2: "worker"}
    for e in report.get("events") or []:
        who = (f"{roles.get(e.get('role', -1), '?')}"
               f"/n{e.get('node', -1)}")
        args = ",".join(str(e.get(k, 0)) for k in ("a0", "a1", "a2"))
        print(f"event: {e.get('ts_us', 0) / 1e6:>12.3f}s "
              f"{e.get('name', '?'):<22} {who:<12} args=[{args}]")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m byteps_tpu_torch.monitor.top",
        description="scrape the fleet's monitor endpoints; flag "
                    "stragglers and dead/stale nodes (docs/monitoring.md)")
    p.add_argument("--host", default=os.environ.get("DMLC_PS_ROOT_URI",
                                                    "127.0.0.1"))
    p.add_argument("--base-port", type=int,
                   default=int(os.environ.get("BYTEPS_MONITOR_PORT",
                                              "9100")))
    p.add_argument("--num-workers", type=int,
                   default=int(os.environ.get("DMLC_NUM_WORKER", "1")))
    p.add_argument("--num-servers", type=int,
                   default=int(os.environ.get("DMLC_NUM_SERVER", "1")))
    p.add_argument("--num-replicas", type=int,
                   default=int(os.environ.get("BYTEPS_NUM_REPLICAS", "0")
                               or 0),
                   help="read replicas to scrape (ranks after the "
                        "workers; docs/serving.md)")
    p.add_argument("--endpoints", nargs="*", metavar="NAME=HOST:PORT",
                   help="explicit endpoints (e.g. worker0=10.0.0.5:9104); "
                        "overrides the derived topology")
    p.add_argument("--straggler-factor", type=float,
                   default=float(os.environ.get("BYTEPS_STRAGGLER_FACTOR",
                                                "2.0")))
    p.add_argument("--heartbeat-timeout", type=float,
                   default=float(os.environ.get("PS_HEARTBEAT_TIMEOUT",
                                                "30")))
    p.add_argument("--watch", type=float, metavar="SECONDS", default=0,
                   help="re-scrape every N seconds until interrupted")
    p.add_argument("--json", action="store_true",
                   help="machine-readable report (one JSON line per poll)")
    args = p.parse_args(argv)

    if args.endpoints:
        eps = dict(e.split("=", 1) for e in args.endpoints)
    else:
        eps = fleet_endpoints(args.host, args.base_port, args.num_workers,
                              args.num_servers, args.num_replicas)
    last_ev_us = 0
    while True:
        report = analyze({name: scrape(ep) for name, ep in eps.items()},
                         straggler_factor=args.straggler_factor,
                         heartbeat_timeout_s=args.heartbeat_timeout)
        if "scheduler" in eps:
            fresh = scrape_events(eps["scheduler"], since_us=last_ev_us)
            if fresh:
                last_ev_us = max(e.get("ts_us", 0) for e in fresh)
            report["events"] = fresh
        _print_report(report, args.json)
        if not args.watch:
            return 1 if (report["stragglers"] or report["dead_nodes"]
                         or report["stale_nodes"]) else 0
        time.sleep(args.watch)


if __name__ == "__main__":
    sys.exit(main())
