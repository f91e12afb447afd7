"""Fleet timeline merge + critical-path analysis.

Every role dumps a per-rank Chrome-trace JSON (``bps_dump_trace``, or
automatically at shutdown with ``BYTEPS_TRACE_ON=1``) whose ``meta``
object carries the rank's identity and its clock offset vs the
scheduler (estimated from the heartbeat RTT exchange, min-RTT sample).
This module gathers those dumps, applies the offsets so every rank sits
on the scheduler's timebase, and emits ONE Perfetto/chrome://tracing
loadable trace in which a worker's push span flow-links (Chrome
``s``/``t``/``f`` events keyed on (sender, req_id)) to its server's sum
span and back to the ack — the cross-rank attribution the worker-only
timeline could not give ("server slow" vs "peer late" vs "wire
congested").

It also prints a per-step critical-path breakdown — worker-enqueue wait
vs wire+ack vs server-sum vs pull wait — and straggler attribution using
the same low-median rule as ``monitor.top``.

Usage::

    python -m byteps_tpu_torch.monitor.timeline merge --dir traces/ \
        --out fleet.json            # merged trace + report
    python -m byteps_tpu_torch.monitor.timeline report --dir traces/
    python -m byteps_tpu_torch.monitor.timeline merge --dir traces/ \
        --glob 'flight_*.json' --out flight.json   # merged flight view

The same functions are importable for tests and tooling:
``load_dump`` / ``merge_dumps`` / ``critical_path``.
"""

from __future__ import annotations

import argparse
import glob as _glob
import json
import os
import re
import statistics
import sys
from typing import Dict, List, Optional, Tuple

_ROLE_NAMES = {0: "scheduler", 1: "server", 2: "worker"}

# Worker/server span names the critical-path report attributes.
# qencode/qdecode: the quantized wire's encode/EF
# fold and reply-leg dequant, previously invisible under "compress" /
# inside the pull span.
_WORKER_SPANS = ("compress", "qencode", "push", "pull", "qdecode")
_SERVER_SPANS = ("s_sum", "s_reply")


def load_dump(path: str) -> dict:
    """One per-rank dump: {"meta": {...}, "traceEvents": [...]}. Dumps
    from cores without trace metadata (no meta) load with an empty meta."""
    with open(path) as f:
        d = json.load(f)
    d.setdefault("meta", {})
    d["meta"].setdefault("path", path)
    return d


def gather(trace_dir: str, pattern: str = "trace_*.json") -> List[dict]:
    paths = sorted(_glob.glob(os.path.join(trace_dir, pattern)))
    return [load_dump(p) for p in paths]


def _rank_label(meta: dict) -> str:
    role = _ROLE_NAMES.get(meta.get("role", -1), "rank")
    nid = meta.get("node_id", -1)
    if role == "worker" and meta.get("worker_rank", -1) >= 0:
        return f"worker {meta['worker_rank']} (node {nid})"
    if nid < 0:
        # Pre-topology dump (a rank that died before learning its id):
        # the pid is the only attribution; SetNode renames survivors'
        # files to role/node form, but the merge tolerates both.
        return f"{role} (pid {meta.get('pid', '?')})"
    return f"{role} (node {nid})"


def _incarnation(meta: dict) -> int:
    """Incarnation index from the dump filename: restart forensics
    (crash-restart, restore-relaunch) leave multiple dumps for one
    role/node — ``flight_rR_nN.json`` is the first life, and each
    relaunch probes to ``flight_rR_nN_i<k>.json`` rather than
    overwriting its predecessor's evidence."""
    m = re.search(r"_i(\d+)\.json$", meta.get("path", "") or "")
    return int(m.group(1)) if m else 0


# Synthetic process row for the journal overlay: far above any real
# node id (which stay < 100000 * incarnations in practice).
_EVENTS_PID = 10 ** 9


def journal_instants(journal: dict) -> List[dict]:
    """Fleet event journal -> Perfetto instant events, one
    per timeline entry, already on the scheduler timebase (the journal
    aligns at ingest). They ride a dedicated "fleet events" process
    row so pauses, deaths, and recovery commits sit visually above the
    per-rank spans they explain."""
    out = []
    for e in journal.get("timeline") or journal.get("events") or []:
        out.append({
            "name": e.get("name", "event"),
            "ph": "i", "s": "g",  # global scope: full-height marker
            "pid": _EVENTS_PID, "tid": e.get("node", -1),
            "ts": e.get("ts_us", 0),
            "args": {"node": e.get("node", -1),
                     "role": e.get("role", -1),
                     "a0": e.get("a0", 0), "a1": e.get("a1", 0),
                     "a2": e.get("a2", 0)},
        })
    return out


def merge_dumps(dumps: List[dict],
                out_path: Optional[str] = None,
                journal: Optional[dict] = None) -> dict:
    """Merge per-rank dumps into one fleet trace.

    Clock alignment: each rank's events are shifted by its
    ``meta.clock_offset_us`` so all timestamps sit on the scheduler's
    timebase (offset is defined as t_scheduler ~= t_local + offset).
    Each rank becomes its own process row (pid = node id) with a
    ``process_name`` metadata record, so Perfetto shows one labelled
    track group per rank. Events are emitted in timestamp order.

    Incarnations: when several dumps share one (role, node id) — a
    crashed first life plus its restarted successor(s), distinguished
    by the ``_i<k>`` filename suffix — each life gets its OWN labelled
    row ("life k") instead of interleaving pre-crash and post-restart
    events on one track.
    """
    events: List[dict] = []
    ranks = []
    lives: Dict[Tuple[int, int], int] = {}
    for d in dumps:
        key = (d.get("meta", {}).get("role", -1),
               d.get("meta", {}).get("node_id", -1))
        if key[1] >= 0:
            lives[key] = lives.get(key, 0) + 1
    for d in dumps:
        meta = d.get("meta", {})
        nid = meta.get("node_id", -1)
        inc = _incarnation(meta)
        # A rank that never learned its id (pre-topology dump) still
        # gets a distinct row: fall back to a synthetic negative pid.
        pid = nid if nid >= 0 else -(len(ranks) + 1)
        label = _rank_label(meta)
        if nid >= 0 and lives.get((meta.get("role", -1), nid), 0) > 1:
            # Distinct row per incarnation (node ids are small; the
            # 100000 stride cannot collide with a real node id).
            pid = nid + 100000 * inc
            label = f"{label} [life {inc + 1}]"
        offset = int(meta.get("clock_offset_us", 0) or 0)
        ranks.append({"pid": pid, "label": label,
                      "offset_us": offset,
                      "rtt_us": meta.get("clock_rtt_us", -1),
                      "dropped": meta.get("dropped", 0),
                      "incarnation": inc,
                      "role": meta.get("role", -1)})
        for e in d.get("traceEvents", []):
            if "ts" not in e:
                continue
            e2 = dict(e)
            e2["pid"] = pid
            e2["ts"] = e["ts"] + offset
            events.append(e2)
    overlay = journal_instants(journal) if journal else []
    events += overlay
    events.sort(key=lambda e: e["ts"])
    merged_events: List[dict] = [
        {"name": "process_name", "ph": "M", "pid": r["pid"],
         "args": {"name": r["label"]}} for r in ranks]
    if overlay:
        merged_events.append({"name": "process_name", "ph": "M",
                              "pid": _EVENTS_PID,
                              "args": {"name": "fleet events"}})
    merged_events += events
    merged = {"traceEvents": merged_events,
              "meta": {"ranks": ranks, "events": len(events),
                       "journal_events": len(overlay)}}
    if out_path:
        with open(out_path, "w") as f:
            json.dump(merged, f)
    return merged


def check_flows(merged: dict) -> dict:
    """Flow-event health of a merged trace: per flow id, the set of
    phases present. A healthy chain has its "s" start matched by an "f"
    end (steps "t" optional); unbalanced ids usually mean a rank's ring
    dropped events or a rank's dump is missing from the merge."""
    flows: Dict[Tuple[str, int], set] = {}
    for e in merged.get("traceEvents", []):
        if e.get("ph") in ("s", "t", "f") and "id" in e:
            flows.setdefault((e.get("name", ""), e["id"]),
                             set()).add(e["ph"])
    balanced = sum(1 for phs in flows.values()
                   if "s" in phs and "f" in phs)
    return {"flows": len(flows), "balanced": balanced,
            "unbalanced": len(flows) - balanced}


def _span_index(dumps: List[dict]) -> Tuple[list, list, dict]:
    """(worker_spans, server_spans, enqueue_index) from raw (unshifted)
    dumps — durations are offset-invariant, so the report reads the
    per-rank dumps directly. enqueue_index: (pid, key, round) -> ts."""
    wspans, sspans = [], []
    enq: Dict[Tuple[int, int, int], int] = {}
    for d in dumps:
        meta = d.get("meta", {})
        nid = meta.get("node_id", -1)
        role = meta.get("role", -1)
        for e in d.get("traceEvents", []):
            args = e.get("args", {})
            rec = {"pid": nid, "role": role, "name": e.get("name"),
                   "ts": e.get("ts", 0), "dur": e.get("dur", 0),
                   "key": args.get("key"), "peer": args.get("peer", -1),
                   "req": args.get("req", -1),
                   "round": args.get("round", -1),
                   # Byte labels on data-carrying spans (quantized
                   # wire): what crossed the wire vs the decoded size.
                   "wire_bytes": args.get("wire_bytes", 0),
                   "raw_bytes": args.get("raw_bytes", 0),
                   "label": _rank_label(meta)}
            if e.get("ph") == "X":
                if role == 2 and e.get("name") in _WORKER_SPANS:
                    wspans.append(rec)
                elif role == 1 and e.get("name") in _SERVER_SPANS:
                    sspans.append(rec)
            elif e.get("ph") == "i" and e.get("name") == "enqueue":
                enq[(nid, args.get("key"), args.get("round", -1))] = \
                    e.get("ts", 0)
    return wspans, sspans, enq


def critical_path(dumps: List[dict],
                  straggler_factor: float = 2.0) -> dict:
    """Per-stage totals and straggler attribution.

    Stages (all microsecond sums):
      - queue:      enqueue instant -> push-span start (scheduled-queue
                    wait: credit admission + priority)
      - compress:   codec encode spans
      - push:       push issue -> server ack (includes wire + server)
      - server_sum: the owning server's decompress+sum spans
      - wire_ack:   push minus its matched server_sum — wire transit,
                    server queueing, and the ack's return leg
      - pull:       pull issue -> response (includes waiting for PEERS'
                    pushes — the straggler signal)
      - server_reply: the server's reply-serve spans

    Matching uses (worker node id, req_id) — the same pair the flow
    events stitch on; server spans carry it as (peer, req).
    Per-step rows group by the round number each span carries.
    """
    wspans, sspans, enq = _span_index(dumps)
    ssum_by_req: Dict[Tuple[int, int, int], int] = {}
    for s in sspans:
        if s["name"] == "s_sum":
            k = (s["peer"], s["req"], s["key"])
            ssum_by_req[k] = ssum_by_req.get(k, 0) + s["dur"]

    per_worker: Dict[str, dict] = {}
    per_round: Dict[int, dict] = {}

    def stage_add(bucket: dict, stage: str, us: float) -> None:
        bucket[stage] = bucket.get(stage, 0.0) + us

    for w in wspans:
        wb = per_worker.setdefault(
            w["label"], {"push_count": 0, "stages": {},
                         "push_wire_bytes": 0, "push_raw_bytes": 0})
        rb = per_round.setdefault(w["round"], {})
        stage_add(wb["stages"], w["name"], w["dur"])
        stage_add(rb, w["name"], w["dur"])
        if w["name"] == "push":
            wb["push_count"] += 1
            # Quantized-vs-raw freight: a push span whose wire bytes
            # undercut its raw bytes shipped the int8 encoding.
            if w.get("raw_bytes", 0) > 0:
                wb["push_wire_bytes"] += w.get("wire_bytes", 0)
                wb["push_raw_bytes"] += w["raw_bytes"]
            q = enq.get((w["pid"], w["key"], w["round"]))
            if q is not None and w["ts"] >= q:
                stage_add(wb["stages"], "queue", w["ts"] - q)
                stage_add(rb, "queue", w["ts"] - q)
            ssum = ssum_by_req.get((w["pid"], w["req"], w["key"]))
            if ssum is not None:
                stage_add(wb["stages"], "server_sum", ssum)
                stage_add(wb["stages"], "wire_ack",
                          max(0, w["dur"] - ssum))
                stage_add(rb, "server_sum", ssum)
                stage_add(rb, "wire_ack", max(0, w["dur"] - ssum))

    per_server: Dict[str, dict] = {}
    for s in sspans:
        sb = per_server.setdefault(s["label"], {})
        stage_add(sb, s["name"], s["dur"])

    # Straggler rule: monitor.top's — mean push latency above
    # straggler_factor x the fleet low-median, with a 1 ms floor.
    means = {}
    for name, wb in per_worker.items():
        if wb["push_count"]:
            means[name] = wb["stages"].get("push", 0) / wb["push_count"]
    baseline = statistics.median_low(list(means.values())) if means else 0
    stragglers = sorted(
        n for n, m in means.items()
        if m >= 1000.0 and m > straggler_factor * baseline)

    fleet: Dict[str, float] = {}
    for wb in per_worker.values():
        for stage, us in wb["stages"].items():
            fleet[stage] = fleet.get(stage, 0.0) + us
    return {
        "per_worker": per_worker,
        "per_server": per_server,
        "per_round": {k: v for k, v in sorted(per_round.items())
                      if k >= 0},
        "fleet_stages_us": fleet,
        "push_mean_us": means,
        "baseline_push_us": baseline,
        "stragglers": stragglers,
    }


def _fmt_us(us: float) -> str:
    return f"{us / 1e3:.2f}ms" if us >= 1000 else f"{us:.0f}us"


def print_report(report: dict, flow_stats: Optional[dict] = None,
                 file=None) -> None:
    out = file or sys.stdout
    fleet = report["fleet_stages_us"]
    order = ("queue", "compress", "qencode", "push", "wire_ack",
             "server_sum", "pull", "qdecode")
    print("fleet critical-path totals (worker-observed):", file=out)
    for stage in order:
        if stage in fleet:
            print(f"  {stage:<11} {_fmt_us(fleet[stage])}", file=out)
    for name, wb in sorted(report["per_worker"].items()):
        mean = report["push_mean_us"].get(name, 0.0)
        flag = " STRAGGLER" if name in report["stragglers"] else ""
        stages = " ".join(f"{s}={_fmt_us(u)}"
                          for s, u in sorted(wb["stages"].items()))
        quant = ""
        if wb.get("push_raw_bytes", 0) > 0:
            wire = wb.get("push_wire_bytes", 0)
            raw = wb["push_raw_bytes"]
            kind = "quantized" if wire < raw else "raw"
            quant = (f" push_bytes={wire >> 10}K/{raw >> 10}K"
                     f" ({kind})")
        print(f"  {name}: pushes={wb['push_count']} "
              f"mean_push={_fmt_us(mean)} {stages}{quant}{flag}",
              file=out)
    for name, sb in sorted(report["per_server"].items()):
        stages = " ".join(f"{s}={_fmt_us(u)}"
                          for s, u in sorted(sb.items()))
        print(f"  {name}: {stages}", file=out)
    if report["stragglers"]:
        print(f"stragglers: {report['stragglers']} "
              f"(baseline {_fmt_us(report['baseline_push_us'])})",
              file=out)
    if flow_stats:
        print(f"flows: {flow_stats['flows']} "
              f"({flow_stats['balanced']} balanced, "
              f"{flow_stats['unbalanced']} unbalanced)", file=out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m byteps_tpu_torch.monitor.timeline",
        description="merge per-rank trace dumps into one clock-aligned "
                    "fleet timeline + critical-path report "
                    "(docs/timeline.md)")
    p.add_argument("cmd", choices=["merge", "report"],
                   help="merge: write the fleet trace (+report); "
                        "report: analysis only")
    p.add_argument("--dir", default=os.environ.get("BYTEPS_TRACE_DIR")
                   or os.environ.get("BPS_TRACE_OUT") or "./traces",
                   help="directory holding the per-rank dumps "
                        "(default: BYTEPS_TRACE_DIR)")
    p.add_argument("--glob", default="trace_*.json",
                   help="dump filename pattern (use 'flight_*.json' to "
                        "merge flight-recorder dumps)")
    p.add_argument("--out", default="",
                   help="merged trace output path (merge mode; default "
                        "<dir>/fleet.json)")
    p.add_argument("--events", default="", metavar="JOURNAL",
                   help="overlay the fleet event journal (a saved "
                        "/events JSON, e.g. from monitor.incident) as "
                        "Perfetto instant markers on a 'fleet events' "
                        "row (merge mode)")
    p.add_argument("--straggler-factor", type=float,
                   default=float(os.environ.get("BYTEPS_STRAGGLER_FACTOR",
                                                "2.0")))
    p.add_argument("--json", action="store_true",
                   help="machine-readable report (one JSON line)")
    args = p.parse_args(argv)

    dumps = gather(args.dir, args.glob)
    if not dumps:
        print(f"no dumps matching {args.glob!r} under {args.dir!r} — "
              "run with BYTEPS_TRACE_ON=1 (every role auto-dumps at "
              "shutdown) or call bps_dump_trace", file=sys.stderr)
        return 1
    flow_stats = None
    if args.cmd == "merge":
        out = args.out or os.path.join(args.dir, "fleet.json")
        journal = None
        if args.events:
            with open(args.events) as f:
                journal = json.load(f)
        merged = merge_dumps(dumps, out_path=out, journal=journal)
        flow_stats = check_flows(merged)
        print(f"merged {len(dumps)} rank dump(s), "
              f"{merged['meta']['events']} events -> {out}",
              file=sys.stderr)
    report = critical_path(dumps, straggler_factor=args.straggler_factor)
    if args.json:
        report["flow_stats"] = flow_stats
        print(json.dumps(report))
    else:
        print_report(report, flow_stats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
