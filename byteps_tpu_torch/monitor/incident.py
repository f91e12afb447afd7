"""One-command incident reports from the fleet event journal.

The scheduler's journal (``/events`` on its monitor endpoint, or the
``bps_events_summary`` probe) already holds everything a post-mortem
opens with: the clock-aligned fleet timeline of lifecycle events
(pauses, deaths, recoveries, scheduler fail-over, checkpoint seals,
CRC quarantines, ...), plus bounded history rings sampled from every
registered gauge. This module turns one journal snapshot — live-scraped
or saved to a file — into a readable report, and stitches in the
flight-recorder dumps each crisis left behind, matched by
role/node and overlapped against the same scheduler timebase.

Usage::

    python -m byteps_tpu_torch.monitor.incident --url http://host:9100
    python -m byteps_tpu_torch.monitor.incident --file events.json \
        --dir traces/ --window-s 120
    python -m byteps_tpu_torch.monitor.incident --file events.json --json

``--window-s N`` keeps the LAST N seconds of the timeline (measured
back from its newest event); ``--since-us`` / ``--until-us`` pin an
explicit aligned-timestamp window instead. The same functions are
importable for tests and tooling: ``load_events`` / ``stitch_flights``
/ ``build_report`` / ``render_report``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import urllib.request
from typing import List, Optional

from byteps_tpu_torch.monitor import timeline as _timeline

# Event types whose presence makes a window an "incident" rather than
# routine churn — the report leads with these (csrc/events.h catalog).
_SEVERE = {
    "epoch_pause", "fleet_pause", "death", "sched_park", "shutdown",
    "crc_quarantine", "crc_failstop", "ckpt_restore", "replica_lag",
    "tenant_starved",
}

# ...and the ones that close an episode the severe set opened.
_RESOLVING = {
    "epoch_resume", "fleet_resume", "server_recover",
    "sched_recovery_commit", "join",
}


def load_events(url: Optional[str] = None,
                file: Optional[str] = None,
                timeout: float = 5.0) -> dict:
    """One journal snapshot: scrape ``<url>/events`` or read a saved
    JSON file; with neither, probe the in-process journal (the FFI
    path — useful from tests and notebooks living inside a rank)."""
    if url:
        full = url.rstrip("/") + "/events"
        with urllib.request.urlopen(full, timeout=timeout) as r:
            return json.loads(r.read().decode())
    if file:
        with open(file) as f:
            return json.load(f)
    from byteps_tpu_torch.core.ffi import events_summary
    return events_summary()


def _window(journal: dict, since_us: Optional[int],
            until_us: Optional[int],
            window_s: Optional[float]) -> tuple:
    """Resolve the report's [since, until] aligned-timestamp window.
    The scheduler's own events are already on its timebase; a rank's
    local ring (no ingest) serves as the timeline fallback so the
    command still works pointed at a worker."""
    evs = journal.get("timeline") or journal.get("events") or []
    ts = [e["ts_us"] for e in evs if "ts_us" in e]
    lo = min(ts) if ts else 0
    hi = max(ts) if ts else 0
    if window_s is not None:
        lo = hi - int(window_s * 1e6)
    if since_us is not None:
        lo = since_us
    if until_us is not None:
        hi = until_us
    return lo, hi


def stitch_flights(trace_dir: str,
                   pattern: str = "flight_*.json") -> List[dict]:
    """Summarise every flight-recorder dump under ``trace_dir`` on the
    scheduler timebase: who dumped (role/node/incarnation), why
    (``meta.reason`` — the FlightDumpAuto trigger), and the aligned
    time span its ring covers, so the report can point each journal
    event at the dump that holds its microscale evidence."""
    out = []
    for d in _timeline.gather(trace_dir, pattern):
        meta = d.get("meta", {})
        offset = int(meta.get("clock_offset_us", 0) or 0)
        ts = [e["ts"] + offset for e in d.get("traceEvents", [])
              if "ts" in e]
        out.append({
            "path": meta.get("path", ""),
            "role": meta.get("role", -1),
            "node_id": meta.get("node_id", -1),
            "incarnation": _timeline._incarnation(meta),
            "label": _timeline._rank_label(meta),
            "reason": meta.get("reason", ""),
            "events": len(ts),
            "dropped": meta.get("dropped", 0),
            "first_ts_us": min(ts) if ts else -1,
            "last_ts_us": max(ts) if ts else -1,
        })
    out.sort(key=lambda f: (f["first_ts_us"], f["node_id"]))
    return out


def build_report(journal: dict,
                 flights: Optional[List[dict]] = None,
                 since_us: Optional[int] = None,
                 until_us: Optional[int] = None,
                 window_s: Optional[float] = None) -> dict:
    """Assemble the incident document: the in-window slice of the
    fleet timeline (falling back to the local ring off-scheduler),
    in-window metric history, per-type counts, and — when flight dumps
    were stitched in — each dump matched against the window."""
    lo, hi = _window(journal, since_us, until_us, window_s)
    evs = journal.get("timeline") or journal.get("events") or []
    inwin = [e for e in evs if lo <= e.get("ts_us", 0) <= hi]
    counts: dict = {}
    for e in inwin:
        counts[e.get("name", "?")] = counts.get(e.get("name", "?"), 0) + 1
    history = {}
    for name, samples in (journal.get("history") or {}).items():
        kept = [s for s in samples if lo <= s[0] <= hi]
        if kept:
            history[name] = {
                "samples": len(kept),
                "first": kept[0][1], "last": kept[-1][1],
                "min": min(s[1] for s in kept),
                "max": max(s[1] for s in kept),
            }
    matched = []
    for fl in flights or []:
        fl = dict(fl)
        # A dump "covers" the window when its ring span overlaps it —
        # empty dumps (or never-aligned rings) are kept but flagged, so
        # a rank that died before its clock exchange still shows up.
        fl["in_window"] = (fl["events"] > 0 and fl["last_ts_us"] >= lo
                           and fl["first_ts_us"] <= hi)
        matched.append(fl)
    return {
        "source": {
            "role": journal.get("role", -1),
            "node_id": journal.get("node_id", -1),
            "on": journal.get("on", False),
            "scheduler": bool(journal.get("timeline")),
            "emitted_total": journal.get("emitted_total", 0),
            "ingested_total": journal.get("ingested_total", 0),
            "dropped": journal.get("dropped", 0),
            "timeline_dropped": journal.get("timeline_dropped", 0),
        },
        "window_us": [lo, hi],
        "events": inwin,
        "counts": counts,
        "severe": sorted(k for k in counts if k in _SEVERE),
        "resolved": sorted(k for k in counts if k in _RESOLVING),
        "history": history,
        "flights": matched,
    }


_ROLE = {0: "sched", 1: "server", 2: "worker"}


def _fmt_ev(e: dict, t0: int) -> str:
    dt = (e.get("ts_us", 0) - t0) / 1e6
    who = f"{_ROLE.get(e.get('role', -1), '?')}/n{e.get('node', -1)}"
    args = ",".join(str(e.get(k, 0)) for k in ("a0", "a1", "a2"))
    return (f"  +{dt:10.3f}s  {e.get('name', '?'):<22} {who:<12} "
            f"args=[{args}]")


def render_report(report: dict, file=None) -> None:
    """Human-readable post-mortem: verdict line, ordered timeline,
    metric history extremes, and the flight dumps to open next."""
    out = file or sys.stdout
    src = report["source"]
    lo, hi = report["window_us"]
    span = max(0, hi - lo) / 1e6
    where = "scheduler journal" if src["scheduler"] else (
        f"local ring ({_ROLE.get(src['role'], '?')}/n{src['node_id']})")
    print(f"incident report — {where}, {len(report['events'])} "
          f"event(s) over {span:.1f}s", file=out)
    if report["severe"]:
        closing = (f"; resolved by: {', '.join(report['resolved'])}"
                   if report["resolved"] else "; NOT resolved in window")
        print(f"  severe: {', '.join(report['severe'])}{closing}",
              file=out)
    elif report["events"]:
        print("  no severe lifecycle events in window (routine churn)",
              file=out)
    else:
        print("  journal empty in window — widen it (--window-s) or "
              "point --url/--file at the scheduler", file=out)
    lost = src["dropped"] + src["timeline_dropped"]
    if lost:
        print(f"  WARNING: {lost} event(s) dropped before this "
              "snapshot (raise BYTEPS_EVENTS_RING)", file=out)
    print("timeline (scheduler timebase):", file=out)
    for e in report["events"]:
        print(_fmt_ev(e, lo), file=out)
    if report["history"]:
        print("metric history (in-window):", file=out)
        for name, h in sorted(report["history"].items()):
            print(f"  {name:<34} first={h['first']} last={h['last']} "
                  f"min={h['min']} max={h['max']} "
                  f"({h['samples']} samples)", file=out)
    if report["flights"]:
        print("flight-recorder dumps:", file=out)
        for fl in report["flights"]:
            flag = "in-window" if fl["in_window"] else "outside window"
            why = f" reason={fl['reason']}" if fl["reason"] else ""
            print(f"  {fl['label']}: {fl['path']} "
                  f"({fl['events']} events, {flag}){why}", file=out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m byteps_tpu_torch.monitor.incident",
        description="render a post-mortem report from the fleet event "
                    "journal (docs/monitoring.md, "
                    "docs/troubleshooting.md)")
    p.add_argument("--url", default="",
                   help="monitor endpoint base URL (scrapes <url>/"
                        "events); point it at the SCHEDULER for the "
                        "fleet timeline")
    p.add_argument("--file", default="",
                   help="saved /events (or bps_events_summary) JSON")
    p.add_argument("--dir", default=os.environ.get("BYTEPS_TRACE_DIR")
                   or os.environ.get("BPS_TRACE_OUT") or "",
                   help="trace directory to stitch flight dumps from "
                        "(default: BYTEPS_TRACE_DIR; '' = skip)")
    p.add_argument("--window-s", type=float, default=None,
                   help="keep only the last N seconds of the timeline")
    p.add_argument("--since-us", type=int, default=None,
                   help="window start (aligned us)")
    p.add_argument("--until-us", type=int, default=None,
                   help="window end (aligned us)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable report (one JSON line)")
    args = p.parse_args(argv)

    try:
        journal = load_events(url=args.url or None,
                              file=args.file or None)
    except Exception as e:
        print(f"cannot load journal: {e}", file=sys.stderr)
        return 1
    flights = stitch_flights(args.dir) if args.dir else []
    report = build_report(journal, flights, since_us=args.since_us,
                          until_us=args.until_us,
                          window_s=args.window_s)
    if args.json:
        print(json.dumps(report))
    else:
        render_report(report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
