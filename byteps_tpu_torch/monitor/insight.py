"""Online per-round bottleneck attribution + fleet-state classification
(round insight).

The C core keeps a per-round summary ring on every rank (csrc/
roundstats.h): per-stage wall time, wire bytes/frames, retries, parked
ops. Workers piggyback completed rounds on their heartbeats; the
scheduler folds them into per-rank EWMA baselines and a fleet round
table, served raw at the monitor endpoint's ``/rounds`` path
(``bps_round_summary``). This module is the judgment layer on top:

- ``dominant_stage``   — which stage bound a round record;
- ``classify``         — the fleet state: ``wire-bound`` /
  ``sum-bound`` / ``straggler-skewed`` / ``retry-degraded`` /
  ``healthy``;
- ``regressions``      — ranks whose latest round wall blew past their
  EWMA baseline;
- ``hints``            — *advisory* tuning hints naming the knob (e.g.
  "wire msgs dominate -> raise BYTEPS_FUSION_BYTES"). Hints only, no
  actuation: this PR is the sensor; the closed-loop controller
  (ROADMAP item 3) consumes the same classification as its input.

``python -m byteps_tpu_torch.monitor.insight --watch`` scrapes the
scheduler's ``/rounds`` endpoint and prints a live scrolling per-round
report; ``monitor.top`` reuses ``classify``/``dominant_stage`` for its
BOTTLENECK column and fleet-state header.

Stage taxonomy (docs/monitoring.md "Round insight"): ``queue``
(scheduled-queue wait), ``compress`` (codec + qencode), ``wire_ack``
(push wall minus the server's ack-reported sum time: wire transit,
server queueing, ack return), ``server_sum`` (decode+sum on the
server), ``pull_wait`` (pull issue -> response; includes waiting for
PEERS' pushes — the straggler signal), ``decode`` (decompress +
qdecode).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
import urllib.request
from typing import Dict, Iterable, List, Optional, Tuple

# Attribution stages, in report order. Keys into a breakdown dict.
STAGES = ("queue", "compress", "wire_ack", "server_sum", "pull_wait",
          "decode")

# Stages the fleet-state dominance rule considers: the ACTIVE stages —
# time something was being computed or carried. The two WAIT stages are
# deliberately excluded from dominance:
#  - pull_wait is mostly the echo of PEERS' bottlenecks (a pull waits
#    for every other rank's push to land), so in a symmetric
#    wire-bound fleet it mirrors wire_ack and would split the dominant
#    share in half; skew in it is caught by the straggler rule;
#  - queue wait is the echo of DOWNSTREAM serialization, quadratically:
#    with a backlog of N tasks the k-th waits k x the per-task send
#    time, so the queue total is ~N/2 x the wire total for ANY
#    wire-gated round — dominance over it would classify every
#    backlogged round "queue-bound" regardless of what actually gates
#    the drain rate.
# Both stay in the per-rank breakdown, the BOTTLENECK column, and the
# hints (where "mostly waiting" is exactly the informative reading).
ATTRIB_STAGES = ("compress", "wire_ack", "server_sum", "decode")

# A stage must own at least this share of the round wall before the
# fleet is declared BOUND on it; below, no single stage gates the round
# and the state is healthy.
DOMINANCE_SHARE = 0.4

# Straggler rule: same shape as monitor.top's — a rank whose mean
# per-partition push wall exceeds factor x the fleet low-median, above
# an absolute floor that keeps loopback microsecond noise quiet.
PUSH_FLOOR_US = 1000.0

# Regression rule: latest round wall vs the rank's EWMA baseline, only
# once the baseline has seen enough rounds to mean something.
REGRESS_FACTOR = 1.5
REGRESS_MIN_UPDATES = 3

FLEET_STATES = ("healthy", "wire-bound", "sum-bound", "straggler-skewed",
                "retry-degraded", "corruption-degraded", "resizing")


def stage_breakdown(rec: dict) -> Dict[str, float]:
    """Per-stage microseconds from one round record (the JSON shape
    ``bps_round_summary`` emits). ``wire_ack`` is derived when absent:
    push wall minus the server-reported sum time."""
    push = float(rec.get("push_us", 0))
    sum_us = float(rec.get("sum_us", 0))
    wire_ack = float(rec.get("wire_ack_us", max(0.0, push - sum_us)))
    return {
        "queue": float(rec.get("queue_us", 0)),
        "compress": float(rec.get("comp_us", 0)),
        "wire_ack": wire_ack,
        "server_sum": min(sum_us, push) if push else sum_us,
        "pull_wait": float(rec.get("pull_us", 0)),
        "decode": float(rec.get("dec_us", 0)),
    }


def round_wall_us(rec: dict) -> float:
    return sum(stage_breakdown(rec).values())


def dominant_stage(rec: dict) -> Tuple[str, float]:
    """(stage, share-of-wall) for the stage that bound this record;
    ("idle", 0.0) for an empty record."""
    bd = stage_breakdown(rec)
    wall = sum(bd.values())
    if wall <= 0:
        return "idle", 0.0
    stage = max(STAGES, key=lambda s: bd[s])
    return stage, bd[stage] / wall


def merge_recs(recs: Iterable[dict]) -> dict:
    """Elementwise sum of round records — the fleet-wide view of one
    round (or of each rank's latest round). ``round`` keeps the max,
    not the sum (it is an identity, not a quantity)."""
    recs = [r for r in recs if r]
    out: Dict[str, float] = {}
    for rec in recs:
        for k, v in rec.items():
            if isinstance(v, (int, float)):
                out[k] = out.get(k, 0) + v
    if recs and "round" in out:
        out["round"] = max(int(r.get("round", -1)) for r in recs)
    return out


def classify(workers: Dict[str, dict], straggler_factor: float = 2.0,
             retry_threshold: int = 1,
             dominance: float = DOMINANCE_SHARE,
             resizing: bool = False,
             tenants: Optional[Dict[str, int]] = None,
             crc_fails: int = 0) -> dict:
    """Fleet state from per-worker round records (one record per
    worker — normally each rank's latest completed round).

    Precedence: a membership epoch change in flight (``resizing``)
    first — a round spanning a join/leave/shrink legitimately stalls
    some ranks behind the commit and would otherwise read as
    straggler-skewed — then wire corruption (``corruption-degraded``,
    driven by the caller-scraped ``crc_fails`` total: CRC-failed frames
    CAUSE the resends, so naming the corruption outranks the generic
    retry state), then faults (``retry-degraded``), then skew
    (``straggler-skewed``), then stage dominance (``wire-bound`` /
    ``sum-bound``); anything else is ``healthy``. Skew outranks
    dominance because a paced straggler ALSO inflates wire shares —
    the skew is the actionable signal there, not the stage.
    """
    workers = {k: v for k, v in workers.items() if v}
    fleet = merge_recs(list(workers.values())) if workers else {}
    bd = stage_breakdown(fleet) if fleet else {}
    attrib_wall = sum(bd.get(s, 0.0) for s in ATTRIB_STAGES)
    if attrib_wall > 0:
        dom = max(ATTRIB_STAGES, key=lambda s: bd[s])
        share = bd[dom] / attrib_wall
    else:
        dom, share = "idle", 0.0
    retries = int(fleet.get("retries", 0))

    # Per-rank mean per-partition push wall (monitor.top's metric).
    push_means = {}
    for name, rec in workers.items():
        parts = int(rec.get("parts", 0))
        if parts > 0:
            push_means[name] = float(rec.get("push_us", 0)) / parts
    baseline = (statistics.median_low(list(push_means.values()))
                if push_means else 0.0)
    stragglers = sorted(
        n for n, m in push_means.items()
        if m >= PUSH_FLOOR_US and m > straggler_factor * baseline)

    if resizing:
        state = "resizing"
    elif crc_fails > 0:
        state = "corruption-degraded"
    elif retries >= retry_threshold:
        state = "retry-degraded"
    elif stragglers:
        state = "straggler-skewed"
    elif dom == "wire_ack" and share >= dominance:
        state = "wire-bound"
    elif dom == "server_sum" and share >= dominance:
        state = "sum-bound"
    else:
        state = "healthy"

    # Noisy-neighbor attribution: when the fleet spans more
    # than one tenant, split the round wall by tenant so a bound/skewed
    # state can NAME the job that owns most of it — the multi-tenant
    # "which neighbor is noisy" question monitor.top and the hints
    # surface.
    tenant_walls: Dict[str, float] = {}
    if tenants and len(set(tenants.values())) > 1:
        for name, rec in workers.items():
            t = str(tenants.get(name, 0))
            tenant_walls[t] = tenant_walls.get(t, 0.0) + round_wall_us(rec)
    total_wall = sum(tenant_walls.values())
    noisy = None
    if total_wall > 0:
        top = max(tenant_walls, key=lambda t: tenant_walls[t])
        if tenant_walls[top] / total_wall >= 0.6:
            noisy = top
    return {
        "state": state,
        "dominant": dom,
        "dominant_share": round(share, 3),
        "fleet": fleet,
        "stragglers": stragglers,
        "baseline_push_us": baseline,
        "retries": retries,
        "tenant_walls": {t: round(v, 1) for t, v in tenant_walls.items()},
        "noisy_tenant": noisy,
    }


def regressions(fleet: Dict[str, dict],
                factor: float = REGRESS_FACTOR) -> List[str]:
    """Ranks whose latest round wall exceeds factor x their EWMA
    baseline (``fleet`` is the scheduler snapshot's per-rank section:
    {node: {"last": rec, "ewma_wall_us": x, "updates": n}})."""
    out = []
    for node, st in fleet.items():
        if int(st.get("updates", 0)) < REGRESS_MIN_UPDATES:
            continue
        ewma = float(st.get("ewma_wall_us", 0.0))
        if ewma > 0 and round_wall_us(st.get("last", {})) > factor * ewma:
            out.append(node)
    return sorted(out)


def hints(state: str, fleet_rec: dict) -> List[str]:
    """Advisory tuning hints naming the knob. NEVER actuated here —
    the observability layer stays a sensor (docs/monitoring.md)."""
    out: List[str] = []
    parts = max(1, int(fleet_rec.get("parts", 0)))
    msgs_per_part = float(fleet_rec.get("wire_msgs", 0)) / parts
    fused = int(fleet_rec.get("fused_frames", 0))
    bd = stage_breakdown(fleet_rec)
    wall = sum(bd.values()) or 1.0
    if state == "wire-bound":
        if msgs_per_part > 1.5 and fused == 0:
            out.append(
                "wire_msgs dominate (%.1f frames/partition, none fused)"
                " -> raise BYTEPS_FUSION_BYTES so small tensors coalesce"
                % msgs_per_part)
        else:
            out.append(
                "wire transit bounds the round -> raise "
                "BYTEPS_VAN_STREAMS (per-stream cwnd cap) and check "
                "BYTEPS_SOCKET_BUF >= the link BDP")
    elif state == "sum-bound":
        out.append(
            "server summation bounds the round -> raise "
            "BYTEPS_SERVER_ENGINE_THREAD or add server ranks "
            "(DMLC_NUM_SERVER)")
    elif state == "straggler-skewed":
        out.append(
            "one rank's push wall gates the fleet -> inspect that "
            "host's NIC/pacing/CPU before touching fleet-wide knobs")
    elif state == "retry-degraded":
        out.append(
            "resends are burning round time -> inspect link loss; if "
            "rounds are healthy-but-slow, raise BYTEPS_RETRY_TIMEOUT_MS "
            "so the timer stops re-sending live requests")
    elif state == "corruption-degraded":
        out.append(
            "frames are failing CRC32C verification (bps_crc_fail_total "
            "climbing) -> the wire is corrupting data, not just losing "
            "it; check NICs/cables on the flagged link, arm "
            "BYTEPS_WIRE_CRC_QUARANTINE to force re-dials, and expect a "
            "named fail-stop if the corruption survives fresh sockets")
    elif state == "resizing":
        out.append(
            "a worker membership epoch change is committing -> "
            "transient; re-check once bps_fleet_resizing drops to 0 "
            "(stuck past BYTEPS_ELASTIC_TIMEOUT_MS would fail-stop)")
    if bd["queue"] / wall >= DOMINANCE_SHARE:
        out.append(
            "scheduled-queue wait dominates the wall -> raise "
            "BYTEPS_SCHEDULING_CREDIT if credit-limited; otherwise the "
            "queue is draining at the bound stage's rate (fix that "
            "first)")
    if bd["compress"] / wall >= DOMINANCE_SHARE:
        out.append(
            "encode cost dominates -> larger BYTEPS_WIRE_QUANT_BLOCK "
            "(fewer scales) or drop the codec on small keys "
            "(BYTEPS_WIRE_QUANT_MIN_BYTES)")
    if int(fleet_rec.get("parked", 0)) > parts:
        out.append(
            "server parks exceed partitions -> deep pipelining is "
            "outrunning slot recycling; fewer in-flight rounds or more "
            "servers")
    return out


def window_recs(summary: dict, window: int) -> Dict[str, dict]:
    """Per-worker records merged over each worker's last ``window``
    completed rounds in the scheduler's ``fleet_rounds`` table. A
    single round's record is pacing-sensitive (one scheduler hiccup on
    a loaded box flips its ratios); summing a small completed-round
    window classifies on the same share arithmetic but over a stable
    base — the deflake contract for the straggler fleet test. Falls
    back to each rank's ``last`` record when the table is empty or
    ``window`` <= 1."""
    fleet = summary.get("fleet", {}) or {}
    last = {node: st.get("last", {}) for node, st in fleet.items()
            if st.get("role") == 2}
    table = summary.get("fleet_rounds", {}) or {}
    if window <= 1 or not table:
        return last
    by_node: Dict[str, List[dict]] = {}
    for rnd in sorted(table, key=int, reverse=True):
        for node, rec in table[rnd].items():
            if node not in last:
                continue  # non-worker rank
            recs = by_node.setdefault(node, [])
            if len(recs) < window:
                recs.append(rec)
    return {node: merge_recs(recs) for node, recs in by_node.items()} \
        or last


def analyze(summary: dict, straggler_factor: float = 2.0,
            regress_factor: float = REGRESS_FACTOR,
            window: int = 1) -> dict:
    """Full report from one ``bps_round_summary`` snapshot (normally the
    SCHEDULER's, whose ``fleet`` section holds every rank's summaries).
    Falls back to the local ring when no fleet data is present.
    ``window`` > 1 classifies over each worker's last N completed
    rounds instead of a single pacing-sensitive one (see window_recs)."""
    fleet = summary.get("fleet", {}) or {}
    workers = window_recs(summary, window)
    local_only = False
    if not workers:
        last = summary.get("last")
        workers = {str(summary.get("node_id", -1)): last} if last else {}
        local_only = True
    tenants = {node: int(st.get("tenant", 0))
               for node, st in fleet.items() if st.get("role") == 2}
    rep = classify(workers, straggler_factor=straggler_factor,
                   resizing=bool(summary.get("resizing", 0)),
                   tenants=tenants)
    rep["regressions"] = regressions(
        {n: st for n, st in fleet.items() if st.get("role") == 2},
        factor=regress_factor)
    rep["hints"] = hints(rep["state"], rep["fleet"])
    # Noisy-neighbor hint: name the tenant, not just the
    # stage — on a shared fleet the actionable knob is that job's
    # BYTEPS_TENANT_WEIGHT (or its own pacing), not a fleet-wide one.
    if rep.get("noisy_tenant") is not None:
        walls = rep.get("tenant_walls", {})
        total = sum(walls.values()) or 1.0
        share = walls.get(rep["noisy_tenant"], 0.0) / total
        rep["hints"].append(
            "tenant %s owns %.0f%% of the fleet round wall -> the "
            "noisy neighbor; rebalance BYTEPS_TENANT_WEIGHT or pace "
            "that job before touching fleet-wide knobs"
            % (rep["noisy_tenant"], share * 100))
    rep["local_only"] = local_only
    rep["workers"] = workers
    rep["rounds_seen"] = sorted(
        int(r) for r in summary.get("fleet_rounds", {}))
    return rep


# --- live CLI ---------------------------------------------------------------

def _fmt_us(us: float) -> str:
    return f"{us / 1e3:.2f}ms" if us >= 1000 else f"{us:.0f}us"


# Classification -> journal code (EV_INSIGHT a0; the catalog lives in
# csrc/events.h and docs/monitoring.md "Event catalog"). Stable wire
# values: append, never renumber.
STATE_CODES = {
    "healthy": 0, "wire-bound": 1, "sum-bound": 2,
    "straggler-skewed": 3, "retry-degraded": 4,
    "corruption-degraded": 5, "resizing": 6, "idle": 7,
}


def journal_state(endpoint: str, state: str, prev_state: str,
                  timeout: float = 2.0) -> bool:
    """Journal a classification FLIP onto the fleet event timeline
    (POST /events, type=insight, a0=new code, a1=old code) so a
    performance regression lands next to the lifecycle events that
    explain it in `monitor.incident`. Edge-triggered by the caller —
    posting every poll would bury the timeline. Best-effort: False
    (and no raise) when the endpoint is unreachable."""
    body = json.dumps({
        "type": "insight",
        "a0": STATE_CODES.get(state, -1),
        "a1": STATE_CODES.get(prev_state, -1),
    }).encode()
    req = urllib.request.Request(
        f"http://{endpoint}/events", data=body,
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status == 200
    except (OSError, ValueError):
        return False


def scrape_rounds(endpoint: str, timeout: float = 2.0) -> Optional[dict]:
    """Fetch one /rounds snapshot; None when unreachable."""
    try:
        with urllib.request.urlopen(f"http://{endpoint}/rounds",
                                    timeout=timeout) as r:
            return json.loads(r.read().decode())
    except (OSError, ValueError):
        return None


def print_round_line(round_no: int, recs: Dict[str, dict],
                     file=None) -> None:
    """One scrolling line per fleet round: wall, bottleneck, state."""
    out = file or sys.stdout
    fleet = merge_recs(list(recs.values()))
    dom, share = dominant_stage(fleet)
    rep = classify(recs)
    print(f"round {round_no:>6}  wall {_fmt_us(round_wall_us(fleet)):>9}  "
          f"bottleneck {dom}({share * 100:.0f}%)  "
          f"state {rep['state'].upper()}  "
          f"wire {int(fleet.get('wire_bytes', 0)) >> 10}K/"
          f"{int(fleet.get('wire_msgs', 0))}msg"
          + (f"  retries {int(fleet.get('retries', 0))}"
             if fleet.get("retries") else ""), file=out,
          flush=True)  # watch mode is tail/pipe-friendly


def print_report(rep: dict, file=None) -> None:
    out = file or sys.stdout
    print(f"fleet state: {rep['state'].upper()} "
          f"(bottleneck {rep['dominant']} "
          f"{rep['dominant_share'] * 100:.0f}% of round wall"
          + (", local ring only — scrape the scheduler for fleet view"
             if rep.get("local_only") else "") + ")", file=out)
    bd = stage_breakdown(rep["fleet"])
    print("  " + "  ".join(f"{s}={_fmt_us(bd[s])}" for s in STAGES),
          file=out)
    if rep["stragglers"]:
        print(f"  stragglers: {rep['stragglers']} "
              f"(baseline push {_fmt_us(rep['baseline_push_us'])}/part)",
              file=out)
    if rep["regressions"]:
        print(f"  regressions vs EWMA baseline: {rep['regressions']}",
              file=out)
    for h in rep["hints"]:
        print(f"  hint: {h}", file=out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m byteps_tpu_torch.monitor.insight",
        description="live per-round bottleneck attribution from the "
                    "scheduler's fleet round table "
                    "(docs/monitoring.md 'Round insight')")
    p.add_argument("--endpoint", default="",
                   help="scheduler monitor endpoint host:port (default: "
                        "DMLC_PS_ROOT_URI:BYTEPS_MONITOR_PORT — the "
                        "scheduler is node 0, so the base port IS its "
                        "port)")
    p.add_argument("--watch", type=float, metavar="SECONDS", default=0,
                   help="poll every N seconds, printing one line per "
                        "newly completed fleet round")
    p.add_argument("--straggler-factor", type=float,
                   default=float(os.environ.get("BYTEPS_STRAGGLER_FACTOR",
                                                "2.0")))
    p.add_argument("--json", action="store_true",
                   help="machine-readable report (one JSON object per "
                        "poll)")
    p.add_argument("--window", type=int, default=1,
                   help="classify over each worker's last N completed "
                        "rounds instead of only the latest (stable "
                        "under scheduler-noise; default 1)")
    args = p.parse_args(argv)

    endpoint = args.endpoint or "%s:%s" % (
        os.environ.get("DMLC_PS_ROOT_URI", "127.0.0.1"),
        os.environ.get("BYTEPS_MONITOR_PORT", "9100"))
    last_printed = -1
    last_state = None
    while True:
        summary = scrape_rounds(endpoint)
        if summary is None:
            print(f"endpoint {endpoint} unreachable — is the scheduler "
                  "running with BYTEPS_MONITOR_ON=1?", file=sys.stderr)
            if not args.watch:
                return 1
            time.sleep(args.watch)
            continue
        rep = analyze(summary, straggler_factor=args.straggler_factor,
                      window=args.window)
        # Journal flips only: the first poll seeds the edge
        # detector without posting, so attaching insight to a long-
        # degraded fleet doesn't misreport the attach as a transition.
        if last_state is not None and rep["state"] != last_state:
            journal_state(endpoint, rep["state"], last_state)
        last_state = rep["state"]
        if args.json:
            rep2 = dict(rep)
            print(json.dumps(rep2))
        elif args.watch:
            table = summary.get("fleet_rounds", {})
            for rnd in sorted(int(r) for r in table):
                if rnd > last_printed:
                    print_round_line(rnd, table[str(rnd)])
                    last_printed = rnd
        else:
            print_report(rep)
        if not args.watch:
            return 0 if rep["state"] == "healthy" else 2
        time.sleep(args.watch)


if __name__ == "__main__":
    sys.exit(main())
