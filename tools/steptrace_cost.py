#!/usr/bin/env python3
"""What the step trace (``byteps_tpu_torch.utils.timeline.start_steps``)
costs a training step, on the card.

    python3 tools/steptrace_cost.py --workload <cell> [--seed N]
        [--rounds R] [--block K]

Builds a benchmark cell's program as ``portbench/run.py`` does (its PS
fleet for a PS cell, the weights and batches from ``--seed``), runs the
traffic's warm-up, then R rounds of a block of K steps of each side, the
sides' order rotating each round:

- ``untraced``: the steps as the benchmark's window runs them;
- ``traced``: one ``start_steps`` / ``stop_steps`` around the block,
  outside the steps' own clocks;
- ``core_only``: the core's trace ring armed (``ffi.trace_arm``) and no
  step trace (PS cells);
- ``host_only``: the step trace with the core's ring disarmed (PS
  cells).

Prints one JSON line: each side's median and quartiles of the step's
host time (``Program.step``: zero_grad to the loss read back) and the
medians of its phases (forward, backward and optimizer step returned,
loss read), each block's median, each side's cost over the untraced
median, the records and gaps the traced blocks held, and the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _quartiles(xs):
    q = statistics.quantiles(xs, n=4)
    return {"median": statistics.median(xs), "q1": q[0], "q3": q[2],
            "n": len(xs)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=1234567)
    p.add_argument("--rounds", type=int, default=6)
    p.add_argument("--block", type=int, default=10)
    args = p.parse_args(argv)

    import contextlib

    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.core import ffi
    from byteps_tpu_torch.utils import timeline
    from portbench.cell import load
    from portbench.fleet import fleet
    from portbench.program import Program

    cell = load(args.workload)
    traffic = cell.traffic
    os.environ.update(traffic.get("env", {}))
    ps = traffic["mode"] == "ps"
    device = torch.device("cuda", 0)
    sides = (["untraced", "traced", "core_only", "host_only"] if ps
             else ["untraced", "traced"])
    steps = {k: [] for k in sides}
    blocks = {k: [] for k in sides}
    held = {"records": 0, "gaps": 0, "gap_s": 0.0}
    with fleet(traffic["fleet"]) if ps else contextlib.nullcontext():
        bps.init(device=device)
        try:
            prog = Program(cell, args.seed, device)
            for _ in range(traffic["warmup_steps"]):
                prog.step()
            torch.cuda.synchronize()
            for r in range(args.rounds):
                for side in sides[r % len(sides):] + sides[:r % len(sides)]:
                    if side in ("traced", "host_only"):
                        timeline.start_steps()
                    if side == "host_only":
                        ffi.trace_arm(False)
                    if side == "core_only":
                        ffi.trace_arm(True)
                    got = [prog.step() for _ in range(args.block)]
                    if side == "core_only":
                        ffi.trace_arm(False)
                        bps._st().ps_client.dump_trace(os.devnull)
                    if side in ("traced", "host_only"):
                        out = timeline.stop_steps()
                        held["records"] += len(out["records"])
                        held["gaps"] += len(out["gaps"])
                        held["gap_s"] += sum(g.seconds for g in out["gaps"])
                    steps[side] += got
                    blocks[side].append(statistics.median(
                        (s["end"] - s["start"]) * 1e3 for s in got))
            del prog
        finally:
            bps.shutdown()
    phases = (("forward", "start", "fwd_end"), ("backward", "fwd_end",
              "bwd_end"), ("opt_step", "bwd_end", "opt_end"),
              ("loss_read", "opt_end", "end"))
    report = {}
    for side in sides:
        report[side] = dict(
            _quartiles([(s["end"] - s["start"]) * 1e3 for s in steps[side]]),
            phases_ms={name: statistics.median((s[b] - s[a]) * 1e3
                                               for s in steps[side])
                       for name, a, b in phases},
            blocks_ms=blocks[side])
    base = report["untraced"]["median"]
    print(json.dumps({
        "workload": cell.name, "seed": args.seed, "rounds": args.rounds,
        "block": args.block, "sides": report,
        "cost_pct": {k: 100 * (v["median"] / base - 1)
                     for k, v in report.items() if k != "untraced"},
        "held": held, "card": _card(), "at": time.time()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT
    sys.exit(main())
