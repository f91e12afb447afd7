"""The readings a cell's limits are set from, in one process:

    python3 portbench/calibrate.py --workload <cell> --seeds 1-12 \
        --control-seeds 1-3 --fault-seeds 1-3 [--out FILE]

For each of ``--seeds`` the program's first steps against the reference
(the numbers a run compares; the lower readings); for each of
``--control-seeds`` the control, the reference computed with every
product's operands rounded to fp8, against the reference (the upper
readings); for each of ``--fault-seeds`` the program with each planted
fault the cell can have (``program.Program``'s ``fault``) against the
reference. One JSON line a reading on stdout, and all of them in
``--out``. The PS cells run every seed in one fleet. Needs the card.
"""

import argparse
import contextlib
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FAULTS = ("half_batch", "state_unchanged")
PS_FAULTS = ("no_round_trip",)


def seeds(spec: str) -> list:
    """"1-3,7" -> [1, 2, 3, 7]."""
    out = []
    for part in filter(None, spec.split(",")):
        lo, _, hi = part.partition("-")
        out += range(int(lo), int(hi or lo) + 1)
    return out


def readings(cell, program_seeds, control_seeds, fault_seeds, device,
             emit) -> None:
    import torch

    import byteps_tpu_torch as bps
    from portbench import check
    from portbench.fleet import fleet
    from portbench.program import Program
    from portbench.run import CHECKED_STEPS, log

    os.environ.update(cell.traffic.get("env", {}))
    ps = cell.traffic["mode"] == "ps"
    wanted = {}

    def reference(seed):
        if seed not in wanted:
            wanted[seed] = check.reference_steps(cell, seed, device,
                                                 CHECKED_STEPS)
        return wanted[seed]

    faults = FAULTS + (PS_FAULTS if ps else ())
    runs = ([(s, "") for s in program_seeds]
            + [(s, f) for s in fault_seeds for f in faults])
    fleet_or_none = (fleet(cell.traffic["fleet"], log) if ps
                     else contextlib.nullcontext())
    with fleet_or_none:
        bps.init(device=device)
        try:
            for seed, fault in runs:
                t0 = time.perf_counter()
                prog = Program(cell, seed, device, fault)
                got = prog.first_steps(CHECKED_STEPS)
                del prog
                gc.collect()
                torch.cuda.empty_cache()
                emit({"kind": fault or "program", "seed": seed,
                      "numbers": check.numbers(got, reference(seed)),
                      "losses": got["losses"],
                      "reference_losses": reference(seed)["losses"],
                      "seconds": time.perf_counter() - t0})
        finally:
            bps.shutdown()
    for seed in control_seeds:
        got = check.reference_steps(cell, seed, device, CHECKED_STEPS,
                                    fp8=True)
        emit({"kind": "control_fp8", "seed": seed,
              "numbers": check.numbers(got, reference(seed)),
              "losses": got["losses"],
              "reference_losses": reference(seed)["losses"]})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="1-12")
    p.add_argument("--control-seeds", default="1-3")
    p.add_argument("--fault-seeds", default="1-3")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)

    import torch

    from portbench.cell import load
    if not torch.cuda.is_available():
        print("calibrate.py needs the card", file=sys.stderr)
        return 2
    cell = load(args.workload)
    lines = []

    def emit(rec):
        rec = dict(rec, cell=cell.name)
        lines.append(rec)
        print(json.dumps(rec), flush=True)

    readings(cell, seeds(args.seeds), seeds(args.control_seeds),
             seeds(args.fault_seeds), torch.device("cuda", 0), emit)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            for rec in lines:
                f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    # The benchmark's modules are ``portbench.*``, imported from the
    # checkout's root; this script's own directory would shadow the
    # standard library's ``trace`` with ``portbench/trace.py``.
    sys.path[0] = ROOT
    sys.exit(main())
