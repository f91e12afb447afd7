"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A run starts the cell's PS fleet (PS cells), makes the weights and the
batch pool on the card from ``--seed``, builds the program
(``program.Program``: the port's model under ``bps.DistributedOptimizer``),
drives it through its first steps (the ones the reference follows) and
the rest of the traffic's warm-up, measures for ``--seconds``, shuts the
fleet down, holds the first steps against the plain reference
(``check``), and prints one JSON line: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``check``, each number compared beside its
limit. It exits non-zero with no result line when the card is missing,
when anything fails, or when JAX or the JAX package was loaded.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHECKED_STEPS = 3
# Top-level module names a run may not load (whole names: the port's
# ``byteps_tpu_torch`` begins with ``byteps_tpu``).
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "byteps_tpu")


def log(*a):
    """A line on stderr behind the seconds since the process started."""
    print(f"[{time.perf_counter() - _T0:7.1f} s]", *a, file=sys.stderr,
          flush=True)


def forbidden_modules() -> list:
    return sorted({m.partition(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def _window(prog, seconds: float, sync, van=None) -> tuple:
    """Steps until ``seconds`` have passed (the step in flight finishes),
    closed by a synchronize: (steps, the window's seconds)."""
    steps = []
    sync()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        s = prog.step()
        if van is not None:
            s["van"] = van()
        steps.append(s)
        if s["end"] >= deadline:
            break
    sync()
    return steps, time.perf_counter() - t0


def run(cell, seed: int, seconds: float, traced: bool, device, t0=_T0,
        fault: str = "") -> dict:
    """One run of ``cell`` on ``device``: the result line's fields."""
    import torch

    import byteps_tpu_torch as bps
    from portbench import check, trace
    from portbench.clock import Anchors, paced_idle, window_busy
    from portbench.fleet import fleet
    from portbench.program import Program
    from portbench.stats import percentile

    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    traffic = cell.traffic
    os.environ.update(traffic.get("env", {}))
    ps = traffic["mode"] == "ps"
    out = {"device": {}}
    log("imports done")
    with fleet(traffic["fleet"], log) if ps else contextlib.nullcontext():
        bps.init(device=device)
        log("bps.init returned")
        prog = None
        try:
            prog = Program(cell, seed, device, fault)
            log("program built")
            first = prog.first_steps(CHECKED_STEPS)
            log("first steps' losses:", first["losses"])
            for _ in range(traffic["warmup_steps"] - CHECKED_STEPS):
                prog.step()
            sync()
            setup_s = time.perf_counter() - t0
            log(f"set-up {setup_s} s; window of {seconds} s")
            peak = torch.cuda.max_memory_allocated() if on_card else 0
            if not traced:
                steps, window_s = _window(prog, seconds, sync)
                ms = [(s["end"] - s["start"]) * 1e3 for s in steps]
                e2e = {"samples_per_s": sum(s["samples"] for s in steps)
                       / window_s,
                       "step_ms_p90": percentile(ms, 90),
                       "setup_s": setup_s}
                log(f"{len(steps)} steps in {window_s} s; step ms median "
                    f"{percentile(ms, 50)} p90 {percentile(ms, 90)}")
                # ``<quantity>.<group>`` (``samples_per_s.ps``) is the
                # quantity, in the cells that the manifest lists for it,
                # under a bound of its own
                out["metrics"] = {m["name"]: {
                    "value": e2e[m["name"].partition(".")[0]],
                    "unit": m["unit"]} for m in cell.end_to_end}
            else:
                torch.cuda.reset_peak_memory_stats()
                rec = {"cell": cell, "seed": seed, "live": prog, "log": log}
                van = trace.van_bytes if ps else None
                if ps:
                    rec["van_start"] = trace.van_bytes()
                anchors = Anchors()
                prog.mark = True
                anchors.start()
                steps, window_s = _window(prog, seconds, sync, van)
                anchors.stop()
                prog.mark = False
                card = []  # (start, backward, resume, end) on the host
                for s in steps:
                    s["bwd_card"] = anchors.on_host(s.pop("bwd_event"))
                    landed = s["timings"].get("landed", s["bwd_card"])
                    card.append((anchors.on_host(s.pop("start_event")),
                                 s["bwd_card"], max(s["bwd_card"], landed),
                                 anchors.on_host(s.pop("end_event"))))
                rec.update(steps=steps, window_s=window_s,
                           peak_bytes=torch.cuda.max_memory_allocated())
                log(f"{len(steps)} traced steps in {window_s} s")
                out["metrics"] = trace.read_metrics(rec, cell.per_layer, log)
                out["breakdown"] = trace.breakdown(rec, log)
                # Read over the window's own steps, from its first step's
                # start: the card's span of each step (events at its start,
                # after backward() and after step()), less the PS round
                # trip's wait and the idle the host's pace leaves in a
                # forward and backward (``clock.paced_idle``), the card
                # idle between steps (``clock.window_busy``). Beside it
                # ``busy_s_probe``: one probe step's card time after the
                # window (``trace.card_busy``) times the window's steps.
                paced = paced_idle(trace.paced_pairs(rec), [
                    (b - a) * 1e3 for a, b, _, _ in card])
                log("paced idle: " + json.dumps(paced))
                opened = steps[0]["start"]
                busy = window_busy(card, paced["ms"] / 1e3, opened,
                                   opened + window_s)
                busy["busy_s_probe"] = (trace.card_busy(rec)["ms"] / 1e3
                                        * len(steps))
                busy["paced_idle_ms"] = paced["ms"]
                log("card busy over the window: " + json.dumps(
                    dict(busy, window_s=window_s)))
                out["device"].update(busy_s=busy.pop("busy_s"),
                                     window_s=window_s, **busy)
                rec.clear()  # it holds the program
            sync()
            if on_card:
                peak = max(peak, torch.cuda.max_memory_allocated())
        finally:
            del prog
            gc.collect()
            bps.shutdown()
    if on_card:
        torch.cuda.empty_cache()
        out["device"] = {"platform": "gpu",
                         "kind": torch.cuda.get_device_name(device),
                         "count": cell.chips, "memory_peak_bytes": peak,
                         **out["device"]}
    want = check.reference_steps(cell, seed, device, CHECKED_STEPS)
    log("reference losses:", want["losses"])
    correct, pairs = check.verdict(check.numbers(first, want), cell.limits)
    out.update(correct=correct, attempted=len(steps), failed=0,
               check=pairs)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from portbench.cell import load
    cell = load(args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        log(f"cell {cell.name} needs {cell.chips} CUDA device(s); "
            f"available: {torch.cuda.is_available()}, "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run(cell, args.seed, args.seconds, bool(args.trace),
                 torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        log(f"the run loaded {bad}: the benchmark measures the port alone")
        return 3
    for name, (value, limit) in result["check"].items():
        log(f"check {name} {value!r} limit {limit!r}")
    order = ("correct", "attempted", "failed", "metrics", "device",
             "breakdown", "check")
    print(json.dumps({k: result[k] for k in order if k in result}),
          flush=True)
    return 0


if __name__ == "__main__":
    # The benchmark's modules are ``portbench.*``, imported from the
    # checkout's root; this script's own directory would shadow the
    # standard library's ``trace`` with ``portbench/trace.py``.
    sys.path[0] = ROOT
    sys.exit(main())
