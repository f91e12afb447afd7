"""The program's own step trace, read once a traced run's window has
closed: ``PROBE_STEPS`` more steps of the live program inside the port's
``utils.timeline.start_steps`` / ``stop_steps`` (one record a step: the
hook path's host spans, the card's marks on the host's clock, the idle
gaps between them, the core's spans and round counters of the step's
round). A program without the step trace gives None, and every reader of
it then finds nothing to read.
"""

from __future__ import annotations

import statistics

from portbench.trace import TOP, probe

# 32 steps: a PS step's core leg varies 2-78 ms from step to step on the
# loopback, and the core's ring (65,536 records) holds 32 PS steps of
# ResNet-50 (about 1,640 records a step) with room; at 40 it dropped the
# first step's
PROBE_STEPS = 32


def recorded(rec: dict):
    """``stop_steps``' result for PROBE_STEPS steps of ``rec["live"]``,
    taken once a run; None where the program has no step trace."""
    def measure():
        try:
            from byteps_tpu_torch.utils.timeline import (start_steps,
                                                         stop_steps)
        except ImportError:
            return None
        live = rec["live"]
        start_steps()
        for _ in range(PROBE_STEPS):
            live.step()
        out = stop_steps()
        rounds = [(r["step"], r.get("round")) for r in out["records"]]
        rec["log"](f"step trace: {len(out['records'])} records over "
                   f"{out['end'] - out['start']} s; core ring records "
                   f"dropped {out['core_dropped']}; (step, core round) "
                   f"{rounds}; gaps {idle_gaps_of(out)}; tails (d2h, core, "
                   f"h2d ms) {[tails(r) for r in out['records']]}; exposed "
                   f"ms {[exposed(r) for r in out['records']]}; server "
                   f"sum in the tail ms "
                   f"{[server_tail(r) for r in out['records']]}")
        return out
    return probe(rec, "program_steps", measure)


def idle_gaps_of(out) -> list:
    """The TOP gap names with the most idle seconds summed over the
    records, as [[name, seconds], ...], longest first."""
    by_name = {}
    for g in out["gaps"] if out else ():
        by_name[g.name] = by_name.get(g.name, 0.0) + g.seconds
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return [[k, v] for k, v in top]


def tails(r: dict):
    """One PS step's tail after the card's end of backward (the last
    gradient hook's mark), in ms, leg by leg, each floored at 0: the D2H
    copies (the end of the last ``d2h`` span, the stager's wait for the
    copies returned, after it), the core (the end of the round's last
    pull after the later of the two), the uploads (the copy-stream mark
    after the uploads, after the later of the end of backward and the
    last pull). None where the record lacks a leg (collective mode, no
    card, no core)."""
    marks = r["marks"]
    hooks = [m.t for m in marks if m.name == "hook"]
    uploads = [m.t for m in marks if m.name == "uploaded"]
    d2h = [s.end for s in r["spans"] if s.name == "d2h"]
    pulls = [s.end for s in r.get("core", ()) if s.name == "pull"]
    if not (hooks and d2h and uploads and pulls):
        return None
    bwd, copied, pulled = max(hooks), max(d2h), max(pulls)
    return (max(0.0, copied - bwd) * 1e3,
            max(0.0, pulled - max(bwd, copied)) * 1e3,
            max(0.0, max(uploads) - max(bwd, pulled)) * 1e3)


def exposed(r: dict):
    """A PS step's ``landed`` (the host clock once the last pull was
    waited and every upload enqueued) less the card's end of backward, in
    ms: ``ps_exposed_ms``' quantity, read on the step trace's own steps;
    None without both."""
    hooks = [m.t for m in r["marks"] if m.name == "hook"]
    if not hooks or not r.get("landed"):
        return None
    return (r["landed"] - max(hooks)) * 1e3


def server_tail(r: dict):
    """One PS step's server summation inside its tail, in ms: over the
    keys whose push was acknowledged after the card's end of backward,
    each key's summation (as the server reported it on the ack) cut to
    the part that could lie after that end. None without the hooks'
    marks or the sums."""
    hooks = [m.t for m in r["marks"] if m.name == "hook"]
    if not hooks or not r.get("sums"):
        return None
    bwd = max(hooks)
    return sum(min(s, t - bwd) for t, _, s in r["sums"] if t > bwd) * 1e3


def mean_tail(rec: dict, leg: int):
    """The mean over the probe's PS steps of tail ``leg`` (0 D2H, 1 core,
    2 uploads); None where no step has the three legs."""
    out = recorded(rec)
    got = [t[leg] for t in map(tails, out["records"] if out else ())
           if t is not None]
    return statistics.fmean(got) if got else None
