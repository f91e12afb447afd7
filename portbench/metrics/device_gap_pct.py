"""Share of the step trace's window in which the card sat idle between
two of the program's compute-stream marks (%): the idle gaps of the
port's step trace (``utils.timeline.idle_gaps``: after the last gradient
hook until the last pull was waited, between the update and the next
zero_grad, across a push_pull that enqueued nothing) summed, over the
window from the trace's first anchor to its last. A lower bound of the
idle share: the trace has no marks inside the forward and the backward.
None where the program has no step trace or no card marks."""

from portbench.steps import recorded


def read(rec):
    out = recorded(rec)
    if not out or not any(r["marks"] for r in out["records"]):
        return None
    return 100.0 * sum(g.seconds for g in out["gaps"]) / (
        out["end"] - out["start"])
