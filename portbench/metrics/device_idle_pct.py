"""Share of a step in which the card had nothing to run (%): 1 less the
card's own busy time for a step's work (``trace.card_busy``: forward and
backward, and the optimizer's update, each timed behind a sleep of the
card) over the mean host time of the traced window's steps. Each part's
exactness (the card never waited for the host while it was timed) is
logged beside it; an inexact part reads high, and the idle share low."""

import statistics

from portbench.trace import card_busy


def read(rec):
    busy = card_busy(rec)
    rec["log"]("card busy: " + repr(busy))
    step_ms = statistics.fmean(s["end"] - s["start"]
                               for s in rec["steps"]) * 1e3
    return 100.0 * (1.0 - busy["ms"] / step_ms)
