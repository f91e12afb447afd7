"""The card's own time for one step (ms): its zero_grad, forward and
backward, and its optimizer's update, each enqueued behind a sleep of
the card and timed by CUDA events (``trace.card_busy``), judged exact
when marker events show the card never waited for the host
(``clock.card_backlog``, a copy of ``chip_smoke._card_backlog``). An
inexact part, which is an upper bound, is logged as such before the
result."""

from portbench.trace import card_busy


def read(rec):
    r = card_busy(rec)
    rec["log"]("card step: " + repr(r))
    return r["ms"]
