"""The PS tail's D2H leg (ms): the end of the last D2H batch (the
stager's wait for its copies returned, on the host's clock) less the
card's end of backward (the last gradient hook's mark), floored at 0,
mean over the step trace's steps (``steps.tails``): what the stager's
copies add after the card's backward."""

from portbench.steps import mean_tail


def read(rec):
    return mean_tail(rec, 0)
