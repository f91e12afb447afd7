"""The PS tail's upload leg (ms): the copy-stream mark after the uploads
less the later of the card's end of backward and the round's last pull,
floored at 0, mean over the step trace's steps (``steps.tails``)."""

from portbench.steps import mean_tail


def read(rec):
    return mean_tail(rec, 2)
