"""The PS tail's core leg (ms): the end of the step's round's last core
``pull`` span less the later of the card's end of backward and the last
D2H copy, floored at 0, mean over the step trace's steps
(``steps.tails``): the core's queue, the van, the server's sum and the
pull after the gradients reached the host."""

from portbench.steps import mean_tail


def read(rec):
    return mean_tail(rec, 1)
