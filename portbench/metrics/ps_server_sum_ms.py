"""The server's summation inside a PS step's tail (ms): over the keys
whose push the server acknowledged after the card's end of backward (the
last gradient hook's mark), the summation time the server reported on
each key's ack (the core ring's ``sum`` instants), each cut to the time
from that end to the ack; mean over the step trace's steps
(``steps.server_tail``). The summation under backward is left out: it
delays no step."""

import statistics

from portbench.steps import recorded, server_tail


def read(rec):
    out = recorded(rec)
    got = [v for v in map(server_tail, out["records"] if out else ())
           if v is not None]
    return statistics.fmean(got) if got else None
