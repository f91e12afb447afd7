"""Communication a PS step waits for (ms): the mean over the traced steps
of the optimizer's ``timings["landed"]`` (its last pull waited) minus
the time the card finished backward (an event recorded after
``backward()`` returned, put on the host's clock). ``chip_smoke.
_overlap_record``'s ``exposed_ms`` counts from ``backward()``'s return
on the host, which runs ahead of the card: that counts the card's own
backward as communication."""

import statistics


def read(rec):
    steps = [s for s in rec["steps"] if s["timings"].get("landed")]
    if not steps:
        return None
    return statistics.fmean((s["timings"]["landed"] - s["bwd_card"]) * 1e3
                            for s in steps)
