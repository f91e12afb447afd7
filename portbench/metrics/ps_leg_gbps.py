"""The round trip's rate: a step's bytes through the worker's PS van,
sent and received, over the time from its first push to its last pull
waited (``timings``), in GB/s (1e9 bytes); the median over the traced
steps."""

import statistics


def read(rec):
    if "van_start" not in rec:
        return None
    rates, before = [], rec["van_start"]
    for s in rec["steps"]:
        t, van = s["timings"], s["van"]
        moved = (van[0] - before[0]) + (van[1] - before[1])
        before = van
        if t.get("pushes") and t.get("landed"):
            first = min(ts for ts, _ in t["pushes"])
            rates.append(moved / (t["landed"] - first) / 1e9)
    return statistics.median(rates) if rates else None
