"""Bytes the worker's PS van sent a step (MB, 1e6 bytes), from the
difference of its sent-bytes counter across the traced steps (the
counter ``core.ffi.Worker.net_bytes`` reads)."""


def read(rec):
    van = [s["van"] for s in rec["steps"] if "van" in s]
    if len(van) != len(rec["steps"]) or "van_start" not in rec:
        return None
    return (van[-1][0] - rec["van_start"][0]) / len(van) / 1e6
