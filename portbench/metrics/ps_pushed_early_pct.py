"""Share of the traced steps' pushed bytes (``timings["pushes"]``: the
host clock at each push's enqueue, with its bytes) enqueued before the
card finished backward (``bwd_card``): how much of the round trip the
hooks start under the card's backward. ``chip_smoke._overlap_record``'s
``bytes_before_backward`` counts before ``backward()`` returned on the
host, which runs ahead of the card, so a card-bound backward reads 0
there."""


def read(rec):
    pushes = [(ts, n, s["bwd_card"]) for s in rec["steps"]
              for ts, n in s["timings"].get("pushes", ())]
    total = sum(n for _, n, _ in pushes)
    if not total:
        return None
    return 100.0 * sum(n for ts, n, bwd in pushes if ts < bwd) / total
