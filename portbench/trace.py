"""The traced run: the record the per-layer readers read, and the
breakdown the result line carries.

The record (``rec``) holds the window's steps (host clock stamps, the
card's end of backward on the host's clock, and the optimizer's
``timings``), the PS van's byte counters at each step's end, the peak
memory of the window, the cell, and ``live``, the program as the window
left it, for the readers that measure something of their own once the
window has closed (``probe``).

The result line's ``busy_s`` is not derived from ``card_busy``: it is
read over the window's own steps, from the card's span of each
(``clock.window_busy``), less the idle the host's pace leaves in a step
(``clock.paced_idle`` over ``paced_pairs``). ``card_busy``, one probe
step after the window, still gives ``card_step_ms``,
``device_idle_pct``, the profiler's coverage in ``breakdown`` and the
``busy_s_probe`` kept beside ``busy_s``.
"""

from __future__ import annotations

import importlib
import json

import torch

TOP = 10


def van_bytes():
    """(sent, received) bytes through this process's PS van so far."""
    from byteps_tpu_torch.core import ffi
    van = ffi.metrics_snapshot()["van"]
    return int(van["sent_bytes"]), int(van["recv_bytes"])


def probe(rec: dict, name: str, fn):
    """``fn()`` once a traced run, kept under ``name`` for every reader
    and the breakdown."""
    probes = rec.setdefault("probes", {})
    if name not in probes:
        probes[name] = fn()
    return probes[name]


def card_busy(rec: dict) -> dict:
    """The card's own time for one step's work, in two parts each
    enqueued behind a sleep of the card (``clock.card_backlog``): the
    zero_grad, forward and backward, and, once ``synchronize`` has
    brought the gradients back, the wrapped optimizer's own update. What
    the step waits for between the two (the PS round trip) is left out,
    and so are the PS cells' copies between card and host, which run on
    a stream of their own. ``ms`` is the sum; each part says whether it
    is exact. A probe of one step, on the pool's next batch after the
    window: no longer the window's ``busy_s``, which can differ from it
    where steps are uneven (an expert layer's rows swing)."""
    def measure():
        from portbench.clock import card_backlog
        live, held = rec["live"], {}

        def forward_backward():
            live.opt.zero_grad()
            held["loss"] = live.loss_fn(live.model, live.next_batch())
            held["loss"].backward()
        compute = card_backlog(forward_backward)
        live.opt.synchronize()
        update = card_backlog(lambda: live.plain_step(live.opt))
        held["loss"].item()
        return {"compute": compute, "update": update,
                "ms": compute["device_ms"] + update["device_ms"]}
    return probe(rec, "card_busy", measure)


# pairs that ``paced_pairs`` times
PACED_PAIRS = 8


def paced_pairs(rec: dict) -> list:
    """A step's zero_grad, forward and backward run twice on each of
    PACED_PAIRS batches: once as the window runs it, the card idle at its
    start (``paced_ms``, CUDA events at its start and after
    ``backward()``), and once behind a sleep of the card
    (``clock.card_backlog``: ``own_ms``, the card's own time, exact where
    the card never waited). The model's buffers (the routers' biases and
    loads, the norms' statistics) are put back between the two, so both
    run the same work."""
    def measure():
        from portbench.clock import card_backlog
        live, pairs = rec["live"], []
        for _ in range(PACED_PAIRS):
            batch = live.next_batch()

            def forward_backward():
                live.opt.zero_grad()
                live.loss_fn(live.model, batch).backward()
            kept = [b.clone() for b in live.model.buffers()]
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            torch.cuda.synchronize()
            start.record()
            forward_backward()
            end.record()
            live.opt.synchronize()
            torch.cuda.synchronize()
            with torch.no_grad():
                for b, k in zip(live.model.buffers(), kept):
                    b.copy_(k)
            own = card_backlog(forward_backward)
            live.opt.synchronize()
            torch.cuda.synchronize()
            pairs.append({"paced_ms": start.elapsed_time(end),
                          "own_ms": own["device_ms"],
                          "own_exact": own["device_ms_exact"]})
        rec["log"]("paced pairs: " + json.dumps(pairs))
        return pairs
    return probe(rec, "paced_pairs", measure)


def read_metrics(rec: dict, per_layer: list, log) -> dict:
    """{name: {"value", "unit"}} of every per-layer metric whose reader
    finds something to read."""
    out = {}
    for m in per_layer:
        reader = importlib.import_module(
            "portbench.metrics." + m["name"].replace(".", "_"))
        value = reader.read(rec)
        if value is None:
            log(f"metric {m['name']}: nothing to read in this cell")
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def breakdown(rec: dict, log) -> dict:
    """The device operations of one profiled step that took most time.
    The profiler loses device records on this card, so its coverage (the
    union of its kernel intervals over the card's busy time for a step,
    ``card_busy``) is logged beside them."""
    from torch.profiler import ProfilerActivity, profile
    live = rec["live"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        live.step()
        torch.cuda.synchronize()
    by_name, spans = {}, []
    for ev in prof.events():
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and "#" not in ev.name):
            by_name[ev.name] = (by_name.get(ev.name, 0.0)
                                + ev.time_range.elapsed_us() / 1e6)
            spans.append((ev.time_range.start, ev.time_range.end))
    union_us, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            union_us, end = union_us + b - a, b
        elif b > end:
            union_us, end = union_us + b - end, b
    card_ms = card_busy(rec)["ms"]
    log("profiler coverage: " + json.dumps({
        "kernel_union_ms": union_us / 1e3, "card_busy_ms": card_ms,
        "share": union_us / 1e3 / card_ms, "device_events": len(spans)}))
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[k, v] for k, v in ops]}
