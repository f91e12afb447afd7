"""The card's clock: its own time for a step, whether it waited for the
host, its busy time over a window, and device time of captured kernels.

``card_backlog`` and ``time_alternating`` are frozen copies of
``chip_smoke.py``'s ``_card_backlog`` and ``_time_alternating``;
``Anchors`` puts events of a window on the host's clock;
``window_busy`` reads the card's busy seconds in a window from its span
of each step. None of them uses ``torch.profiler``, which loses device
records on this card.
"""

from __future__ import annotations

import statistics
import threading
import time

import torch

# Host seconds between marker events.
MARK_PERIOD_S = 5e-4


def card_backlog(run) -> dict:
    """``run()`` enqueued behind a ~0.5 s sleep of the card, so that the
    host is ahead from the start: the card's ms for it (CUDA events
    around it), the host's ms to enqueue it, and ``backlog_ms``, the
    least of (card reaches marker a) - (host has enqueued marker b) over
    consecutive markers recorded every MARK_PERIOD_S by a sampler thread.
    Above 0 the card never waited for the host between the two events,
    so its time is the card's own (``device_ms_exact``). The card's times
    are put on the host's clock by an event recorded on the idle card
    right after a synchronize; its launch latency makes them early by
    microseconds, so the check errs towards "waited".
    Copy of ``chip_smoke._card_backlog``."""
    stream = torch.cuda.current_stream()
    marks, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(stream)
            marks.append((time.perf_counter(), ev))
            stop.wait(MARK_PERIOD_S)

    before, start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(3))
    torch.cuda.synchronize()
    h_before = time.perf_counter()
    before.record()
    torch.cuda._sleep(1_000_000_000)  # ~0.5 s at the H100's clocks
    start.record()
    marks.append((time.perf_counter(), start))
    sampler = threading.Thread(target=sample)
    sampler.start()
    t0 = time.perf_counter()
    try:
        run()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
    finally:
        stop.set()
        sampler.join()
    end.record()
    marks.append((time.perf_counter(), end))
    torch.cuda.synchronize()
    reached = [h_before + before.elapsed_time(ev) / 1e3 for _, ev in marks]
    backlog_ms = min(reached[i] - marks[i + 1][0]
                     for i in range(len(marks) - 1)) * 1e3
    sleep_ms = before.elapsed_time(start)
    return {"device_ms": start.elapsed_time(end),
            "enqueue_behind_sleep_ms": enqueue_ms, "sleep_ms": sleep_ms,
            "host_waited": enqueue_ms > sleep_ms, "markers": len(marks),
            "backlog_ms": backlog_ms, "device_ms_exact": backlog_ms > 0}


def time_alternating(fns, windows=5, iters=20, stream=None) -> dict:
    """Device ms per call of each function: ``iters`` calls captured in
    one CUDA graph per function, so the host's launch cost is out of the
    window, and the graphs replayed in turns for ``windows`` windows.
    Returns {name: (median, min, max)}. Copy of
    ``chip_smoke._time_alternating``."""
    side = stream or torch.cuda.Stream()
    graphs = {}
    for name, fn in fns.items():
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graphs[name] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[name], stream=side):
            for _ in range(iters):
                fn()
    times = {name: [] for name in fns}
    for _ in range(windows):
        for name, g in graphs.items():
            g.replay()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            g.replay()
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / iters)
    del graphs
    return {name: (sorted(t)[len(t) // 2], min(t), max(t))
            for name, t in times.items()}


class Anchors:
    """The card's clock put on the host's for one window: an event
    recorded on the idle card, with the host's clock read just before
    it, at the window's start and at its end (``on_host``)."""

    def __init__(self, stream=None):
        self.stream = stream or torch.cuda.current_stream()

    def _anchored(self):
        torch.cuda.synchronize()
        ev = torch.cuda.Event(enable_timing=True)
        at = time.perf_counter()
        ev.record(self.stream)
        torch.cuda.synchronize()
        return at, ev

    def start(self):
        self._first = self._anchored()

    def stop(self):
        self._last = self._anchored()

    def on_host(self, ev) -> float:
        """The host clock at which the card reached event ``ev`` (recorded
        between ``start`` and ``stop``): the card's clock mapped onto the
        host's through the anchors at both ends of the window, since the
        two drift apart by tens of microseconds a second."""
        h0, a0 = self._first
        h1, a1 = self._last
        return on_host(h0, h1, a0.elapsed_time(a1), a0.elapsed_time(ev))


def on_host(h0: float, h1: float, card_ms: float, ev_ms: float) -> float:
    """The host time of an event ``ev_ms`` after the first anchor on the
    card's clock, where the anchors were enqueued at host times ``h0`` and
    ``h1`` and lie ``card_ms`` apart on the card's clock."""
    return h0 + ev_ms / 1e3 * (h1 - h0) / (card_ms / 1e3)


def clipped(intervals, lo: float, hi: float) -> float:
    """The seconds of ``intervals`` ((start, end) pairs, disjoint) that lie
    inside [``lo``, ``hi``]; an interval that ends before it starts has
    none."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in intervals)


def window_busy(steps, paced_idle_s: float, lo: float, hi: float) -> dict:
    """The card's busy seconds in the window [``lo``, ``hi``] from its span
    of each of the window's steps, all on the host's clock: ``steps``
    holds (start, backward, resume, end) a step, when the card reached
    the step's start, finished its backward, could resume after the
    round trip (the host's ``landed``, where that is later than the end
    of backward), and finished its update. Each step is busy from its
    start plus ``paced_idle_s`` (the idle that the host's pace leaves in
    a zero_grad, forward and backward, ``paced_idle``) to the end
    of its backward, and from its resumption to its end; between steps
    (the loss read, the host's work up to the next step) the card is
    idle. The intervals are disjoint and cut to the window, so 0 <=
    ``busy_s`` <= ``hi`` - ``lo`` by construction; a step whose start,
    end of backward and end are out of order is refused. ``busy_s_upper``:
    the steps' whole spans, nothing taken out."""
    busy, spans = [], []
    for i, (start, bwd, resume, end) in enumerate(steps):
        if not start <= bwd <= end or not bwd <= resume:
            raise ValueError(f"step {i}: the card's start {start}, end of "
                             f"backward {bwd}, resumption {resume} and end "
                             f"{end} are out of order")
        busy += [(start + paced_idle_s, bwd), (resume, end)]
        spans.append((start, end))
    return {"busy_s": clipped(busy, lo, hi),
            "busy_s_upper": clipped(spans, lo, hi)}


def paced_idle(pairs, window_ms) -> dict:
    """The idle ms that the host's pace leaves in a step's zero_grad,
    forward and backward, the card idle at its start: ``pairs``, the same
    work timed as the window runs it (``paced_ms``) and as the card's own
    time behind a sleep (``own_ms``), on a few batches after the window
    (``trace.paced_pairs``); ``window_ms``, the card's span of that part
    (start to end of backward) in each of the window's steps. Two
    estimates: the pairs' mean of paced less own, whose standard error
    is their spread over the root of their count; and the window's mean
    span less the pairs' mean own time, which has every step of the
    window but stands on the window's work being the pairs': the window's
    batches ran at another point of the run, so its error counts as one
    more batch's own time, the pairs' spread of it times the root of
    (1 + 1 / pairs). The window's wins where the work is even and the
    host's pace swings (GPT-2, the PS cell), the pairs' where the work
    swings from batch to batch (an expert layer's rows). ``ms`` is the
    one with the smaller error, and 0 where that reads under 0."""
    k = len(pairs)
    diff = [p["paced_ms"] - p["own_ms"] for p in pairs]
    own = [p["own_ms"] for p in pairs]
    by_pairs = (statistics.fmean(diff), statistics.stdev(diff) / k ** 0.5)
    by_window = (statistics.fmean(window_ms) - statistics.fmean(own),
                 statistics.stdev(own) * (1 + 1 / k) ** 0.5)
    est = min(by_pairs, by_window, key=lambda e: e[1])[0]
    return {"ms": max(0.0, est), "by_pairs_ms": by_pairs[0],
            "by_pairs_se_ms": by_pairs[1], "by_window_ms": by_window[0],
            "by_window_se_ms": by_window[1]}
