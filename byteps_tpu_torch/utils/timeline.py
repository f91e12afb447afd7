"""Communication trace timeline (Chrome trace-event JSON).

Counterpart of ``byteps_tpu/utils/timeline.py`` (the reference's
BYTEPS_TRACE_ON / BYTEPS_TRACE_DIR / BYTEPS_TRACE_START_STEP /
BYTEPS_TRACE_END_STEP timeline). Two sources feed it:
- the C++ core's per-partition stage spans (compress / push / pull),
  drained through ``bps_dump_trace``;
- ``torch.profiler`` (host ops, and the card's kernels and copies where
  CUDA is available), started and stopped over the same step window.

At the end of the window both are merged into
``<trace_dir>/combined_rank<r>.json``. Unlike the JAX version, a failure
of the profiler or of the merge inside the window raises.

Usage::

    tl = Timeline()            # reads BYTEPS_TRACE_* from the config
    for batch in data:
        step(...)
        tl.step()              # call once per training step
    tl.close()                 # idempotent; also dumps on end-step

The profiler's device lane is partial on an H100: it kept a fifth of
ResNet-50's kernel time and under three quarters of GPT-2's. The step
trace below is what ``Timeline`` adds beside it, over the same window,
as two more process rows of the combined file: the program's host spans,
and the card's marks with the idle gaps between them.

The step trace (``start_steps`` / ``stop_steps``, off by default): one
record a training step, kept in memory while it runs and resolved when
it stops. A record is the step's window dict (``_TapState.timeline`` in
PS mode, ``opt.timings`` then) with ``step`` (the window count; in PS
mode the core's round of the step, read back as ``round``), ``spans``
(``Span``: name, start and end on ``time.perf_counter``, the parent
span's name, the leaf, or leaves, or core key, and bytes) and ``marks``
(timing CUDA events of the trace's own, beside the program's events,
which stay as they are untraced: a few a step, since each costs the
host tens of microseconds and one after every gradient's ready event
changes the step; PS mode: the compute stream at ``zero_grad``, after
the last gradient hook (the card's end of backward), once the last pull
was waited (``collected``) and after the update, the copy stream after
the uploads). The host clock is CLOCK_MONOTONIC, the core's span clock,
so the core's enqueue, push, pull and sum records of the step's round
join the record as they are; the card's marks are put on that clock
through two anchor events, one at each end of the trace, each recorded
on the idle card just after the host clock was read (the only
synchronisations tracing adds). Tracing off costs each site on the hook
path one branch. A window opened while tracing is traced to its end.

The idle gaps: between two consecutive compute-stream marks between
which the program enqueues nothing on that stream (``QUIET``), the card
was idle for their distance on its own clock, since an event recorded on
an idle stream completes as it is enqueued. Each gap is named by the
innermost host span open at its middle. This is a lower bound of the
card's idle time: it sees nothing inside the forward pass or the
backward, where the program has no marks.

A record may also carry counters: ``bn_launches``, the batch-norm kernel
entries the step called (``ops.batch_norm``: a forward and a backward a
norm of a training step); ``moe_rows``, the (token, expert) pairs the
step's expert layers routed to the experts held here
(``models.deepseek``), summed on the card as the step runs and read once
the trace stops; ``head_pad_rows``, the zero rows the step's tied heads
appended to their tables (``models.transformer`` ``Embed.attend``: 47 a
GPT-2 step, absent where the vocabulary is a multiple of 64). The expert
layers also mark the card around each layer's forward
(``moe_fwd_start``, ``moe_fwd_end``) and backward (``moe_bwd_start``,
``moe_bwd_end``), the layer's index as the leaf.
"""

from __future__ import annotations

import collections
import glob
import json
import os
import tempfile
import threading
import time
from typing import Optional

import torch

from byteps_tpu_torch.config import Config, get_config

# The name of the host event that ties the profiler's timebase to the
# core's CLOCK_MONOTONIC microseconds.
ANCHOR_NAME = "byteps_clock_anchor"


class Timeline:
    """Step-windowed trace recorder (reference: BytePSContext timestamps +
    the trace dump on BYTEPS_TRACE_END_STEP)."""

    def __init__(self, config: Optional[Config] = None,
                 *, device_trace: bool = True):
        self._cfg = config or get_config()
        self._enabled = self._cfg.trace_on
        self._device_trace = device_trace
        self._step = 0
        self._profiler = None
        self._dumped = False
        self._device_dir: Optional[str] = None
        self._anchor_us: Optional[int] = None
        self._steps_on = False
        if self._enabled:
            os.makedirs(self._cfg.trace_dir, exist_ok=True)
            # the core's ring records only inside the window from here on
            self._report_core_step(0)

    @property
    def active(self) -> bool:
        """True while the current step is inside the trace window."""
        return (self._enabled and not self._dumped
                and self._step >= self._cfg.trace_start_step)

    def step(self) -> None:
        """Mark the end of one training step."""
        if not self._enabled or self._dumped:
            return
        self._step += 1
        self._report_core_step(self._step)
        if (self._step >= self._cfg.trace_start_step
                and not self._steps_on
                and self._step < self._cfg.trace_end_step):
            start_steps()
            self._steps_on = True
            if self._device_trace:
                self._start_device_trace()
        if self._step >= self._cfg.trace_end_step:
            self.close()

    @staticmethod
    def _report_core_step(step: int) -> None:
        """Tell the C core's ring the step, so it records only inside the
        window. A process without the core loaded (collective mode) has
        no ring; the core is never built for this."""
        from byteps_tpu_torch.core import ffi
        if ffi._lib is not None:
            ffi._lib.bps_trace_step(int(step))

    def close(self) -> None:
        """Dump both trace sources and the combined timeline (idempotent)."""
        if not self._enabled or self._dumped:
            return
        self._dumped = True
        self._stop_device_trace()
        core_path = self._core_path()
        recorded = None
        if self._steps_on:
            # drains the core's ring into core_path too
            recorded = stop_steps(core_path)
        elif core_path:
            bps_client().dump_trace(core_path)
        if core_path and self._device_dir:
            merge_core_device_traces(
                core_path, self._device_dir,
                os.path.join(self._cfg.trace_dir,
                             f"combined_rank{self._rank()}.json"),
                self._anchor_us, recorded)

    # --- internals ---------------------------------------------------------

    def _rank(self) -> int:
        import byteps_tpu_torch as bps
        return bps.rank() if bps.initialized() else self._cfg.worker_id

    def _core_path(self) -> Optional[str]:
        """Where the C++ worker's per-partition spans go as Chrome JSON,
        or None when no PS client is live."""
        if bps_client() is None:
            return None
        return os.path.join(self._cfg.trace_dir,
                            f"comm_rank{self._rank()}.json")

    def _start_device_trace(self) -> None:
        self._device_dir = os.path.join(self._cfg.trace_dir,
                                        f"device_rank{self._rank()}")
        os.makedirs(self._device_dir, exist_ok=True)
        self._profiler = torch.profiler.profile(
            activities=sorted(torch.profiler.supported_activities(),
                              key=lambda a: a.value))
        self._profiler.start()
        self._anchor_us = clock_anchor()

    def _stop_device_trace(self) -> None:
        if self._profiler is None:
            return
        prof, self._profiler = self._profiler, None
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(self._device_dir,
                                              "trace.json"))


def bps_client():
    """This process's PS client, or None."""
    import byteps_tpu_torch as bps
    return bps._st().ps_client if bps.initialized() else None


def clock_anchor() -> int:
    """Record the anchor event in the running profiler and return
    CLOCK_MONOTONIC in microseconds (the C core's span clock,
    ``std::chrono::steady_clock`` on Linux) as it opened: the midpoint of
    readings just before and just after, between which the profiler
    stamps the event's start."""
    before = time.monotonic_ns()
    with torch.profiler.record_function(ANCHOR_NAME):
        after = time.monotonic_ns()
    return (before + after) // 2000


# --- combined device + core timeline -----------------------------------------

_DCN_PID = 900000  # far above real pids; its own process row in the viewer
_HOST_PID = 900001  # the step trace's host spans
_CARD_PID = 900002  # the step trace's card marks and idle gaps


def find_device_chrome_trace(device_dir: str) -> Optional[str]:
    """The newest Chrome-trace JSON that the profiler exported under
    ``device_dir``."""
    paths = glob.glob(os.path.join(device_dir, "*.json"))
    return max(paths, key=os.path.getmtime) if paths else None


def merge_core_device_traces(core_path: str, device_dir: str,
                             out_path: str, anchor_monotonic_us: int,
                             recorded: Optional[dict] = None) -> int:
    """Merge the C core's spans into the profiler's trace: one Chrome JSON
    with the card's kernels, the host's ops and the core's push/pull
    stages on a single timeline, the core's under their own process row
    (``_DCN_PID``). ``recorded`` (``stop_steps``' result) adds two rows:
    the step trace's host spans (``_HOST_PID``, a thread a step) and the
    card's marks and idle gaps (``_CARD_PID``), on the same timebase.

    The core stamps spans in CLOCK_MONOTONIC µs; the profiler stamps its
    events on its own µs timebase. The anchor event (``ANCHOR_NAME``),
    opened when the monotonic clock read ``anchor_monotonic_us``, gives
    the offset between the two. Returns the number of merged core events;
    raises when the trace or its anchor is missing."""
    dev_file = find_device_chrome_trace(device_dir)
    if dev_file is None:
        raise FileNotFoundError(f"no profiler trace under {device_dir}")
    with open(dev_file) as f:
        dev = json.load(f)
    with open(core_path) as f:
        core = json.load(f)

    events = list(dev.get("traceEvents", []))
    anchors = [e["ts"] for e in events
               if e.get("name") == ANCHOR_NAME and "ts" in e]
    if len(anchors) != 1:
        raise ValueError(f"{dev_file}: expected one {ANCHOR_NAME} event, "
                         f"found {len(anchors)}")
    offset = float(anchors[0]) - anchor_monotonic_us
    events.append({"name": "process_name", "ph": "M", "pid": _DCN_PID,
                   "args": {"name": "byteps core (C++ worker)"}})
    n = 0
    for e in core.get("traceEvents", []):
        if "ts" not in e:
            continue
        shifted = dict(e)
        shifted["pid"] = _DCN_PID
        shifted["ts"] = e["ts"] + offset
        events.append(shifted)
        n += 1
    if recorded is not None:
        events += _step_rows(recorded, offset)
    dev["traceEvents"] = events
    with open(out_path, "w") as f:
        json.dump(dev, f)
    return n


def _step_rows(recorded: dict, offset_us: float) -> list:
    """Chrome events of a stopped step trace, host clock seconds shifted
    by ``offset_us``: the host spans a thread a step, the card's marks a
    thread a lane, and the idle gaps."""
    def ts(t):
        return t * 1e6 + offset_us

    rows = [{"name": "process_name", "ph": "M", "pid": _HOST_PID,
             "args": {"name": "byteps step trace: host spans"}},
            {"name": "process_name", "ph": "M", "pid": _CARD_PID,
             "args": {"name": "byteps step trace: card marks, idle gaps"}}]
    for rec in recorded["records"]:
        for s in rec["spans"]:
            e = {"name": s.name, "pid": _HOST_PID, "tid": rec["step"],
                 "ts": ts(s.start),
                 "args": {"step": rec["step"], "parent": s.parent,
                          "leaf": s.leaf, "bytes": s.nbytes}}
            e.update({"ph": "X", "dur": (s.end - s.start) * 1e6}
                     if s.end > s.start else {"ph": "i", "s": "t"})
            rows.append(e)
        for m in rec["marks"]:
            rows.append({"name": m.name, "ph": "i", "s": "t",
                         "pid": _CARD_PID, "tid": m.lane, "ts": ts(m.t),
                         "args": {"step": m.step, "leaf": m.leaf,
                                  "card_ms": m.card_ms}})
    for g in recorded["gaps"]:
        rows.append({"name": f"idle: {g.name}", "ph": "X",
                     "pid": _CARD_PID, "tid": "idle", "ts": ts(g.start),
                     "dur": g.seconds * 1e6, "args": {"step": g.step}})
    return rows


# --- the step trace ----------------------------------------------------------

# A host span: ``start`` and ``end`` in seconds of ``time.perf_counter``
# (equal for an instant), ``parent`` the enclosing span's name or None,
# ``leaf`` a leaf index, a tuple of them, or a core key, ``nbytes`` the
# bytes it moved.
Span = collections.namedtuple("Span", "name start end parent leaf nbytes")
# A card mark once resolved: ``lane`` "compute" or "copy", ``t`` the host
# clock at which the card reached it, ``card_ms`` its time on the card's
# clock after the trace's first anchor.
Mark = collections.namedtuple("Mark", "name lane leaf t card_ms step")
# An idle gap of the compute stream, from ``start`` (host clock) for
# ``seconds``, named by the host span open at its middle.
Gap = collections.namedtuple("Gap", "step name start seconds")

# Consecutive compute-stream marks between which the program enqueues
# nothing on that stream: the last gradient hook and the mark after the
# last pull was waited (the PS tail); the update and the next step's
# zero_grad (between steps); collective mode's synchronize entry and
# exit, where its push_pull enqueues nothing.
QUIET = frozenset({("hook", "collected"), ("update", "zero_grad"),
                   ("synchronize", "synchronized")})
# The core ring's records a step trace keeps: the worker's enqueue
# instants, push and pull spans, and sum instants (the server's summation
# of a key, reported on its push ack, in the record's ``aux``).
CORE = ("enqueue", "push", "pull", "sum")
# The plain PS path's legs (``ps.ps_push_pull``, ``ps.local_push_pull``),
# recorded as spans whose parent is "push_pull".
LEGS = ("reduce_scatter", "d2h", "core", "h2d", "all_gather")

# The running step trace, or None: what every site checks.
steps: Optional["StepTrace"] = None
_steps_lock = threading.Lock()


class StepTrace:
    """The records of a running step trace (``start_steps``)."""

    def __init__(self, device: Optional[torch.device]):
        self.device = device
        self.lock = threading.Lock()
        self.records: list = []
        self.first = None  # (host seconds, anchor event); None on the CPU
        self.start = time.perf_counter()
        self.dropped = _ring_dropped()

    def open(self, step: Optional[int] = None,
             record: Optional[dict] = None) -> dict:
        """Make ``record`` (a step's window dict; a new dict if None) the
        record of ``step`` (the next number if None), replacing a record
        opened for the same step before."""
        rec = {} if record is None else record
        with self.lock:
            if step is None:
                step = len(self.records)
            self.records = [r for r in self.records if r["step"] != step]
            rec.update(step=step, spans=[], marks=[])
            self.records.append(rec)
        return rec

    def current(self) -> dict:
        """The record opened last (a new one if none was)."""
        with self.lock:
            last = self.records[-1] if self.records else None
        return last if last is not None else self.open()


def add_span(rec: dict, name: str, start: float, end: float,
             parent: Optional[str] = None, leaf=None, nbytes: int = 0):
    rec["spans"].append(Span(name, start, end, parent, leaf, nbytes))


def card_event(stream):
    """A timing event recorded on ``stream`` now; None off the card."""
    if stream is None:
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


def add_mark(rec: dict, name: str, event, lane: str = "compute",
             leaf=None) -> None:
    """Keep timing event ``event`` (None off the card: nothing kept) as
    mark ``name`` of ``rec``."""
    if event is not None:
        rec["marks"].append((name, lane, leaf, event))


def mark(rec: dict, name: str, stream, lane: str = "compute",
         leaf=None) -> None:
    """Record mark ``name`` on ``stream`` (None off the card)."""
    add_mark(rec, name, card_event(stream), lane, leaf)


def add_count(name: str, n) -> None:
    """Add ``n`` to counter ``name`` of the running step trace's current
    record; nothing when no trace runs. ``n`` may be a tensor on the card,
    added there with no host read (``stop_steps`` reads it)."""
    tr = steps
    if tr is not None:
        rec = tr.current()
        rec[name] = rec.get(name, 0) + n


def _anchor(device):
    """(host clock, an event recorded on the idle card just after it);
    None off the card."""
    if device is None or device.type != "cuda":
        return None
    torch.cuda.synchronize(device)
    ev = torch.cuda.Event(enable_timing=True)
    at = time.perf_counter()
    ev.record(torch.cuda.current_stream(device))
    torch.cuda.synchronize(device)
    return at, ev


def on_host(h0: float, h1: float, card_ms: float, ev_ms: float) -> float:
    """The host time of an event ``ev_ms`` after the first anchor on the
    card's clock, where the anchors were enqueued at host times ``h0`` and
    ``h1`` and lie ``card_ms`` apart on the card's clock (the two clocks
    drift apart by tens of microseconds a second)."""
    return h0 + ev_ms / 1e3 * (h1 - h0) / (card_ms / 1e3)


def start_steps(device=None) -> None:
    """Start recording steps (see the module docstring) on ``device``
    (``bps.device()`` when initialised). Arms the C core's trace ring
    when the core is loaded. Raises if a step trace is running."""
    global steps
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.core import ffi
    if device is None and bps.initialized():
        device = bps.device()
    tr = StepTrace(torch.device(device) if device is not None else None)
    with _steps_lock:
        if steps is not None:
            raise RuntimeError("a step trace is running already")
        if ffi._lib is not None:
            ffi.trace_arm(True)
        tr.first = _anchor(tr.device)
        steps = tr


def _ring_dropped() -> int:
    """Records the core's main trace ring has overwritten so far (it
    keeps the newest BYTEPS_TRACE_RING_EVENTS); 0 without the core."""
    from byteps_tpu_torch.core import ffi
    if ffi._lib is None:
        return 0
    return int(ffi.metrics_snapshot()["counters"].get(
        "bps_trace_dropped_total", 0))


def stop_steps(core_path: Optional[str] = None) -> dict:
    """Stop the step trace and resolve its records: {"records", "gaps",
    "start", "end", "core_dropped"}, with each record's ``marks`` put on
    the host clock,
    ``gaps`` (``idle_gaps``), and where this process holds the PS client
    ``round`` (the core's round of the step's pushes, or None), ``core``
    (the round's enqueue instants and push and pull spans, ``leaf`` the
    key), ``sums`` (the server's summation of each of the round's keys,
    as reported on its push ack: [(the ack's host time, key, seconds)])
    and ``round_stats`` (the core's ``RoundStats`` of that round:
    ``sum_us``, ``queue_us``, ``push_us``, ``pull_us``, ``wire_bytes``,
    ...; None until a later round has started). The core's ring is
    drained into ``core_path`` (a temporary file if None);
    ``core_dropped`` counts the ring's records overwritten while tracing
    (the oldest steps then lack their core records). Records with
    nothing recorded are dropped."""
    global steps
    from byteps_tpu_torch.core import ffi
    with _steps_lock:
        tr, steps = steps, None
    if tr is None:
        raise RuntimeError("no step trace is running")
    last = _anchor(tr.device)
    end = time.perf_counter()
    dropped = _ring_dropped() - tr.dropped
    client = bps_client()
    core, rounds = [], {}
    if ffi._lib is not None:
        ffi.trace_arm(False)
    if client is not None:
        core = _drain_core(client, core_path)
        if ffi._lib is not None:
            rounds = {r["round"]: r
                      for r in ffi.round_summary().get("rounds", ())}
    records = [r for r in tr.records if r["spans"] or r["marks"]]
    for rec in records:
        for k, v in rec.items():
            if isinstance(v, torch.Tensor):  # a counter summed on the card
                rec[k] = int(v)
        rec["marks"] = _resolve(rec, tr.first, last)
        rec["spans"].sort(key=lambda s: s.start)
        if client is not None:
            _join_core(rec, core, rounds)
    gaps = idle_gaps([m for r in records for m in r["marks"]],
                     [s for r in records for s in r["spans"]])
    for rec in records:
        rec["gaps"] = [g for g in gaps if g.step == rec["step"]]
    return {"records": records, "gaps": gaps, "start": tr.start,
            "end": end, "core_dropped": dropped}


def _resolve(rec: dict, first, last) -> list:
    """``rec``'s marks as ``Mark``s on the host clock, in card order."""
    if first is None or not rec["marks"]:
        return []
    (h0, a0), (h1, a1) = first, last
    span_ms = a0.elapsed_time(a1)
    out = []
    for name, lane, leaf, ev in rec["marks"]:
        ms = a0.elapsed_time(ev)
        out.append(Mark(name, lane, leaf, on_host(h0, h1, span_ms, ms), ms,
                        rec["step"]))
    return sorted(out, key=lambda m: m.card_ms)


def _drain_core(client, path: Optional[str]) -> list:
    """The core ring's enqueue instants, push and pull spans and sum
    instants, as (Span with ``leaf`` the key, round, the record's
    ``aux``: a sum instant's us), drained into ``path``."""
    keep = path
    if path is None:
        fd, path = tempfile.mkstemp(prefix="bps_steps_", suffix=".json")
        os.close(fd)
    try:
        client.dump_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        if keep is None:
            os.unlink(path)
    out = []
    for e in events:
        args = e.get("args", {})
        if e.get("name") not in CORE or "key" not in args:
            continue
        start = e["ts"] / 1e6
        out.append((Span(e["name"], start, start + e.get("dur", 0) / 1e6,
                         None, args["key"], args.get("wire_bytes", 0)),
                    args.get("round"), args.get("aux", 0)))
    return out


def _join_core(rec: dict, core: list, rounds: dict) -> None:
    """Give ``rec`` the core's round of its pushes (the commonest round
    of the enqueue instants inside the record's host interval; None when
    there are none), that round's core spans (``core``), the server's
    summation of each of its keys (``sums``: [(the ack's host time, key,
    seconds)]) and its RoundStats."""
    spans = rec["spans"]
    if not spans:
        rec.update(round=None, core=[], sums=[], round_stats=None)
        return
    lo = min(s.start for s in spans)
    hi = max(s.end for s in spans)
    seen = [(s.leaf, r) for s, r, _ in core
            if s.name == "enqueue" and lo <= s.start <= hi]
    counts = collections.Counter(r for _, r in seen)
    rnd = counts.most_common(1)[0][0] if counts else None
    keys = {k for k, r in seen if r == rnd}
    mine = [(s, us) for s, r, us in core if r == rnd and s.leaf in keys]
    rec["round"] = rnd
    rec["core"] = [s for s, _ in mine if s.name != "sum"]
    rec["sums"] = [(s.start, s.leaf, us / 1e6) for s, us in mine
                   if s.name == "sum"]
    rec["round_stats"] = rounds.get(rnd)


def idle_gaps(marks, spans) -> list:
    """The card's idle gaps (``Gap``) among ``marks``: each pair of
    consecutive compute-stream marks, in card order, that ``QUIET`` names,
    lasts their distance on the card's clock and is named by
    ``gap_name`` at its middle."""
    compute = sorted((m for m in marks if m.lane == "compute"),
                     key=lambda m: m.card_ms)
    gaps = []
    for a, b in zip(compute, compute[1:]):
        if (a.name, b.name) in QUIET:
            seconds = (b.card_ms - a.card_ms) / 1e3
            gaps.append(Gap(a.step, gap_name(a.t + seconds / 2, spans),
                            a.t, seconds))
    return gaps


def gap_name(t: float, spans) -> str:
    """The innermost (latest started) host span open at ``t``, as
    "parent/name leaf i" (or "leaves i-j"); "between steps" when none
    is."""
    open_ = [s for s in spans if s.start <= t < s.end]
    if not open_:
        return "between steps"
    s = max(open_, key=lambda s: s.start)
    name = f"{s.parent}/{s.name}" if s.parent else s.name
    if isinstance(s.leaf, tuple):
        return f"{name} leaves {min(s.leaf)}-{max(s.leaf)}"
    return name if s.leaf is None else f"{name} leaf {s.leaf}"


def leg_seconds(result: dict) -> dict:
    """The plain PS path's legs over a stopped trace (``stop_steps``):
    each leg's seconds as "<leg>_s" (those that ran), and ``d2h_bytes``
    (the D2H copies: a local group's into the host's shared staging) and
    ``pushed_bytes`` (handed to the core: a local group's root, every
    leaf; the other ranks 0)."""
    out = {}
    for rec in result["records"]:
        for s in rec["spans"]:
            if s.parent == "push_pull" and s.name in LEGS:
                key = s.name + "_s"
                out[key] = out.get(key, 0.0) + s.end - s.start
                if s.name in ("d2h", "core"):
                    key = "d2h_bytes" if s.name == "d2h" else "pushed_bytes"
                    out[key] = out.get(key, 0) + s.nbytes
    return out
