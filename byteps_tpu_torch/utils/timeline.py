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
"""

from __future__ import annotations

import glob
import json
import os
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
                and self._profiler is None and self._device_trace
                and self._step < self._cfg.trace_end_step):
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
        core_path = self._dump_core_trace()
        if core_path and self._device_dir:
            merge_core_device_traces(
                core_path, self._device_dir,
                os.path.join(self._cfg.trace_dir,
                             f"combined_rank{self._rank()}.json"),
                self._anchor_us)

    # --- internals ---------------------------------------------------------

    def _rank(self) -> int:
        import byteps_tpu_torch as bps
        return bps.rank() if bps.initialized() else self._cfg.worker_id

    def _dump_core_trace(self) -> Optional[str]:
        """Drain the C++ worker's per-partition spans into Chrome JSON.
        Returns the path, or None when no PS client is live."""
        import byteps_tpu_torch as bps
        client = bps._st().ps_client if bps.initialized() else None
        if client is None:
            return None
        path = os.path.join(self._cfg.trace_dir,
                            f"comm_rank{self._rank()}.json")
        client.dump_trace(path)
        return path

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


def find_device_chrome_trace(device_dir: str) -> Optional[str]:
    """The newest Chrome-trace JSON that the profiler exported under
    ``device_dir``."""
    paths = glob.glob(os.path.join(device_dir, "*.json"))
    return max(paths, key=os.path.getmtime) if paths else None


def merge_core_device_traces(core_path: str, device_dir: str,
                             out_path: str, anchor_monotonic_us: int) -> int:
    """Merge the C core's spans into the profiler's trace: one Chrome JSON
    with the card's kernels, the host's ops and the core's push/pull
    stages on a single timeline, the core's under their own process row
    (``_DCN_PID``).

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
    dev["traceEvents"] = events
    with open(out_path, "w") as f:
        json.dump(dev, f)
    return n
