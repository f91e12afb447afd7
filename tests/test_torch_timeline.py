"""The port's trace ``Timeline`` (``byteps_tpu_torch.utils.timeline``)
against ``byteps_tpu.utils.timeline``: the same step window for the same
configuration (``tests/test_aux.py``'s cases), and the C core's spans
merged into a ``torch.profiler`` trace on the CPU, shifted onto the
profiler's timebase by the anchor event; a merge that cannot place them
raises.
"""

import json
import os
import time

import pytest
import torch

import byteps_tpu.config as jconfig
import byteps_tpu.utils.timeline as jtimeline
import byteps_tpu_torch as bps
import byteps_tpu_torch.config as config
from byteps_tpu_torch.utils import timeline
from tests.ps_loopback import LoopbackClient, init_loopback


@pytest.fixture(autouse=True)
def _port_state(monkeypatch):
    monkeypatch.setenv("BYTEPS_PS_MODE", "collective")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    if bps.initialized():
        bps.shutdown()


@pytest.mark.parametrize("kw", [
    dict(trace_on=True, trace_start_step=2, trace_end_step=4),
    dict(trace_on=True, trace_start_step=1, trace_end_step=2),
    dict(trace_on=False)])
def test_window_matches_the_reference(tmp_path, kw):
    port = timeline.Timeline(
        config.Config(trace_dir=str(tmp_path / "port"), **kw))
    ref = jtimeline.Timeline(
        jconfig.Config(trace_dir=str(tmp_path / "jax"), **kw),
        device_trace=False)
    flags = []
    for tl in (port, ref):
        seq = [tl.active]
        for _ in range(6):
            tl.step()
            seq.append(tl.active)
        tl.close()  # idempotent
        flags.append(seq)
    assert flags[0] == flags[1]
    if kw["trace_on"]:
        # the port profiled its window (no core to merge with here)
        assert timeline.find_device_chrome_trace(
            str(tmp_path / "port" / "device_rank0")) is not None


def _profile(dev_dir):
    """A CPU torch.profiler trace with the anchor event; returns the
    anchor's monotonic microseconds."""
    os.makedirs(dev_dir)
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    anchor = timeline.clock_anchor()
    torch.ones(64, 64) @ torch.ones(64, 64)
    prof.stop()
    prof.export_chrome_trace(os.path.join(dev_dir, "trace.json"))
    return anchor


def _core_trace(path):
    """A synthetic C-core dump (``tests/test_aux.py``'s), stamped in the
    monotonic clock as worker.cc::Record does."""
    now = time.monotonic_ns() // 1000
    with open(path, "w") as f:
        json.dump({"traceEvents": [
            {"name": "push", "ph": "X", "pid": 0, "tid": 7,
             "ts": now - 3000, "dur": 1000, "args": {"key": 7}},
            {"name": "pull", "ph": "X", "pid": 0, "tid": 7,
             "ts": now - 2000, "dur": 1500, "args": {"key": 7}},
        ]}, f)


def test_merge_shifts_core_spans_onto_the_profiler_timebase(tmp_path):
    dev_dir = str(tmp_path / "dev")
    anchor = _profile(dev_dir)
    core_path = str(tmp_path / "comm.json")
    _core_trace(core_path)
    out_path = str(tmp_path / "combined.json")
    n = timeline.merge_core_device_traces(core_path, dev_dir, out_path,
                                          anchor)
    assert n == 2
    with open(out_path) as f:
        events = json.load(f)["traceEvents"]
    core = [e for e in events if e.get("pid") == timeline._DCN_PID
            and "ts" in e]
    assert sorted(e["name"] for e in core) == ["pull", "push"]
    prof_ts = [e["ts"] for e in events
               if "ts" in e and e.get("pid") != timeline._DCN_PID]
    assert len(prof_ts) > 3
    for e in core:
        assert min(prof_ts) - 1e6 < e["ts"] < max(prof_ts) + 1e6


def test_merge_without_anchor_raises(tmp_path):
    dev_dir = str(tmp_path / "dev")
    os.makedirs(dev_dir)
    with open(os.path.join(dev_dir, "trace.json"), "w") as f:
        json.dump({"traceEvents": [{"name": "x", "ph": "X", "ts": 1.0}]}, f)
    core_path = str(tmp_path / "comm.json")
    _core_trace(core_path)
    with pytest.raises(ValueError, match="byteps_clock_anchor"):
        timeline.merge_core_device_traces(core_path, dev_dir,
                                          str(tmp_path / "out.json"), 0)
    with pytest.raises(FileNotFoundError):
        timeline.merge_core_device_traces(core_path, str(tmp_path / "none"),
                                          str(tmp_path / "out.json"), 0)


def test_timeline_writes_the_combined_trace_in_ps_mode(tmp_path,
                                                       monkeypatch):
    client = LoopbackClient()
    client.dump_trace = _core_trace  # the core's spans of the window
    init_loopback(monkeypatch, client)
    cfg = config.Config(trace_on=True, trace_dir=str(tmp_path),
                        trace_start_step=1, trace_end_step=2)
    tl = timeline.Timeline(cfg)
    tl.step()
    assert tl.active
    bps.push_pull(torch.ones(8), name="traced")
    tl.step()
    assert not tl.active
    with open(tmp_path / "combined_rank0.json") as f:
        events = json.load(f)["traceEvents"]
    assert sum(e.get("pid") == timeline._DCN_PID and "ts" in e
               for e in events) == 2
