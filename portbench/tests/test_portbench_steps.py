"""The step trace's readers (``portbench/steps.py`` and the metrics that
read it) on synthetic records, as ``stop_steps`` returns them: marks on
the host clock, the core's spans and the server's sums of the step's
round, the idle gaps."""

import collections

import pytest

from portbench import steps
from portbench.metrics import (device_gap_pct, ps_server_sum_ms,
                               ps_tail_core_ms, ps_tail_d2h_ms,
                               ps_tail_h2d_ms)

# the port's record types, by their fields
Mark = collections.namedtuple("Mark", "name lane leaf t card_ms step")
Span = collections.namedtuple("Span", "name start end parent leaf nbytes")
Gap = collections.namedtuple("Gap", "step name start seconds")


def _ps_record(step, t0, sums=((0.2, 1e-3), (0.302, 4e-3), (0.31, 5e-3))):
    # backward ends on the card at t0 + 0.300, the last D2H lands 1 ms
    # later, the last pull ends at t0 + 0.325, the last upload 4 ms later;
    # the server's sums (ack after t0, seconds): by default one under
    # backward, one cut to the 2 ms after it, one of 5 ms inside the tail
    marks = [Mark("zero_grad", "compute", None, t0, 0.0, step),
             Mark("hook", "compute", 0, t0 + 0.300, 0.0, step),
             Mark("collected", "compute", None, t0 + 0.326, 0.0, step),
             Mark("uploaded", "copy", None, t0 + 0.329, 0.0, step),
             Mark("update", "compute", None, t0 + 0.335, 0.0, step)]
    spans = [Span("d2h", t0 + 0.29, t0 + 0.295, None, (1,), 8),
             Span("d2h", t0 + 0.3, t0 + 0.301, None, (0,), 8)]
    core = [Span("push", t0 + 0.29, t0 + 0.31, None, 1 << 16, 8),
            Span("pull", t0 + 0.31, t0 + 0.325, None, 1 << 16, 0),
            Span("pull", t0 + 0.30, t0 + 0.320, None, 2 << 16, 0)]
    return {"step": step, "round": step, "marks": marks, "core": core,
            "spans": spans, "sums": [(t0 + t, 1 << 16, s) for t, s in sums]}


def _rec(out):
    return {"probes": {"program_steps": out}, "log": lambda *a: None}


def _ps_out():
    records = [_ps_record(5, 0.0), _ps_record(6, 1.0, sums=((0.4, 3e-3),)),
               _ps_record(7, 2.0, sums=())]
    gaps = [Gap(5, "collect/wait leaf 0", 0.300, 0.026),
            Gap(5, "between steps", 0.335, 0.010),
            Gap(6, "collect/wait leaf 0", 1.300, 0.024),
            Gap(6, "between steps", 1.335, 0.010)]
    return {"records": records, "gaps": gaps, "start": 0.0, "end": 2.4}


def test_ps_tails_split_the_tail_after_backward():
    rec = _rec(_ps_out())
    assert steps.tails(rec["probes"]["program_steps"]["records"][0]) == (
        pytest.approx(1.0), pytest.approx(24.0), pytest.approx(4.0))
    assert ps_tail_d2h_ms.read(rec) == pytest.approx(1.0)
    assert ps_tail_core_ms.read(rec) == pytest.approx(24.0)
    assert ps_tail_h2d_ms.read(rec) == pytest.approx(4.0)


def test_a_leg_that_ended_before_backward_adds_no_tail():
    out = _ps_out()
    r = out["records"][0]
    # the copies and the pulls all done before the card ended backward
    r["spans"] = [s._replace(end=s.end - 0.1) for s in r["spans"]]
    r["core"] = [s._replace(end=0.2) for s in r["core"]]
    assert steps.tails(r) == (0.0, 0.0, pytest.approx(29.0))


def test_server_sum_counts_the_tail_alone():
    """Sums acknowledged under backward add nothing, one acknowledged
    2 ms after its end at most those 2 ms; a step without sums is left
    out of the mean."""
    out = _ps_out()
    assert steps.server_tail(out["records"][0]) == pytest.approx(7.0)
    assert steps.server_tail(out["records"][1]) == pytest.approx(3.0)
    assert steps.server_tail(out["records"][2]) is None
    assert ps_server_sum_ms.read(_rec(out)) == pytest.approx(5.0)


def test_device_gap_pct_is_the_gaps_over_the_window():
    # 70 ms of gaps in a window of 2.4 s
    assert device_gap_pct.read(_rec(_ps_out())) == pytest.approx(
        100 * 0.070 / 2.4)


def test_idle_gaps_sum_by_name_longest_first():
    got = steps.idle_gaps_of(_ps_out())
    assert [n for n, _ in got] == ["collect/wait leaf 0", "between steps"]
    assert [v for _, v in got] == [pytest.approx(0.050),
                                   pytest.approx(0.020)]
    many = {"records": [], "start": 0.0, "end": 1.0,
            "gaps": [Gap(0, f"g{i}", 0.0, i / 100) for i in range(15)]}
    top = steps.idle_gaps_of(many)
    assert len(top) == 10 and top[0] == ["g14", 0.14]


def test_collective_records_have_gaps_and_no_tails():
    marks = [Mark("zero_grad", "compute", None, 0.0, 0.0, 0),
             Mark("synchronize", "compute", None, 0.07, 70.0, 0),
             Mark("synchronized", "compute", None, 0.071, 71.0, 0),
             Mark("update", "compute", None, 0.075, 75.0, 0)]
    out = {"records": [{"step": 0, "marks": marks, "spans": []}],
           "gaps": [Gap(0, "synchronize", 0.07, 0.001)],
           "start": 0.0, "end": 0.1}
    rec = _rec(out)
    assert device_gap_pct.read(rec) == pytest.approx(1.0)
    for reader in (ps_tail_d2h_ms, ps_tail_core_ms, ps_tail_h2d_ms,
                   ps_server_sum_ms):
        assert reader.read(rec) is None


def test_readers_find_nothing_without_a_step_trace():
    """A program without ``start_steps`` (the probe gives None), or a run
    with no card marks: every reader returns None and no gap is named."""
    for out in (None, {"records": [{"step": 0, "marks": [], "spans": []}],
                       "gaps": [], "start": 0.0, "end": 1.0}):
        rec = _rec(out)
        for reader in (device_gap_pct, ps_tail_d2h_ms, ps_tail_core_ms,
                       ps_tail_h2d_ms, ps_server_sum_ms):
            assert reader.read(rec) is None
        assert steps.idle_gaps_of(out) == []


def test_the_probe_gives_none_where_the_program_has_no_step_trace(
        monkeypatch):
    from byteps_tpu_torch.utils import timeline
    monkeypatch.delattr(timeline, "start_steps")
    rec = {"live": None, "log": lambda *a: None}
    assert steps.recorded(rec) is None
    assert device_gap_pct.read(rec) is None
