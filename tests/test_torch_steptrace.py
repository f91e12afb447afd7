"""The port's step trace (``byteps_tpu_torch.utils.timeline``
``start_steps`` / ``stop_steps``): one record a training step, with the
hook path's spans per leaf, the card's marks and the idle gaps between
them, and the C core's spans and round counters of the step's round.

Fast tests run the PS-mode ``DistributedOptimizer`` on the loopback
client (``tests/ps_loopback.py``, as ``tests/test_torch_overlap.py``
does) on the CPU, where there are no card marks; the gap rule is checked
as a pure function on synthetic marks. The core's side needs a real
fleet: one worker and one server (``ps`` marker, outside the fast tier),
run as a script this file is that worker.
"""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import byteps_tpu_torch as bps  # noqa: E402
from byteps_tpu_torch.utils import timeline  # noqa: E402
from byteps_tpu_torch.utils.timeline import Mark, Span  # noqa: E402
from ps_loopback import LoopbackClient, init_loopback  # noqa: E402

STEPS = 3


@pytest.fixture(autouse=True)
def _port_state(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("BYTEPS_PS_MODE", "collective")
    yield
    timeline.steps = None  # a test that failed mid-trace leaves none
    if bps.initialized():
        bps.shutdown()
    torch.set_num_threads(threads)


def _model(width=16):
    with torch.random.fork_rng():
        torch.manual_seed(5)
        return torch.nn.Sequential(
            torch.nn.Linear(6, width), torch.nn.Tanh(),
            torch.nn.Linear(width, width), torch.nn.Tanh(),
            torch.nn.Linear(width, 3))


def _batches(n=STEPS):
    g = torch.Generator().manual_seed(9)
    return [torch.randn(4, 6, generator=g) for _ in range(n)]


def _optimizer(model):
    return bps.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters())


def _train(model, opt, batches):
    losses = []
    for x in batches:
        opt.zero_grad()
        loss = model(x).pow(2).mean()
        loss.backward()
        opt.step()
        losses.append(loss.item())
    return losses


def _traced(model, opt, batches):
    timeline.start_steps()
    losses = _train(model, opt, batches)
    return losses, timeline.stop_steps()


def _one(spans, name, leaf):
    got = [s for s in spans if s.name == name and (
        leaf in s.leaf if isinstance(s.leaf, tuple) else s.leaf == leaf)]
    assert len(got) == 1, (name, leaf, got)
    return got[0]


def test_each_step_has_one_record_and_each_leaf_its_legs(monkeypatch):
    init_loopback(monkeypatch, LoopbackClient())
    model = _model()
    opt = _optimizer(model)
    _train(model, opt, _batches(1))  # window 0 untraced
    _, result = _traced(model, opt, _batches())
    recs = result["records"]
    # one record a step, whose id is the optimizer's window count (the
    # next window's is 4)
    assert [r["step"] for r in recs] == [1, 2, 3]
    assert opt.timings["step"] == 3 and opt._taps.windows == 4
    sizes = [p.nbytes for p in model.parameters()]
    for rec in recs:
        spans = rec["spans"]
        assert rec["round"] is None  # the loopback has no core
        assert rec["marks"] == [] and rec["gaps"] == []  # no card
        zero = _one(spans, "zero_grad", None)
        update = _one(spans, "update", None)
        collect = _one(spans, "collect", None)
        assert zero.end <= collect.start <= collect.end <= update.start
        for s in spans:
            assert zero.start <= s.start <= s.end <= update.end, s
        for i, n in enumerate(sizes):
            hook = _one(spans, "hook", i)
            d2h = _one(spans, "d2h", i)
            push = _one(spans, "push", i)
            wait = _one(spans, "wait", i)
            upload = _one(spans, "upload", i)
            assert hook.start == hook.end and push.start == push.end
            assert (hook.start <= d2h.end <= push.start <= wait.end
                    <= upload.start), (hook, d2h, push, wait, upload)
            for s in (wait, upload):
                assert s.parent == "collect"
                assert collect.start <= s.start <= s.end <= collect.end
            assert hook.nbytes == push.nbytes == upload.nbytes == n
        # the window dict the optimizer always kept is the record
        assert len(rec["pushes"]) == len(sizes) and rec["landed"]


def test_tracing_off_records_nothing_and_trains_the_same_bits(monkeypatch):
    init_loopback(monkeypatch, LoopbackClient())
    runs = []
    for traced in (False, True):
        model = _model()
        opt = _optimizer(model)
        if traced:
            losses, result = _traced(model, opt, _batches())
            assert len(result["records"]) == STEPS
        else:
            losses = _train(model, opt, _batches())
            assert timeline.steps is None
            assert "spans" not in opt.timings
            assert "spans" not in opt._taps.timeline
        runs.append((losses, [p.detach().clone()
                              for p in model.parameters()]))
        opt._taps.close()
    (l0, p0), (l1, p1) = runs
    assert l0 == l1
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


def test_collective_mode_records_zero_grad_synchronize_and_update():
    bps.init(device="cpu")
    model = _model()
    opt = _optimizer(model)
    _, result = _traced(model, opt, _batches())
    recs = result["records"]
    assert [r["step"] for r in recs] == list(range(STEPS))
    for rec in recs:
        assert [s.name for s in rec["spans"]] == [
            "zero_grad", "synchronize", "update"]
    assert opt.timings is recs[-1]


def test_plain_push_pull_records_its_legs(monkeypatch):
    """``ps.ps_push_pull``'s D2H, core and H2D legs are spans of the
    step trace (they were the module globals ``last_timings`` and
    ``last_bytes``)."""
    init_loopback(monkeypatch, LoopbackClient())
    bps.push_pull(torch.ones(8), name="untraced")
    timeline.start_steps()
    t0 = time.perf_counter()
    out = bps.push_pull(torch.ones(8), name="traced")
    t1 = time.perf_counter()
    result = timeline.stop_steps()
    assert torch.equal(out, torch.ones(8))
    legs = timeline.leg_seconds(result)
    assert set(legs) == {"d2h_s", "core_s", "h2d_s", "d2h_bytes",
                         "pushed_bytes"}
    assert legs["d2h_bytes"] == legs["pushed_bytes"] == 32
    spans = result["records"][0]["spans"]
    assert [s.name for s in spans] == ["d2h", "core", "h2d"]
    assert all(s.parent == "push_pull" and t0 <= s.start <= s.end <= t1
               for s in spans)
    assert sum(legs[k] for k in ("d2h_s", "core_s", "h2d_s")) <= t1 - t0


def test_one_step_trace_at_a_time():
    with pytest.raises(RuntimeError, match="no step trace"):
        timeline.stop_steps()
    timeline.start_steps()
    with pytest.raises(RuntimeError, match="running already"):
        timeline.start_steps()
    assert timeline.stop_steps()["records"] == []


def _marks(step, seq):
    return [Mark(name, lane, None, 100.0 + ms / 1e3, ms, step)
            for name, lane, ms in seq]


def test_idle_gaps_follow_the_quiet_pairs():
    """The gap rule on synthetic marks: a PS step (the tail after the last
    hook, then between steps), a collective step whose push_pull enqueued
    nothing; pairs with work between them (forward and backward, the
    update) and the copy stream's marks give none."""
    marks = (_marks(0, [("zero_grad", "compute", 0.0),
                        ("hook", "compute", 10.0),
                        ("hook", "compute", 30.0),
                        ("uploaded", "copy", 65.0),
                        ("collected", "compute", 60.0),
                        ("update", "compute", 70.0)])
             + _marks(1, [("zero_grad", "compute", 75.0),
                          ("synchronize", "compute", 90.0),
                          ("synchronized", "compute", 94.0),
                          ("update", "compute", 99.0)]))
    h = 100.0
    spans = [Span("collect", h + 0.032, h + 0.0605, None, None, 0),
             Span("wait", h + 0.0321, h + 0.0603, "collect", 0, 0),
             Span("d2h", h + 0.029, h + 0.0312, None, (1, 2), 8),
             Span("synchronize", h + 0.089, h + 0.0945, None, None, 0),
             Span("hook", h + 0.045, h + 0.045, None, 3, 4)]
    gaps = timeline.idle_gaps(marks[::-1], spans)
    assert [(g.step, g.name) for g in gaps] == [
        (0, "collect/wait leaf 0"), (0, "between steps"),
        (1, "synchronize")]
    assert [round(g.seconds, 9) for g in gaps] == [0.03, 0.005, 0.004]
    assert gaps[0].start == pytest.approx(h + 0.030)


def test_gap_name_takes_the_innermost_open_span():
    spans = [Span("collect", 0.0, 10.0, None, None, 0),
             Span("d2h", 1.0, 3.0, None, (5, 2, 4), 0)]
    assert timeline.gap_name(2.0, spans) == "d2h leaves 2-5"
    assert timeline.gap_name(4.0, spans) == "collect"
    assert timeline.gap_name(10.0, spans) == "between steps"


def test_on_host_maps_the_card_clock_between_anchors():
    # the card's clock runs 1e-5 faster than the host's
    assert timeline.on_host(5.0, 7.0, 2000.02, 1000.01) == pytest.approx(6.0)


def test_core_clock_is_the_host_clock():
    """The core stamps its spans with ``steady_clock``
    (CLOCK_MONOTONIC); the step trace's host spans use
    ``time.perf_counter``: the two must be one clock."""
    from byteps_tpu_torch.core import ffi
    ffi.ensure_built()
    ffi.now_us()  # load first
    before = time.perf_counter()
    now = ffi.now_us() / 1e6
    after = time.perf_counter()
    assert before - 1e-3 <= now <= after + 1e-3


_ARM_PROBE = """
import json, sys
from byteps_tpu_torch.core import ffi
lib = ffi._load()
ffi.trace_arm(True)
lib.bps_trace_note(b"armed", 1)
ffi.trace_arm(False)
lib.bps_trace_note(b"disarmed", 2)
lib.bps_dump_trace(sys.argv[1].encode())
print(json.dumps(sorted(e["name"] for e in
                        json.load(open(sys.argv[1]))["traceEvents"])))
"""


def test_the_core_ring_is_armed_at_run_time(tmp_path):
    """``bps_trace_arm`` turns the core's main ring on and off whatever
    BYTEPS_TRACE_ON says (a fresh process, the variable unset)."""
    from byteps_tpu_torch.core import ffi
    ffi.ensure_built()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("BYTEPS_TRACE")}
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c", _ARM_PROBE, str(tmp_path / "ring.json")],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.splitlines()[-1]) == ["armed"]


# --- the fleet ---------------------------------------------------------------

@pytest.mark.ps
def test_core_records_carry_the_step_round_and_the_server_sum():
    """One worker and one server on the CPU: the core's push and pull
    spans of each traced step carry the step's id as their round, the
    record's ``round`` reads it back, each key's sum instant carries the
    server's summation time of the key, which add up to the round's
    ``RoundStats`` ``sum_us``, and the ring and the worker's trace sites
    are disarmed once tracing stops."""
    from ps_utils import spawn_worker, topology_env

    from byteps_tpu_torch.core import build
    from byteps_tpu_torch.utils.ports import free_port
    build.build(verbose=False)
    env = topology_env(1, 1, free_port(), {"BYTEPS_PS_MODE": "ps"})
    procs = [(role, subprocess.Popen(
        [sys.executable, "-m", "byteps_tpu_torch.server"],
        env=dict(env, DMLC_ROLE=role), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True))
        for role in ("scheduler", "server")]
    procs.append(("worker", spawn_worker(os.path.abspath(__file__), env, 0)))
    outs = {}
    try:
        for name, p in procs:
            outs[name], _ = p.communicate(timeout=180)
            assert p.returncode == 0, f"{name}:\n{outs[name]}"
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    got = json.loads(outs["worker"].splitlines()[-1])
    assert [r["step"] for r in got["records"]] == [1, 2, 3]
    n = len(got["keys"])
    for r in got["records"]:
        assert r["round"] == r["step"], got
        # every tensor's push and pull in the step carry its round
        assert r["raw"] == {"push": [r["step"]] * n, "pull": [r["step"]] * n}
        assert r["core_keys"] == got["keys"]
        assert {"enqueue", "push", "pull"} == set(r["core_names"])
        assert r["sum_keys"] == got["keys"]
        if r["sum_us"] is not None:
            assert sum(r["sums_us"]) == r["sum_us"]
    summed = [r["sum_us"] for r in got["records"] if r["sum_us"] is not None]
    assert len(summed) >= 2 and min(summed) > 0, got
    assert got["after_stop"] == [] and got["dropped"] == 0


def _fleet_worker() -> int:
    """The fleet test's worker: 1 untraced and 3 traced steps of a model
    whose 1 MB leaf takes the server measurable time to sum, the core's
    ring drained into a file of its own; prints one JSON line."""
    torch.set_num_threads(2)
    bps.init(device="cpu")
    tmp = os.environ.get("TMPDIR", "/tmp")
    path = os.path.join(tmp, f"steptrace_{os.getpid()}.json")
    try:
        model = _model(width=512)
        opt = _optimizer(model)
        _train(model, opt, _batches(1))
        timeline.start_steps()
        _train(model, opt, _batches())
        result = timeline.stop_steps(core_path=path)
        with open(path) as f:
            raw = json.load(f)["traceEvents"]
        _train(model, opt, _batches(1))  # untraced: the ring stays empty
        bps._st().ps_client.dump_trace(path)
        with open(path) as f:
            after = [e["name"] for e in json.load(f)["traceEvents"]
                     if e.get("name") in timeline.CORE]
        tids = sorted(opt._taps.tids.values())
        records = []
        for r in result["records"]:
            lo = r["spans"][0].start
            hi = max(s.end for s in r["spans"])
            records.append({
                "step": r["step"], "round": r["round"],
                "raw": {name: [e["args"]["round"] for e in raw
                               if e["name"] == name
                               and e["args"]["key"] >> 16 in tids
                               and lo <= e["ts"] / 1e6 <= hi]
                        for name in ("push", "pull")},
                "core_names": sorted({s.name for s in r["core"]}),
                "core_keys": sorted({s.leaf >> 16 for s in r["core"]}),
                "sum_keys": sorted({k >> 16 for _, k, _ in r["sums"]}),
                "sums_us": [round(s * 1e6) for _, _, s in r["sums"]],
                "sum_us": (r["round_stats"] or {}).get("sum_us")})
        print(json.dumps({"records": records, "keys": tids,
                          "after_stop": after,
                          "dropped": result["core_dropped"]}))
        return 0
    finally:
        if os.path.exists(path):
            os.unlink(path)
        bps.shutdown()


if __name__ == "__main__":
    sys.exit(_fleet_worker())
