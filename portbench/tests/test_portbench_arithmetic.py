"""The yardstick's arithmetic on synthetic inputs: order statistics,
roofline bounds, model operations, the clocks, the wire number of the
comparison and the readers."""

import math

import pytest

from portbench import cell as cells
from portbench import check, clock, roofline, stats
from portbench.metrics import (device_idle_pct, mfu, peak_mem_gib,
                               ps_exposed_ms, ps_leg_gbps,
                               ps_pushed_early_pct, ps_wire_mb)
from portbench.reference import gpt2, resnet


def test_percentile_interpolates_between_ranks():
    xs = list(range(1, 11))
    assert stats.percentile(xs, 90) == pytest.approx(9.1)
    assert stats.percentile(xs, 50) == pytest.approx(5.5)
    assert stats.percentile([3.0], 90) == 3.0
    assert stats.percentile(reversed(xs), 0) == 1


def test_live_pairs_and_bounds():
    assert roofline.live_pairs(1024, 1024, True) == 1024 * 1025 // 2
    assert roofline.live_pairs(8, 8, False) == 64
    assert roofline.live_pairs(8, 8, True, window=2) == 1 + 2 * 7
    b, h, s, d, elem = 12, 12, 1024, 64, 2
    ms, by = roofline.bound_ms("fwd_lse", b, h, s, s, d, elem, True, None,
                               "bfloat16")
    ops = 4 * d * b * h * (s * (s + 1) // 2)
    nbytes = 4 * b * s * h * d * elem + b * h * s * 4
    assert ms == pytest.approx(max(ops / 989e12, nbytes / 3.35e12) * 1e3)
    assert by == ("operations" if ops / 989e12 > nbytes / 3.35e12
                  else "bytes")


def _count(specs, skip=()):
    return sum(math.prod(shape) for name, shape, _ in specs
               if name not in skip)


def test_gpt2_small_parameters_and_operations():
    cfg = cells.load("gpt2s-coll").cfg
    specs = gpt2.specs(cfg)
    assert _count(specs) == 124_439_808  # GPT-2 124M, position table in
    traffic = {"batch": 12, "seq": 1024}
    tokens = 12 * 1024
    want = (6 * _count(specs, {"pos_embed.embedding"}) * tokens
            + 12 * 12 * 768 * 1024 * tokens)
    assert gpt2.train_flops(cfg, traffic) == want
    assert 10.4e12 < want < 10.6e12


def test_resnet50_parameters_and_operations():
    cfg = cells.load("resnet50-coll").cfg
    assert _count(resnet.specs(cfg)) == 25_557_032  # He et al.'s 25.6 M
    macs = resnet.forward_macs(cfg)
    assert 4.05e9 < macs < 4.15e9  # v1.5: 4.1 G multiply-adds at 224
    assert resnet.train_flops(cfg, {"batch": 256}) == 6 * macs * 256


def test_card_events_map_onto_the_host_clock_through_both_anchors():
    # anchors enqueued at host 10.0 and 12.0, 1999 ms apart on the card:
    # the card's clock runs 0.05 % slow against the host's
    assert clock.on_host(10.0, 12.0, 1999.0, 0.0) == pytest.approx(10.0)
    assert clock.on_host(10.0, 12.0, 1999.0, 1999.0) == pytest.approx(12.0)
    assert clock.on_host(10.0, 12.0, 1999.0, 999.5) == pytest.approx(11.0)


def test_wire_short_is_the_share_of_the_gradient_a_step_did_not_move():
    got = {"losses": [1.0], "grad_norms": {"w": 1.0},
           "change_norms": {"w": 1.0}}
    want = dict(got, step_grad_norms=[{"w": 1.0}], grad_bytes=400)
    # headers make a sound step move more than the gradient: 0
    sound = check.numbers(dict(got, wire=[(420, 410), (401, 400)]), want)
    assert sound["wire_short"] == 0.0
    # a pull that brought back half, and a step that moved nothing
    assert check.numbers(dict(got, wire=[(420, 200)]), want)[
        "wire_short"] == pytest.approx(0.5)
    assert check.numbers(dict(got, wire=[(420, 410), (0, 0)]), want)[
        "wire_short"] == 1.0
    # a collective run has no wire to read
    assert "wire_short" not in check.numbers(got, want)


def test_a_number_the_limits_name_and_the_run_did_not_read_fails():
    limits = {"loss_gap": 1e-4, "wire_short": 0.0}
    ok, pairs = check.verdict({"loss_gap": 0.0, "wire_short": 0.0}, limits)
    assert ok and list(pairs) == ["loss_gap", "wire_short"]
    ok, pairs = check.verdict({"loss_gap": 0.0}, limits)
    assert not ok and pairs["wire_short"] == [None, 0.0]
    assert not check.verdict({"loss_gap": math.nan, "wire_short": 0.0},
                             limits)[0]


def _ps_rec():
    # two steps: the card ends backward at 1.1 (and 11.1); pushes of 100
    # and 300 bytes, one before and one after; the last pull lands at 1.5
    steps = []
    for k, t0 in enumerate((0.0, 10.0)):
        steps.append({
            "start": t0, "bwd_end": t0 + 1.0, "bwd_card": t0 + 1.1,
            "end": t0 + 2.0,
            "timings": {"pushes": [(t0 + 0.5, 100), (t0 + 1.2, 300)],
                        "landed": t0 + 1.5},
            "van": (1000 * (k + 1), 900 * (k + 1))})
    return {"steps": steps, "van_start": (0, 0), "peak_bytes": 2 ** 31,
            "probes": {"card_busy": {"ms": 500.0}},
            "log": lambda *a: None}


def test_ps_readers():
    rec = _ps_rec()
    assert ps_exposed_ms.read(rec) == pytest.approx(400.0)
    assert ps_pushed_early_pct.read(rec) == pytest.approx(25.0)
    assert ps_wire_mb.read(rec) == pytest.approx(1000 / 1e6)
    # 1900 bytes a step from the first push (0.5) to landed (1.5)
    assert ps_leg_gbps.read(rec) == pytest.approx(1900 / 1.0 / 1e9)
    assert peak_mem_gib.read(rec) == 2.0
    # 500 ms of the card's own time in steps of 2 s
    assert device_idle_pct.read(rec) == pytest.approx(75.0)


def test_ps_readers_find_nothing_in_a_collective_cell():
    rec = _ps_rec()
    for s in rec["steps"]:
        s["timings"] = {}
        del s["van"]
    del rec["van_start"]
    for reader in (ps_exposed_ms, ps_pushed_early_pct, ps_wire_mb,
                   ps_leg_gbps):
        assert reader.read(rec) is None


def test_mfu_is_the_model_operations_over_the_mean_step():
    c = cells.load("gpt2s-coll")
    rec = {"cell": c, "steps": [{"start": 0.0, "end": 0.1},
                                {"start": 0.1, "end": 0.3}]}
    flops = gpt2.train_flops(c.cfg, c.traffic)
    assert mfu.read(rec) == pytest.approx(100 * flops / 0.15 / 989e12)
