"""The traced window's busy time from the card's span of each step
(``clock.window_busy``) on synthetic timelines of one stream: a host that
enqueues a step's forward, backward and update, may wait for a PS round
trip, reads the loss back and does host work before the next step, and a
card that runs the stream in order. The card's true busy intervals are
known, so each reading is held to them."""

import math
import random

import pytest

from portbench import clock


class Timeline:
    """One stream: ``launch`` enqueues a kernel at the host's clock ``t``
    after ``cost`` seconds of host work, and the card starts it once it
    is queued and the kernel before it has ended; ``event`` is when the
    card reaches an event recorded now."""

    def __init__(self, t=0.0):
        self.t0 = self.t = self.card_end = t
        self.busy = []

    def launch(self, seconds, cost):
        self.t += cost
        start = max(self.t, self.card_end)
        self.card_end = start + seconds
        self.busy.append((start, self.card_end))

    def event(self):
        return max(self.t, self.card_end)

    def kernels(self, n, seconds, cost):
        for _ in range(n):
            self.launch(seconds / n, cost)

    def step(self, fwd, bwd, upd=(4, 0.004, 1e-5), wait=0.0, after=1e-3):
        """One step as the program runs it: ``fwd``, ``bwd`` and ``upd``
        are (kernels, card seconds, host seconds a launch); ``wait`` the
        host's wait for the round trip after backward; then the loss read
        and ``after`` seconds of host work. Returns the card's (start,
        backward, resume, end) as ``window_busy`` takes them."""
        start = self.event()
        self.kernels(*fwd)
        self.kernels(*bwd)
        bwd_end = self.event()
        self.t += wait
        landed = self.t
        self.kernels(*upd)
        end = self.event()
        self.t = max(self.t, self.card_end)  # the loss read
        self.t += after
        return start, bwd_end, max(bwd_end, landed), end

    def true_busy(self, lo, hi):
        return clock.clipped(self.busy, lo, hi)


def paced_idle(fwd, bwd):
    """``trace.paced_idle`` on a timeline: a step's forward and backward
    with the card idle at its start, less the card's own time for them."""
    tl = Timeline()
    start = tl.event()
    tl.kernels(*fwd)
    tl.kernels(*bwd)
    return tl.event() - start - fwd[1] - bwd[1]


# GPT-2 small's step on the H100 in shape: a forward that the host's
# launches pace (400 kernels of 45 us, 50 us a launch), a backward the
# host enqueues ahead of the card, an update
FWD, BWD = (400, 0.018, 5e-5), (800, 0.036, 3e-5)


def _read(tl, card, paced, lo=None, hi=None):
    lo = tl.t0 if lo is None else lo
    hi = tl.t if hi is None else hi
    return clock.window_busy(card, paced, lo, hi)


def test_a_card_bound_step_reads_its_card_time():
    tl = Timeline()
    fwd, bwd = (100, 0.02, 1e-5), (200, 0.04, 1e-5)
    card = [tl.step(fwd, bwd) for _ in range(50)]
    paced = paced_idle(fwd, bwd)
    assert paced == pytest.approx(1e-5)  # the first launch only
    got = _read(tl, card, paced)
    assert got["busy_s"] == pytest.approx(tl.true_busy(tl.t0, tl.t),
                                          rel=1e-9)
    # idle: the host's work after each loss read, and its first launch
    assert tl.t - got["busy_s"] == pytest.approx(50 * (1e-3 + 1e-5),
                                                 rel=1e-6)


def test_a_host_paced_forward_reads_its_card_time_and_the_upper_does_not():
    tl = Timeline()
    card = [tl.step(FWD, BWD) for _ in range(40)]
    paced = paced_idle(FWD, BWD)
    assert paced > 1e-3  # the card waits for the launches
    got = _read(tl, card, paced)
    true = tl.true_busy(tl.t0, tl.t)
    assert got["busy_s"] == pytest.approx(true, rel=1e-9)
    assert got["busy_s_upper"] - true == pytest.approx(40 * paced, rel=1e-6)


def test_planted_host_gaps_count_as_idle():
    tl = Timeline()
    steps, gap = 40, 0.05
    card = [tl.step(FWD, BWD, after=gap) for _ in range(steps)]
    got = _read(tl, card, paced_idle(FWD, BWD))
    idle = (tl.t - tl.t0) - got["busy_s"]
    assert idle >= steps * gap
    assert got["busy_s"] == pytest.approx(tl.true_busy(tl.t0, tl.t),
                                          rel=1e-9)


def test_the_card_is_busy_while_the_host_waits_in_a_loss_read():
    tl = Timeline()
    # each step enqueued in 1 ms, run in 60: the host waits 59 ms in the
    # read, then 1.5 ms of host work before the next step
    fwd, bwd = (50, 0.02, 1e-5), (50, 0.04, 1e-5)
    card = [tl.step(fwd, bwd, upd=(1, 1e-4, 1e-5), after=1.5e-3)
            for _ in range(25)]
    got = _read(tl, card, paced_idle(fwd, bwd))
    true = tl.true_busy(tl.t0, tl.t)
    assert true == pytest.approx(25 * 0.0601)
    assert got["busy_s"] == pytest.approx(true, rel=1e-9)
    assert (tl.t - tl.t0) - got["busy_s"] >= 25 * 1.5e-3


def test_the_round_trip_s_wait_counts_as_idle():
    tl = Timeline()
    # a PS step: the host waits 80 ms for the pulls after enqueuing the
    # backward, which the card ends well before them
    card = [tl.step(FWD, BWD, wait=0.08) for _ in range(30)]
    got = _read(tl, card, paced_idle(FWD, BWD))
    true = tl.true_busy(tl.t0, tl.t)
    # the update's first launch after the pulls landed reads busy
    assert true <= got["busy_s"] <= true + 30 * 1e-5 + 1e-12
    assert got["busy_s_upper"] - got["busy_s"] > 30 * 0.05


def test_intervals_are_cut_to_both_edges_of_the_window():
    tl = Timeline()
    fwd, bwd = (10, 0.2, 1e-5), (10, 0.4, 1e-5)
    card = [tl.step(fwd, bwd, after=0.1) for _ in range(5)]  # 3.5 s
    paced = paced_idle(fwd, bwd)
    inner = clock.window_busy(card, paced, 0.8, 1.3)  # inside one step
    assert inner["busy_s"] == pytest.approx(0.5)
    outer = clock.window_busy(card, paced, -1.0, 10.0)
    assert outer["busy_s"] == pytest.approx(tl.true_busy(-1.0, 10.0))
    # steps only before the window, only after it, or none at all
    assert clock.window_busy(card, paced, 10.0, 11.0)["busy_s"] == 0.0
    assert clock.window_busy(card, paced, -9.0, -8.0)["busy_s"] == 0.0
    assert clock.window_busy([], paced, 0.0, 1.0) == {
        "busy_s": 0.0, "busy_s_upper": 0.0}


@pytest.mark.parametrize("seed", range(12))
def test_random_timelines_never_read_busier_than_the_window(seed):
    rng = random.Random(seed)
    tl = Timeline(rng.uniform(-1.0, 1.0))

    def phase():
        return (rng.randint(1, 80), rng.expovariate(1 / 0.02),
                rng.choice((1e-6, 2e-5, 3e-4, 2e-3)))
    card = [tl.step(phase(), phase(), phase(),
                    wait=rng.choice((0.0, rng.expovariate(1 / 0.05))),
                    after=rng.choice((0.0, 1e-4, rng.expovariate(1 / 0.01))))
            for _ in range(rng.randint(5, 60))]
    # a pair of another step's shape: its idle need not be this one's
    paced = paced_idle(phase(), phase())
    lo = rng.uniform(tl.t0 - 0.05, tl.t)
    hi = lo + rng.uniform(0.0, tl.t - tl.t0 + 0.1)
    got = clock.window_busy(card, paced, lo, hi)
    assert 0.0 <= got["busy_s"] <= got["busy_s_upper"] <= hi - lo + 1e-12
    assert tl.true_busy(lo, hi) <= got["busy_s_upper"] + 1e-12


def test_uneven_steps_a_heavy_probe_step_overshoots_and_spans_do_not():
    tl = Timeline()
    rng = random.Random(7)
    # an expert layer's steps: the card's backward swings 4x from step to
    # step, the forward's host-paced part does not
    bwd_s = [rng.choice((0.3, 0.6, 0.9, 1.2)) for _ in range(40)]
    card = [tl.step(FWD, (800, s, 3e-5), after=4e-3) for s in bwd_s]
    window_s = tl.t - tl.t0
    mean = sum(FWD[1] + s + 0.004 for s in bwd_s) / len(bwd_s)
    probe_s = 3 * mean * len(bwd_s)  # one probe step at 3x the mean
    assert probe_s > window_s
    got = _read(tl, card, paced_idle(FWD, (800, 1.2, 3e-5)))
    assert got["busy_s"] <= window_s
    assert got["busy_s"] == pytest.approx(tl.true_busy(tl.t0, tl.t),
                                          rel=1e-9)


def test_a_step_read_out_of_order_is_refused():
    with pytest.raises(ValueError, match="step 1: .* out of order"):
        clock.window_busy([(0.0, 0.5, 0.5, 1.0), (2.0, 1.5, 2.5, 3.0)],
                          0.0, 0.0, 4.0)
    with pytest.raises(ValueError, match="step 0"):
        clock.window_busy([(0.0, 0.5, 0.4, 1.0)], 0.0, 0.0, 4.0)


def _pairs(paced, own):
    return [{"paced_ms": p, "own_ms": o} for p, o in zip(paced, own)]


def test_paced_idle_takes_the_window_where_the_work_is_even():
    # GPT-2's shape: the card's own time steady, the host's pace swinging
    rng = random.Random(3)
    idle = [rng.choice((1.3, 2.7, 3.0, 4.1, 8.5)) for _ in range(500)]
    window = [54.0 + i for i in idle]
    own = [54.0 + rng.uniform(-0.05, 0.05) for _ in range(8)]
    paced = [o + rng.choice(idle) for o in own]
    got = clock.paced_idle(_pairs(paced, own), window)
    assert got["by_window_se_ms"] < got["by_pairs_se_ms"]
    assert got["ms"] == got["by_window_ms"]
    assert got["ms"] == pytest.approx(sum(idle) / len(idle), abs=0.05)


def test_paced_idle_takes_the_pairs_where_the_work_swings():
    # an expert layer: the card's own time swings from batch to batch, the
    # window's batches heavier than the pairs'; the host's pace adds 3 ms
    rng = random.Random(4)
    window = [rng.uniform(630.0, 675.0) + 3.0 for _ in range(40)]
    own = [rng.uniform(605.0, 630.0) for _ in range(8)]
    paced = [o + 3.0 + rng.uniform(-0.5, 0.5) for o in own]
    got = clock.paced_idle(_pairs(paced, own), window)
    assert got["by_pairs_se_ms"] < got["by_window_se_ms"]
    assert got["ms"] == pytest.approx(3.0, abs=0.5)
    assert got["by_window_ms"] > 20.0  # the window's own estimate is off


def test_paced_idle_takes_the_pairs_where_the_work_swings_a_little():
    # Moonlight's readings on the H100: the pairs' own time spreads 1.6
    # ms, their idle 2.9 ms; the window's batches ran 10 ms heavier
    own = [621.0, 623.5, 624.1, 622.2, 625.3, 620.9, 624.0, 623.4]
    idle = [7.1, 4.0, 9.9, 5.2, 11.0, 6.3, 8.8, 9.6]
    paced = [o + i for o, i in zip(own, idle)]
    window = [633.0 + 10 * math.sin(i) for i in range(45)]
    got = clock.paced_idle(_pairs(paced, own), window)
    assert got["by_window_se_ms"] > got["by_pairs_se_ms"]
    assert got["ms"] == got["by_pairs_ms"]


def test_paced_idle_under_0_counts_0():
    got = clock.paced_idle(_pairs([10.0, 10.1, 9.9], [10.2, 10.2, 10.2]),
                           [10.0] * 50)
    assert got["by_window_ms"] < 0 and got["by_pairs_ms"] < 0
    assert got["ms"] == 0.0
