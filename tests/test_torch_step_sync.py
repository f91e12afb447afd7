"""The collective training steps never make the card wait for the host.

On the card (``cuda``): one warmed-up step of GPT-2 small in bf16 (full
width, 8 x 512 tokens, flash attention, AdamW: chip_smoke.py's phase 3),
of ResNet-50 (224^2, batch 256, bf16, SGD: phase 5 (a)) and of
Moonlight-16B-A3B at its published widths (three of its layers, the dense
one and two expert layers holding 8 of 64 experts, 2 x 4096 tokens,
through ``bps.DistributedOptimizer(AdamW)`` and the correction-bias
update: the expert layer's sort, counts and grouped products stay on the
card) under
``torch.cuda.set_sync_debug_mode("error")``, with the caching allocator's
retries unchanged across it (a retry frees the cache with cudaFree, which
waits for the card, and the debug mode does not see it); then each step
behind a sleep of the card, where ``chip_smoke._card_backlog`` must find
that the card never waited for the host, and a planted wait (an
``.item()`` between two steps) where it must find that it did.

On the CPU: ``_card_backlog``'s arithmetic against a stand-in card whose
events report when a card that runs behind the host (or one that runs
every launch at once) would reach them; ``_profile_step`` failing an
allocator retry on every path, and reporting no card time where the card
waited for the host.
"""

import time

import pytest
import torch

import chip_smoke as cs


class _Card:
    """Stands in for ``torch.cuda``'s Event, synchronize, _sleep and
    current_stream: the card reaches an event recorded before the sleep at
    once (it is idle), sleeps ``sleep_s`` from the ``_sleep`` call, then
    reaches each event ``lag_s`` after the host recorded it, or at the
    sleep's end if that is later."""

    def __init__(self, monkeypatch, sleep_s, lag_s):
        card = self
        self.sleep_end = None

        class Event:
            def __init__(self, enable_timing=False):
                self.at = None

            def record(self, stream=None):
                now = time.perf_counter()
                self.at = (now if card.sleep_end is None
                           else max(now + lag_s, card.sleep_end))

            def elapsed_time(self, other):
                return (other.at - self.at) * 1e3

        def sleep(cycles):
            card.sleep_end = time.perf_counter() + sleep_s

        monkeypatch.setattr(torch.cuda, "Event", Event)
        monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
        monkeypatch.setattr(torch.cuda, "_sleep", sleep)
        monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: None)


def _host_step(seconds=0.02, ops=40):
    """A step as the host sees it: ``ops`` launches over ``seconds``."""
    for _ in range(ops):
        time.sleep(seconds / ops)


def test_backlog_reads_exact_where_the_card_stays_behind(monkeypatch):
    # the card reaches each launch 200 ms after the host made it: it is
    # always behind, so it never waits
    _Card(monkeypatch, sleep_s=0.01, lag_s=0.2)
    got = cs._card_backlog(_host_step)
    assert got["device_ms_exact"] and got["backlog_ms"] > 0, got
    assert got["markers"] > 2


def test_backlog_reads_a_wait_where_the_card_catches_up(monkeypatch):
    # the card runs each launch as soon as it is made: once the sleep is
    # over it waits for the host between launches
    _Card(monkeypatch, sleep_s=0.005, lag_s=0.0)
    got = cs._card_backlog(_host_step)
    assert not got["device_ms_exact"] and got["backlog_ms"] < 0, got


def test_host_wait_is_told_apart_from_the_card_waiting(monkeypatch):
    # a host that outlasts the sleep (as behind a full launch queue) while
    # the card stays behind it: the host waited, the card did not
    _Card(monkeypatch, sleep_s=0.005, lag_s=0.1)
    got = cs._card_backlog(lambda: _host_step(seconds=0.2))
    assert got["host_waited"] and got["device_ms_exact"], got


class _NoProfiler:
    """Stands in for ``torch.profiler.profile``: a profile that saw
    nothing."""

    def __init__(self, activities=()):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def events(self):
        return []


def _profile(monkeypatch, retries, backlog_ms, require_exact):
    """``chip_smoke._profile_step`` of a host-only step, its allocator
    making ``retries`` retries and the card behind the sleep reading
    ``backlog_ms``: the card took 40 ms for the step."""
    import torch.profiler
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.profiler, "profile", _NoProfiler)
    monkeypatch.setattr(cs, "_sync_debug_step", lambda run: {
        "num_alloc_retries": retries, "num_device_alloc": 0,
        "num_device_free": 0})
    monkeypatch.setattr(cs, "_card_backlog", lambda run: {
        "device_ms": 40.0, "enqueue_behind_sleep_ms": 30.0,
        "sleep_ms": 500.0, "host_waited": False, "markers": 9,
        "backlog_ms": backlog_ms, "device_ms_exact": backlog_ms > 0})
    return cs._profile_step(lambda: None, require_exact=require_exact)


@pytest.mark.parametrize("require_exact", [False, True])
def test_profile_fails_an_allocator_retry_on_every_path(monkeypatch,
                                                        require_exact):
    # a retry frees the cache with cudaFree, which waits for the card:
    # it fails the step whether or not the card's time must be exact
    with pytest.raises(AssertionError, match="allocator retried"):
        _profile(monkeypatch, retries=1, backlog_ms=5.0,
                 require_exact=require_exact)


def test_profile_keeps_an_exact_card_time(monkeypatch):
    got = _profile(monkeypatch, retries=0, backlog_ms=5.0,
                   require_exact=True)
    assert got["device_ms"] == 40.0 and got["device_ms_upper_bound"] is None
    assert got["profiled_share"] == 0.0
    # the median of the steps after the first: 50 ms
    assert cs._idle_share(got, [90.0, 50.0, 50.0, 60.0]) == pytest.approx(0.2)
    assert cs._per_card_ms(10.0, got) == pytest.approx(0.25)


def test_profile_gives_no_card_time_where_the_card_waited(monkeypatch):
    # the card caught up with the host: its 40 ms are only an upper
    # bound, so neither the card's time nor a share of it is reported
    got = _profile(monkeypatch, retries=0, backlog_ms=-1.0,
                   require_exact=False)
    assert got["device_ms"] is None and got["device_ms_upper_bound"] == 40.0
    assert got["profiled_share"] is None
    assert cs._idle_share(got, [90.0, 50.0]) is None
    assert cs._per_card_ms(10.0, got) is None
    with pytest.raises(AssertionError, match="waited for the host"):
        _profile(monkeypatch, retries=0, backlog_ms=-1.0,
                 require_exact=True)


def _gpt2_bf16():
    from byteps_tpu_torch.training import make_train_step
    model = cs._model()
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4)
    step = make_train_step(cs._loss_fn, opt)
    tokens = cs._tokens(next(model.parameters()).device)
    return lambda: step(model, tokens)


def _resnet50():
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    model = cs._resnet()
    batch = cs._images(cs.IMAGE_BATCH, next(model.parameters()).device)
    step = cs._resnet_step("collective", model)
    return lambda: step(batch)


def _moonlight():
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.models import Moonlight16B, moe_lm_loss
    model = Moonlight16B(num_layers=3, vocab_size=20480, experts=(0, 8),
                         attn_impl="flash")
    opt = bps.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=2.2e-4, betas=(0.9, 0.95),
                          weight_decay=0.1),
        named_parameters=model.named_parameters())
    tokens = torch.randint(0, 20480, (2, 4096),
                           generator=torch.Generator().manual_seed(0)).cuda()

    def step():
        opt.zero_grad()
        loss = moe_lm_loss(model(tokens), tokens)
        loss.backward()
        opt.step()
        model.update_bias()
        return loss
    return step


@pytest.mark.cuda
@pytest.mark.parametrize("build", [_gpt2_bf16, _resnet50, _moonlight],
                         ids=["gpt2_small_bf16", "resnet50", "moonlight"])
def test_step_makes_the_card_wait_nowhere(build, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import byteps_tpu_torch as bps
    monkeypatch.setenv("BYTEPS_PS_MODE", "collective")
    bps.init()
    try:
        run = build()
        for _ in range(2):
            run()
        torch.cuda.synchronize()
        allocator = cs._sync_debug_step(run)
        assert allocator["num_alloc_retries"] == 0, allocator
        backlog = cs._card_backlog(run)
        planted = cs._card_backlog(lambda: [run().item(), run()])
        print(f"{build.__name__}: {backlog}; planted wait: {planted}")
        assert backlog["device_ms_exact"], backlog
        assert not planted["device_ms_exact"], planted
    finally:
        bps.shutdown()
        torch.cuda.empty_cache()
