"""The port's training callbacks (``byteps_tpu_torch.callbacks``) against
``byteps_tpu.callbacks``: the warmup callback's and ``warmup_schedule``'s
learning rates equal the JAX ones; ``MetricAverageCallback`` averages
over two gloo processes and, in PS mode, goes through the servers
(``tests/ps_loopback.py`` stands in for the core);
``BroadcastGlobalVariablesCallback`` overwrites rank 1's model and
optimizer with rank 0's; ``MonitorCallback`` publishes its step metrics
through the port's monitor.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import byteps_tpu.callbacks as jcb
import byteps_tpu_torch as bps
from byteps_tpu_torch import callbacks as cb
from byteps_tpu_torch.monitor import metrics
from byteps_tpu_torch.utils.ports import free_port
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


def test_warmup_callback_matches_the_reference():
    kw = dict(initial_lr=0.1, multiplier=4.0, warmup_epochs=2,
              steps_per_epoch=4)
    lrs = []
    for mod in (cb, jcb):
        c = mod.CallbackList([mod.LearningRateWarmupCallback(**kw)])
        state = {}
        c.on_train_begin(state)
        seq = [state["lr"]]
        for epoch in range(3):
            c.on_epoch_begin(epoch, state)
            for batch in range(4):
                c.on_batch_end(batch, state)
                seq.append(state["lr"])
            c.on_epoch_end(epoch, state)
        lrs.append(seq)
    assert lrs[0] == lrs[1]
    assert lrs[0][0] == 0.1 and lrs[0][-1] == pytest.approx(0.4)


@pytest.mark.parametrize("multiplier", [4.0, 0.5])
def test_warmup_schedule_matches_the_reference(multiplier):
    warmup = 10
    port = cb.warmup_schedule(0.1, multiplier, warmup_steps=warmup)
    ref = jcb.warmup_schedule(0.1, multiplier, warmup_steps=warmup)
    got = np.array([port(s) for s in range(2 * warmup + 1)])
    want = np.array([float(ref(s)) for s in range(2 * warmup + 1)])
    # the reference computes in f32
    np.testing.assert_allclose(got, want, rtol=2e-7)


def test_warmup_schedule_defaults_to_the_worker_count():
    bps.init(device="cpu")
    assert cb.warmup_schedule(0.1, warmup_steps=4)(4) == pytest.approx(0.1)


def test_metric_average_in_ps_mode_goes_through_the_servers(monkeypatch):
    client = LoopbackClient()
    init_loopback(monkeypatch, client)
    state = {"metrics": {"loss": 2.5, "acc": 0.75}}
    cb.MetricAverageCallback().on_epoch_end(0, state)
    # one worker: the mean is the value
    assert state["metrics"] == {"acc": 0.75, "loss": 2.5}
    assert [d[0].startswith("metric_avg") for d in client.declares] == [True]
    assert client.declares[0][1:3] == (2, "float32")


def test_monitor_callback_publishes_step_metrics():
    bps.init(device="cpu")
    before = metrics._py_counters.get("bps_train_steps_total", 0.0)
    mon = cb.MonitorCallback(batch_size=8)
    jmon = jcb.MonitorCallback(batch_size=8)
    state, jstate = {}, {}
    mon.on_train_begin(state)
    jmon.on_train_begin(jstate)
    for b in range(3):
        mon.on_batch_end(b, state)
        jmon.on_batch_end(b, jstate)
    assert (metrics._py_counters["bps_train_steps_total"]
            == before + 3)
    assert metrics._py_gauges["bps_step_seconds"] >= 0.0
    assert metrics._py_gauges["bps_examples_per_sec"] > 0.0
    # the queue's entries appear where a process has loaded that
    # package's core (another test may have)
    core_keys = {"queue_pending", "credit_inflight_bytes"}
    assert (set(state["monitor"]) - core_keys
            == set(jstate["monitor"]) - core_keys)
    assert state["monitor"]["step"] == jstate["monitor"]["step"] == 3
    assert state["monitor"]["wire_sent_bytes"] == 0  # no traffic


# --- two gloo processes -------------------------------------------------------

def _gloo_worker(rank, world, port, out_dir):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        os.environ["BYTEPS_PS_MODE"] = "collective"
        torch.set_num_threads(1)
        bps.init(device="cpu")
        torch.manual_seed(rank)  # different weights on each rank
        model = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Tanh(),
                                    torch.nn.Linear(8, 2))
        opt = torch.optim.AdamW(model.parameters(), lr=1e-3 * (rank + 1))
        (model(torch.ones(3, 4)).sum() * (rank + 1)).backward()
        opt.step()
        state = {"model": model, "optimizer": opt,
                 "metrics": {"loss": float(rank + 1),
                             "acc": 10.0 * (rank + 1)}}
        callbacks = cb.CallbackList([cb.BroadcastGlobalVariablesCallback(0),
                                     cb.MetricAverageCallback()])
        callbacks.on_train_begin(state)
        callbacks.on_epoch_end(0, state)
        osd = opt.state_dict()
        torch.save({"model": {k: v.numpy().copy()
                              for k, v in model.state_dict().items()},
                    "opt": [(i, k, v.numpy().copy())
                            for i, s in sorted(osd["state"].items())
                            for k, v in sorted(s.items())],
                    "lr": osd["param_groups"][0]["lr"],
                    "metrics": state["metrics"]},
                   os.path.join(out_dir, f"r{rank}.pt"))
        bps.shutdown()
    finally:
        dist.destroy_process_group()


def test_broadcast_and_metric_average_over_gloo(tmp_path):
    mp.spawn(_gloo_worker, args=(2, free_port(), str(tmp_path)), nprocs=2,
             join=True)
    r0, r1 = (torch.load(tmp_path / f"r{i}.pt", weights_only=False)
              for i in range(2))
    torch.manual_seed(0)
    root = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Tanh(),
                               torch.nn.Linear(8, 2))
    # rank 0's weights after its own step differ from its initial ones;
    # rank 1 now holds exactly rank 0's
    for k, v in r0["model"].items():
        np.testing.assert_array_equal(r1["model"][k], v)
        assert not np.array_equal(v, root.state_dict()[k].numpy())
    assert len(r0["opt"]) == len(r1["opt"]) == 12  # step, m, v x 4
    for (i0, k0, v0), (i1, k1, v1) in zip(r0["opt"], r1["opt"]):
        assert (i0, k0) == (i1, k1)
        np.testing.assert_array_equal(v0, v1)
    # broadcast_optimizer_state takes the param_groups from the root too,
    # as the reference torch plugin does: rank 1 now holds rank 0's lr
    assert (r0["lr"], r1["lr"]) == (1e-3, 1e-3)
    assert r0["metrics"] == r1["metrics"] == {"acc": 15.0, "loss": 1.5}
