"""The port's checkpoint/resume (``byteps_tpu_torch.utils.checkpoint``)
against ``byteps_tpu.utils`` (orbax), as ``tests/test_aux.py`` holds the
JAX one: the same save sequence leaves the same step directories, the
round trip is exact with casts to the target, namedtuples restore by
field name, a missing checkpoint gives the target back, restore
broadcasts rank 0's values (one process, and two gloo processes whose
states differ), and an AdamW ``state_dict`` round-trips with its ``step``
tensors.
"""

import collections
import os
import socket

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import byteps_tpu.utils as jutils
import byteps_tpu_torch as bps
from byteps_tpu_torch.utils import (latest_step, restore_checkpoint,
                                    save_checkpoint)


@pytest.fixture(autouse=True)
def _port_state(monkeypatch):
    monkeypatch.setenv("BYTEPS_PS_MODE", "collective")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    if bps.initialized():
        bps.shutdown()


def _arrays(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal(3).astype(np.float32)}


def _state(seed=0):
    a = _arrays(seed)
    return {"params": {k: torch.from_numpy(v) for k, v in a.items()},
            "step": 7}


def test_save_sequence_and_prune_match_the_reference(tmp_path):
    a = _arrays(0)
    for s in (1, 2, 3, 4, 5):
        jutils.save_checkpoint(str(tmp_path / "jax"),
                               {k: jnp.asarray(v) for k, v in a.items()},
                               step=s, keep=3)
        save_checkpoint(str(tmp_path / "port"), _state(), step=s, keep=3)
    assert (sorted(os.listdir(tmp_path / "port"))
            == sorted(os.listdir(tmp_path / "jax"))
            == ["step_3", "step_4", "step_5"])
    assert (latest_step(str(tmp_path / "port"))
            == jutils.latest_step(str(tmp_path / "jax")) == 5)
    assert latest_step(str(tmp_path / "none")) is None


def test_round_trip_is_exact_with_casts_to_the_target(tmp_path):
    base = str(tmp_path / "ckpt")
    state = _state()
    save_checkpoint(base, state, step=10)
    later = {"params": {k: v + 1 for k, v in state["params"].items()},
             "step": 8}
    save_checkpoint(base, later, step=20)
    assert latest_step(base) == 20
    # the target sets each leaf's dtype and shape
    target = {"params": {"w": torch.zeros(12, dtype=torch.float64),
                         "b": torch.zeros(3, dtype=torch.bfloat16)},
              "step": 0.0}
    restored, step = restore_checkpoint(base, target, broadcast=False)
    assert step == 20 and restored["step"] == 8.0
    assert isinstance(restored["step"], float)
    w = restored["params"]["w"]
    assert w.dtype == torch.float64 and w.shape == (12,)
    np.testing.assert_array_equal(
        w.numpy(), later["params"]["w"].double().reshape(-1).numpy())
    assert restored["params"]["b"].dtype == torch.bfloat16
    assert torch.equal(restored["params"]["b"],
                       later["params"]["b"].to(torch.bfloat16))
    # an older step, as the reference's test asks for it
    old, step10 = restore_checkpoint(base, _state(1), step=10,
                                     broadcast=False)
    jbase = str(tmp_path / "jax")
    a = _arrays(0)
    jutils.save_checkpoint(jbase, {k: jnp.asarray(v) for k, v in a.items()},
                           step=10)
    jold, jstep = jutils.restore_checkpoint(
        jbase, {k: jnp.zeros_like(v) for k, v in a.items()},
        broadcast=False)
    assert step10 == jstep == 10
    for k in a:
        np.testing.assert_array_equal(old["params"][k].numpy(),
                                      np.asarray(jold[k]))


def test_namedtuple_restores_by_field_name(tmp_path):
    TS = collections.namedtuple("TS", "step bias")  # 's' sorts after 'b'
    base = str(tmp_path / "ckpt")
    save_checkpoint(base, TS(step=torch.tensor(1.0), bias=torch.tensor(7.0)),
                    step=1)
    # the target's fields in the other order: matched by name, not place
    TS2 = collections.namedtuple("TS2", "bias step")
    restored, _ = restore_checkpoint(
        base, TS2(bias=torch.tensor(0.0), step=torch.tensor(0.0)),
        broadcast=False)
    assert float(restored.step) == 1.0 and float(restored.bias) == 7.0
    jbase = str(tmp_path / "jax")

    JTS = collections.namedtuple("JTS", "step bias")
    jutils.save_checkpoint(jbase, JTS(jnp.asarray(1.0), jnp.asarray(7.0)),
                           step=1)
    jr, _ = jutils.restore_checkpoint(
        jbase, JTS(jnp.asarray(0.0), jnp.asarray(0.0)), broadcast=False)
    assert (float(jr.step), float(jr.bias)) == (float(restored.step),
                                                float(restored.bias))


def test_missing_checkpoint_returns_the_target(tmp_path):
    target = _state()
    out, step = restore_checkpoint(str(tmp_path / "none"), target)
    assert step is None and out is target
    jout, jstep = jutils.restore_checkpoint(str(tmp_path / "none"), target)
    assert jstep is None and jout is target


def test_missing_entry_names_its_path(tmp_path):
    base = str(tmp_path / "ckpt")
    save_checkpoint(base, _state(), step=1)
    with pytest.raises(KeyError, match="'params', 'extra'"):
        restore_checkpoint(base, {"params": {"extra": torch.zeros(1)}},
                           broadcast=False)


def test_restore_with_broadcast_one_process(tmp_path):
    bps.init(device="cpu")
    base = str(tmp_path / "ckpt")
    state = _state()
    save_checkpoint(base, state, step=1)
    restored, step = restore_checkpoint(base, _state(1), broadcast=True)
    assert step == 1
    for k, v in state["params"].items():
        assert torch.equal(restored["params"][k], v)


def test_only_rank_zero_writes(tmp_path):
    base = str(tmp_path / "ckpt")
    path = save_checkpoint(base, _state(), step=3, rank=1)
    assert path == os.path.join(base, "step_3")
    assert not os.path.exists(base)


def test_adamw_state_dict_round_trips(tmp_path):
    def stepped(seed):
        model = torch.nn.Linear(3, 2)
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(torch.from_numpy(np.random.default_rng(seed)
                                         .standard_normal(p.shape)))
        opt = torch.optim.AdamW(model.parameters(), lr=1e-3,
                                weight_decay=1e-4)
        for _ in range(seed + 1):
            opt.zero_grad()
            model(torch.ones(2, 3)).square().sum().backward()
            opt.step()
        return model, opt

    model, opt = stepped(2)
    base = str(tmp_path / "ckpt")
    save_checkpoint(base, {"model": model.state_dict(),
                           "optimizer": opt.state_dict(), "step": 3}, step=3)
    want = opt.state_dict()
    # into a primed optimizer (its state has every entry) and a fresh one
    # (an empty state: the entries come back as dicts of CPU tensors)
    for model2, opt2 in (stepped(0),
                         (torch.nn.Linear(3, 2),
                          torch.optim.AdamW(torch.nn.Linear(3, 2)
                                            .parameters()))):
        restored, step = restore_checkpoint(
            base, {"model": model2.state_dict(),
                   "optimizer": opt2.state_dict(), "step": 0},
            broadcast=False)
        model2.load_state_dict(restored["model"])
        opt2.load_state_dict(restored["optimizer"])
        got = opt2.state_dict()
        assert got["param_groups"] == want["param_groups"]
        assert sorted(got["state"]) == sorted(want["state"])
        for i, entry in want["state"].items():
            for k, v in entry.items():
                assert torch.equal(got["state"][i][k], v), (i, k)
                assert got["state"][i][k].dtype == v.dtype
        assert float(got["state"][0]["step"]) == 3.0
        for a, b in zip(model2.parameters(), model.parameters()):
            assert torch.equal(a, b)


# --- two gloo processes -------------------------------------------------------

def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _gloo_worker(rank, world, port, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        os.environ["BYTEPS_PS_MODE"] = "collective"
        bps.init(device="cpu")
        model = torch.nn.Linear(4, 3)
        with torch.no_grad():
            for p in model.parameters():
                p.fill_(float(rank + 1))
        opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
        (model(torch.ones(1, 4)).sum() * (rank + 1)).backward()
        opt.step()
        state = {"model": model.state_dict(), "optimizer": opt.state_dict()}
        # each rank's own directory holds its own state (rank= forces the
        # write); rank 0's must win
        base = os.path.join(out_dir, f"ckpt{rank}")
        save_checkpoint(base, state, step=5, rank=0)
        restored, step = restore_checkpoint(base, state)
        torch.save({"step": step,
                    "model": {k: v.numpy() for k, v in
                              restored["model"].items()},
                    "momentum": [s["momentum_buffer"].numpy() for _, s in
                                 sorted(restored["optimizer"]["state"]
                                        .items())]},
                   os.path.join(out_dir, f"r{rank}.pt"))
        bps.shutdown()
    finally:
        dist.destroy_process_group()


def test_restore_broadcasts_rank_zero_over_gloo(tmp_path):
    mp.spawn(_gloo_worker, args=(2, _free_port(), str(tmp_path)), nprocs=2,
             join=True)
    r0, r1 = (torch.load(tmp_path / f"r{i}.pt", weights_only=False)
              for i in range(2))
    assert r0["step"] == r1["step"] == 5
    for k, v in r0["model"].items():
        np.testing.assert_array_equal(r1["model"][k], v)
    np.testing.assert_array_equal(r0["model"]["weight"],
                                  np.full((3, 4), 1.0 - 0.1, np.float32))
    for a, b in zip(r0["momentum"], r1["momentum"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(r1["momentum"][0],
                                  np.ones((3, 4), np.float32))
