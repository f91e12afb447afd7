"""The in-place API of the reference's torch plugin in the port
(``push_pull_inplace_``, ``push_pull_async_inplace_`` with
``synchronize``, ``declare``), held to the assertions of
``tests/_torch_worker.py``'s ``push_pull`` mode, which drive
``byteps_tpu.torch``: over two gloo processes (collective mode) and over
the loopback client (PS mode, one worker). The non-in-place variants
leave their input as it was.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import byteps_tpu_torch as bps
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


def _check_push_pull(rank, nw):
    """``tests/_torch_worker.py``'s push_pull mode on the port, plus the
    async in-place variant and ``declare``."""
    rng = np.random.default_rng(1234)  # the same stream on every worker
    for shape, dtype in [((64,), torch.float32), ((13, 5), torch.float32),
                         ((128,), torch.float64), ((16,), torch.int64)]:
        base = rng.standard_normal(shape)
        x = torch.as_tensor(base * (rank + 1)).to(dtype)
        x0 = x.clone()
        out = bps.push_pull(x, average=False, name=f"t_{shape}_{dtype}")
        expect = sum(torch.as_tensor(base * (r + 1)).to(dtype).double()
                     for r in range(nw))
        torch.testing.assert_close(out.double(), expect, rtol=1e-5,
                                   atol=1e-8)
        # input unchanged by the non-in-place variant
        torch.testing.assert_close(x, x0)

    # in-place + average
    y = torch.full((50,), float(rank + 1))
    bps.declare("avg", y)
    assert bps.push_pull_inplace_(y, average=True, name="avg") is y
    mean = sum(r + 1 for r in range(nw)) / nw
    torch.testing.assert_close(y, torch.full((50,), mean))

    # async in-place: the handle writes into the tensor it was given
    zs = [torch.full((1024,), float(i + rank)) for i in range(3)]
    handles = [bps.push_pull_async_inplace_(z, average=False,
                                            name=f"hz{i}")
               for i, z in enumerate(zs)]
    for i, (z, h) in enumerate(zip(zs, handles)):
        assert bps.synchronize(h) is z
        assert bps.poll(h)
        torch.testing.assert_close(
            z, torch.full((1024,), float(sum(i + r for r in range(nw)))))

    # async handles: several in flight, poll true once synchronized
    handles = [bps.push_pull_async(torch.full((1024,), float(i + rank)),
                                   average=False, name=f"h{i}")
               for i in range(6)]
    for i, h in enumerate(handles):
        out = bps.synchronize(h)
        assert bps.poll(h)
        torch.testing.assert_close(
            out, torch.full((1024,), float(sum(i + r for r in range(nw)))))


def test_inplace_api_over_the_loopback(monkeypatch):
    client = LoopbackClient()
    init_loopback(monkeypatch, client)
    _check_push_pull(0, 1)
    names = [d[0] for d in client.declares]
    assert any(n.startswith("avg_") for n in names)
    assert len(client.waited) == len(client.pushes) == len(names)


def test_declare_registers_the_tensor():
    bps.init(device="cpu")
    bps.declare("w", torch.zeros(3, 4, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        # a name keeps its shape
        bps.declare("w", torch.zeros(5))


def _gloo_worker(rank, world, port, out_dir):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        os.environ["BYTEPS_PS_MODE"] = "collective"
        torch.set_num_threads(1)
        bps.init(device="cpu")
        _check_push_pull(rank, world)
        bps.shutdown()
        open(os.path.join(out_dir, f"ok{rank}"), "w").close()
    finally:
        dist.destroy_process_group()


def test_inplace_api_over_gloo(tmp_path):
    mp.spawn(_gloo_worker, args=(2, free_port(), str(tmp_path)), nprocs=2,
             join=True)
    assert sorted(os.listdir(tmp_path)) == ["ok0", "ok1"]
