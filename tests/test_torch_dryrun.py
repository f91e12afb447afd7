"""The port's dry run (``byteps_tpu_torch.dryrun``), the counterpart of
``__graft_entry__``'s: the same phases as the JAX dry run (the
ResNet-18 data-parallel step on a (dcn, ici) mesh, ``push_pull`` of a
stacked tensor, LlamaTiny under ring sequence parallelism, the MoE FFN
over experts, the TP MLP and a GPipe schedule), each finite, on the CPU:
inside the gloo world of 4 that ``_torch_par_worker.par_worker`` runs
once per session, and spawning a world of its own; and ``entry()``'s
ResNet-50 bf16 forward."""

import math

import pytest
import torch

from byteps_tpu_torch import dryrun
from byteps_tpu_torch.dryrun import dryrun_multichip, entry

from _torch_par_worker import par_inputs, par_worker
from _torch_sp_worker import WORLD, run_once

PHASES = {"resnet18_loss", "push_pull", "sp_loss", "moe_aux", "tp_out",
          "pp_out"}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _check(run, n):
    assert set(run) == PHASES
    assert all(math.isfinite(v) for v in run.values()), run
    # each rank pushes its row of ones((n, 7)): the sum is n everywhere
    assert run["push_pull"] == 7.0 * n


def test_dryrun_in_a_world_of_4(tmp_path_factory):
    _, ranks = run_once(tmp_path_factory, "par", par_inputs, par_worker)
    for res in ranks:
        _check(res["dryrun"], WORLD)
    # the data-parallel loss and the SP loss are averaged over the world
    assert len({res["dryrun"]["resnet18_loss"] for res in ranks}) == 1
    assert len({res["dryrun"]["sp_loss"] for res in ranks}) == 1


def test_dryrun_spawns_a_world(monkeypatch):
    # a hung world fails here rather than after the module's half hour
    monkeypatch.setattr(dryrun, "DRYRUN_TIMEOUT_S", 240.0)
    _check(dryrun_multichip(2, device="cpu"), 2)


def test_entry_forward():
    forward, args = entry(device="cpu")
    out = forward(*args)
    assert out.shape == (8, 1000) and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all())
