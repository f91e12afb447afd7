"""The port's torch front end held to the contract of ``byteps_tpu/torch/``,
the JAX package's own PyTorch plugin.

``tests/_torch_worker.py`` is that plugin's worker: its ``push_pull``,
``fp16``, ``broadcast`` and ``dist_opt`` scenarios run here unchanged,
with the port in the place of ``byteps_tpu.torch`` (``init`` on the
CPU, collective mode), in one process and in a two-rank gloo world.
Then, pinned one by one:

- ``DistributedOptimizer`` is an instance of the wrapped optimizer's
  class, so ``torch.optim.lr_scheduler`` works with it; it takes
  ``named_parameters``, refuses repeated names and names parameters in
  its errors; it keeps a state loaded into the optimizer before wrapping;
  it wraps an optimizer whose constructor needs arguments;
- ``broadcast_optimizer_state`` gives a rank with no state its state
  with a zero-gradient step that leaves the parameters as they were
  (AdamW's decoupled weight decay would move them), gives a fresh rank
  beside a stepped root the root's tensors and learning rate, and raises
  on both ranks when their state keys differ;
- in PS mode (``tests/ps_loopback.py`` stands in for the core's client)
  the optimizer's step still goes through the hooks' ``_TapState``, and
  making the state does not communicate.

Torch is held to one intra-op thread, in the test process and in the
spawned ranks.
"""

import copy
import importlib.util
import os
import sys
import types
import warnings

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import byteps_tpu_torch as bps
from byteps_tpu_torch.utils.ports import free_port
from tests.ps_loopback import LoopbackClient, init_loopback

HERE = os.path.dirname(os.path.abspath(__file__))
SCENARIOS = ["push_pull", "fp16", "broadcast", "dist_opt"]


@pytest.fixture(autouse=True)
def _port_state(monkeypatch):
    monkeypatch.setenv("BYTEPS_PS_MODE", "collective")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    if bps.initialized():
        bps.shutdown()


def _port_as_plugin():
    """The port under the name ``byteps_tpu.torch``: its API, with
    ``init()`` on the CPU."""
    shim = types.ModuleType("byteps_tpu.torch")
    shim.__dict__.update({name: getattr(bps, name) for name in bps.__all__})
    shim.init = lambda: bps.init(device="cpu")
    return shim


def _reference_scenario(mode: str) -> int:
    """``tests/_torch_worker.py``'s ``main()`` for ``mode``, loaded afresh
    so that its ``import byteps_tpu.torch`` binds what ``sys.modules``
    holds now."""
    os.environ["BPS_TEST_MODE"] = mode
    spec = importlib.util.spec_from_file_location(
        "_torch_worker_on_port", os.path.join(HERE, "_torch_worker.py"))
    worker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(worker)
    return worker.main()


@pytest.mark.parametrize("mode", SCENARIOS)
def test_reference_scenario_in_one_process(mode, monkeypatch):
    import byteps_tpu
    shim = _port_as_plugin()
    monkeypatch.setitem(sys.modules, "byteps_tpu.torch", shim)
    monkeypatch.setattr(byteps_tpu, "torch", shim, raising=False)
    monkeypatch.setenv("BPS_TEST_MODE", mode)
    assert _reference_scenario(mode) == 0
    assert not bps.initialized()  # the scenario shuts the port down


def _gloo(rank, world, port):
    os.environ["BYTEPS_PS_MODE"] = "collective"
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)


def _scenario_rank(rank, world, port, mode):
    _gloo(rank, world, port)
    try:
        import byteps_tpu
        shim = _port_as_plugin()
        sys.modules["byteps_tpu.torch"] = shim
        byteps_tpu.torch = shim
        if _reference_scenario(mode) != 0:
            raise SystemExit(f"rank {rank}: {mode} failed")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("mode", SCENARIOS)
def test_reference_scenario_over_two_gloo_ranks(mode):
    mp.spawn(_scenario_rank, args=(2, free_port(), mode), nprocs=2,
             join=True)


# --- DistributedOptimizer --------------------------------------------------

def _model(seed=0):
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(6, 16), torch.nn.Tanh(),
                               torch.nn.Linear(16, 3))


def _train_once(model, opt, scale=1.0):
    opt.zero_grad()
    loss = model(torch.ones(4, 6)).pow(2).sum() * scale
    loss.backward()
    opt.step()


def test_distributed_optimizer_is_the_optimizer_and_takes_a_scheduler():
    bps.init(device="cpu")
    model = _model()
    base = torch.optim.SGD(model.parameters(), lr=0.4, momentum=0.9)
    opt = bps.DistributedOptimizer(
        base, named_parameters=model.named_parameters())
    assert isinstance(opt, torch.optim.SGD)
    assert isinstance(opt, torch.optim.Optimizer)
    assert type(opt).__name__ == "SGD" and type(opt) is not torch.optim.SGD
    sched = torch.optim.lr_scheduler.StepLR(opt, 1, gamma=0.5)
    lrs = []
    with warnings.catch_warnings():
        # the scheduler warns when it sees no optimizer.step() before its
        # own: the built class's step must be the one it wrapped
        warnings.simplefilter("error")
        for _ in range(3):
            _train_once(model, opt)
            sched.step()
            lrs.append(opt.param_groups[0]["lr"])
    assert lrs == [0.2, 0.1, 0.05]
    # one process: the steps are SGD's own, the state is the wrapped one's
    ref = _model()
    ref_opt = torch.optim.SGD(ref.parameters(), lr=0.4, momentum=0.9)
    ref_sched = torch.optim.lr_scheduler.StepLR(ref_opt, 1, gamma=0.5)
    for _ in range(3):
        _train_once(ref, ref_opt)
        ref_sched.step()
    for a, b in zip(model.parameters(), ref.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert base.state is opt.state and base.param_groups is opt.param_groups


def test_distributed_optimizer_refuses_repeated_names():
    bps.init(device="cpu")
    model = _model()
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    named = [("w", p) for p in model.parameters()]
    with pytest.raises(ValueError, match="unique parameter names.*'w'"):
        bps.DistributedOptimizer(opt, named_parameters=named)
    with pytest.raises(TypeError):  # average stays keyword-only
        bps.DistributedOptimizer(opt, None, bps.Compression.none, 1, True)
    with pytest.raises(ValueError, match="already"):
        bps.DistributedOptimizer(bps.DistributedOptimizer(opt))


def test_state_loaded_before_wrapping_survives():
    bps.init(device="cpu")
    model = _model()
    first = torch.optim.AdamW(model.parameters(), lr=0.01, weight_decay=0.1)
    for _ in range(2):
        _train_once(model, first)
    saved = copy.deepcopy(first.state_dict())
    again = torch.optim.AdamW(model.parameters(), lr=0.5)
    again.load_state_dict(saved)
    opt = bps.DistributedOptimizer(again,
                                   named_parameters=model.named_parameters())
    got = opt.state_dict()
    assert got["param_groups"] == saved["param_groups"]
    assert opt.defaults == again.defaults
    assert sorted(got["state"]) == sorted(saved["state"]) == [0, 1, 2, 3]
    for pid, st in saved["state"].items():
        for key, value in st.items():
            torch.testing.assert_close(got["state"][pid][key], value,
                                       rtol=0, atol=0)
    # and it steps on from there as the unwrapped optimizer would
    ref = _model()
    ref.load_state_dict(model.state_dict())
    ref_opt = torch.optim.AdamW(ref.parameters(), lr=0.5)
    ref_opt.load_state_dict(copy.deepcopy(saved))
    _train_once(model, opt)
    _train_once(ref, ref_opt)
    for a, b in zip(model.parameters(), ref.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


class _NeedsArguments(torch.optim.SGD):
    """An optimizer whose constructor needs an argument the wrapper could
    not pass: wrapping must not call it again."""

    def __init__(self, params, tag):
        super().__init__(params, lr=0.1)
        self.tag = tag


def test_wraps_an_optimizer_whose_constructor_needs_arguments():
    bps.init(device="cpu")
    model = _model()
    opt = bps.DistributedOptimizer(_NeedsArguments(model.parameters(), "x"))
    assert isinstance(opt, _NeedsArguments) and opt.tag == "x"
    _train_once(model, opt)


# --- broadcast_optimizer_state ---------------------------------------------

def test_materializing_state_leaves_adamw_parameters_as_they_were():
    bps.init(device="cpu")
    model = _model()
    before = [p.detach().clone() for p in model.parameters()]
    opt = torch.optim.AdamW(model.parameters(), lr=0.1, weight_decay=0.5)
    bps.broadcast_optimizer_state(opt, root_rank=0)
    assert len(opt.state) == 4
    assert all(float(s["step"]) == 1.0 for s in opt.state.values())
    for p, b in zip(model.parameters(), before):
        torch.testing.assert_close(p.detach(), b, rtol=0, atol=0)
        assert p.grad is None
    # the plain zero-gradient step would have moved them: the decay
    plain = _model()
    plain_opt = torch.optim.AdamW(plain.parameters(), lr=0.1,
                                  weight_decay=0.5)
    for p in plain.parameters():
        p.grad = torch.zeros_like(p)
    plain_opt.step()
    assert not torch.equal(next(plain.parameters()).detach(), before[0])


def _opt_state_rank(rank, world, port, out_dir, case):
    _gloo(rank, world, port)
    try:
        bps.init(device="cpu")
        model = _model(seed=rank)
        before = [p.detach().clone() for p in model.parameters()]
        if case == "fresh":
            opt = torch.optim.AdamW(model.parameters(), lr=1e-3 * (rank + 1),
                                    weight_decay=0.1)
            if rank == 0:
                for _ in range(2):
                    _train_once(model, opt)
                before = [p.detach().clone() for p in model.parameters()]
            out = {}
        else:  # rank 1 holds one parameter fewer
            params = list(model.parameters())[:4 - rank]
            opt = torch.optim.SGD(params, lr=0.1, momentum=0.9)
            _train_once(model, opt)
            out = {"error": None}
        try:
            bps.broadcast_optimizer_state(opt, root_rank=0)
        except RuntimeError as e:
            out["error"] = str(e)
        sd = opt.state_dict()
        out.update(
            lr=opt.param_groups[0]["lr"],
            state=[(pid, k, v.clone())
                   for pid, s in sorted(sd["state"].items())
                   for k, v in sorted(s.items())],
            moved=[not torch.equal(p.detach(), b)
                   for p, b in zip(model.parameters(), before)])
        torch.save(out, os.path.join(out_dir, f"r{rank}.pt"))
        bps.shutdown()
    finally:
        dist.destroy_process_group()


def _opt_state_world(tmp_path, case):
    mp.spawn(_opt_state_rank, args=(2, free_port(), str(tmp_path), case),
             nprocs=2, join=True)
    return [torch.load(tmp_path / f"r{r}.pt", weights_only=False)
            for r in range(2)]


def test_fresh_rank_beside_a_stepped_root_takes_its_state_and_lr(tmp_path):
    r0, r1 = _opt_state_world(tmp_path, "fresh")
    assert len(r0["state"]) == len(r1["state"]) == 12  # step, m, v x 4
    for (p0, k0, v0), (p1, k1, v1) in zip(r0["state"], r1["state"]):
        assert (p0, k0) == (p1, k1)
        torch.testing.assert_close(v1, v0, rtol=0, atol=0)
    assert r1["state"][2][1] == "step" and float(r1["state"][2][2]) == 2.0
    assert "error" not in r0 and "error" not in r1
    assert r0["lr"] == r1["lr"] == 1e-3
    # making rank 1's state moved none of its parameters
    assert r1["moved"] == [False] * 4 and r0["moved"] == [False] * 4


def test_state_keys_that_differ_raise_on_both_ranks(tmp_path):
    r0, r1 = _opt_state_world(tmp_path, "mismatch")
    for r in (r0, r1):
        assert r["error"] and "differs from root rank 0" in r["error"]
    assert "this rank: 3 state tensors against the root's 4" in r1["error"]
    assert ", equal" in r0["error"]


# --- PS mode ---------------------------------------------------------------

def test_ps_mode_step_goes_through_the_hooks(monkeypatch):
    client = LoopbackClient()
    init_loopback(monkeypatch, client)
    model = _model()
    opt = bps.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.2),
        named_parameters=model.named_parameters())
    assert isinstance(opt, torch.optim.SGD)
    assert [d[0] for d in client.declares] == [f"grad_{i}.0"
                                               for i in range(4)]
    sched = torch.optim.lr_scheduler.StepLR(opt, 1, gamma=0.5)
    # a fresh optimizer's state comes without communicating: no push
    bps.broadcast_optimizer_state(opt, root_rank=0)
    assert not any(client.declares[t][0].startswith("grad_")
                   for t in client.pushes)
    pushed = len(client.pushes)
    opt.zero_grad()
    model(torch.ones(4, 6)).pow(2).sum().backward()
    opt._taps.stager.join()  # what the hooks queued has been pushed
    grads = [client.declares[t][0] for t in client.pushes[pushed:]]
    assert sorted(grads) == [f"grad_{i}.0" for i in range(4)]
    opt.step()
    sched.step()
    assert opt.param_groups[0]["lr"] == 0.1
    assert opt.timings["pushes"] and opt.timings["landed"] is not None
    # a parameter without a gradient is named in the error
    opt.zero_grad()
    model[2](torch.ones(4, 16)).sum().backward()
    with pytest.raises(RuntimeError, match=r"0\.weight, 0\.bias"):
        opt.step()
    opt._taps.close()
