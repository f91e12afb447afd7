"""The port's asynchronous PS step (``training.make_async_train_step``).

Fast tests need no fleet: the loopback client (``tests/ps_loopback.py``)
has the servers' async rule, so one worker's step is the seed plus its
own deltas:

- the seed regression: one SGD step from w = 1.0 with gradient -4 and
  lr 0.1 must pull 1.4 (the seeded value plus the delta 0.4). Had the
  deltas gone to keys of their own, the servers would have started them
  from zero and pulled 0.4, the first delta in place of the parameters;
- 3 steps of an MLP with flax's nonzero initialisation, SGD(0.1,
  momentum 0.9), against the JAX package's ``make_async_train_step`` on
  the same loopback: losses to rtol 1e-5 and parameters to rtol 1e-5,
  atol 1e-6 (f32 on both sides, the same sums in another order);
- the step refuses collective mode.

Fleet test (``ps`` marker, outside the fast tier): 2 workers and 1
server with ``BYTEPS_ENABLE_ASYNC=1``, each worker pushing its deltas at
its own pace; the loss must fall below a fifth of its first value, as in
``tests/test_ps_core.py``'s JAX async test. Run as a script, this file is
such a worker.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch import nn

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import byteps_tpu_torch as bps  # noqa: E402
from byteps_tpu_torch import ps  # noqa: E402
from byteps_tpu_torch.models import mlp  # noqa: E402
from byteps_tpu_torch.stateful import cross_entropy_loss  # noqa: E402
from byteps_tpu_torch.training import make_async_train_step  # noqa: E402
from ps_loopback import LoopbackClient, init_loopback  # noqa: E402

FEATURES = (16, 8, 3)
STEPS, LR = 3, 0.1


@pytest.fixture(autouse=True)
def _port_state(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("BYTEPS_PS_MODE", "collective")
    yield
    if bps.initialized():
        bps.shutdown()
    torch.set_num_threads(threads)


class _Scalar(nn.Module):
    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.tensor([1.0]))


def test_async_seed_is_updated_not_replaced(monkeypatch):
    client = LoopbackClient()
    init_loopback(monkeypatch, client)
    model = _Scalar()
    step = make_async_train_step(
        lambda m, batch: -4.0 * m.w.sum() + 0.0 * batch.sum(),
        torch.optim.SGD(model.parameters(), lr=LR), model)
    assert model.w.item() == 1.0
    step(torch.zeros(1))
    assert abs(model.w.item() - 1.4) < 1e-6, model.w.item()
    # the delta landed on the seeded key: nothing new was declared
    assert len(client.declares) == 1
    # what keys of its own would have given: the first delta alone
    own = ps.ps_push_pull([torch.tensor([0.4])], average=False,
                          prefix="fresh", async_mode=True)
    assert abs(own[0].item() - 0.4) < 1e-6


def _batches():
    rng = np.random.default_rng(21)
    return [(rng.standard_normal((8, 12)).astype(np.float32),
             rng.integers(0, FEATURES[-1], size=8)) for _ in range(STEPS)]


def _jax_async_run(batches):
    """The JAX package's make_async_train_step on its own loopback client:
    (initial params as a port state_dict, losses, state_dict after each
    step)."""
    import jax
    import jax.numpy as jnp
    import optax

    import byteps_tpu.jax as jbps
    from byteps_tpu.core import ffi as jffi
    from byteps_tpu.jax.flax_util import cross_entropy_loss as jax_ce
    from byteps_tpu.jax.training import make_async_train_step as jax_async
    from byteps_tpu.models.mlp import MLP as FlaxMLP
    from byteps_tpu.parallel.mesh import MeshSpec, build_mesh

    module = FlaxMLP(features=FEATURES)
    params = jax.tree_util.tree_map(np.asarray, module.init(
        jax.random.PRNGKey(0), jnp.asarray(batches[0][0])))

    def port(tree):
        return {k: v.numpy() for k, v in mlp.from_flax(
            jax.tree_util.tree_map(np.asarray, tree)).items()}

    def loss_fn(p, batch):
        x, y = batch
        return jax_ce(module.apply(p, x), y)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BYTEPS_PS_MODE", "ps")
        mp.setattr(jffi.Worker, "start",
                   classmethod(lambda cls, cfg: LoopbackClient()))
        jbps.init(mesh=build_mesh(MeshSpec(dcn=1, ici=1),
                                  devices=jax.devices()[:1]))
        try:
            tx = optax.sgd(LR, momentum=0.9)
            p, step = jax_async(loss_fn, tx, jax.tree_util.tree_map(
                jnp.asarray, params))
            opt_state = tx.init(p)
            losses, states = [], []
            for x, y in batches:
                p, opt_state, loss = step(p, opt_state, (
                    jnp.asarray(x), jnp.asarray(y, jnp.int32)))
                losses.append(float(loss))
                states.append(port(p))
        finally:
            jbps.shutdown()
    return port(params), losses, states


def test_async_step_matches_jax(monkeypatch):
    batches = _batches()
    start, want_losses, want_states = _jax_async_run(batches)
    client = LoopbackClient()
    init_loopback(monkeypatch, client)
    model = mlp.MLP(12, FEATURES, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in start.items()})
    step = make_async_train_step(
        lambda m, b: cross_entropy_loss(m(b[0]), b[1]),
        torch.optim.SGD(model.parameters(), lr=LR, momentum=0.9), model)
    for (x, y), want_loss, want in zip(batches, want_losses, want_states):
        loss = step((torch.from_numpy(x), torch.from_numpy(y)))
        np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
        for k, v in model.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    # every step pushed every parameter to the keys the seed declared
    assert len(client.declares) == len(start)
    assert len(client.pushes) == len(start) * STEPS


def test_async_step_needs_ps_mode():
    bps.init(device="cpu")
    model = _Scalar()
    with pytest.raises(RuntimeError, match="PS mode"):
        make_async_train_step(lambda m, b: m.w.sum(),
                              torch.optim.SGD(model.parameters(), lr=LR),
                              model)


# --- the fleet ---------------------------------------------------------------

@pytest.mark.ps
def test_fleet_async_two_workers_converge():
    from ps_utils import spawn_worker, topology_env

    from byteps_tpu_torch.core import build
    from byteps_tpu_torch.utils.ports import free_port
    build.build(verbose=False)  # once, before the processes load it
    env = topology_env(2, 1, free_port(), {"BYTEPS_PS_MODE": "ps",
                                           "BYTEPS_ENABLE_ASYNC": "1"})
    procs = [(role, subprocess.Popen(
        [sys.executable, "-m", "byteps_tpu_torch.server"],
        env=dict(env, DMLC_ROLE=role), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True))
        for role in ("scheduler", "server")]
    procs += [(f"worker{r}", spawn_worker(os.path.abspath(__file__), env, r))
              for r in range(2)]
    failed = []
    try:
        for name, p in procs:
            out, _ = p.communicate(timeout=180)
            if p.returncode != 0:
                failed.append(f"--- {name} exited {p.returncode} ---\n{out}")
            elif name.startswith("worker"):
                assert "OK" in out, out
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert not failed, "\n".join(failed)


def _worker_main() -> int:
    bps.init(device="cpu")
    try:
        assert bps._st().config.enable_async
        rank = bps.rank()
        prng = np.random.default_rng(11)
        w_true = torch.from_numpy(prng.standard_normal((6, 3)).astype(
            np.float32))
        model = nn.Linear(6, 3, bias=False)
        with torch.no_grad():
            model.weight.zero_()

        def loss_fn(m, batch):
            x, y = batch
            return ((m(x) - y) ** 2).mean()

        step = make_async_train_step(
            loss_fn, torch.optim.SGD(model.parameters(), lr=0.05), model)
        losses = []
        for _ in range(40):
            x = torch.from_numpy(prng.standard_normal((16, 6)).astype(
                np.float32))
            losses.append(step((x, x @ w_true)).item())
        assert losses[-1] < losses[0] * 0.2, losses
        print(f"worker {rank}: OK ({losses[0]:.4f} -> {losses[-1]:.4f})")
        return 0
    finally:
        bps.shutdown()


if __name__ == "__main__":
    sys.exit(_worker_main())
