"""The port's step for models with BatchNorm state
(``byteps_tpu_torch.stateful.make_stateful_train_step``) against the JAX
package's ``make_flax_train_step``.

ResNet-18 at ``num_filters=8`` (f32, 10 classes), trained 3 steps with
SGD(0.1, momentum 0.9) on seeded 64 x 64 images from the same flax
variables (``test_torch_resnet._variables``), moved over with
``from_flax``:

- one process against a 1-device CPU mesh;
- two gloo processes, each on half of every batch, against a 2-device CPU
  mesh on the whole batch: each replica normalises by its own half's
  statistics, the gradients are averaged and so are the running
  statistics (flax_util.py's pmean);
- PS mode through the loopback client (``tests/ps_loopback.py``: one
  worker, the sum is the gradient) against the collective step: equal to
  the bit, with one push per parameter a step and no BatchNorm buffer
  pushed.

Tolerances. Both sides run in float64 (the JAX step under
``jax.enable_x64``) and in f32. In float64 the port equals the JAX step:
the losses, parameters and running statistics to rtol 1e-6, atol 1e-6
(both heads compute in f32, as the flax module has it; ~2.5e-7 is seen).
This checks the arithmetic. In f32 the port may be at most twice as far
from the float64 step as the JAX f32 step is (losses; and all parameters
and statistics together), plus 1e-6: the two sum in other orders, and
BatchNorm over the last stage's few values a replica (8 on two
processes) amplifies that rounding into ~1e-3 of the parameters after 3
steps on both sides, more than any fixed f32 tolerance.
"""

import os
import socket
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import byteps_tpu.jax as jbps  # noqa: E402
import byteps_tpu_torch as bps  # noqa: E402
from byteps_tpu.jax.flax_util import make_flax_train_step  # noqa: E402
from byteps_tpu.jax.training import replicate, shard_batch  # noqa: E402
from byteps_tpu.models import resnet as fresnet  # noqa: E402
from byteps_tpu.parallel.mesh import MeshSpec, build_mesh  # noqa: E402
from byteps_tpu_torch.models import resnet  # noqa: E402
from byteps_tpu_torch.stateful import (  # noqa: E402
    cross_entropy_loss, make_stateful_train_step)
from ps_loopback import LoopbackClient, init_loopback  # noqa: E402
from test_torch_resnet import _variables  # noqa: E402

CLASSES, FILTERS, SIZE, BATCH, STEPS, LR = 10, 8, 64, 4, 3, 0.1


@pytest.fixture(autouse=True)
def _port_state(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("BYTEPS_PS_MODE", "collective")
    yield
    if bps.initialized():
        bps.shutdown()
    torch.set_num_threads(threads)


def _flax_model(dtype=jnp.float32):
    return fresnet.ResNet18(num_classes=CLASSES, num_filters=FILTERS,
                            dtype=dtype)


@pytest.fixture(scope="module")
def setup():
    """(flax variables, STEPS batches of NHWC images and labels)."""
    rng = np.random.default_rng(11)
    batches = [(rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(
        np.float32), rng.integers(0, CLASSES, size=BATCH))
        for _ in range(STEPS)]
    return _variables(_flax_model(), batches[0][0], 5, train=False), batches


def _jax_run(n_devices, variables, batches, dtype="float32"):
    """make_flax_train_step on an n-device CPU mesh in ``dtype`` (float64
    under ``jax.enable_x64``): (losses, the final parameters and running
    statistics as a port state_dict)."""
    mesh = build_mesh(MeshSpec(dcn=1, ici=n_devices),
                      devices=jax.devices()[:n_devices])
    jdt = getattr(jnp, dtype)
    with jax.enable_x64(dtype == "float64"):
        jbps.init(mesh=mesh)
        try:
            tx = optax.sgd(LR, momentum=0.9)
            step = make_flax_train_step(_flax_model(jdt).apply, tx, mesh)
            params, stats = (replicate(jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jdt), variables[k]), mesh)
                for k in ("params", "batch_stats"))
            opt_state = replicate(tx.init(params), mesh)
            losses = []
            for x, y in batches:
                params, stats, opt_state, loss = step(
                    params, stats, opt_state, shard_batch(
                        (jnp.asarray(x, jdt), jnp.asarray(y, jnp.int32)),
                        mesh))
                losses.append(float(loss))
            return losses, {k: v.numpy() for k, v in resnet.from_flax(
                jax.tree_util.tree_map(np.asarray, params),
                jax.tree_util.tree_map(np.asarray, stats)).items()}
        finally:
            jbps.shutdown()


def _port_model(variables, dtype=torch.float32):
    model = resnet.ResNet18(num_classes=CLASSES, num_filters=FILTERS,
                            dtype=dtype, device="cpu")
    model.load_state_dict(resnet.from_flax(variables))
    return model.to(dtype)


def _port_run(variables, batches, rows=slice(None), dtype=torch.float32):
    """STEPS steps of make_stateful_train_step on ``rows`` of each batch:
    (losses, state_dict as float64 numpy)."""
    model = _port_model(variables, dtype)
    opt = torch.optim.SGD(model.parameters(), lr=LR, momentum=0.9)
    step = make_stateful_train_step(model, opt)
    losses = [step((torch.from_numpy(x[rows]).permute(0, 3, 1, 2).to(dtype),
                    torch.from_numpy(y[rows]))).item()
              for x, y in batches]
    return losses, {k: v.double().numpy()
                    for k, v in model.state_dict().items()}


def _port_runs(variables, batches, rows=slice(None)):
    return {dt: _port_run(variables, batches, rows, getattr(torch, dt))
            for dt in ("float32", "float64")}


def _assert_matches(got, n_devices, variables, batches):
    """``got`` ({dtype: (losses, state)}) against the JAX step on
    ``n_devices``; returns the float64 step's state."""
    truth_losses, truth = _jax_run(n_devices, variables, batches, "float64")
    ref_losses, ref = _jax_run(n_devices, variables, batches)
    losses64, sd64 = got["float64"]
    np.testing.assert_allclose(losses64, truth_losses, rtol=1e-6)
    assert set(sd64) == set(truth)
    for k, v in truth.items():
        np.testing.assert_allclose(sd64[k], v, rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    losses32, sd32 = got["float32"]
    keys = sorted(truth)
    for label, a, b, t in [
            ("losses", losses32, ref_losses, truth_losses),
            ("state", *(np.concatenate([sd[k].ravel() for k in keys])
                        for sd in (sd32, ref, truth)))]:
        err = np.abs(np.subtract(a, t)).max()
        bound = 2 * np.abs(np.subtract(b, t)).max() + 1e-6
        assert err <= bound, (label, err, bound)
    return truth


def test_stateful_step_matches_flax_step(setup):
    variables, batches = setup
    bps.init(device="cpu")
    got = _port_runs(variables, batches)
    _assert_matches(got, 1, variables, batches)
    # the running statistics moved: the step carried them
    start = resnet.from_flax(variables)["bn_init.var"].numpy()
    assert not np.allclose(got["float32"][1]["bn_init.var"], start)


def test_cross_entropy_matches_flax():
    from byteps_tpu.jax.flax_util import cross_entropy_loss as jax_ce
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((6, 5)).astype(np.float32) * 3
    labels = rng.integers(0, 5, size=6)
    want = float(jax_ce(jnp.asarray(logits), jnp.asarray(labels)))
    got = cross_entropy_loss(torch.from_numpy(logits).bfloat16(),
                             torch.from_numpy(labels)).item()
    # bf16 logits: both sides take the same rounded values, then f32
    want_bf16 = float(jax_ce(jnp.asarray(logits, jnp.bfloat16),
                             jnp.asarray(labels)))
    np.testing.assert_allclose(got, want_bf16, rtol=1e-6)
    assert got != want  # the bf16 rounding is visible
    np.testing.assert_allclose(
        cross_entropy_loss(torch.from_numpy(logits),
                           torch.from_numpy(labels)).item(), want,
        rtol=1e-6)


# --- two gloo processes ------------------------------------------------------

def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _gloo_worker(rank, world, port, out_dir, variables, batches):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        os.environ["BYTEPS_PS_MODE"] = "collective"
        bps.init(device="cpu")
        half = BATCH // world
        out = _port_runs(variables, batches,
                         slice(rank * half, (rank + 1) * half))
        bps.shutdown()
        torch.save(out, os.path.join(out_dir, f"r{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_two_process_gloo_matches_two_device_mesh(setup, tmp_path):
    variables, batches = setup
    mp.spawn(_gloo_worker, args=(2, _free_port(), str(tmp_path), variables,
                                 batches), nprocs=2, join=True)
    got = [torch.load(tmp_path / f"r{i}.pt", weights_only=False)
           for i in range(2)]
    for dt, (losses, sd) in got[0].items():  # both hold the same state
        assert losses == got[1][dt][0]
        for k, v in sd.items():
            np.testing.assert_array_equal(v, got[1][dt][1][k])
    truth = _assert_matches(got[0], 2, variables, batches)
    # each replica normalised by its own half: the statistics differ
    # from one process's on the whole batch
    bps.init(device="cpu")
    whole = _port_run(variables, batches)[1]
    assert not np.allclose(truth["bn_init.var"], whole["bn_init.var"],
                           rtol=1e-3)


def test_ps_mode_equals_collective_with_one_worker(setup, monkeypatch):
    """With one worker the servers' sum is the gradient itself: the PS
    step gives the collective step's losses and state to the bit. Every
    parameter is pushed once a step; the BatchNorm buffers never are."""
    variables, batches = setup
    bps.init(device="cpu")
    want = _port_run(variables, batches)
    bps.shutdown()
    client = LoopbackClient()
    init_loopback(monkeypatch, client)
    got = _port_run(variables, batches)
    assert got[0] == want[0]
    for k, v in want[1].items():
        np.testing.assert_array_equal(got[1][k], v, err_msg=k)
    n_params = len(list(_port_model(variables).parameters()))
    assert len(client.declares) == n_params
    assert all(name.startswith("grad_") for name, *_ in client.declares)
    assert len(client.pushes) == n_params * STEPS
