"""The port's ZeRO-sharded optimizer against its own dense step and the
JAX package's ZeRO step.

One gloo world of 4 spawned processes (``_torch_par_worker.par_worker``,
once per session) trains the ``tests/test_zero.py`` problem 8 steps on a
2 (dcn) x 2 (ici) mesh, each rank 8 rows of a batch of 32, through
``make_zero_train_step`` and through ``training.make_train_step``, with
SGD with momentum and with AdamW. Carried over from
``tests/test_zero.py`` at its tolerance (rtol 1e-5, atol 1e-6): ZeRO
against the dense step, losses and parameters; the state 1/n a rank.
Added: against the JAX ZeRO step on a 2 x 2 mesh of the CPU devices
(parameters and losses to 1e-5 relative; optax's adamw and torch's
AdamW with weight_decay 1e-4 are the same update), and PS mode refused.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import byteps_tpu.jax as jbps
import byteps_tpu_torch as bps
from byteps_tpu.jax.training import replicate, shard_batch
from byteps_tpu.parallel.mesh import MeshSpec, build_mesh
from byteps_tpu.parallel.zero import make_zero_train_step, zero_init_sharded
from byteps_tpu_torch.parallel import make_zero_train_step as port_zero_step

from _torch_par_worker import par_inputs, par_worker
from _torch_sp_worker import WORLD, run_once

TX = {"sgdm": lambda: optax.sgd(0.05, momentum=0.9),
      "adamw": lambda: optax.adamw(1e-2)}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def par(tmp_path_factory):
    return run_once(tmp_path_factory, "par", par_inputs, par_worker)


def _loss_fn(params, batch):
    x, y = batch
    h = jnp.tanh(x @ params["w1"] + params["b1"])
    return jnp.mean((h @ params["w2"] - y) ** 2)


@pytest.mark.parametrize("tx_name", list(TX))
def test_zero_matches_dense_training(par, tx_name):
    """On every rank: the ZeRO step's losses and parameters equal the
    dense step's to rtol 1e-5."""
    _, ranks = par
    for res in ranks:
        run = res[f"zero_{tx_name}"]
        (dl, dp), (zl, zp) = run["dense"], run["zero"]
        np.testing.assert_allclose(zl, dl, rtol=1e-5, atol=1e-6)
        for k in dp:
            np.testing.assert_allclose(zp[k], dp[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)


@pytest.mark.parametrize("tx_name", list(TX))
def test_zero_matches_jax_zero_step(par, tx_name):
    inp, ranks = par
    z = inp["zero"]
    mesh = build_mesh(MeshSpec(dcn=2, ici=2), devices=jax.devices()[:WORLD])
    jbps.init(mesh=mesh)
    tx = TX[tx_name]()
    params = {k: jnp.asarray(v) for k, v in z["params"].items()}
    p = replicate(params, mesh)
    o = zero_init_sharded(params, tx, mesh)
    step = make_zero_train_step(_loss_fn, tx, mesh)
    losses = []
    for x, y in z["batches"]:
        p, o, loss = step(p, o, shard_batch((jnp.asarray(x), jnp.asarray(y)),
                                            mesh))
        losses.append(float(loss))
    for res in ranks:
        zl, zp = res[f"zero_{tx_name}"]["zero"]
        np.testing.assert_allclose(zl, losses, rtol=1e-5, atol=1e-6)
        for k in zp:
            np.testing.assert_allclose(zp[k], np.asarray(p[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_zero_state_is_sharded(par):
    """On a 1 x 4 mesh each rank's AdamW moments cover its shard alone:
    a quarter of the parameters (plus padding)."""
    _, ranks = par
    for res in ranks:
        st = res["zero_state"]
        assert st["shard"] == -(-st["total"] // WORLD)
        assert st["exp_avg"] == st["shard"] <= st["total"] // WORLD + WORLD


def test_zero_refuses_ps_mode(monkeypatch):
    monkeypatch.setenv("BYTEPS_PS_MODE", "collective")
    bps.init(device="cpu")
    try:
        st = bps._st()
        monkeypatch.setattr(st, "config",
                            dataclasses.replace(st.config, ps_mode="ps"))
        assert st.config.use_ps
        opt = torch.optim.SGD([torch.zeros(2, requires_grad=True)], lr=0.1)
        with pytest.raises(NotImplementedError, match="collective mode"):
            port_zero_step(lambda p, b: p.sum(), opt)
    finally:
        bps.shutdown()
