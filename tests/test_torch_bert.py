"""The port's BERT-style encoder (``TransformerEncoder``) and
``masked_lm_loss`` against the flax module on the same weights.

A tiny encoder (2 layers, d_model 64, 4 heads, MLP 128, vocab 128,
max_len 32) is initialised in flax and moved over with ``from_flax``; the
MLM logits, ``masked_lm_loss`` and every parameter's gradient are
compared in f32 and bf16, with the attention core ``full`` and ``flash``
(the JAX flash kernel in interpret mode on the CPU, the port's plain
versions). Then the named configurations' parameter shapes against
``jax.eval_shape`` (no weights allocated on either side), three
``make_train_step`` steps against the JAX step on a one-device mesh, and
PS mode through the loopback client against the collective step.

Tolerances are ``tests/test_torch_transformer.py``'s: in f32 the two
differ only by summation order, 1e-4 relative / 1e-5 absolute; in bf16
the logits are held to 0.05 absolute and each gradient to
||g - g_ref|| <= 3e-2 ||g_ref|| + 1e-3 (the key biases' gradient is zero
up to rounding: softmax ignores a per-query constant).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import byteps_tpu.jax as jbps  # noqa: E402
import byteps_tpu_torch as bps  # noqa: E402
from byteps_tpu.jax.training import (  # noqa: E402
    make_train_step as jax_make_train_step, replicate, shard_batch)
from byteps_tpu.models import transformer as ft  # noqa: E402
from byteps_tpu.parallel.mesh import MeshSpec, build_mesh  # noqa: E402
from byteps_tpu_torch.models import transformer as tt  # noqa: E402
from byteps_tpu_torch.training import make_train_step  # noqa: E402
from ps_loopback import LoopbackClient, init_loopback  # noqa: E402

CFG = dict(vocab_size=128, num_layers=2, d_model=64, num_heads=4,
           mlp_dim=128, max_len=32)
LR, STEPS = 1e-4, 3


@pytest.fixture(autouse=True)
def _port_state(monkeypatch):
    # One intra-op thread: the models are tiny, and the other test
    # workers on this host need the cores more than these tests do.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("BYTEPS_PS_MODE", "collective")
    yield
    if bps.initialized():
        bps.shutdown()
    torch.set_num_threads(threads)


def _batch(rng, b=2, s=24):
    """bench.py's MLM batch: tokens, then the mask in {0, 1}."""
    return (rng.integers(0, CFG["vocab_size"], size=(b, s)).astype(np.int32),
            rng.integers(0, 2, size=(b, s)).astype(np.int32))


def _flax_params(model, tokens):
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(tokens))
    return jax.tree_util.tree_map(np.asarray, params)


def _port(params, **kw):
    model = tt.TransformerEncoder(**CFG, device="cpu", **kw)
    model.load_state_dict(tt.from_flax(params), strict=True)
    return model


@pytest.mark.parametrize("attn_impl", ["full", "flash"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_flax(attn_impl, dtype):
    tokens, mask = _batch(np.random.default_rng(0))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    fmodel = ft.TransformerEncoder(**CFG, dtype=jdt, attn_impl=attn_impl)
    params = _flax_params(fmodel, tokens)
    model = _port(params, dtype=tdt, attn_impl=attn_impl)

    def jloss(p):
        return ft.masked_lm_loss(fmodel.apply(p, jnp.asarray(tokens)),
                                 jnp.asarray(tokens), jnp.asarray(mask))

    want_logits = np.asarray(fmodel.apply(params, jnp.asarray(tokens)))
    want_loss, want_grads = jax.value_and_grad(jloss)(params)
    want = tt.from_flax(jax.tree_util.tree_map(np.asarray, want_grads))

    t = torch.as_tensor(tokens, dtype=torch.long)
    logits = model(t)
    assert logits.dtype == torch.float32
    assert logits.shape == (2, 24, CFG["vocab_size"])
    loss = tt.masked_lm_loss(logits, t, torch.as_tensor(mask))
    loss.backward()
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert set(grads) == set(want)

    if dtype == "float32":
        np.testing.assert_allclose(logits.detach().numpy(), want_logits,
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
        for k, g in grads.items():
            np.testing.assert_allclose(g, want[k].numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)
    else:
        np.testing.assert_allclose(logits.detach().numpy(), want_logits,
                                   atol=0.05)
        np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-2)
        for k, g in grads.items():
            err = np.linalg.norm(g - want[k].numpy())
            assert err <= 3e-2 * np.linalg.norm(want[k].numpy()) + 1e-3, (
                k, err)


def test_masked_lm_loss_matches_jax_and_empty_mask_is_zero():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, size=(3, 5))
    mask = rng.integers(0, 2, size=(3, 5))
    got = tt.masked_lm_loss(torch.as_tensor(logits), torch.as_tensor(labels),
                            torch.as_tensor(mask))
    want = ft.masked_lm_loss(jnp.asarray(logits), jnp.asarray(labels),
                             jnp.asarray(mask))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    zero = torch.zeros((3, 5), dtype=torch.long)
    assert tt.masked_lm_loss(torch.as_tensor(logits),
                             torch.as_tensor(labels), zero).item() == 0.0


def test_from_flax_names_every_parameter():
    tokens, _ = _batch(np.random.default_rng(2), 1, 8)
    params = _flax_params(ft.TransformerEncoder(**CFG), tokens)
    sd = tt.from_flax(params)
    model = tt.TransformerEncoder(**CFG, device="cpu")
    assert set(sd) == set(model.state_dict())
    for k, v in sd.items():
        assert model.state_dict()[k].shape == v.shape, k
    for name in ("final_ln.scale", "layers.1.ln_0.bias", "layers.0.ln_1.scale",
                 "mlm_dense.kernel", "mlm_ln.bias", "mlm_out.bias"):
        assert name in sd, name
    assert sd["mlm_out.kernel"].shape == (64, CFG["vocab_size"])


def test_encoder_rejects_sequence_past_max_len():
    model = tt.TransformerEncoder(**CFG, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        model(torch.zeros((1, CFG["max_len"] + 1), dtype=torch.long))


@pytest.mark.parametrize("name", ["BertBase", "BertLarge", "GPT2Medium"])
def test_named_configs_have_flax_shapes(name):
    """Every parameter of the full-width configuration, by name and shape,
    without allocating the weights (flax: ``jax.eval_shape`` of ``init``;
    the port: the meta device)."""
    shapes = jax.eval_shape(getattr(ft, name)().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))["params"]
    want = {tt.port_name(k): tuple(v.shape)
            for k, v in tt._flatten(shapes).items()}
    with torch.device("meta"):
        model = getattr(tt, name)(device="meta")
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want
    n = sum(np.prod(s) for s in got.values())
    expected = {"BertBase": 132_953_658, "BertLarge": 366_426_938,
                "GPT2Medium": 354_823_168}[name]
    assert n == expected, n


def _jax_steps(params, batches):
    """JAX make_train_step with optax.adamw(LR) (weight decay 1e-4) on a
    one-device mesh: the masked mean is over the whole batch, as the
    port's one process takes it."""
    fmodel = ft.TransformerEncoder(**CFG, dtype=jnp.float32)
    mesh = build_mesh(MeshSpec(dcn=1, ici=1), devices=jax.devices()[:1])
    jbps.init(mesh=mesh)
    try:
        tx = optax.adamw(LR)

        def jloss(p, batch):
            t, m = batch
            return ft.masked_lm_loss(fmodel.apply(p, t), t, m)

        step = jax_make_train_step(jloss, tx, mesh)
        p = replicate(jax.tree_util.tree_map(jnp.asarray, params), mesh)
        s = replicate(tx.init(p), mesh)
        out = []
        for t, m in batches:
            p, s, loss = step(p, s, shard_batch(
                (jnp.asarray(t), jnp.asarray(m)), mesh))
            out.append((float(loss), tt.from_flax(
                jax.tree_util.tree_map(np.asarray, p))))
        return out
    finally:
        jbps.shutdown()


def _bert_loss(model, batch):
    t, m = batch
    return tt.masked_lm_loss(model(t), t, m)


def _port_steps(params, batches):
    model = _port(params, dtype=torch.float32, attn_impl="flash")
    opt = torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=1e-4)
    step = make_train_step(_bert_loss, opt)
    out = []
    for t, m in batches:
        loss = step(model, (torch.as_tensor(t, dtype=torch.long),
                            torch.as_tensor(m)))
        out.append((loss.item(), {k: v.clone() for k, v in
                                  model.state_dict().items()}))
    return out


@pytest.fixture(scope="module")
def steps_setup():
    rng = np.random.default_rng(3)
    batches = [_batch(rng, 4, 16) for _ in range(STEPS)]
    params = _flax_params(ft.TransformerEncoder(**CFG, dtype=jnp.float32),
                          batches[0][0])
    return params, batches


def test_train_step_matches_jax(steps_setup):
    """Loss and every parameter after each AdamW step. torch's AdamW with
    weight_decay=1e-4 is optax.adamw's default update; where a gradient is
    zero up to rounding (the key biases) Adam's m / sqrt(v) can step by up
    to lr either way, so those are held to lr x steps, the rest to
    1e-4 / 1e-6."""
    params, batches = steps_setup
    want = _jax_steps(params, batches)
    bps.init(device="cpu")
    got = _port_steps(params, batches)
    for i, ((gl, gp), (wl, wp)) in enumerate(zip(got, want)):
        np.testing.assert_allclose(gl, wl, rtol=1e-5, err_msg=f"loss {i}")
        for k, v in gp.items():
            atol = LR * (i + 1) if k.endswith("key.bias") else 1e-6
            np.testing.assert_allclose(v.numpy(), wp[k].numpy(), rtol=1e-4,
                                       atol=atol, err_msg=f"{k} step {i}")


def test_ps_mode_equals_collective_with_one_worker(steps_setup, monkeypatch):
    """With one worker the servers' sum is the gradient itself: the PS
    step (through the loopback client) gives the collective step's losses
    and parameters to the bit, one push per parameter a step."""
    params, batches = steps_setup
    bps.init(device="cpu")
    want = _port_steps(params, batches)
    bps.shutdown()
    client = LoopbackClient()
    init_loopback(monkeypatch, client)
    got = _port_steps(params, batches)
    for (gl, gp), (wl, wp) in zip(got, want):
        assert gl == wl
        for k, v in wp.items():
            assert torch.equal(gp[k], v), k
    n = len(want[0][1])
    assert len(client.declares) == n
    assert len(client.pushes) == n * STEPS
