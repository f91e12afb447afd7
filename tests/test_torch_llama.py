"""The port's LLaMA family (``byteps_tpu_torch/models/llama.py``) against
the flax modules of ``byteps_tpu/models/llama.py``.

- ``RMSNorm`` and ``_rope`` on random numpy inputs, f32 and bf16;
- ``LlamaTiny`` (2 layers, d_model 64, 4 heads over 2 KV heads, so GQA
  groups of 2) on the same weights via ``from_flax``: logits, ``lm_loss``
  and every gradient, f32 and bf16, attention ``full`` and ``flash`` (the
  JAX flash kernel in interpret mode on the CPU, the port's plain
  versions), and the same model with K/V heads tiled instead of repeated
  in a row, which must disagree;
- causality, ``remat`` against no remat, the heads check, ``full``
  attention under sequence parallelism (it raises, as the reference does;
  ``tests/test_torch_seq_parallel.py`` holds the SP paths);
- ``Llama1B`` and ``Llama7B`` parameter shapes against ``jax.eval_shape``
  with no weights allocated (the port on the meta device);
- three ``make_train_step`` steps against the JAX step on a one-device
  mesh, and PS mode through the loopback client against the collective
  step.

Tolerances. RMSNorm and RoPE compute in f32 on both sides (rsqrt, cos and
sin from other libraries, a few f32 ulps apart): f32 to 1e-5 relative /
1e-6 absolute; in bf16 both round the f32 value once at the end, so they
differ by at most one bf16 ulp, 2^-7 of the value. The model is held to
``tests/test_torch_transformer.py``'s tolerances: f32 1e-4 relative /
1e-5 absolute, bf16 logits 0.05 absolute and gradients ||g - g_ref|| <=
3e-2 ||g_ref|| + 1e-3; remat to ``tests/test_llama.py``'s 1e-4 / 1e-5.
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
from byteps_tpu.models import llama as fl  # noqa: E402
from byteps_tpu.models.transformer import lm_loss as jax_lm_loss  # noqa: E402
from byteps_tpu.parallel.mesh import MeshSpec, build_mesh  # noqa: E402
from byteps_tpu_torch.models import llama  # noqa: E402
from byteps_tpu_torch.models.transformer import (  # noqa: E402
    _flatten, lm_loss, port_name)
from byteps_tpu_torch.training import make_train_step  # noqa: E402
from ps_loopback import LoopbackClient, init_loopback  # noqa: E402

VOCAB, LR, STEPS = 1024, 1e-4, 3


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


def _close(got, want, dtype):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32) * 3
    scale = rng.standard_normal(48).astype(np.float32)
    want = fl.RMSNorm().apply({"params": {"scale": jnp.asarray(scale)}},
                              jnp.asarray(x, getattr(jnp, dtype)))
    norm = llama.RMSNorm(48)
    with torch.no_grad():
        norm.scale.copy_(torch.as_tensor(scale))
        got = norm(torch.as_tensor(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("positions", ["arange", "random"])
def test_rope_matches_jax(dtype, positions):
    rng = np.random.default_rng(1)
    b, s, h, d = 2, 9, 3, 16
    x = rng.standard_normal((b, s, h, d)).astype(np.float32)
    pos = (np.arange(s)[None, :] if positions == "arange"
           else rng.integers(0, 4096, size=(b, s)))
    want = fl._rope(jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(pos),
                    500000.0)
    got = llama._rope(torch.as_tensor(x).to(getattr(torch, dtype)),
                      torch.as_tensor(pos), 500000.0)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


def _flax_params(model, tokens):
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(tokens))
    return jax.tree_util.tree_map(np.asarray, params)


def _port(params, **kw):
    model = llama.LlamaTiny(device="cpu", **kw)
    model.load_state_dict(llama.from_flax(params), strict=True)
    return model


def _tokens(seed, b=2, s=24):
    rng = np.random.default_rng(seed)
    return rng.integers(0, VOCAB, size=(b, s)).astype(np.int32)


def _port_logits_grads(model, tokens):
    t = torch.as_tensor(tokens, dtype=torch.long)
    logits = model(t)
    loss = lm_loss(logits, t)
    loss.backward()
    return logits.detach(), loss.item(), {
        k: p.grad.numpy() for k, p in model.named_parameters()}


@pytest.mark.parametrize("attn_impl", ["full", "flash"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_llama_matches_flax(attn_impl, dtype):
    tokens = _tokens(0)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    fmodel = fl.LlamaTiny(dtype=jdt, attn_impl=attn_impl)
    params = _flax_params(fmodel, tokens)
    model = _port(params, dtype=tdt, attn_impl=attn_impl)

    def jloss(p):
        return jax_lm_loss(fmodel.apply(p, jnp.asarray(tokens)),
                           jnp.asarray(tokens))

    want_logits = np.asarray(fmodel.apply(params, jnp.asarray(tokens)))
    want_loss, want_grads = jax.value_and_grad(jloss)(params)
    want = llama.from_flax(jax.tree_util.tree_map(np.asarray, want_grads))

    logits, loss, grads = _port_logits_grads(model, tokens)
    assert logits.dtype == torch.float32
    assert logits.shape == (2, 24, VOCAB)
    assert set(grads) == set(want)
    if dtype == "float32":
        np.testing.assert_allclose(logits.numpy(), want_logits, rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
        for k, g in grads.items():
            np.testing.assert_allclose(g, want[k].numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)
    else:
        np.testing.assert_allclose(logits.numpy(), want_logits, atol=0.05)
        np.testing.assert_allclose(loss, float(want_loss), rtol=1e-2)
        for k, g in grads.items():
            err = np.linalg.norm(g - want[k].numpy())
            assert err <= 3e-2 * np.linalg.norm(want[k].numpy()) + 1e-3, (
                k, err)


def test_gqa_repeats_each_kv_head_in_a_row(monkeypatch):
    """Query head j reads KV head j // groups, as jnp.repeat has it: the
    same model with the K/V heads tiled (head j reads j % num_kv_heads)
    is far from flax, beyond the f32 tolerance the real one meets."""
    tokens = _tokens(1)
    fmodel = fl.LlamaTiny(dtype=jnp.float32)
    params = _flax_params(fmodel, tokens)
    want = np.asarray(fmodel.apply(params, jnp.asarray(tokens)))
    model = _port(params, dtype=torch.float32)
    t = torch.as_tensor(tokens, dtype=torch.long)
    with torch.no_grad():
        np.testing.assert_allclose(model(t).numpy(), want, rtol=1e-4,
                                   atol=1e-5)
        monkeypatch.setattr(llama, "_repeat_kv",
                            lambda x, g: x.repeat(1, 1, g, 1))
        tiled = model(t).numpy()
    assert np.abs(tiled - want).max() > 100 * (1e-5 + 1e-4 * np.abs(
        want).max())


def test_heads_must_be_a_multiple_of_kv_heads():
    with pytest.raises(ValueError, match="multiple of num_kv_heads"):
        llama.LlamaTiny(num_heads=4, num_kv_heads=3, device="cpu")


def test_full_attention_under_sp_raises():
    """``full`` attention under a sequence-parallel group would attend
    within each block only, so it is refused, as the reference does
    (tests/test_torch_seq_parallel.py holds the SP paths). The check comes before the group is used, so
    any object stands in for one here."""
    with pytest.raises(ValueError, match="sequence parallelism"):
        llama.LlamaTiny(attn_impl="full", sp_group=object(), device="cpu")


def test_causality():
    """Changing a later token leaves every earlier position's logits as
    they were, and changes its own."""
    model = llama.LlamaTiny(dtype=torch.float32, attn_impl="flash",
                            device="cpu")
    t = torch.as_tensor(_tokens(2, 1, 12), dtype=torch.long)
    t2 = t.clone()
    t2[0, 8] = (t2[0, 8] + 1) % VOCAB
    with torch.no_grad():
        base, out = model(t), model(t2)
    assert torch.equal(base[0, :8], out[0, :8])
    assert not torch.allclose(base[0, 8:], out[0, 8:])


def test_remat_matches_plain():
    tokens = _tokens(3)
    grads = {}
    for remat in (False, True):
        model = llama.LlamaTiny(dtype=torch.float32, attn_impl="flash",
                                remat=remat, device="cpu")
        _, _, grads[remat] = _port_logits_grads(model, tokens)
    for k, g in grads[False].items():
        np.testing.assert_allclose(grads[True][k], g, rtol=1e-4, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("name", ["Llama1B", "Llama7B"])
def test_named_configs_have_flax_shapes(name):
    shapes = jax.eval_shape(getattr(fl, name)().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))["params"]
    want = {port_name(k): tuple(v.shape) for k, v in _flatten(shapes).items()}
    with torch.device("meta"):
        model = getattr(llama, name)(device="meta")
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want
    assert got["layers.0.attn.k.kernel"] == (
        (2048, 4, 64) if name == "Llama1B" else (4096, 32, 128))
    n = sum(np.prod(s) for s in got.values())
    assert n == {"Llama1B": 1_034_512_384, "Llama7B": 6_607_343_616}[name]


def _jax_steps(params, batches):
    """JAX make_train_step with optax.adamw(LR) (weight decay 1e-4) on a
    one-device mesh."""
    fmodel = fl.LlamaTiny(dtype=jnp.float32)
    mesh = build_mesh(MeshSpec(dcn=1, ici=1), devices=jax.devices()[:1])
    jbps.init(mesh=mesh)
    try:
        tx = optax.adamw(LR)

        def jloss(p, t):
            return jax_lm_loss(fmodel.apply(p, t), t)

        step = jax_make_train_step(jloss, tx, mesh)
        p = replicate(jax.tree_util.tree_map(jnp.asarray, params), mesh)
        s = replicate(tx.init(p), mesh)
        out = []
        for t in batches:
            p, s, loss = step(p, s, shard_batch(jnp.asarray(t), mesh))
            out.append((float(loss), llama.from_flax(
                jax.tree_util.tree_map(np.asarray, p))))
        return out
    finally:
        jbps.shutdown()


def _llama_loss(model, tokens):
    return lm_loss(model(tokens), tokens)


def _port_steps(params, batches):
    model = _port(params, dtype=torch.float32, attn_impl="flash")
    opt = torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=1e-4)
    step = make_train_step(_llama_loss, opt)
    out = []
    for t in batches:
        loss = step(model, torch.as_tensor(t, dtype=torch.long))
        out.append((loss.item(), {k: v.clone() for k, v in
                                  model.state_dict().items()}))
    return out


@pytest.fixture(scope="module")
def steps_setup():
    batches = [_tokens(10 + i, 4, 16) for i in range(STEPS)]
    params = _flax_params(fl.LlamaTiny(dtype=jnp.float32), batches[0])
    return params, batches


def test_train_step_matches_jax(steps_setup):
    """Loss and every parameter after each AdamW step (torch's AdamW with
    weight_decay=1e-4 is optax.adamw's default update): 1e-5 relative on
    the loss, 1e-4 / 1e-6 on the parameters."""
    params, batches = steps_setup
    want = _jax_steps(params, batches)
    bps.init(device="cpu")
    got = _port_steps(params, batches)
    for i, ((gl, gp), (wl, wp)) in enumerate(zip(got, want)):
        np.testing.assert_allclose(gl, wl, rtol=1e-5, err_msg=f"loss {i}")
        for k, v in gp.items():
            np.testing.assert_allclose(v.numpy(), wp[k].numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=f"{k} step {i}")


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
