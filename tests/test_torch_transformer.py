"""The port's TransformerLM against the flax module on the same weights.

A tiny LM (2 layers, d_model 64, 4 heads, vocab 128) is initialised in
flax, its parameters move over with ``from_flax``, and the logits and
every parameter's gradient of ``lm_loss`` are compared, with the attention
core ``full`` and ``flash``.

Tolerances: in f32 the two differ only by summation order (XLA's and
PyTorch's matmuls, layer-norm statistics), so 1e-4 relative / 1e-5
absolute. In bf16 every product rounds to 8 mantissa bits at places that
differ between the frameworks (XLA may fuse what PyTorch rounds), so the
logits are held to 0.05 absolute (a few bf16 ulps of logits of order 1)
and each parameter's gradient to ||g - g_ref|| <= 3e-2 ||g_ref|| + 1e-3
(about 1% is seen; the floor is for the key biases, whose gradient is
zero up to rounding, as softmax ignores a per-query constant).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.models.transformer import TransformerLM as FlaxLM
from byteps_tpu.models.transformer import lm_loss as jax_lm_loss
from byteps_tpu_torch.models.transformer import (TransformerLM, from_flax,
                                                 lm_loss)

CFG = dict(vocab_size=128, num_layers=2, d_model=64, num_heads=4,
           mlp_dim=128, max_len=32)


@pytest.fixture(autouse=True)
def _one_thread():
    # One intra-op thread: under pytest -n 6 (xdist) the torch processes'
    # threads oversubscribed the host until the JAX package's 8-device
    # CPU collectives in other test workers timed out and aborted.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flax_params(model, tokens):
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(tokens))
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("attn_impl", ["full", "flash"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_matches_flax(attn_impl, dtype):
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, CFG["vocab_size"], size=(2, 24)).astype(np.int32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    fmodel = FlaxLM(**CFG, dtype=jdt, attn_impl=attn_impl)
    params = _flax_params(fmodel, tokens)

    model = TransformerLM(**CFG, dtype=tdt, attn_impl=attn_impl,
                          device="cpu")
    missing = model.load_state_dict(from_flax(params), strict=True)
    assert not missing.missing_keys and not missing.unexpected_keys

    def jloss(p):
        return jax_lm_loss(fmodel.apply(p, jnp.asarray(tokens)),
                           jnp.asarray(tokens))

    want_logits = np.asarray(fmodel.apply(params, jnp.asarray(tokens)))
    want_loss, want_grads = jax.value_and_grad(jloss)(params)

    t = torch.as_tensor(tokens, dtype=torch.long)
    logits = model(t)
    assert logits.dtype == torch.float32
    loss = lm_loss(logits, t)
    loss.backward()
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()}
    want = {k: np.asarray(v) for k, v in
            from_flax(jax.tree_util.tree_map(np.asarray,
                                             want_grads)).items()}

    if dtype == "float32":
        np.testing.assert_allclose(logits.detach().numpy(), want_logits,
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
        for k, g in grads.items():
            np.testing.assert_allclose(g, want[k], rtol=1e-4, atol=1e-5,
                                       err_msg=k)
    else:
        np.testing.assert_allclose(logits.detach().numpy(), want_logits,
                                   atol=0.05)
        np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-2)
        for k, g in grads.items():
            err = np.linalg.norm(g - want[k])
            assert err <= 3e-2 * np.linalg.norm(want[k]) + 1e-3, (k, err)


def test_from_flax_names_every_parameter():
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, CFG["vocab_size"], size=(1, 8)).astype(np.int32)
    params = _flax_params(FlaxLM(**CFG), tokens)
    sd = from_flax(params)
    model = TransformerLM(**CFG, device="cpu")
    assert set(sd) == set(model.state_dict())
    for k, v in sd.items():
        assert model.state_dict()[k].shape == v.shape, k
    assert sd["layers.1.attention.query.kernel"].shape == (64, 4, 16)
    assert sd["layers.0.attention.out.kernel"].shape == (4, 16, 64)


def test_unknown_attn_impl_raises():
    # a typo of "ulysses", as the reference's test_bogus_attn_impl_rejected
    with pytest.raises(ValueError, match="attn_impl"):
        TransformerLM(**CFG, attn_impl="ulyses", device="cpu")


def test_model_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TransformerLM(**CFG)
