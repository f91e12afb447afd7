"""The port's flash attention against the JAX version.

Every case of tests/test_flash_attention.py except the Ulysses one, with
the same tolerances: the same seeded numpy inputs go through the JAX
``flash_attention`` (Pallas, interpret mode on the CPU) and through
``byteps_tpu_torch.ops.flash_attention``, whose autograd function runs the
plain versions of the four kernels on CPU tensors (forward with lse, then
the dQ and dK/dV recompute). The CUDA kernels themselves are held
against these plain versions in tests/test_torch_kernels_cuda.py.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.ops import flash_attention as jax_flash
from byteps_tpu.ops.flash_attention import _flash_fwd_impl
from byteps_tpu.parallel.ring_attention import full_attention as jax_full
from byteps_tpu_torch.ops.flash_attention import flash_attention

# the module (the package's ``flash_attention`` attribute is the function)
fa_mod = importlib.import_module("byteps_tpu_torch.ops.flash_attention")


def _qkv(rng, b=2, s=64, h=3, d=32):
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(3)]


def _j(xs, dtype=jnp.float32):
    return [jnp.asarray(x, dtype) for x in xs]


def _t(xs, dtype=torch.float32, grad=False):
    return [torch.tensor(x, dtype=dtype, requires_grad=grad) for x in xs]


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_matches_jax(rng, causal):
    x = _qkv(rng)
    want = jax_flash(*_j(x), causal, None, 32, 32)
    got = flash_attention(*_t(x), causal, None, 32, 32)
    _close(got.numpy(), want, rtol=2e-5, atol=2e-6)
    # and the JAX reference attention, as the JAX test holds its kernel
    _close(got.numpy(), jax_full(*_j(x), causal=causal), rtol=2e-5,
           atol=2e-6)


def test_flash_unaligned_seq(rng):
    """seq 50: the kernel's ragged last tile must not leak into the
    softmax."""
    x = _qkv(rng, s=50)
    want = jax_flash(*_j(x), True, None, 32, 32)
    got = flash_attention(*_t(x), True, None, 32, 32)
    _close(got.numpy(), want, rtol=2e-5, atol=2e-6)


def test_flash_bf16(rng):
    x = _qkv(rng)
    want = jax_full(*_j(x), causal=True)
    got = flash_attention(*_t(x, torch.bfloat16), True, None, 32, 32)
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), want, rtol=0.05, atol=0.05)
    jax_bf16 = jax_flash(*_j(x, jnp.bfloat16), True, None, 32, 32)
    _close(got.float().numpy(), jax_bf16, rtol=0.05, atol=0.05)


def _grads_jax(x, fn):
    return jax.grad(lambda *a: (fn(*a) ** 2).sum(),
                    argnums=(0, 1, 2))(*_j(x))


def _grads_torch(x, fn):
    ts = _t(x, grad=True)
    (fn(*ts) ** 2).sum().backward()
    return [t.grad.numpy() for t in ts]


def _check_grads(x, jfn, tfn, rtol, atol):
    for a, b in zip(_grads_torch(x, tfn), _grads_jax(x, jfn)):
        _close(a, b, rtol=rtol, atol=atol)


def test_flash_gradients(rng):
    x = _qkv(rng, b=1, s=32, h=2, d=16)
    _check_grads(x, lambda *a: jax_flash(*a, True, None, 16, 16),
                 lambda *a: flash_attention(*a, True, None, 16, 16),
                 rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_gradients_multiblock(rng, causal):
    """seq 600: several of the kernel's 64-row tiles and a ragged tail."""
    x = _qkv(rng, b=1, s=600, h=2, d=32)
    _check_grads(x, lambda *a: jax_flash(*a, causal),
                 lambda *a: flash_attention(*a, causal),
                 rtol=5e-4, atol=5e-4)


def _cross(rng):
    q = _qkv(rng, b=1, s=100, h=2, d=16)[0]
    _, k, v = _qkv(rng, b=1, s=260, h=2, d=16)
    return [q, k, v]


def test_flash_gradients_cross_attention_shapes(rng):
    x = _cross(rng)
    _check_grads(x, lambda *a: jax_flash(*a), lambda *a: flash_attention(*a),
                 rtol=5e-4, atol=5e-4)


def test_flash_gradients_causal_rectangular(rng):
    """causal with seq_q != seq_k: the top-left aligned mask."""
    x = _cross(rng)
    _check_grads(x, lambda *a: jax_flash(*a, causal=True),
                 lambda *a: flash_attention(*a, causal=True),
                 rtol=5e-4, atol=5e-4)


def test_flash_sliding_window(rng):
    """window=64 against the JAX kernel's window, forward and gradients."""
    w = 64
    x = _qkv(rng, b=1, s=300, h=2, d=16)
    want = jax_flash(*_j(x), True, None, 64, 64, None, w)
    got = flash_attention(*_t(x), True, None, 64, 64, w)
    _close(got.numpy(), want, rtol=2e-4, atol=2e-5)
    _check_grads(x, lambda *a: jax_flash(*a, True, None, 64, 64, None, w),
                 lambda *a: flash_attention(*a, True, None, 64, 64, w),
                 rtol=5e-4, atol=5e-4)


def test_flash_window_requires_causal(rng):
    x = _t(_qkv(rng, b=1, s=32, h=1, d=16))
    with pytest.raises(ValueError, match="causal"):
        flash_attention(*x, False, None, 16, 16, 8)


@pytest.mark.parametrize("causal,window", [(False, None), (True, None),
                                           (True, 24)])
def test_fwd_reference_lse_matches_jax(rng, causal, window):
    """lse of the plain forward against the JAX kernel's residual rows."""
    x = _qkv(rng, b=2, s=70, h=2, d=16)
    _, lse = _flash_fwd_impl(*_j(x), causal, None, 32, 32, None,
                             return_lse=True, window=window)
    want = np.asarray(lse)[:, :70, 0].reshape(2, 2, 70)   # [b*h, s] rows
    q, k, v = _t(x)
    _, got = fa_mod._fwd_reference(q, k, v, causal, 0.25, window)
    _close(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_no_grad_takes_forward_without_lse(rng, monkeypatch):
    """Under no_grad the public function calls the forward that writes no
    logsumexp (the evaluation path's kernel)."""
    calls = []
    real = fa_mod.flash_fwd

    def spy(*a, **kw):
        calls.append(kw.get("return_lse", True))
        return real(*a, **kw)

    monkeypatch.setattr(fa_mod, "flash_fwd", spy)
    x = _t(_qkv(rng, b=1, s=16, h=1, d=16), grad=True)
    with torch.no_grad():
        flash_attention(*x, True)
    flash_attention(*x, True)
    assert calls == [False, True]
