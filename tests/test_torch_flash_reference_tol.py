"""The card's flash attention kernels at the JAX package's own tolerances.

Every case of tests/test_flash_attention.py that runs f32 (and its bf16
case) runs here on the card through the port's ``flash_attention``: with
no gradient, the forward without lse; with one, the autograd Function, so
the forward with lse feeds its own lse and D = rowsum(dO * O) to the dQ
and dK/dV kernels, for the gradient of ``(o ** 2).sum()`` as the
reference takes it. Inputs are the reference's: its ``_qkv`` shapes drawn
in its order from ``np.random.default_rng(0)`` (its ``rng`` fixture),
as ``chip_smoke.REFERENCE_CASES`` lists them. The
other side is the JAX package's ``full_attention`` and ``jax.grad`` of it
on the CPU (for the window, the reference test's band-masked attention),
and the bounds are the reference test's: rtol / atol 2e-5 / 2e-6 for o,
2e-4 / 2e-5 for the small gradient case and the window's forward, 5e-4 /
5e-4 for the other gradients, 0.05 / 0.05 in bf16. Each case prints its
worst |err| / (atol + rtol |want|) a tensor (``-s``); a case passes where
every ratio is at most 1.

On the card: ``python -m pytest tests/test_torch_flash_reference_tol.py
-s``. JAX runs on the CPU there too: it is pinned below, before any use
(JAX on the card would take most of its memory, and its f32 products
there default to TF32).
"""

import importlib
import json

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from byteps_tpu.parallel.ring_attention import full_attention  # noqa: E402
from chip_smoke import REFERENCE_CASES, reference_inputs  # noqa: E402

fa = importlib.import_module("byteps_tpu_torch.ops.flash_attention")


def _band_reference(w):
    """test_flash_sliding_window_matches_masked_reference's ``ref``."""
    def ref(q, k, v):
        s, d = q.shape[1], q.shape[-1]
        sc = jnp.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / (d ** 0.5))
        pos_q = jnp.arange(s)[:, None]
        pos_k = jnp.arange(s)[None, :]
        mask = (pos_q >= pos_k) & (pos_q - pos_k < w)
        sc = jnp.where(mask[None, None], sc, -1e30)
        p = jax.nn.softmax(sc, axis=-1)
        return jnp.einsum("bhqk,bkhd->bqhd", p, v)
    return ref


def _ratio(got, want, bound):
    """Worst |got - want| / (atol + rtol |want|): assert_allclose's test
    passes where this is at most 1."""
    rtol, atol = bound
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want)
    if not np.isfinite(err).all():
        return float("inf")
    return float((err / (atol + rtol * np.abs(want))).max())


def _reference(dtype, causal, window):
    if window is not None:
        return _band_reference(window)
    if dtype == jnp.bfloat16:
        return lambda q, k, v: full_attention(
            *(t.astype(jnp.float32) for t in (q, k, v)), causal=causal)
    return lambda q, k, v: full_attention(q, k, v, causal=causal)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(REFERENCE_CASES))
def test_kernels_meet_the_reference_tolerances(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    _, dtype, causal, window, fwd_bound, grad_bound = REFERENCE_CASES[case]
    jdtype = getattr(jnp, dtype)
    q, k, v = (jnp.asarray(x, jdtype) for x in reference_inputs(case))
    ref = _reference(jdtype, causal, window)

    def port(*t):
        return fa.flash_attention(*t, causal=causal, window=window)

    tq, tk, tv = (torch.from_numpy(np.array(t, np.float32)).to(
        "cuda", getattr(torch, dtype)) for t in (q, k, v))
    ratios = {}
    fa.reset_launches()
    if fwd_bound is not None:
        want = np.asarray(ref(q, k, v), np.float32)
        with torch.no_grad():
            o = port(tq, tk, tv)
        assert o.dtype == tq.dtype
        ratios["o (fwd)"] = _ratio(o.float().cpu(), want, fwd_bound)
        o = port(*(t.detach().requires_grad_() for t in (tq, tk, tv)))
        ratios["o (fwd_lse)"] = _ratio(o.detach().float().cpu(), want,
                                       fwd_bound)
    if grad_bound is not None:
        want = jax.grad(lambda *a: (ref(*a) ** 2).sum(),
                        argnums=(0, 1, 2))(q, k, v)
        leaves = [t.detach().requires_grad_() for t in (tq, tk, tv)]
        (port(*leaves) ** 2).sum().backward()
        for name, leaf, w in zip(("dq", "dk", "dv"), leaves, want):
            ratios[name] = _ratio(leaf.grad.float().cpu(), w, grad_bound)
    torch.cuda.synchronize()
    launched = {name: n for name, n in fa.LAUNCHES.items() if n}
    want_launched = {**({"fwd": 1, "fwd_lse": 1} if fwd_bound else {}),
                     **({"fwd_lse": 1 + bool(fwd_bound), "bwd_dq": 1,
                         "bwd_dkv": 1} if grad_bound else {})}
    print("reference_tol " + json.dumps({"case": case, "ratios": ratios}))
    assert launched == want_launched
    failed = {name: r for name, r in ratios.items() if not r <= 1.0}
    assert not failed, f"{case}: error / (atol + rtol |want|) {failed}"
