"""The port's plain flash-attention backward in bf16 against the JAX one.

The bf16/f16 backward kernels on the card are held to the port's plain
versions (``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``); this
file holds those plain versions, in bf16, to the JAX package's backward:
its dQ and dK/dV Pallas kernels in interpret mode on the CPU, on the same
seeded numpy inputs. Cases: causal, rectangular causal (s_q 100, s_k 260)
and a sliding window.

Tolerance, element by element: ``limit()`` of chip_smoke.py, the bound the
kernels meet. Both sides round ds to bf16 from f32 values summed in
another order (XLA's dot against PyTorch's einsum) and round each output
to bf16 once, which is what the bound's terms cover (``eps`` x the terms
behind the element, 3e-5 x the terms of dp behind each ds, 1e-4 x the
terms for f32 order). End to end, each side also runs its own forward:
o may differ by its bound, and D = rowsum(dO o) by sum_d |dO| |o - o'|,
which ds = p (dp - D) scale carries into dq and dk; that term is added.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.ops import flash_attention as jax_flash
from byteps_tpu.ops.flash_attention import _flash_bwd
from chip_smoke import limit

fa = importlib.import_module("byteps_tpu_torch.ops.flash_attention")

CASES = {
    # b, s_q, s_k, h, d, causal, window
    "causal": (2, 130, 130, 2, 32, True, None),
    "rect_causal": (1, 100, 260, 2, 16, True, None),
    "window64": (1, 300, 300, 2, 16, True, 64),
}


@pytest.fixture(autouse=True)
def _one_thread():
    # One intra-op thread: under pytest -n 6 (xdist) the torch processes'
    # threads oversubscribed the host until the JAX package's 8-device
    # CPU collectives in other test workers timed out and aborted.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(case):
    b, s_q, s_k, h, d, causal, window = CASES[case]
    rng = np.random.default_rng(0)
    shapes = [(b, s_q, h, d), (b, s_k, h, d), (b, s_k, h, d), (b, s_q, h, d)]
    # rounded to bf16 once, so both sides see the same values
    x = [torch.tensor(rng.standard_normal(s).astype(np.float32)).bfloat16()
         for s in shapes]
    return x, causal, d ** -0.5, window


def _jax(t):
    return jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _torch(a):
    return torch.from_numpy(np.array(a, np.float32))


def _check(what, got, want, mag, mag_dp=None, extra=0.0):
    lim = limit("bfloat16", what, got.float(), want.float(), mag,
                mag_dp) + extra
    ratio = ((got.float() - want.float()).abs() / lim).max().item()
    assert bool(torch.isfinite(got.float()).all()), what
    assert ratio <= 1.0, f"{what}: error/limit {ratio:.3f}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_jax_from_same_residuals(case):
    """q, k, v, o and lse of the port's plain forward go through JAX's
    backward rule (``_flash_bwd``: the dQ and dK/dV Pallas kernels) and
    through the port's ``_bwd_dq_reference`` / ``_bwd_dkv_reference``; D
    is formed once, by the same jnp expression as ``_flash_bwd``'s."""
    (q, k, v, do), causal, scale, window = _inputs(case)
    b, s_q, h, _ = q.shape
    o, lse = fa._fwd_reference(q, k, v, causal, scale, window)
    lse_rows = jnp.broadcast_to(
        jnp.asarray(lse.numpy()).reshape(b * h, s_q, 1), (b * h, s_q, 8))
    res = (_jax(q), _jax(k), _jax(v), _jax(o), lse_rows)
    want = _flash_bwd(causal, scale, None, None, True, window, res, _jax(do))
    dvec = jnp.sum(_jax(do).astype(jnp.float32) * _jax(o).astype(jnp.float32),
                   axis=-1)
    dvec = _torch(dvec).permute(0, 2, 1).contiguous()
    args = (q, k, v, do, lse, dvec, causal, scale, window)
    mag = fa._term_magnitudes(*args)
    got = (fa._bwd_dq_reference(*args), *fa._bwd_dkv_reference(*args))
    for what, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        _check(what, g, _torch(w), mag[what], mag.get(what + "_dp"))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_gradient_matches_jax_vjp(case):
    """End to end: torch.autograd through the port's flash_attention (the
    plain forward, then the plain dQ and dK/dV) against jax.vjp of the JAX
    ``flash_attention`` (Pallas forward and backward), same cotangent."""
    (q, k, v, do), causal, scale, window = _inputs(case)
    o_jax, vjp = jax.vjp(
        lambda a, b_, c: jax_flash(a, b_, c, causal, None, 64, 64, None,
                                   window), _jax(q), _jax(k), _jax(v))
    want = vjp(_jax(do))
    qt, kt, vt = (t.clone().requires_grad_() for t in (q, k, v))
    o = fa.flash_attention(qt, kt, vt, causal, None, 64, 64, window)
    got = torch.autograd.grad(o, (qt, kt, vt), do)

    o_ref, lse = fa._fwd_reference(q, k, v, causal, scale, window)
    dvec = (do.float() * o_ref.float()).sum(-1).permute(0, 2, 1).contiguous()
    args = (q, k, v, do, lse, dvec, causal, scale, window)
    mag = fa._term_magnitudes(*args)
    _check("o", o.detach(), _torch(o_jax), mag["o"])
    # D's difference from the two forwards, carried into dq and dk
    d_diff = (do.float().abs() * (o.detach().float() - _torch(o_jax)).abs()
              ).sum(-1).permute(0, 2, 1)
    p, _ = fa._recompute(*args)
    pd = p * d_diff[..., None] * scale
    extra = {"dq": torch.einsum("bhqk,bkhd->bqhd", pd, k.float().abs()),
             "dk": torch.einsum("bhqk,bqhd->bkhd", pd, q.float().abs()),
             "dv": 0.0}
    for what, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        _check(what, g, _torch(w), mag[what], mag.get(what + "_dp"),
               extra[what])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_limit_admits_exact_arithmetic(dtype):
    """``limit()`` is met by the plain backward's formulas in float64 (ds
    rounded to the working dtype at the same point): a computation that
    sums in another order than the plain f32 version, as the kernels do.
    Under a causal mask the first query has one live key, p = 1 and
    o = v exactly, so dp - D is f32 rounding noise on both sides; the
    bound's dp term is what admits it (without it, dq reads 0.77 in bf16
    and 2.2 in f16 here; with it 0.44 and 0.49)."""
    b, s, h, d = 10, 130, 100, 64
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn((b, s, h, d), generator=g).to(dtype)
                   for _ in range(4))
    scale = d ** -0.5
    o, lse = fa._fwd_reference(q, k, v, True, scale)
    dvec = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
    args = (q, k, v, do, lse, dvec, True, scale, None)
    mag = fa._term_magnitudes(*args)
    qd, kd, vd, dod = (t.double() for t in (q, k, v, do))
    p = (torch.exp(torch.einsum("bqhd,bkhd->bhqk", qd, kd) * scale
                   - lse.double()[..., None])
         * fa._live_mask(s, s, True, None, "cpu"))
    dp = torch.einsum("bqhd,bkhd->bhqk", dod, vd)
    ds = (p * (dp - dvec.double()[..., None]) * scale).to(dtype).double()
    exact = {"dq": torch.einsum("bhqk,bkhd->bqhd", ds, kd).to(dtype),
             "dk": torch.einsum("bhqk,bqhd->bkhd", ds, qd).to(dtype)}
    plain = {"dq": fa._bwd_dq_reference(*args),
             "dk": fa._bwd_dkv_reference(*args)[0]}
    name = str(dtype).replace("torch.", "")
    for what in ("dq", "dk"):
        got, want = exact[what].float(), plain[what].float()
        ratio, without = (
            ((got - want).abs() / limit(name, what, got, want, *m)).max()
            .item() for m in ((mag[what], mag[what + "_dp"]), (mag[what],)))
        print(f"{name} {what}: err/limit {ratio:.3f} (without the dp term "
              f"{without:.3f})")
        assert ratio <= 1.0, f"{what}: error/limit {ratio:.3f}"
