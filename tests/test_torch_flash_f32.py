"""The port's f32 flash attention: the kernels' arithmetic, the f32 LM
against the JAX one, and (on a card) the kernels against their plain
versions.

On the card the f32 forward (``fa_fwd_tf32_kernel``), dQ
(``fa_bwd_dq_tf32_kernel``) and dK/dV (``fa_bwd_dkv_tf32_kernel``) take
every product on the tensor cores as three TF32 products: each operand x
splits into hi = x rounded to TF32 (``cvt.rna``: to nearest, ties away
from zero, on the 13 low mantissa bits) and lo = x - hi rounded the same
way, and a sum of products a.b is taken as all of a_lo.b_hi, then
a_hi.b_lo, then a_hi.b_hi, into one f32 accumulator
(``csrc/flash_attention.cu``). The CPU has no TF32, so the first tests
emulate that arithmetic in numpy, bit for bit in the split and in f32 for
the sums, at the kernels' tile depths (K = 16 to 128: the head dims for
Q.K^T and dO.V^T, 64, 32 and 16 keys or queries for P.V, dS.K, P^T.dO and
dS^T.Q), and hold it to float64 under ``limit()``'s f32 terms (the bound
every kernel check on the card uses): its worst error must sit under a
twentieth of them, and one TF32 product alone must exceed them, so the
limit can tell the two apart.

``test_f32_plain_backward_matches_jax`` holds the port's plain f32 dQ
(and dK/dV) to the JAX package's backward (its dQ and dK/dV Pallas
kernels in interpret mode) from the same residuals, and
``test_f32_flash_lm_matches_jax`` holds the port's f32 ``TransformerLM``
with flash attention (on the CPU: the kernels' plain versions) to the JAX
package's with its Pallas flash kernel in interpret mode, at the
tolerance tests/test_torch_transformer.py states for f32 (1e-4 relative,
1e-5 absolute: the two differ only by summation order).
"""

import importlib

import numpy as np
import pytest
import torch

from byteps_tpu_torch.models.transformer import (TransformerLM, from_flax,
                                                 lm_loss)
from chip_smoke import limit

fa = importlib.import_module("byteps_tpu_torch.ops.flash_attention")

# The share of limit()'s f32 terms that the three-product sums may take.
MARGIN = 1 / 20
DEPTHS = (16, 32, 64, 128)


@pytest.fixture(autouse=True)
def _one_thread():
    # One intra-op thread, as the other torch test files that run JAX
    # beside torch under pytest -n 6.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rna_tf32(x):
    """float32 -> TF32 as ``cvt.rna.tf32.f32``: add half of the 13 dropped
    bits to the magnitude, then clear them (ties away from zero)."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    hi = rna_tf32(x)
    return hi, rna_tf32(np.asarray(x, np.float32) - hi)


def f32_sum(terms):
    """Column sums of [K, N] float32 terms, one f32 addition after another
    in row order (an accumulator)."""
    acc = np.zeros(terms.shape[1], np.float32)
    for row in terms:
        acc = acc + row
    return acc


def three_tf32_dots(a, b):
    """Row-wise dot products of [N, K] float32 a and b as the kernels take
    them: each TF32 x TF32 product is exact in f32 (11 x 11 significant
    bits), summed lo.hi over K, then hi.lo, then hi.hi."""
    (ah, al), (bh, bl) = split(a), split(b)
    terms = np.concatenate([(al * bh).T, (ah * bl).T, (ah * bh).T])
    return f32_sum(terms)


def one_tf32_dots(a, b):
    return f32_sum((rna_tf32(a) * rna_tf32(b)).T)


def ratio_to_limit(got, a, b):
    """Worst |got - exact| over limit()'s f32 bound for an output element
    (eps |value| + 1e-4 sum |term| + 1e-6)."""
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    want = (a64 * b64).sum(1)
    mag = np.abs(a64 * b64).sum(1)
    err = np.abs(got.astype(np.float64) - want)
    lim = limit("float32", "o", torch.from_numpy(got.astype(np.float64)),
                torch.from_numpy(want), torch.from_numpy(mag))
    return float((torch.from_numpy(err) / lim).max())


def test_rna_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # TF32's spacing in [1, 2)
    x = np.array([one + ulp / 2,                 # a tie: away from zero
                  -(one + ulp / 2),
                  one + ulp / 2 - 2.0 ** -23,    # just below: down
                  one + 3 * ulp / 2,             # a tie above an odd ulp
                  one + ulp], np.float32)
    want = np.array([one + ulp, -(one + ulp), one, one + 2 * ulp, one + ulp],
                    np.float32)
    np.testing.assert_array_equal(rna_tf32(x), want)
    hi, lo = split(x)
    assert not np.any(hi.view(np.uint32) & 0x1FFF)
    assert not np.any(lo.view(np.uint32) & 0x1FFF)


@pytest.mark.parametrize("k", DEPTHS)
@pytest.mark.parametrize("kind", ["normal", "probabilities", "ds"])
def test_three_tf32_products_sit_well_inside_the_f32_limit(k, kind):
    """Random operands as the kernels meet them: normal q, k, v, dO,
    probabilities in [0, 1] against normal values (P.V, P^T.dO), and
    mixed-sign ds = p (dp - D) scale against normal values (dS.K,
    dS^T.Q)."""
    rng = np.random.default_rng(k)
    n = 4096
    a = rng.standard_normal((n, k)).astype(np.float32)
    if kind == "probabilities":
        a = rng.random((n, k)).astype(np.float32)
    elif kind == "ds":
        p = rng.random((n, k))
        dp = rng.standard_normal((n, k)) * 8
        dd = rng.standard_normal((n, 1)) * 8
        a = (p * (dp - dd) * 0.125).astype(np.float32)
    b = rng.standard_normal((n, k)).astype(np.float32)
    ratio = ratio_to_limit(three_tf32_dots(a, b), a, b)
    print(f"K {k} {kind}: three TF32 products at {ratio:.2e} of the "
          f"limit")
    assert ratio <= MARGIN


@pytest.mark.parametrize("k", DEPTHS)
def test_one_tf32_product_fails_the_f32_limit(k):
    """Operands in [1, 2) whose 13 low bits are 0x0FFF all round down by
    0xFFF f32 ulps (2^-11 of 1), so every product of one TF32 pass loses
    ~2^-10 / 1.5 of itself in one direction: ~7x the limit's 1e-4 of the
    terms. The three-product sum of the same operands keeps within the
    margin."""
    rng = np.random.default_rng(k)
    n = 256
    u = (np.uint32(0x3F800000)
         | (rng.integers(0, 1 << 10, size=(2, n, k)).astype(np.uint32) << 13)
         | np.uint32(0x0FFF))
    a, b = u.view(np.float32)
    one = ratio_to_limit(one_tf32_dots(a, b), a, b)
    three = ratio_to_limit(three_tf32_dots(a, b), a, b)
    print(f"K {k}: one TF32 product at {one:.2f} of the limit, three at "
          f"{three:.2e}")
    assert one > 1.0
    assert three <= MARGIN


# b, s_q, s_k, h, d, causal, window: lengths that cross the f32 dQ
# kernel's 16-, 32- and 64-key tiles, d 16 and 128, causal, a window and
# s_q != s_k
JAX_BWD_CASES = {
    "d16_causal": (1, 100, 100, 2, 16, True, None),
    "d16_window": (1, 150, 150, 2, 16, True, 40),
    "d128_rect_causal": (1, 70, 150, 2, 128, True, None),
    "d128_full_rect": (1, 48, 90, 2, 128, False, None),
}


@pytest.mark.parametrize("case", sorted(JAX_BWD_CASES))
def test_f32_plain_backward_matches_jax(case):
    """q, k, v, o and lse of the port's plain f32 forward go through JAX's
    backward rule (``_flash_bwd``: the ``_fa_bwd_dq_kernel`` and
    ``_fa_bwd_dkv_kernel`` Pallas kernels in interpret mode) and through
    the port's ``_bwd_dq_reference`` / ``_bwd_dkv_reference``, D formed
    once by ``_flash_bwd``'s expression; both sum f32 in another order
    (XLA's dot against PyTorch's einsum): rtol 1e-4, atol 1e-5."""
    jax = pytest.importorskip("jax")
    # The JAX side runs on the CPU, as tests/conftest.py pins it, also where
    # JAX sees a card (its f32 dots there default to TF32, and it would
    # take most of the card's memory); a no-op once JAX is set up.
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from byteps_tpu.ops.flash_attention import _flash_bwd
    b, s_q, s_k, h, d, causal, window = JAX_BWD_CASES[case]
    rng = np.random.default_rng(d + s_q)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (b, s, h, d)).astype(np.float32)) for s in (s_q, s_k, s_k, s_q))
    scale = d ** -0.5
    o, lse = fa._fwd_reference(q, k, v, causal, scale, window)
    lse_rows = jnp.broadcast_to(
        jnp.asarray(lse.numpy()).reshape(b * h, s_q, 1), (b * h, s_q, 8))
    res = (*(jnp.asarray(t.numpy()) for t in (q, k, v, o)), lse_rows)
    want = _flash_bwd(causal, scale, None, None, True, window, res,
                      jnp.asarray(do.numpy()))
    dvec = jnp.sum(jnp.asarray(do.numpy()) * jnp.asarray(o.numpy()),
                   axis=-1)
    dvec = torch.from_numpy(np.array(dvec)).permute(0, 2, 1).contiguous()
    args = (q, k, v, do, lse, dvec, causal, scale, window)
    got = (fa._bwd_dq_reference(*args), *fa._bwd_dkv_reference(*args))
    for what, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg=what)


@pytest.mark.parametrize("head_dim", [32, 64])
def test_f32_flash_lm_matches_jax(head_dim):
    """2 layers, d_model 128, 40 tokens (no multiple of a 64-row tile):
    logits, loss and every parameter's gradient of the port's f32 flash
    LM against the JAX package's (its Pallas kernels in interpret mode).
    JAX and flax are imported here, so that the card's tests below also
    run where only torch is installed."""
    jax = pytest.importorskip("jax")
    pytest.importorskip("flax")
    import jax.numpy as jnp

    from byteps_tpu.models.transformer import TransformerLM as FlaxLM
    from byteps_tpu.models.transformer import lm_loss as jax_lm_loss
    cfg = dict(vocab_size=96, num_layers=2, d_model=128,
               num_heads=128 // head_dim, mlp_dim=256, max_len=64)
    tokens = np.random.default_rng(head_dim).integers(
        0, cfg["vocab_size"], size=(2, 40)).astype(np.int32)
    fmodel = FlaxLM(**cfg, dtype=jnp.float32, attn_impl="flash")
    params = jax.tree_util.tree_map(
        np.asarray, fmodel.init(jax.random.PRNGKey(0), jnp.asarray(tokens)))
    model = TransformerLM(**cfg, dtype=torch.float32, attn_impl="flash",
                          device="cpu")
    model.load_state_dict(from_flax(params), strict=True)

    def jloss(p):
        return jax_lm_loss(fmodel.apply(p, jnp.asarray(tokens)),
                           jnp.asarray(tokens))

    want_logits = np.asarray(fmodel.apply(params, jnp.asarray(tokens)))
    want_loss, want_grads = jax.value_and_grad(jloss)(params)
    want = from_flax(jax.tree_util.tree_map(np.asarray, want_grads))

    t = torch.as_tensor(tokens, dtype=torch.long)
    logits = model(t)
    loss = lm_loss(logits, t)
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), want_logits,
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


# --- on the card ---------------------------------------------------------

CUDA_CASES = {
    # b, s_q, s_k, h, d, causal, window
    "d16_rect_causal": (1, 100, 260, 2, 16, True, None),
    "d32_unaligned": (1, 600, 600, 2, 32, True, None),
    "d64_full_rect": (2, 96, 80, 3, 64, False, None),
    "d64_window_rect": (1, 150, 330, 2, 64, True, 48),
    "d128_unaligned": (1, 130, 130, 2, 128, True, None),
    "d128_window": (1, 300, 300, 2, 128, True, 64),
    "gpt2": (8, 512, 512, 12, 64, True, None),
    # one query row: K tiles with no live query write dK = dV = 0
    "d16_one_query": (2, 1, 77, 3, 16, True, None),
    # more (batch, head) pairs than the card has SMs, many times over
    "bh1000": (10, 130, 130, 100, 64, True, None),
}


def _check(what, got, want, mag, failures, mag_dp=None):
    diff = (got.float() - want.float()).abs()
    ratio = (diff / limit("float32", what, got.float(), want.float(),
                          mag, mag_dp)).max().item()
    print(f"{what}: max_abs_err {diff.max().item():.3e} err/limit "
          f"{ratio:.4f}")
    if not (bool(torch.isfinite(got).all()) and ratio <= 1.0):
        failures.append(f"{what}: error/limit {ratio:.3f}")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CUDA_CASES))
def test_f32_tensor_core_kernels_match_plain(case):
    """The f32 forward with and without lse, dQ and dK/dV (three TF32
    products on wgmma) against their plain versions under limit(), at
    every head dim, rectangular and unaligned lengths, a window, a single
    query row, a thousand (batch, head) pairs and GPT-2 small's shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    b, s_q, s_k, h, d, causal, window = CUDA_CASES[case]
    g = torch.Generator().manual_seed(0)

    def rnd(s):
        return torch.randn((b, s, h, d), generator=g).to("cuda")

    q, k, v, do = rnd(s_q), rnd(s_k), rnd(s_k), rnd(s_q)
    scale = d ** -0.5
    failures = []
    fa.reset_launches()
    o, lse = fa.flash_fwd(q, k, v, causal, scale, window)
    o_nl = fa.flash_fwd(q, k, v, causal, scale, window, return_lse=False)
    o_ref, lse_ref = fa._fwd_reference(q, k, v, causal, scale, window)
    dvec = (do * o_ref).sum(-1).permute(0, 2, 1).contiguous()
    args = (q, k, v, do, lse_ref, dvec, causal, scale, window)
    dq = fa.flash_bwd_dq(*args)
    dk, dv = fa.flash_bwd_dkv(*args)
    dq_ref = fa._bwd_dq_reference(*args)
    dk_ref, dv_ref = fa._bwd_dkv_reference(*args)
    mag = fa._term_magnitudes(*args)
    assert fa.LAUNCHES == {"fwd_lse": 1, "fwd": 1, "bwd_dq": 1,
                           "bwd_dkv": 1}
    _check("o", o, o_ref, mag["o"], failures)
    _check("lse", lse, lse_ref, None, failures)
    _check("o", o_nl, o_ref, mag["o"], failures)
    _check("dq", dq, dq_ref, mag["dq"], failures, mag["dq_dp"])
    _check("dk", dk, dk_ref, mag["dk"], failures, mag["dk_dp"])
    _check("dv", dv, dv_ref, mag["dv"], failures)
    assert not failures, failures
