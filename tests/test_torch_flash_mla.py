"""Flash attention at latent attention's head dims: q and k of 192 (128
without position, 64 rotary), v and o of 128 (DeepSeek-V3's MLA as it
trains, without the absorbed form).

CPU: the plain path (``flash_attention`` on CPU tensors) against naive
softmax attention, values and gradients, and the wrapper's contract for
the head dims. ``cuda``: the three bf16/f16 kernels at (192, 128)
against the plain path, at sequence lengths from 1 to 8,192 (the ends of
a tile, a sequence shorter than one, Moonlight-16B-A3B's context), within
``chip_smoke.limit`` (the port's bound for a kernel against its plain
version: each side's final rounding, a rounding of each term in a half
dtype, f32 sums in another order); and f32 at (192, 128) refused on the
card. This file imports torch and the port only:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_flash_mla.py
"""

import importlib
import math

import pytest
import torch

from chip_smoke import limit

fa = importlib.import_module("byteps_tpu_torch.ops.flash_attention")

D_QK, D_V = 192, 128


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread, as the port's other torch test files hold it:
    under parallel pytest workers a torch test on every core starves
    the JAX package's 8-device CPU collectives in another worker."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _naive(q, k, v, causal, scale):
    """softmax(q k^T scale, causal mask top-left aligned) v, [b, s, h, d]."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        live = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool).tril()
        s = s.masked_fill(~live, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s_q,s_k", [(1, 1), (17, 17), (64, 64), (70, 130)])
def test_plain_path_matches_naive_attention(s_q, s_k, causal):
    """The plain path at (192, 128) in float64 equals naive softmax
    attention in float64: values to float64 round-off (1e-10: the two sum
    the same terms in another order), the gradients of q, k and v within
    1e-6, since the backward forms D = rowsum(dO * O) in f32 (the
    kernels' residual) whatever the inputs' dtype, 2^-24 of |D| a term."""
    g = torch.Generator().manual_seed(s_q * 1000 + s_k)
    b, h = 2, 3
    q = torch.randn((b, s_q, h, D_QK), generator=g, dtype=torch.float64)
    k = torch.randn((b, s_k, h, D_QK), generator=g, dtype=torch.float64)
    v = torch.randn((b, s_k, h, D_V), generator=g, dtype=torch.float64)
    do = torch.randn((b, s_q, h, D_V), generator=g, dtype=torch.float64)
    scale = D_QK ** -0.5
    got_in = [t.clone().requires_grad_() for t in (q, k, v)]
    want_in = [t.clone().requires_grad_() for t in (q, k, v)]
    got = fa.flash_attention(*got_in, causal=causal)
    want = _naive(*want_in, causal, scale)
    assert got.shape == (b, s_q, h, D_V)
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)
    got.backward(do)
    want.backward(do)
    for a, w in zip(got_in, want_in):
        torch.testing.assert_close(a.grad, w.grad, rtol=1e-6, atol=1e-6)


def test_default_scale_is_qk_head_dim():
    """The scale defaults to 1 / sqrt(192), q and k's head dim (DeepSeek-V3
    scales by the query's whole head dim), not v's."""
    g = torch.Generator().manual_seed(1)
    q, k = (torch.randn((1, 9, 2, D_QK), generator=g, dtype=torch.float64)
            for _ in range(2))
    v = torch.randn((1, 9, 2, D_V), generator=g, dtype=torch.float64)
    torch.testing.assert_close(
        fa.flash_attention(q, k, v, causal=True),
        _naive(q, k, v, True, 1 / math.sqrt(D_QK)), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_kernel_check_takes_192_128_in_half_dtypes(dtype):
    q = torch.empty((2, 5, 3, D_QK), dtype=dtype)
    v = torch.empty((2, 5, 3, D_V), dtype=dtype)
    fa._check(q, q, v)
    fa._check(q, q, v, v)  # the backward's dO has v's head dim


@pytest.mark.parametrize("d,dv,dtype", [
    (D_QK, D_V, torch.float32),   # no f32 kernel at 192 / 128
    (D_QK, 64, torch.bfloat16),   # no other pair
    (D_QK, D_QK, torch.bfloat16),  # 192 alone is no head dim of the kernels
    (64, 128, torch.bfloat16),
])
def test_kernel_check_refuses_untaken_dims(d, dv, dtype):
    q = torch.empty((1, 4, 2, d), dtype=dtype)
    v = torch.empty((1, 4, 2, dv), dtype=dtype)
    with pytest.raises(ValueError, match="not supported"):
        fa._check(q, q, v)


def test_kernel_check_refuses_do_of_qk_head_dim():
    q = torch.empty((1, 4, 2, D_QK), dtype=torch.bfloat16)
    v = torch.empty((1, 4, 2, D_V), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="shape mismatch"):
        fa._check(q, q, v, q)


# --- the kernels on the card ---------------------------------------------

CARD_CASES = {
    # b, s, h: a single query, shorter than a tile, one tile, a tile and
    # one row, uneven tiles, Moonlight-16B-A3B's context of 8,192
    "s1": (2, 1, 3),
    "s7": (2, 7, 3),
    "s64": (1, 64, 4),
    "s65": (1, 65, 4),
    "s200": (2, 200, 2),
    "s1000": (1, 1000, 2),
    "s8192": (1, 8192, 1),
}


def _close(what, got, want, mag, failures, mag_dp=None):
    dtype = str(got.dtype).replace("torch.", "")
    diff = (got.float() - want.float()).abs()
    ratio = (diff / limit(dtype, what, got.float(), want.float(), mag,
                          mag_dp)).max().item()
    print(f"{what}: max_abs_err {diff.max().item():.3e} err/limit "
          f"{ratio:.3f}")
    if not (bool(torch.isfinite(got).all()) and ratio <= 1.0):
        failures.append(f"{what}: error/limit {ratio:.3f}")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_kernels_at_192_128_match_plain(case, dtype):
    """Forward with and without lse, dQ and dK/dV at (192, 128), causal,
    against the plain path on the same inputs and residuals."""
    _card()
    b, s, h = CARD_CASES[case]
    g = torch.Generator().manual_seed(s)

    def rnd(d):
        return torch.randn((b, s, h, d), generator=g).to("cuda", dtype)

    q, k, v, do = rnd(D_QK), rnd(D_QK), rnd(D_V), rnd(D_V)
    scale = D_QK ** -0.5
    failures = []
    print(f"case {case} {dtype}")
    o, lse = fa.flash_fwd(q, k, v, True, scale)
    o_ref, lse_ref = fa._fwd_reference(q, k, v, True, scale)
    assert o.shape == (b, s, h, D_V)
    dvec = (do.float() * o_ref.float()).sum(-1).permute(0, 2, 1).contiguous()
    args = (q, k, v, do, lse_ref, dvec, True, scale)
    mag = fa._term_magnitudes(*args)
    _close("o", o, o_ref, mag["o"], failures)
    _close("lse", lse, lse_ref, None, failures)
    _close("o", fa.flash_fwd(q, k, v, True, scale, return_lse=False), o_ref,
           mag["o"], failures)
    _close("dq", fa.flash_bwd_dq(*args), fa._bwd_dq_reference(*args),
           mag["dq"], failures, mag["dq_dp"])
    for what, got, want in zip(("dk", "dv"), fa.flash_bwd_dkv(*args),
                               fa._bwd_dkv_reference(*args)):
        assert got.shape == want.shape
        _close(what, got, want, mag[what], failures, mag.get(what + "_dp"))
    assert not failures, failures


@pytest.mark.cuda
def test_f32_at_192_128_raises_on_the_card():
    _card()
    q = torch.randn((1, 16, 2, D_QK), device="cuda")
    v = torch.randn((1, 16, 2, D_V), device="cuda")
    with pytest.raises(ValueError, match="not supported"):
        fa.flash_fwd(q, q, v, True, D_QK ** -0.5)
    with pytest.raises(ValueError, match="not supported"):
        fa.flash_attention(q.requires_grad_(), q, v, causal=True)
