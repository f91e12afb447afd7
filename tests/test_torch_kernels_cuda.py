"""The port's CUDA flash-attention kernels against their plain versions.

Needs a CUDA card (the kernels have no CPU mode); skips elsewhere. This
file imports torch and the port only, so it also runs on a GPU machine
without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Tolerance, kernel against plain version on the same inputs, element by
element: the worst-case rounding bound ``limit()`` of chip_smoke.py, over
the sum of |term| behind each element (``_term_magnitudes``).
"""

import importlib

import pytest
import torch

from chip_smoke import limit

fa = importlib.import_module("byteps_tpu_torch.ops.flash_attention")

CASES = {
    # b, s_q, s_k, h, d, causal, window
    "square_causal": (2, 130, 130, 2, 64, True, None),
    "full": (1, 96, 96, 3, 32, False, None),
    "rect_causal": (1, 100, 260, 2, 16, True, None),
    "window": (1, 300, 300, 2, 128, True, 48),
}


def _close(what, got, want, mag, failures):
    """Element-wise check; prints the worst ratio of error to limit."""
    lim = limit(str(got.dtype).replace("torch.", ""), what, got.float(),
                want.float(), mag)
    diff = (got.float() - want.float()).abs()
    ratio = (diff / lim).max().item()
    print(f"{what}: max_abs_err {diff.max().item():.3e} err/limit "
          f"{ratio:.3f}")
    if not (bool(torch.isfinite(got).all()) and ratio <= 1.0):
        failures.append(f"{what}: error/limit {ratio:.3f}")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_kernels_match_plain(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    b, s_q, s_k, h, d, causal, window = CASES[case]
    g = torch.Generator().manual_seed(0)

    def rnd(s):
        return torch.randn((b, s, h, d), generator=g).to("cuda", dtype)

    q, k, v, do = rnd(s_q), rnd(s_k), rnd(s_k), rnd(s_q)
    scale = d ** -0.5
    failures = []
    print(f"case {case} {dtype}")
    o, lse = fa.flash_fwd(q, k, v, causal, scale, window)
    o_ref, lse_ref = fa._fwd_reference(q, k, v, causal, scale, window)
    dvec = (do.float() * o_ref.float()).sum(-1).permute(0, 2, 1).contiguous()
    args = (q, k, v, do, lse_ref, dvec, causal, scale, window)
    mag = fa._term_magnitudes(*args)
    _close("o", o, o_ref, mag["o"], failures)
    _close("lse", lse, lse_ref, None, failures)
    _close("o", fa.flash_fwd(q, k, v, causal, scale, window,
                             return_lse=False), o_ref, mag["o"], failures)
    _close("dq", fa.flash_bwd_dq(*args), fa._bwd_dq_reference(*args),
           mag["dq"], failures)
    for what, got, want in zip(("dk", "dv"), fa.flash_bwd_dkv(*args),
                               fa._bwd_dkv_reference(*args)):
        _close(what, got, want, mag[what], failures)
    assert not failures, failures


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q = torch.zeros((1, 8, 1, 48), device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd(q, q, q, True, 0.1)
    q = torch.zeros((1, 8, 1, 64), device="cuda", dtype=torch.float64)
    with pytest.raises(TypeError):
        fa.flash_fwd(q, q, q, True, 0.1)
    q = torch.zeros((1, 8, 2, 64), device="cuda").transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd(q, q, q, True, 0.1)
    q, k = torch.zeros((1, 8, 1, 64), device="cuda"), torch.zeros(1, 8, 1, 64)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        fa.flash_fwd(q, k, k, True, 0.1)
