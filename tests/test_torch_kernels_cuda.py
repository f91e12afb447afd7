"""The port's CUDA flash-attention kernels against their plain versions,
and the overlapped PS step's copy-stream path against the plain step.

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


def _close(what, got, want, mag, failures, mag_dp=None):
    """Element-wise check; prints the worst ratio of error to limit (and,
    where ``mag_dp`` is given, the ratio the limit reads without its dp
    term)."""
    dtype = str(got.dtype).replace("torch.", "")
    diff = (got.float() - want.float()).abs()
    ratio = (diff / limit(dtype, what, got.float(), want.float(), mag,
                          mag_dp)).max().item()
    without = ""
    if mag_dp is not None:
        without = " (without the dp term {:.3f})".format(
            (diff / limit(dtype, what, got.float(), want.float(),
                          mag)).max().item())
    print(f"{what}: max_abs_err {diff.max().item():.3e} err/limit "
          f"{ratio:.3f}{without}")
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
           mag["dq"], failures, mag["dq_dp"])
    for what, got, want in zip(("dk", "dv"), fa.flash_bwd_dkv(*args),
                               fa._bwd_dkv_reference(*args)):
        _close(what, got, want, mag[what], failures, mag.get(what + "_dp"))
    assert not failures, failures


TENSOR_CORE_CASES = {
    # b, s_q, s_k, h, d, causal, window
    "gpt2": (8, 512, 512, 12, 64, True, None),
    # BERT-Large MLM (seq 128, batch 32), non-causal
    "bert_large": (32, 128, 128, 16, 64, False, None),
    # Llama-1B (seq 2048, batch 4, 32 query heads on GQA-repeated K/V)
    "llama1b": (4, 2048, 2048, 32, 64, True, None),
    # Llama-1B under Ulysses over 2 ranks (chip_smoke.py phase 9): the
    # whole 8192-token sequence for half the query heads
    "ulysses_8192": (1, 8192, 8192, 16, 64, True, None),
    "d16_one_query": (2, 1, 77, 3, 16, True, None),
    "bh1000": (10, 130, 130, 100, 64, True, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(TENSOR_CORE_CASES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_tensor_core_forward_matches_plain(case, dtype):
    """The bf16/f16 forward (wgmma, TMA) with and without lse, at the
    attention shapes of GPT-2, BERT-Large, Llama-1B and Llama-1B under
    Ulysses (8192 tokens, 16 heads a rank), with a single
    query row, and with more (batch, head) pairs than the card has SMs
    many times over."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    b, s_q, s_k, h, d, causal, window = TENSOR_CORE_CASES[case]
    g = torch.Generator().manual_seed(0)

    def rnd(s):
        return torch.randn((b, s, h, d), generator=g).to("cuda", dtype)

    q, k, v = rnd(s_q), rnd(s_k), rnd(s_k)
    scale = d ** -0.5
    failures = []
    print(f"case {case} {dtype}")
    o, lse = fa.flash_fwd(q, k, v, causal, scale, window)
    o_ref, lse_ref = fa._fwd_reference(q, k, v, causal, scale, window)
    mag = fa._fwd_reference(q, k, v.abs(), causal, scale, window)[0]
    _close("o", o, o_ref, mag.float(), failures)
    _close("lse", lse, lse_ref, None, failures)
    _close("o", fa.flash_fwd(q, k, v, causal, scale, window,
                             return_lse=False), o_ref, mag.float(), failures)
    assert not failures, failures


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(TENSOR_CORE_CASES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_tensor_core_backward_matches_plain(case, dtype):
    """The bf16/f16 dQ and dK/dV kernels (wgmma, TMA) from the plain
    forward's residuals, on the same shapes as the forward above
    (test_kernels_match_plain holds them on rectangular causal shapes and
    on a sliding window at d 128, where dK/dV takes 32-query tiles)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    b, s_q, s_k, h, d, causal, window = TENSOR_CORE_CASES[case]
    g = torch.Generator().manual_seed(0)

    def rnd(s):
        return torch.randn((b, s, h, d), generator=g).to("cuda", dtype)

    q, k, v, do = rnd(s_q), rnd(s_k), rnd(s_k), rnd(s_q)
    scale = d ** -0.5
    failures = []
    print(f"case {case} {dtype}")
    o_ref, lse_ref = fa._fwd_reference(q, k, v, causal, scale, window)
    dvec = (do.float() * o_ref.float()).sum(-1).permute(0, 2, 1).contiguous()
    args = (q, k, v, do, lse_ref, dvec, causal, scale, window)
    mag = fa._term_magnitudes(*args)
    _close("dq", fa.flash_bwd_dq(*args), fa._bwd_dq_reference(*args),
           mag["dq"], failures, mag["dq_dp"])
    for what, got, want in zip(("dk", "dv"), fa.flash_bwd_dkv(*args),
                               fa._bwd_dkv_reference(*args)):
        _close(what, got, want, mag[what], failures, mag.get(what + "_dp"))
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


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["overlap_float32", "overlap_bfloat16",
                                  "overlap_int8", "bucketed_multi",
                                  "bucketed_single",
                                  "distributed_optimizer_bfloat16"])
def test_overlapped_step_on_the_card_matches_plain_step(monkeypatch, path):
    """The hook -> copy stream -> event -> stager path on the card, with
    the loopback client of ``tests/ps_loopback.py`` (one worker: the sum
    is the gradient): three SGD steps of a small flash-attention LM,
    each held to the plain gradient at the same parameters (a second
    model loaded with them before the step). The LM computes in f32, so
    the two forwards agree (losses to 1e-6 relative); each update equals
    lr times the plain gradient within the wire's rounding of it
    (``tests/wire_bound.py``'s ``assert_step_near``: nothing for f32, 2^-8
    of each element for bf16, half an int8 step of its block) plus 1e-4
    of it for the f32 arithmetic and the update's own rounding."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the copy stream and events")
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ps_loopback import LoopbackClient, init_loopback
    from wire_bound import assert_step_near

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.bucketed import make_bucketed_overlap_step
    from byteps_tpu_torch.models import TransformerLM, lm_loss
    from byteps_tpu_torch.overlap import make_overlapped_train_step

    def loss_fn(model, tokens):
        return lm_loss(model(tokens), tokens)

    client = LoopbackClient()
    init_loopback(monkeypatch, client, device="cuda")
    try:
        cfg = dict(vocab_size=128, num_layers=2, d_model=64, num_heads=4,
                   mlp_dim=128, max_len=64, dtype=torch.float32,
                   attn_impl="flash")
        model, ref = (TransformerLM(
            **cfg, generator=torch.Generator().manual_seed(0))
            for _ in range(2))
        lr = 0.1
        opt = torch.optim.SGD(model.parameters(), lr=lr)
        kind, wire = path.rsplit("_", 1)
        if kind == "overlap":
            step = make_overlapped_train_step(loss_fn, opt, wire_dtype=wire)
        elif kind == "bucketed":
            step = make_bucketed_overlap_step(
                loss_fn, opt, n_buckets=3, multi_program=wire == "multi")
        else:
            dopt = bps.DistributedOptimizer(
                opt, compression=bps.Compression.bf16)

            def step(model, tokens):
                dopt.zero_grad()
                loss = loss_fn(model, tokens)
                loss.backward()
                dopt.step()
                return loss.detach()
            step.close = dopt._taps.close
        wire = wire if wire in ("bfloat16", "int8") else "float32"
        tokens = torch.randint(0, 128, (4, 64),
                               generator=torch.Generator().manual_seed(1)
                               ).cuda()
        fa.reset_launches()
        shares = []
        for t in range(3):
            before = {k: v.clone() for k, v in model.state_dict().items()}
            ref.load_state_dict(before)
            ref.zero_grad(set_to_none=True)
            want = loss_fn(ref, tokens)
            want.backward()
            loss = step(model, tokens).item()
            assert abs(loss - want.item()) <= 1e-6 * abs(want.item()), (
                t, loss, want.item())
            shares.append(assert_step_near(
                f"{path} step {t}", before, model.state_dict(),
                {n: p.grad for n, p in ref.named_parameters()}, lr, wire))
        torch.cuda.synchronize()
        assert fa.LAUNCHES["bwd_dkv"] == 2 * 3 * 2  # both models' layers
        n = len(list(model.parameters()))
        assert sorted(client.pushes) == sorted(list(range(n)) * 3)
        if path != "bucketed_single":
            assert all(t.startswith("bps_stager")
                       for t in client.push_threads)
        print(f"{path}: share of the wire bound taken by a step "
              f"{max(shares):.3f}")
        step.close()
    finally:
        bps.shutdown()


@pytest.mark.cuda
def test_llama_remat_step_on_the_card_is_bit_equal():
    """A LlamaTiny (bf16, flash) training step on the card under remat
    gives the same loss and gradients, bit for bit, as without: the
    recomputed forward runs the same deterministic kernels (no atomics),
    and the forward kernel with lse runs twice a block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from byteps_tpu_torch.models import LlamaTiny, lm_loss

    tokens = torch.randint(0, 1024, (2, 256),
                           generator=torch.Generator().manual_seed(0)).cuda()
    out = {}
    for remat in (False, True):
        model = LlamaTiny(attn_impl="flash", dtype=torch.bfloat16,
                          remat=remat)
        fa.reset_launches()
        loss = lm_loss(model(tokens), tokens)
        loss.backward()
        torch.cuda.synchronize()
        out[remat] = (loss.item(), dict(fa.LAUNCHES),
                      {k: p.grad for k, p in model.named_parameters()})
    assert out[True][0] == out[False][0]
    assert out[False][1]["fwd_lse"] == 2 and out[True][1]["fwd_lse"] == 4
    assert out[True][1]["bwd_dkv"] == out[False][1]["bwd_dkv"] == 2
    for k, g in out[False][2].items():
        assert torch.equal(out[True][2][k], g), k
