"""The tied head's padded table (``models/transformer.py`` ``Embed.attend``):
where the vocabulary is not a multiple of ``ATTEND_ROWS`` the table is
padded with zero rows before the product and the logits are sliced back.

On the CPU the padded product gives the unpadded one's logits, the
table's gradient and ``lm_loss`` with its gradients bit for bit; an
aligned vocabulary takes the product as it is; the step trace counts the
appended rows as ``head_pad_rows``. The ``cuda`` test holds the padded
head at GPT-2 small's width to the unpadded one on the card and checks
that no product of it runs on cuBLAS's sm75 fallback.

This file imports torch and the port only (no JAX), so its ``cuda`` test
also runs on a GPU machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_head_pad.py
"""

import pytest
import torch

import byteps_tpu_torch as bps
from byteps_tpu_torch.models import transformer
from byteps_tpu_torch.models.transformer import (Embed, TransformerLM,
                                                 lm_loss)
from byteps_tpu_torch.utils import timeline


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    # one intra-op thread: the other test workers need the cores more, and
    # the products then sum in one order
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("BYTEPS_PS_MODE", "collective")
    yield
    timeline.steps = None  # a test that failed mid-trace leaves none
    if bps.initialized():
        bps.shutdown()
    torch.set_num_threads(threads)


def _unpadded(embed: Embed, x: torch.Tensor) -> torch.Tensor:
    """The tied head as a plain product by the unpadded table."""
    return x.to(embed.dtype) @ embed.embedding.to(embed.dtype).T


def _head(vocab, d, dtype=torch.bfloat16, device="cpu", seed=0):
    g = torch.Generator().manual_seed(seed)
    return Embed(vocab, d, dtype, g).to(device)


def _lm(vocab, dtype=torch.bfloat16):
    return TransformerLM(vocab_size=vocab, num_layers=1, d_model=16,
                         num_heads=2, mlp_dim=32, max_len=16, dtype=dtype,
                         generator=torch.Generator().manual_seed(3),
                         device="cpu")


def _tokens(vocab, seed, b=2, s=12):
    return torch.randint(0, vocab, (b, s),
                         generator=torch.Generator().manual_seed(seed))


# GPT-2's vocabulary at GPT-2 small's width, and an odd small one in both
# of the head's dtypes
ODD = [(50257, 768, torch.bfloat16), (131, 32, torch.bfloat16),
       (131, 32, torch.float32)]
ODD_IDS = ["gpt2-bf16", "131-bf16", "131-f32"]


@pytest.mark.parametrize("vocab,d,dtype", ODD, ids=ODD_IDS)
def test_logits_equal_the_unpadded_product(vocab, d, dtype):
    """The logits are the unpadded product's to the bit, a ``[..., V]``
    view of rows padded to a multiple of 64; the parameter stays
    ``[V, d]`` in f32."""
    head = _head(vocab, d, dtype)
    x = torch.randn(2, 64, d, generator=torch.Generator().manual_seed(1))
    got = head.attend(x)
    want = _unpadded(head, x)
    assert got.shape == want.shape == (2, 64, vocab)
    assert got.dtype == want.dtype == dtype
    assert got.stride(-2) % transformer.ATTEND_ROWS == 0
    assert got.stride(-2) - vocab == -vocab % transformer.ATTEND_ROWS
    assert torch.equal(got, want)
    assert head.embedding.shape == (vocab, d)
    assert head.embedding.dtype == torch.float32


@pytest.mark.parametrize("vocab,d,dtype", ODD, ids=ODD_IDS)
def test_gradients_equal_the_unpadded_path(vocab, d, dtype):
    """The table's gradient (``[V, d]`` f32: the padded rows' gradient
    never reaches it) and the input's equal the unpadded path's."""
    head = _head(vocab, d, dtype)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 64, d, generator=g)
    dy = torch.randn(2, 64, vocab, generator=g)
    grads = []
    for fn in (head.attend, lambda t: _unpadded(head, t)):
        head.embedding.grad = None
        xg = x.clone().requires_grad_()
        fn(xg).float().backward(dy)
        grads.append((head.embedding.grad, xg.grad))
    (table, dx), (table_want, dx_want) = grads
    assert table.shape == (vocab, d) and table.dtype == torch.float32
    assert torch.equal(table, table_want)
    assert torch.equal(dx, dx_want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_lm_loss_and_its_gradients_match(monkeypatch, dtype):
    """A whole decoder at an odd vocabulary: ``lm_loss`` and every
    parameter's gradient equal those of the same model with the unpadded
    head."""
    model = _lm(131, dtype)
    tokens = _tokens(131, seed=4)
    runs = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(Embed, "attend", _unpadded)
        model.zero_grad(set_to_none=True)
        loss = lm_loss(model(tokens), tokens)
        loss.backward()
        runs.append((loss.detach(), {n: p.grad.clone()
                                     for n, p in model.named_parameters()}))
    (loss, grads), (loss_want, grads_want) = runs
    assert torch.equal(loss, loss_want)
    assert grads.keys() == grads_want.keys()
    for name in grads:
        assert torch.equal(grads[name], grads_want[name]), name


def _traced_steps(model, vocab, n=2):
    """``n`` steps of ``model`` through the ``DistributedOptimizer`` under
    a step trace: the trace's records."""
    bps.init(device="cpu")
    opt = bps.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-3),
        named_parameters=model.named_parameters())

    def step(tokens):
        opt.zero_grad()
        lm_loss(model(tokens), tokens).backward()
        opt.step()

    step(_tokens(vocab, seed=10))  # tracing off
    timeline.start_steps()
    try:
        for i in range(n):
            step(_tokens(vocab, seed=11 + i))
    finally:
        out = timeline.stop_steps()
    assert len(out["records"]) == n
    return out["records"]


@pytest.mark.parametrize("vocab", [32000, 1024])
def test_an_aligned_vocabulary_is_not_padded(vocab):
    """At a multiple of 64 rows (Llama's 32000, 1024) ``attend`` is the
    plain product, a whole tensor, and a traced step counts no
    ``head_pad_rows``."""
    head = _head(vocab, 16)
    x = torch.randn(2, 8, 16, generator=torch.Generator().manual_seed(1))
    got = head.attend(x)
    assert got.is_contiguous() and got.shape == (2, 8, vocab)
    assert torch.equal(got, _unpadded(head, x))
    records = _traced_steps(_lm(vocab), vocab)
    assert all("head_pad_rows" not in r for r in records)


def test_a_traced_gpt2_step_counts_the_pad():
    """A GPT-2-vocabulary step under the step trace: its record's
    ``head_pad_rows`` is the 47 rows appended to the 50257-row table,
    once a step."""
    records = _traced_steps(_lm(50257), 50257)
    assert [r["head_pad_rows"] for r in records] == [47, 47]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sm75 fallback is cuBLAS's "
                    "choice on the card")


@pytest.mark.cuda
def test_card_head_matches_unpadded_and_leaves_sm75():
    """GPT-2 small's head (50257 x 768, bf16, 2 x 1024 tokens) on the
    card, padded and unpadded: the logits, the input's and the table's
    gradient each within the bf16 tolerance of the float64 product of
    the same bf16 operands, one bf16 ulp of the value plus 2^-9 of the
    sum of |terms| behind it (cuBLAS may split a long sum and round the
    partial sums to bf16: ``allow_bf16_reduced_precision_reduction``);
    under ``torch.profiler`` no kernel of the padded path is of cuBLAS's
    sm75 family. The unpadded path runs there; on an H100 its dX at this
    shape erred about four times as far as the padded one's (0.21 and
    0.055 of the bound's second term)."""
    _card()
    from torch.profiler import ProfilerActivity, profile

    vocab, d = 50257, 768
    head = _head(vocab, d, device="cuda")
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 1024, d, generator=g).cuda()
    dy = torch.randn(2, 1024, vocab, generator=g).cuda()

    def run(fn):
        head.embedding.grad = None
        xg = x.clone().requires_grad_()
        y = fn(xg)
        y.float().backward(dy)
        return y.detach().float(), xg.grad, head.embedding.grad

    unpadded = run(lambda t: _unpadded(head, t))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        padded = run(head.attend)
        torch.cuda.synchronize()
    names = {ev.name for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA}
    assert names, "the profiler saw no kernel"
    assert not [n for n in names if "sm75" in n or "cutlass_75" in n], names

    xd = x.bfloat16().double().reshape(-1, d)
    table = head.embedding.detach().bfloat16().double()
    dyd = dy.bfloat16().double().reshape(-1, vocab)
    want = (xd @ table.T, dyd @ table, dyd.T @ xd)
    mags = (xd.abs() @ table.abs().T, dyd.abs() @ table.abs(),
            dyd.abs().T @ xd.abs())
    failures = []
    for what, a, b, ref, mag in zip(("logits", "dx", "table"), padded,
                                    unpadded, want, mags):
        bound = 2.0 ** -7 * ref.abs() + 2.0 ** -9 * mag
        for side, got in (("padded", a), ("unpadded", b)):
            err = (got.reshape(ref.shape).double() - ref).abs()
            worst = (err / bound).max().item()
            print(f"{what} {side}: worst |err| / bound {worst:.3g}, "
                  f"|err| / mag {(err / mag).max().item():.3g}")
            if worst > 1.0:
                failures.append((what, side, worst))
    assert not failures, failures
