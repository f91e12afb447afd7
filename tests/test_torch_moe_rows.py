"""The dropless expert layer's row kernels (``ops/moe_rows.py``,
``csrc/moe_rows.cu``): on the CPU, their plain versions composed as the
card's path (``parallel.moe._routed_rows``) against the plain
``_routed``, output and every gradient, in f32, over routings that hold
some pairs, none and all; the SwiGLU backward's formula against
autograd; the launch counters. On a CUDA card each kernel and its
backward against its plain version at Moonlight's layer shape, the layer
against the plain ``_routed``, and a run whose unset rows are all NaN.

This file imports torch and the port only (no JAX), so its ``cuda`` tests
also run on a GPU machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_moe_rows.py

Tolerances on the card: a kernel against its plain version on the same
inputs within ``chip_smoke.bn_bound``: 1e-5 of the largest |want| (or of
the sum of |term| behind a sum), which covers two f32 evaluations that
sum in another order, plus one bf16 ulp of want for a bf16 output (the
kernel's own rounding); the gathers are copies and must be equal. The
layer through the kernels and the plain ``_routed``, both bf16, each
against the layer evaluated in f32 from the same bf16 values: the
kernels' path no further from it than the plain path (to 10 %), which
rounds silu(g), its product with u and the route weight to bf16 one by
one where the kernel rounds once; both run the same bf16 products.
"""

import pytest
import torch
import torch.nn.functional as nnf

from byteps_tpu_torch.models import DeepseekTiny, moe_lm_loss
from byteps_tpu_torch.ops import moe_rows
from byteps_tpu_torch.parallel import moe
from byteps_tpu_torch.utils import timeline
from chip_smoke import bn_bound


@pytest.fixture(autouse=True)
def _one_thread():
    # one intra-op thread: the other test workers need the cores more
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    timeline.steps = None
    moe_rows.reset_launches()
    torch.set_num_threads(threads)


def _zipf_idx(t, n_experts, k, gen):
    """[t, k] distinct experts a token, drawn with weights 1 / rank over a
    random order of the experts."""
    rank = torch.randperm(n_experts, generator=gen)
    p = 1.0 / (rank + 1).double()
    return torch.multinomial(p.expand(t, n_experts), k, replacement=False,
                             generator=gen)


def _routing(case, t, k, gen):
    """(idx [t, k], held experts) of a routing case over 8 experts."""
    if case == "zipf":
        return _zipf_idx(t, 8, k, gen), (2, 6)
    # a bias that swamps the scores: every token picks experts 1-6
    bias = torch.tensor([0., 9., 9., 9., 9., 9., 9., 0.])
    _, idx = moe.sigmoid_topk(torch.randn(t, 8, generator=gen), bias, k)
    return idx, {"skewed": (2, 6), "none": (7, 8), "all": (0, 8)}[case]


def _layer(idx, held, d, f, dtype, device, gen, scaling=2.446):
    """([x, route weights, w1, w2] leaves of a held share, idx on
    ``device``)."""
    t, k = idx.shape
    n = held[1] - held[0]
    x = torch.randn(t, d, generator=gen).to(device, dtype)
    gates = torch.rand(t, k, generator=gen) + 0.1
    weights = (gates / gates.sum(-1, keepdim=True) * scaling).to(device)
    w1 = (torch.randn(n, d, 2 * f, generator=gen) * d ** -0.5).to(device)
    w2 = (torch.randn(n, f, d, generator=gen) * f ** -0.5).to(device)
    leaves = [v.requires_grad_() for v in (x, weights, w1, w2)]
    return leaves, idx.to(device)


def _run(routed, leaves, idx, held, dout):
    """The layer's output and the gradients of x, the route weights, w1
    and w2 for output gradient ``dout``, through ``RoutedExperts``'
    checkpoint with the layer function ``routed``."""
    x, weights, w1, w2 = leaves
    plan = moe.expert_plan(idx, weights, held[0], held[1] - held[0])
    out = torch.utils.checkpoint.checkpoint(
        routed, x, plan.src, plan.held, plan.weight, plan.pos, plan.mine,
        plan.offs, w1, w2, use_reentrant=False, preserve_rng_state=False)
    return [out, *torch.autograd.grad(out, leaves, dout)], plan


# --- CPU ----------------------------------------------------------------------

@pytest.mark.parametrize("case", ["zipf", "skewed", "none", "all"])
def test_plain_versions_composed_equal_the_plain_routed(case):
    """``_routed_rows`` on CPU tensors (the three functions' plain
    versions and their backward formulas) is ``_routed``: output and the
    gradients of x, the route weights, w1 and w2, in f32. Held pairs:
    some, every token's same ones, none (rows 0: all zeros), all (rows =
    T k)."""
    gen = torch.Generator().manual_seed(31)
    t, k, d, f = 40, 6, 16, 8
    idx, held = _routing(case, t, k, gen)
    leaves, idx = _layer(idx, held, d, f, torch.float32, "cpu", gen)
    dout = torch.randn(t, d, generator=gen)
    got, plan = _run(moe._routed_rows, leaves, idx, held, dout)
    want, _ = _run(moe._routed, leaves, idx, held, dout)
    rows = int(plan.rows)
    assert rows == {"none": 0, "all": t * k}.get(case, rows)
    if case == "skewed":
        assert rows == t * 4  # experts 2-5 of the chosen 1-6
    for name, a, b in zip(("out", "dx", "dweights", "dw1", "dw2"), got,
                          want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6,
                                   msg=lambda m, name=name: f"{name}: {m}")
    if case == "none":
        assert all(not g.any() for g in got)
    assert moe_rows.LAUNCHES == dict.fromkeys(moe_rows.LAUNCHES, 0)


def test_swiglu_backward_formula_matches_autograd():
    """``swiglu_backward_plain`` (the kernel's arithmetic) is autograd's
    gradient of ``swiglu_plain`` in float64, and 0 past the held rows,
    whatever they hold."""
    gen = torch.Generator().manual_seed(32)
    p, f, rows = 24, 8, 17
    h = (3 * torch.randn(p, 2 * f, generator=gen, dtype=torch.float64))
    h[rows:] = float("nan")
    weight = torch.rand(p, generator=gen, dtype=torch.float64)
    da = torch.randn(p, f, generator=gen, dtype=torch.float64)
    offs = torch.tensor([5, 5, rows], dtype=torch.int32)
    hl, wl = h[:rows].clone().requires_grad_(), weight.clone()
    wl.requires_grad_()
    a = moe_rows.swiglu_plain(hl, wl[:rows], torch.tensor([rows]))
    dh_want, dw_want = torch.autograd.grad(a, (hl, wl), da[:rows])
    dh, dw = moe_rows.swiglu_backward_plain(h, weight, da, offs)
    torch.testing.assert_close(dh[:rows], dh_want, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(dw, dw_want, rtol=1e-12, atol=1e-12)
    assert not dh[rows:].any() and not dw[rows:].any()


def test_cpu_tensors_launch_no_kernel():
    """DeepseekTiny on the CPU takes the wrappers' plain versions: no
    kernel entry counts, also under a step trace."""
    model = DeepseekTiny(dtype=torch.float32, attn_impl="flash",
                         experts=(2, 6),
                         generator=torch.Generator().manual_seed(0),
                         device="cpu")
    tokens = torch.randint(0, 256, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    timeline.start_steps()
    try:
        rec = timeline.steps.open()
        timeline.add_span(rec, "zero_grad", 0.0, 0.0)
        moe_lm_loss(model(tokens), tokens).backward()
    finally:
        out = timeline.stop_steps()
    assert moe_rows.LAUNCHES == dict.fromkeys(moe_rows.LAUNCHES, 0)
    assert [r.get("moe_rows", 0) > 0 for r in out["records"]] == [True]
    assert all("moe_row_launches" not in r for r in out["records"])


def test_each_entry_counts_in_the_step_record():
    """A kernel entry adds to LAUNCHES and, under a step trace, to the
    current record's ``moe_row_launches``."""
    timeline.start_steps()
    try:
        rec = timeline.steps.open()
        timeline.add_span(rec, "zero_grad", 0.0, 0.0)
        for name in ("gather", "swiglu", "combine", "combine"):
            moe_rows._launch(name, lambda: 0)
    finally:
        out = timeline.stop_steps()
    assert moe_rows.LAUNCHES == {"gather": 1, "combine": 2, "swiglu": 1,
                                 "swiglu_backward": 0}
    assert [r["moe_row_launches"] for r in out["records"]] == [4]


def test_refuses_a_device_it_has_no_version_for():
    x = torch.empty(4, 8, device="meta")
    src = torch.empty(8, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        moe_rows.gather_rows(x, src, src, src.bool(),
                             torch.empty(1, dtype=torch.int32,
                                         device="meta"))


# --- CUDA card ------------------------------------------------------------------

# Moonlight-16B-A3B's expert layer (portbench/configs/moonlight-16b-a3b.json)
# at the cell's 4 x 8192 tokens: experts 0-7 of 64 held
T, D, F, K, N_EXPERTS, HELD = 32768, 2048, 1408, 6, 64, (0, 8)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


def _moonlight_plan(dtype, seed):
    """(leaves, idx, plan) of Moonlight's layer on the card with
    Zipf-skewed choices."""
    gen = torch.Generator().manual_seed(seed)
    idx = _zipf_idx(T, N_EXPERTS, K, gen)
    leaves, idx = _layer(idx, HELD, D, F, dtype, "cuda", gen)
    plan = moe.expert_plan(idx, leaves[1].detach(), HELD[0],
                           HELD[1] - HELD[0])
    return leaves, idx, plan


def _unset(t, rows):
    """``t`` with its rows from ``rows`` on NaN, as the products leave
    them unset."""
    t = t.clone()
    t[rows:] = float("nan")
    return t


def _within(what, got, want, dtype, mag=None):
    ratio = ((got.double() - want.double()).abs()
             / bn_bound(dtype, want, mag)).max().item()
    print(f"{what}: err/bound {ratio:.3f}")
    assert torch.isfinite(got).all(), what
    assert ratio <= 1.0, f"{what}: err/bound {ratio:.3f}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("kernel", ["gather", "swiglu", "combine"])
def test_kernel_and_its_backward_match_the_plain_version(kernel, dtype):
    _card()
    (x, _, _, _), _, plan = _moonlight_plan(dtype, seed=41)
    rows = int(plan.rows)
    p = plan.src.numel()
    print(f"rows {rows} of {p}")
    assert 0 < rows < p
    gen = torch.Generator(device="cuda").manual_seed(42)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)
    moe_rows.reset_launches()
    if kernel == "gather":
        xg = x.detach().clone().requires_grad_()
        xs = moe_rows.gather_rows(xg, plan.src, plan.pos, plan.mine,
                                  plan.offs)
        dxs = _unset(rand(p, D), rows)
        (dx,) = torch.autograd.grad(xs, xg, dxs)
        assert torch.equal(xs[:rows], x[plan.src[:rows]])
        mag = moe_rows.combine_plain(dxs.abs().float(), plan.pos, plan.mine,
                                     K)
        _within("dx", dx, moe_rows.combine_plain(
            dxs.float(), plan.pos, plan.mine, K), dtype, mag)
        want = {"gather": 1, "combine": 1}
    elif kernel == "swiglu":
        h = _unset(rand(p, 2 * F, scale=3.0), rows).requires_grad_()
        w = plan.weight.clone().requires_grad_()
        a = moe_rows.swiglu_rows(h, w, plan.offs)
        da = _unset(rand(p, F), rows)
        dh, dw = torch.autograd.grad(a, (h, w), da)
        hf = h.detach().float()
        _within("a", a[:rows], moe_rows.swiglu_plain(
            hf, plan.weight, plan.offs)[:rows], dtype)
        dh_want, dw_want = moe_rows.swiglu_backward_plain(
            hf, plan.weight, da.float(), plan.offs)
        _within("dh", dh[:rows], dh_want[:rows], dtype)
        g, u = hf[:rows].chunk(2, dim=-1)
        terms = (da[:rows].float() * nnf.silu(g) * u).abs().sum(-1)
        _within("dweight", dw[:rows], dw_want[:rows], torch.float32, terms)
        assert not dw[rows:].any()
        want = {"swiglu": 1, "swiglu_backward": 1}
    else:
        y = _unset(rand(p, D), rows).requires_grad_()
        out = moe_rows.combine_rows(y, plan.pos, plan.mine, plan.src,
                                    plan.offs, K)
        dout = rand(T, D)
        (dy,) = torch.autograd.grad(out, y, dout)
        yf = y.detach().float()
        mag = moe_rows.combine_plain(yf.abs(), plan.pos, plan.mine, K)
        _within("out", out, moe_rows.combine_plain(yf, plan.pos, plan.mine,
                                                   K), dtype, mag)
        assert torch.equal(dy[:rows], dout[plan.src[:rows]])
        want = {"combine": 1, "gather": 1}
    torch.cuda.synchronize()
    assert moe_rows.LAUNCHES == {**dict.fromkeys(moe_rows.LAUNCHES, 0),
                                 **want}


def _f32_layer(leaves, idx, dout):
    """The share's output and gradients (x, the route weights, w1, w2) in
    f32 from the same bf16 values, expert by expert with f32 products:
    the yardstick both card paths are measured against."""
    x, weights, w1, w2 = (t.detach() for t in leaves)
    xf = x.float().requires_grad_()
    wf = weights.clone().requires_grad_()
    w1f = w1.bfloat16().float().requires_grad_()
    w2f = w2.bfloat16().float().requires_grad_()
    out = torch.zeros(x.shape, device=x.device)
    for e in range(HELD[1] - HELD[0]):
        t, j = (idx == HELD[0] + e).nonzero(as_tuple=True)
        g, u = (xf[t] @ w1f[e]).chunk(2, dim=-1)
        a = nnf.silu(g) * u * wf[t, j, None]
        out = out.index_add(0, t, a @ w2f[e])
    return [out, *torch.autograd.grad(out, (xf, wf, w1f, w2f),
                                      dout.float())]


@pytest.mark.cuda
def test_routed_experts_on_the_card_match_the_plain_routed():
    """``RoutedExperts`` on the card (the kernels, under its checkpoint)
    and the plain ``_routed`` on the same bf16 inputs, each against the
    layer in f32 (``_f32_layer``): output and the gradients of x, the
    route weights, w1 and w2 are as close to it as the plain path's, to
    10 %, and within 2^-7 of its norm; each kernel entry counted in
    LAUNCHES and in the step record's ``moe_row_launches``."""
    _card()
    leaves, idx, _ = _moonlight_plan(torch.bfloat16, seed=43)
    dout = torch.randn(T, D, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(
                           44)).bfloat16()
    plain, _ = _run(moe._routed, leaves, idx, HELD, dout)
    truth = _f32_layer(leaves, idx, dout)
    moe_rows.reset_launches()
    experts = moe.RoutedExperts(D, F, N_EXPERTS, *HELD).cuda()
    with torch.no_grad():
        experts.w1.copy_(leaves[2])
        experts.w2.copy_(leaves[3])
    x, weights = leaves[0], leaves[1]
    timeline.start_steps()
    try:
        rec = timeline.steps.open()
        timeline.add_span(rec, "zero_grad", 0.0, 0.0)
        plan = moe.expert_plan(idx, weights, *HELD)
        out = experts(x, plan)
        got = [out, *torch.autograd.grad(
            out, (x, weights, experts.w1, experts.w2), dout)]
        torch.cuda.synchronize()
    finally:
        trace = timeline.stop_steps()
    print(f"rows {int(plan.rows)} of {plan.src.numel()}")

    def err(a, want):
        return ((a.double() - want.double()).norm()
                / want.double().norm()).item()
    for name, a, b, want in zip(("out", "dx", "dweights", "dw1", "dw2"),
                                got, plain, truth):
        assert torch.isfinite(a).all(), name
        ek, ep = err(a, want), err(b, want)
        print(f"{name}: |kernels - f32| {ek:.2e}, |plain - f32| {ep:.2e}")
        assert ek <= 1.1 * ep and ek <= 2 ** -7, (name, ek, ep)
    # forward, the checkpoint's recompute, and the three backward entries
    assert moe_rows.LAUNCHES == {"gather": 3, "combine": 3, "swiglu": 2,
                                 "swiglu_backward": 1}
    assert [r["moe_row_launches"] for r in trace["records"]] == [9]


class _Products(torch.autograd.Function):
    """``_grouped`` (``real``), forward and backward; with ``unset`` its
    output rows from offs[-1] on, and its input gradient's, are NaN: what
    an unset row may hold."""

    @staticmethod
    def forward(ctx, x, w, offs, real, unset):
        ctx.save_for_backward(x, w, offs)
        ctx.real, ctx.unset = real, unset
        return _poison(real(x, w, offs), offs, unset)

    @staticmethod
    def backward(ctx, dout):
        x, w, offs = ctx.saved_tensors
        with torch.enable_grad():
            xd, wd = x.detach().requires_grad_(), w.detach().requires_grad_()
            dx, dw = torch.autograd.grad(ctx.real(xd, wd, offs), (xd, wd),
                                         dout)
        return _poison(dx, offs, ctx.unset), dw, None, None, None


def _poison(t, offs, unset):
    if not unset:
        return t
    past = torch.arange(t.shape[0], device=t.device) >= offs[-1]
    return t.masked_fill(past[:, None], float("nan"))


@pytest.mark.cuda
def test_unset_rows_reach_no_output_and_no_gradient(monkeypatch):
    """The products' rows from offs[-1] on NaN both ways, and every buffer
    the kernel entries allocate NaN: the layer's output and gradients are
    finite and equal, to the bit, a run with the same products whose
    unset rows hold what the allocator gave."""
    _card()
    leaves, idx, _ = _moonlight_plan(torch.bfloat16, seed=45)
    dout = torch.randn(T, D, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(
                           46)).bfloat16()
    real = moe._grouped

    def through(fn):
        monkeypatch.setattr(moe, "_grouped", fn)
        return _run(moe._routed_rows, leaves, idx, HELD, dout)[0]

    clean = through(lambda x, w, offs: _Products.apply(x, w, offs, real,
                                                       False))
    again = through(lambda x, w, offs: _Products.apply(x, w, offs, real,
                                                       False))
    monkeypatch.setattr(moe_rows, "_empty", lambda shape, dtype, device:
                        torch.full(shape, float("nan"), dtype=dtype,
                                   device=device))
    poisoned = through(lambda x, w, offs: _Products.apply(x, w, offs, real,
                                                          True))
    for name, c, a, p in zip(("out", "dx", "dweights", "dw1", "dw2"), clean,
                             again, poisoned):
        assert torch.equal(c, a), f"{name}: two clean runs differ"
        assert torch.isfinite(p).all(), name
        assert torch.equal(p, c), name


@pytest.mark.cuda
def test_refuses_what_the_kernels_do_not_take():
    _card()
    src = torch.zeros(12, dtype=torch.int64, device="cuda")
    offs = torch.tensor([3], dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        moe_rows.gather_rows(torch.zeros(4, 8, device="cuda").half(), src,
                             src, src.bool(), offs)
    with pytest.raises(ValueError, match="multiple of 8"):
        moe_rows.gather_rows(torch.zeros(4, 12, device="cuda"), src, src,
                             src.bool(), offs)
    with pytest.raises(ValueError, match="offs"):
        moe_rows.gather_rows(torch.zeros(4, 8, device="cuda"), src, src,
                             src.bool(), offs.long())
