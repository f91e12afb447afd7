"""The port's DeepSeek-V3 decoder (``models/deepseek.py``) and its
dropless expert layer (``parallel/moe.py``: ``RoutedExperts`` and the
routing functions) against the plain f32 reference in
``tests/_deepseek_reference.py``, on the CPU at a tiny size: the loss,
every leaf's gradient, three AdamW steps with the correction bias moved
after each, once a step however many forwards the step makes; one expert
share against the uncut layer; the routing's
rules; RMSNorm's eps and RoPE's pair layout by hand; and the step trace's
marks and counter of the expert layers.
"""

import ast
import math
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _deepseek_reference as ref  # noqa: E402
import byteps_tpu_torch as bps  # noqa: E402
from byteps_tpu_torch.models import DeepseekTiny, moe_lm_loss  # noqa: E402
from byteps_tpu_torch.models.deepseek import DeepseekMoE  # noqa: E402
from byteps_tpu_torch.models.llama import RMSNorm, _rope  # noqa: E402
from byteps_tpu_torch.parallel import moe  # noqa: E402
from byteps_tpu_torch.utils import timeline  # noqa: E402

# DeepseekTiny's sizes, as the reference reads them
HP = dict(num_layers=3, num_heads=4, qk_nope_dim=16, qk_rope_dim=8,
          v_dim=16, kv_lora_rank=32, first_dense=1, top_k=3,
          routed_scaling=2.446, aux_alpha=1e-4, rope_theta=50000.0,
          eps=1e-5)
HELD = (2, 6)  # a share of 4 of the router's 8 experts
SPEED = 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    timeline.steps = None
    if bps.initialized():
        bps.shutdown()
    torch.set_num_threads(threads)


def _model(dtype=torch.float32, held=HELD, seed=0):
    return DeepseekTiny(dtype=dtype, attn_impl="flash", experts=held,
                        generator=torch.Generator().manual_seed(seed),
                        device="cpu")


def _tokens(seed=1, b=2, s=16):
    return torch.randint(0, 256, (b, s),
                         generator=torch.Generator().manual_seed(seed))


def _weights(model):
    return {k: v.detach().clone().requires_grad_()
            for k, v in model.named_parameters()}


def _biases(model):
    return {i: layer.mlp.bias.clone() for i, layer in enumerate(model.layers)
            if isinstance(layer.mlp, DeepseekMoE)}


def test_loss_and_every_gradient_match_the_reference():
    """f32 on both sides: the loss within 1e-5 relative and each leaf's
    gradient within 1e-4 of that leaf's largest reference gradient
    element (f32 sums of the same terms in another order, through a
    softmax and a sigmoid; a choice that flipped would move a gradient
    by its whole size)."""
    model = _model()
    tokens = _tokens()
    biases = _biases(model)
    loss = moe_lm_loss(model(tokens), tokens)
    loss.backward()
    w = _weights(model)
    want, _ = ref.loss(w, tokens, biases, HP, HELD)
    grads = torch.autograd.grad(want, list(w.values()))
    assert abs(loss.item() - want.item()) <= 1e-5 * abs(want.item())
    for (name, p), g in zip(model.named_parameters(), grads):
        tol = 1e-4 * max(g.abs().max().item(), 1e-8)
        err = (p.grad - g).abs().max().item()
        assert err <= tol, (name, err, tol)
    # the routed experts got gradients, and only the held ones exist
    assert model.layers[1].mlp.experts.w1.shape[0] == HELD[1] - HELD[0]
    assert model.layers[1].mlp.experts.w1.grad.abs().sum() > 0


def test_three_adamw_steps_and_the_bias_match_the_reference():
    """Three steps of ``bps.DistributedOptimizer(AdamW)`` in collective
    mode against AdamW on the reference's gradients with the bias moved
    after each step: every parameter within 1e-5 (a hundredth of lr) +
    1e-5 |p|, and every correction bias equal to the bit (the same choices
    give the same loads). Adam divides each element's gradient by that
    element's own scale, so an element whose gradient is near zero turns
    an f32 difference of the gradient (within 1e-4 of the leaf's largest,
    the test above) into a fraction of a step; a wrong gradient, or a
    choice gone another way, moves elements by whole steps of lr."""
    bps.init(device="cpu")
    model = _model()
    w = _weights(model)
    opt = bps.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-3, betas=(0.9, 0.95),
                          weight_decay=0.1),
        named_parameters=model.named_parameters())
    ref_opt = torch.optim.AdamW(list(w.values()), lr=1e-3, betas=(0.9, 0.95),
                                weight_decay=0.1)
    biases = _biases(model)
    for step in range(3):
        tokens = _tokens(seed=10 + step)
        opt.zero_grad()
        moe_lm_loss(model(tokens), tokens).backward()
        opt.step()
        model.update_bias()
        ref_opt.zero_grad()
        want, loads = ref.loss(w, tokens, biases, HP, HELD)
        want.backward()
        ref_opt.step()
        biases = ref.bias_update(biases, loads, SPEED)
        for i, b in biases.items():
            assert torch.equal(model.layers[i].mlp.bias, b), (step, i)
    assert any(b.abs().sum() > 0 for b in biases.values())
    for name, p in model.named_parameters():
        err = (p.detach() - w[name].detach()).abs()
        assert bool((err <= 1e-5 + 1e-5 * w[name].detach().abs()).all()), (
            name, err.max().item())


def test_bias_moves_once_a_step_from_every_forward_of_the_step():
    """Two micro-batches' forwards and backwards, as under gradient
    accumulation, leave every correction bias where it was; the one
    ``update_bias`` after them moves each by the sign of the two batches'
    loads summed (the reference's loads, equal to the bit), and clears
    them, so a second call with no forward between moves nothing. A
    forward without gradients, or in evaluation mode, counts no load."""
    model = _model()
    biases = _biases(model)
    layers = {i: model.layers[i].mlp for i in biases}
    w = _weights(model)
    loads = {i: torch.zeros(8) for i in biases}
    for seed in (30, 31):
        tokens = _tokens(seed=seed)
        moe_lm_loss(model(tokens), tokens).backward()
        for i, load in ref.loss(w, tokens, biases, HP, HELD)[1].items():
            loads[i] += load
    with torch.no_grad():
        model(_tokens(seed=32))
    model.eval()
    model(_tokens(seed=33))
    model.train()
    for i, layer in layers.items():
        assert torch.equal(layer.bias, biases[i])
        assert torch.equal(layer.load, loads[i]), i
    model.update_bias()
    want = ref.bias_update(biases, loads, SPEED)
    for i, layer in layers.items():
        assert torch.equal(layer.bias, want[i]), i
        assert not layer.load.any()
    model.update_bias()
    for i, layer in layers.items():
        assert torch.equal(layer.bias, want[i]), i
    # the loads are the step's, not the model's state
    assert not any(k.endswith(".load") for k in model.state_dict())


def test_bf16_loss_is_near_the_reference():
    """The bf16 model (the port's training numerics) within 2 % of the f32
    reference's loss: bf16 keeps 8 bits, and the residual stream, every
    product's operands and the attention probabilities round to it."""
    model = _model(torch.bfloat16)
    tokens = _tokens()
    got = moe_lm_loss(model(tokens), tokens).item()
    want, _ = ref.loss(_weights(model), tokens, _biases(model), HP, HELD)
    assert abs(got - want.item()) <= 0.02 * want.item()


def test_shares_add_up_to_the_uncut_layer():
    """Every share of the 8 experts (four chips of two), with the shared
    expert and the balance loss counted once, adds up to the reference's
    layer over all 8: the share computes only its own experts' part."""
    g = torch.Generator().manual_seed(3)
    shares = [(0, 2), (2, 4), (4, 6), (6, 8)]
    d, f = 64, 24
    layers = [DeepseekMoE(d, f, 8, held, 3, 2, 2.446, 1e-4, SPEED,
                          torch.float32, torch.Generator().manual_seed(0))
              for held in shares]
    router = torch.randn(8, d, generator=g) / 8
    shared = {n: torch.randn(p.shape, generator=g) / 8
              for n, p in layers[0].shared.named_parameters()}
    w1 = torch.randn(8, d, 2 * f, generator=g) / 8
    w2 = torch.randn(8, f, d, generator=g) / 5
    with torch.no_grad():
        for layer, (lo, hi) in zip(layers, shares):
            layer.router.copy_(router)
            for n, p in layer.shared.named_parameters():
                p.copy_(shared[n])
            layer.experts.w1.copy_(w1[lo:hi])
            layer.experts.w2.copy_(w2[lo:hi])
    x = torch.randn(2, 12, d, generator=g)
    outs, auxes = zip(*(layer(x) for layer in layers))
    shared_out = layers[0].shared(x)
    total = sum(o - shared_out for o in outs) + shared_out
    w = {"router": router, "experts.w1": w1, "experts.w2": w2,
         **{f"shared.{n}": p for n, p in shared.items()}}
    want, want_aux, _ = ref.expert_layer(x, w, "", torch.zeros(8), HP, (0, 8))
    torch.testing.assert_close(total, want, rtol=1e-5, atol=1e-5)
    for aux in auxes:
        torch.testing.assert_close(aux, want_aux, rtol=1e-6, atol=1e-9)


def test_bias_changes_the_choice_not_the_weights():
    g = torch.Generator().manual_seed(4)
    logits = torch.randn(20, 8, generator=g)
    zero = torch.zeros(8)
    push = torch.zeros(8)
    push[5] = 10.0  # every token takes expert 5
    s0, idx0 = moe.sigmoid_topk(logits, zero, 3)
    s1, idx1 = moe.sigmoid_topk(logits, push, 3)
    torch.testing.assert_close(s0, s1)
    assert bool((idx1 == 5).any(-1).all()) and not bool(
        (idx0 == 5).any(-1).all())
    w1 = moe.route_weights(s1, idx1, 2.446)
    want = s1.gather(-1, idx1)  # the scores, not the biased scores
    torch.testing.assert_close(w1, want / want.sum(-1, keepdim=True) * 2.446)


def test_weights_sum_to_the_scaling_factor():
    logits = torch.randn(50, 64, generator=torch.Generator().manual_seed(5))
    scores, idx = moe.sigmoid_topk(logits, torch.zeros(64), 6)
    w = moe.route_weights(scores, idx, 2.446)
    torch.testing.assert_close(w.sum(-1), torch.full((50,), 2.446))


@pytest.mark.parametrize("held", [(0, 8), (2, 6), (7, 8)])
def test_no_pair_is_dropped_however_skewed(held):
    """Every token chooses the same 6 of 8 experts (a bias that swamps the
    scores): each held expert gets every token's row, and each token's
    output is its held experts' weighted sum, computed by hand."""
    g = torch.Generator().manual_seed(6)
    t, d, f = 40, 16, 8
    bias = torch.tensor([0., 9., 9., 9., 9., 9., 9., 0.])
    scores, idx = moe.sigmoid_topk(torch.randn(t, 8, generator=g), bias, 6)
    weights = moe.route_weights(scores, idx, 2.446)
    experts = moe.RoutedExperts(d, f, 8, *held, dtype=torch.float32,
                                generator=g)
    plan = moe.expert_plan(idx, weights, held[0], held[1] - held[0])
    mine = [e for e in range(*held) if 1 <= e <= 6]
    assert int(plan.rows) == t * len(mine)
    counts = torch.diff(plan.offs.long(), prepend=torch.zeros(1).long())
    assert counts.tolist() == [t if 1 <= e <= 6 else 0 for e in range(*held)]
    x = torch.randn(t, d, generator=g)
    got = experts(x, plan)
    w = {"experts.w1": experts.w1.detach(), "experts.w2": experts.w2.detach()}
    want = ref.routed(x, w, "", idx, weights, held)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_rms_norm_eps_by_hand():
    """x = [1, 2, 3, 4] 1e-3: the mean of squares is 7.5e-6, so eps 1e-5
    (DeepSeek-V3's) and 1e-6 (Llama's, flax's default, unchanged) give
    x / sqrt(1.75e-5) and x / sqrt(8.5e-6)."""
    x = torch.tensor([[1.0, 2.0, 3.0, 4.0]]) * 1e-3
    torch.testing.assert_close(RMSNorm(4, eps=1e-5)(x),
                               x / math.sqrt(1.75e-5), rtol=1e-6, atol=0)
    assert RMSNorm(4).eps == 1e-6
    torch.testing.assert_close(RMSNorm(4)(x), x / math.sqrt(8.5e-6),
                               rtol=1e-6, atol=0)


def test_rope_pair_layouts_by_hand():
    """x = [1, 0, 0, 1] at position 1, theta 100: pair i turns by 100^(-i
    / 2), i.e. 1 and 0.1 radians. Interleaved pairs are (x0, x1) and (x2,
    x3); halves (Llama's default, unchanged) are (x0, x2) and (x1, x3)."""
    x = torch.tensor([1.0, 0.0, 0.0, 1.0]).view(1, 1, 1, 4)
    pos = torch.tensor([[1]])
    c1, s1, c01, s01 = math.cos(1), math.sin(1), math.cos(0.1), math.sin(0.1)
    inter = _rope(x, pos, 100.0, interleaved=True).flatten()
    torch.testing.assert_close(inter, torch.tensor([c1, s1, -s01, c01]))
    halves = _rope(x, pos, 100.0).flatten()
    torch.testing.assert_close(halves, torch.tensor([c1, -s01, s1, c01]))


def test_step_trace_carries_the_expert_layers_marks_and_rows(monkeypatch):
    """Under a step trace each expert layer asks for its four marks (the
    forward's in layer order, the backward's in reverse) with its index as
    the leaf, and the record's ``moe_rows`` holds the pairs routed to the
    held experts, read from the card's counter once the trace stops.
    Tracing off: no counter, no mark."""
    bps.init(device="cpu")
    model = _model()
    opt = bps.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-3),
        named_parameters=model.named_parameters())
    asked = []
    real_mark = timeline.mark
    monkeypatch.setattr(timeline, "mark", lambda rec, name, stream, lane=
                        "compute", leaf=None: (asked.append((name, leaf)),
                                               real_mark(rec, name, stream,
                                                         lane, leaf)))

    def step(tokens):
        opt.zero_grad()
        moe_lm_loss(model(tokens), tokens).backward()
        opt.step()

    step(_tokens(seed=20))
    assert asked == []  # tracing off
    counted = []
    real_plan = moe.expert_plan

    def spy(idx, weights, lo, held):
        plan = real_plan(idx, weights, lo, held)
        counted.append(int(plan.rows))
        return plan
    monkeypatch.setattr(sys.modules["byteps_tpu_torch.models.deepseek"],
                        "expert_plan", spy)
    timeline.start_steps()
    rows = []
    for i in range(2):
        step(_tokens(seed=21 + i))
        rows.append(sum(counted))
        counted.clear()
    out = timeline.stop_steps()
    assert [r["moe_rows"] for r in out["records"]] == rows
    assert all(isinstance(r["moe_rows"], int) for r in out["records"])
    one = [("moe_fwd_start", 1), ("moe_fwd_end", 1), ("moe_fwd_start", 2),
           ("moe_fwd_end", 2), ("moe_bwd_start", 2), ("moe_bwd_end", 2),
           ("moe_bwd_start", 1), ("moe_bwd_end", 1)]
    assert [a for a in asked if a[0].startswith("moe_")] == one * 2



def test_the_reference_imports_neither_the_port_nor_jax():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "_deepseek_reference.py")
    tops = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            tops |= {a.name.partition(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            tops.add(node.module.partition(".")[0])
    assert tops == {"math", "torch"}, tops
