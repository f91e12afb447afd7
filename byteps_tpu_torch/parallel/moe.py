"""Mixture-of-Experts FFN with expert parallelism (all-to-all dispatch).

Counterpart of ``byteps_tpu/parallel/moe.py``, GShard's shape: top-1
(Switch) or top-2 gating with a capacity limit, one-hot dispatch and
combine einsums (no gathers or scatters on the hot path), and, over a
``group`` (the JAX version's ``ep_axis``), the dispatched [experts,
capacity, d] blocks ride two all-to-alls so that each process runs only
its own experts over every process's slots. The all-to-alls are
``_collectives.all_to_all``, whose backward is the inverse all-to-all,
so the layer trains through them.

Per-process code over ``group``; a group of ``None`` is the dense layer.

Beside it, the port's own dropless layer of fine-grained experts
(DeepSeek-V3, arXiv:2412.19437 §2.1.2), which has no counterpart in the
JAX package: ``sigmoid_topk`` and ``route_weights`` (sigmoid scores; a
correction bias that chooses but never weighs; the chosen scores
normalised and scaled), ``sequence_balance_loss``, ``expert_load`` and
``bias_update`` (the auxiliary-loss-free balancing), and ``RoutedExperts``,
one expert-parallel share of the routed experts: it holds experts [lo,
hi) of all of them and computes their part of the layer for every
(token, expert) pair routed there (``expert_plan``), with no capacity and
no host-device wait.
"""

from __future__ import annotations

import math
import operator
from functools import partial
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from byteps_tpu_torch.ops import moe_rows
from byteps_tpu_torch.parallel._collectives import (Group, all_to_all,
                                                    group_rank, group_size,
                                                    pmean)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.nn.one_hot(idx, n)`` in f32: an index outside [0, n) gives a
    row of zeros (``F.one_hot`` refuses it)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def moe_dispatch(gate_logits: torch.Tensor, capacity: int):
    """Top-1 dispatch and combine tensors.

    ``gate_logits``: [T, E]. Returns (dispatch [T, E, C] one-hot, combine
    [T, E, C] gate-weighted, aux_loss scalar). Tokens beyond an expert's
    capacity are dropped (their combine weights are zero). The gate's
    softmax is f32; ties go to the lower expert index, as ``jnp.argmax``.
    """
    try:
        capacity = operator.index(capacity)
    except TypeError:
        raise TypeError("moe_dispatch capacity must be an int; got "
                        f"{type(capacity).__name__}") from None
    e = gate_logits.shape[1]
    gates = torch.softmax(gate_logits.float(), dim=-1)
    onehot = _one_hot(gates.argmax(dim=-1), e)             # [T, E]
    # position of each token within its expert's queue
    pos = torch.cumsum(onehot, dim=0) * onehot - 1.0       # [T, E]
    keep = (pos >= 0) & (pos < capacity)
    dispatch = _one_hot(pos.long(), capacity) * keep[..., None]
    gate_val = (gates * onehot).sum(-1, keepdim=True)      # [T, 1]
    combine = dispatch * gate_val[..., None]
    # load-balancing auxiliary loss (Shazeer et al.): mean gate x fraction
    aux = (onehot.mean(0) * gates.mean(0)).sum() * (e ** 2) / e
    return dispatch, combine, aux


def _top2(gates: torch.Tensor):
    """``lax.top_k(gates, 2)``: values and indices, the lower index first
    among equal values (``torch.topk`` promises no order for ties)."""
    first = gates.argmax(dim=-1, keepdim=True)
    rest = gates.scatter(-1, first, float("-inf"))
    idx = torch.cat([first, rest.argmax(dim=-1, keepdim=True)], dim=-1)
    return torch.gather(gates, -1, idx), idx


def moe_dispatch_top2(gate_logits: torch.Tensor, capacity: int):
    """Top-2 dispatch and combine tensors (GShard's gating).

    Each token routes to its best two experts, with combine weights
    renormalised over the chosen pair before the capacity mask (a dropped
    second choice forfeits its share); second choices queue behind every
    first choice, so under capacity pressure first choices win slots.
    Returns (dispatch [T, E, C], combine [T, E, C], aux_loss).
    """
    t, e = gate_logits.shape
    gates = torch.softmax(gate_logits.float(), dim=-1)
    top_v, top_i = _top2(gates)                            # [T, 2]
    norm = top_v / top_v.sum(-1, keepdim=True).clamp_min(1e-9)

    dev = gate_logits.device
    dispatch = torch.zeros((t, e, capacity), device=dev)
    combine = torch.zeros((t, e, capacity), device=dev)
    fill = torch.zeros((e,), device=dev)  # slots taken by earlier choices
    for c in range(2):
        onehot = _one_hot(top_i[:, c], e)
        pos = (torch.cumsum(onehot, dim=0) - 1.0 + fill[None, :]) * onehot
        keep = onehot.bool() & (pos < capacity)
        d_c = _one_hot(pos.long(), capacity) * keep[..., None]
        dispatch = dispatch + d_c
        combine = combine + d_c * norm[:, c][:, None, None]
        fill = fill + onehot.sum(0)

    # load balancing on FIRST choices (GShard): fraction routed x mean gate
    first = _one_hot(top_i[:, 0], e)
    aux = (first.mean(0) * gates.mean(0)).sum() * (e ** 2) / e
    return dispatch, combine, aux


def moe_ffn(x: torch.Tensor, gate_w: torch.Tensor, w1: torch.Tensor,
            w2: torch.Tensor, *, capacity_factor: float = 1.25,
            group: Group = None, top_k: int = 1):
    """Top-1 (Switch) or top-2 (GShard) MoE feed-forward.

    ``x``: [T, D] (this process's tokens); ``gate_w``: [D, E]; ``w1``:
    [E, D, H]; ``w2``: [E, H, D]. The capacity is per process, from its
    own T: ``max(1, int(capacity_factor * T / E))`` slots an expert (size
    ``capacity_factor`` about 2x for top-2). With a ``group`` of n, E must
    divide by n; each process holds every expert's weights but computes
    only its E/n experts, over the slots every process dispatched to them.
    The expert products run in f32. Returns ([T, D] in x's dtype,
    aux_loss), the aux loss averaged over the group.
    """
    t = x.shape[0]
    e = gate_w.shape[1]
    logits = x @ gate_w
    n = group_size(group)
    capacity = max(1, int(capacity_factor * t / e))
    if top_k == 1:
        dispatch, combine, aux = moe_dispatch(logits, capacity)
    elif top_k == 2:
        dispatch, combine, aux = moe_dispatch_top2(logits, capacity)
    else:
        raise ValueError(f"top_k must be 1 or 2, got {top_k}")
    slots = torch.einsum("tec,td->ecd", dispatch, x.float())  # [E, C, D]
    # jax.nn.gelu's default is the tanh approximation
    gelu = partial(F.gelu, approximate="tanh")

    if group is None:
        h = gelu(torch.einsum("ecd,edh->ech", slots, w1.float()))
        out = torch.einsum("ech,ehd->ecd", h, w2.float())
    else:
        if e % n:
            raise ValueError(f"experts ({e}) must divide by the expert-"
                             f"parallel group's size ({n})")
        el = e // n
        me = group_rank(group)
        # each expert block to its owner; receive every process's slots
        # for this process's experts, stacked on the capacity axis
        recv = all_to_all(slots, group, split_dim=0, concat_dim=1)
        w1_l, w2_l = w1[me * el:(me + 1) * el], w2[me * el:(me + 1) * el]
        h = gelu(torch.einsum("ecd,edh->ech", recv, w1_l.float()))
        out_l = torch.einsum("ech,ehd->ecd", h, w2_l.float())
        # the results back to the tokens' home processes: [E, C, D]
        out = all_to_all(out_l, group, split_dim=1, concat_dim=0)

    y = torch.einsum("tec,ecd->td", combine, out)
    if group is not None:
        aux = pmean(aux, group)
    return y.to(x.dtype), aux


# --- dropless routed experts (DeepSeek-V3) -----------------------------------

def sigmoid_topk(logits: torch.Tensor, bias: torch.Tensor, top_k: int):
    """DeepSeek-V3's selection (``topk_method: noaux_tc`` with one group):
    scores s = sigmoid(logits) in f32 [T, E] and each token's ``top_k``
    experts by s + ``bias`` (the correction bias chooses, never weighs):
    (s, idx [T, k] int64). No gradient flows through the choice."""
    scores = logits.float().sigmoid()
    return scores, torch.topk(scores.detach() + bias, top_k, dim=-1).indices


def route_weights(scores: torch.Tensor, idx: torch.Tensor,
                  scaling: float) -> torch.Tensor:
    """The chosen experts' weights [T, k]: their scores over the sum of
    the chosen scores (``norm_topk_prob``), times ``scaling``
    (``routed_scaling_factor``)."""
    w = scores.gather(-1, idx)
    return w / (w.sum(-1, keepdim=True) + 1e-20) * scaling


def expert_load(idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Tokens that chose each expert, f32 [n_experts], counted on the
    tensor's device (no host read)."""
    flat = idx.reshape(-1)
    return torch.zeros(n_experts, device=idx.device).scatter_add_(
        0, flat, torch.ones(flat.shape, device=idx.device))


def sequence_balance_loss(scores: torch.Tensor, idx: torch.Tensor,
                          seqs: int, alpha: float) -> torch.Tensor:
    """DeepSeek-V3's sequence-wise balance loss over ``seqs`` sequences
    of equal length S (the rows of ``scores`` [seqs S, E] in order): per
    sequence alpha sum_i f_i P_i, with f_i = E / (k S) times the tokens
    that chose expert i and P_i the mean over the sequence of s_i / sum_j
    s_j; the mean over sequences. Only P carries a gradient."""
    t, e = scores.shape
    k = idx.shape[1]
    s = t // seqs
    chosen = idx.reshape(seqs, s * k)
    f = torch.zeros(seqs, e, device=scores.device).scatter_add_(
        1, chosen, torch.ones(chosen.shape, device=scores.device))
    f = f * (e / (k * s))
    p = (scores / scores.sum(-1, keepdim=True)).reshape(seqs, s, e).mean(1)
    return alpha * (f * p).sum(-1).mean()


def bias_update(bias: torch.Tensor, load: torch.Tensor,
                speed: float) -> None:
    """DeepSeek-V3's auxiliary-loss-free balancing, once a training step:
    ``bias`` (a buffer, no parameter) moves in place by ``speed`` towards
    balance, b_i += speed * sign(mean load - load_i), from the step's
    ``load`` (``expert_load`` summed over the step's forwards), on the
    tensors' device with no host read. A load of all zeros (no forward
    since the last update) leaves the bias as it is."""
    bias.add_(torch.sign(load.mean() - load), alpha=speed)


class ExpertPlan(NamedTuple):
    """Where the T k (token, expert) pairs go, on the device. Sorted order
    puts the pairs of the held experts first, by expert (stable, so tokens
    in order within an expert), then the pairs of experts held elsewhere:
    ``src`` [T k] the token of each sorted pair; ``held`` [T k] whether the
    sorted pair's expert is held here; ``weight`` [T k] f32 each sorted
    pair's weight, 0 where not held; ``pos`` [T k] the sorted place of
    pair t k + j (token t's j-th choice); ``mine`` [T k] whether that pair's
    expert is held here; ``offs`` [held] int32 the end of each held
    expert's rows; ``rows`` the held pairs (a device scalar)."""
    src: torch.Tensor
    held: torch.Tensor
    weight: torch.Tensor
    pos: torch.Tensor
    mine: torch.Tensor
    offs: torch.Tensor
    rows: torch.Tensor


def expert_plan(idx: torch.Tensor, weights: torch.Tensor, lo: int,
                held: int) -> ExpertPlan:
    """The ``ExpertPlan`` of experts [lo, lo + held) for tokens that chose
    ``idx`` [T, k] (global expert ids) with ``weights`` [T, k]: a sort on
    the device, whose counts stay there. Every pair of a held expert has a
    row, however many there are: no capacity, no drop."""
    k = idx.shape[1]
    local = idx.reshape(-1) - lo
    mine = (local >= 0) & (local < held)
    key, order = torch.sort(torch.where(mine, local, held), stable=True)
    offs = torch.searchsorted(
        key, torch.arange(held, device=idx.device), right=True)
    pos = torch.empty_like(order)
    pos[order] = torch.arange(order.numel(), device=idx.device)
    in_held = key < held
    return ExpertPlan(order // k, in_held,
                      torch.where(in_held, weights.reshape(-1)[order], 0.0),
                      pos, mine, offs.to(torch.int32), offs[-1])


def _grouped(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor):
    """Rows of ``x`` [P, K] in group g (``offs``' ends) times ``w[g]``
    [K, N], in x's dtype with f32 sums (``torch._grouped_mm``); rows past
    offs[-1] are left unset."""
    return torch._grouped_mm(x, w.to(x.dtype), offs=offs)


def grouped_swiglu(xs: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                   offs: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Each row of ``xs`` [P, d] through its expert's SwiGLU, scaled by its
    ``weight``: (silu(x g_e) * (x u_e) * weight) down_e, with w1 [held, d,
    2 dim] = [g | u] and w2 [held, dim, d], rows grouped by ``offs``.
    Products in xs's dtype with f32 sums; rows past offs[-1] unset."""
    gate, up = _grouped(xs, w1, offs).chunk(2, dim=-1)
    a = F.silu(gate) * up * weight[:, None].to(xs.dtype)
    return _grouped(a, w2, offs)


def _routed(x, src, held, weight, pos, mine, offs, w1, w2):
    """The held experts' part of the layer for ``x`` [T, d] (``ExpertPlan``
    fields): gather each sorted pair's token row, the grouped SwiGLU over
    the held experts' rows, then each token's k rows back in token order,
    summed. Rows past the held pairs are zero in both directions, whatever
    the products leave there, and no row is added into twice but a
    token's own k. Every pass covers all T k rows: the plain reference
    that the tests hold ``_routed_rows`` to, on the CPU and the card."""
    t, d = x.shape
    xs = torch.where(held[:, None], x[src], 0.0)
    y = grouped_swiglu(xs, w1, w2, offs, weight)
    back = torch.where(mine[:, None], y[pos], 0.0)
    return back.view(t, -1, d).sum(1)


def _routed_rows(x, src, held, weight, pos, mine, offs, w1, w2):
    """``_routed`` through ``ops.moe_rows``, whose kernels walk only the
    held rows (below offs[-1], read on the card) and whose plain versions
    run for CPU tensors: the same arguments (``held`` unused) and
    function. No row past the held pairs is read, so what the products
    leave there reaches nothing."""
    k = src.numel() // x.shape[0]
    xs = moe_rows.gather_rows(x, src, pos, mine, offs)
    a = moe_rows.swiglu_rows(_grouped(xs, w1, offs), weight, offs)
    return moe_rows.combine_rows(_grouped(a, w2, offs), pos, mine, src,
                                 offs, k)


def _init(shape, fan_in, generator):
    return nn.Parameter(torch.empty(shape).normal_(
        0.0, 1.0 / math.sqrt(fan_in), generator=generator))


class RoutedExperts(nn.Module):
    """One expert-parallel share of a layer of routed SwiGLU experts: the
    weights of experts [lo, hi) of ``n_experts`` (``w1`` [held, d_model,
    2 dim], gate then up; ``w2`` [held, dim, d_model]; f32, products in
    ``dtype``), told which experts every token chose and computing, for
    every pair routed to an expert held here, that expert's weighted part
    of the token's output. The parts of experts held elsewhere are left
    out: across processes an all-to-all would bring them, and on one
    process they are the shares that other chips would add.

    Under autograd the gathered rows and the products are recomputed in
    the backward: their buffers are sized for the worst case (every pair
    routed here, T k rows, since the count stays on the device), so
    keeping them for every layer would hold n_experts / held times the
    rows an even routing needs. The row passes around the products are
    ``ops.moe_rows``' (``_routed_rows``): on a CUDA device its kernels,
    which touch only the held rows, so the recompute costs the held rows'
    work; on the CPU their plain versions."""

    def __init__(self, d_model: int, dim: int, n_experts: int, lo: int,
                 hi: int, dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not 0 <= lo < hi <= n_experts:
            raise ValueError(f"held experts [{lo}, {hi}) not within the "
                             f"{n_experts} experts")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.n_experts, self.lo, self.hi = n_experts, lo, hi
        self.dtype = dtype
        held = hi - lo
        self.w1 = _init((held, d_model, 2 * dim), d_model, generator)
        self.w2 = _init((held, dim, d_model), dim, generator)

    def forward(self, x: torch.Tensor, plan: ExpertPlan) -> torch.Tensor:
        """``x`` [T, d_model] -> [T, d_model] in ``dtype``: the held
        experts' weighted sum for each token (``plan`` from
        ``expert_plan(idx, weights, self.lo, self.hi - self.lo)``)."""
        args = (x.to(self.dtype), plan.src, plan.held, plan.weight,
                plan.pos, plan.mine, plan.offs, self.w1, self.w2)
        if torch.is_grad_enabled():
            return checkpoint(_routed_rows, *args, use_reentrant=False,
                              preserve_rng_state=False)
        return _routed_rows(*args)
