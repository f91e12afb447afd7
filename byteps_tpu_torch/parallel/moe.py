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
"""

from __future__ import annotations

import operator
from functools import partial

import torch
import torch.nn.functional as F

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
