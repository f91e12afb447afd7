"""Ulysses sequence parallelism: all-to-all head/sequence resharding.

Counterpart of ``byteps_tpu/parallel/ulysses.py``, the DeepSpeed-Ulysses
shape: activations arrive sequence-sharded [B, S/n, H, D] on each of the
n processes of ``group`` (the JAX version's ``sp`` axis). One all-to-all
reshards them to head-sharded [B, S, H/n, D], so each process computes
exact attention over the whole sequence for its heads with any attention
core (``full_attention``, or the port's flash kernels), and a second
all-to-all restores the sequence sharding. The all-to-alls are
differentiable (``_collectives.all_to_all``), so a model trains through
them. Every function here is per-process code.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from byteps_tpu_torch.parallel._collectives import all_to_all, group_size
from byteps_tpu_torch.parallel.ring_attention import (_gather_seq,
                                                      _local_block,
                                                      full_attention)

AttnFn = Callable[..., torch.Tensor]


def _seq_to_heads(x: torch.Tensor, group) -> torch.Tensor:
    # [B, S/n, H, D] -> [B, S, H/n, D]
    return all_to_all(x, group, split_dim=2, concat_dim=1)


def _heads_to_seq(x: torch.Tensor, group) -> torch.Tensor:
    # [B, S, H/n, D] -> [B, S/n, H, D]
    return all_to_all(x, group, split_dim=1, concat_dim=2)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      group=None, causal: bool = False,
                      scale: Optional[float] = None,
                      attn_fn: Optional[AttnFn] = None) -> torch.Tensor:
    """Exact attention over a sequence split over ``group`` (the JAX
    version's ``axis``) by head/sequence all-to-all resharding.

    ``q``/``k``/``v``: this process's blocks [batch, seq_local, heads,
    head_dim]; q's ``heads`` must divide by the group's size. ``attn_fn``
    replaces the inner full-sequence attention (signature: (q, k, v, *,
    causal, scale)); it defaults to the exact softmax attention.
    """
    n = group_size(group)
    h = q.shape[2]
    if h % n != 0:
        raise ValueError(
            f"ulysses_attention needs heads ({h}) divisible by the "
            f"sequence-parallel group's size ({n}); use ring_attention "
            f"otherwise")
    inner = attn_fn or full_attention
    if n == 1:
        return inner(q, k, v, causal=causal, scale=scale)
    qh, kh, vh = (_seq_to_heads(x, group) for x in (q, k, v))
    out = inner(qh, kh, vh, causal=causal, scale=scale)
    return _heads_to_seq(out, group)


def ulysses_attention_sharded(q, k, v, group=None, *, causal: bool = False,
                              scale: Optional[float] = None,
                              attn_fn: Optional[AttnFn] = None):
    """Convenience wrapper: global [B, S, H, D] tensors in (the same on
    every rank), this rank's sequence block computed by
    ``ulysses_attention`` over ``group``, the global result out, gathered
    from every rank. For evaluation and tests: the gradient of a model
    goes through ``ulysses_attention`` itself."""
    out = ulysses_attention(_local_block(q, group), _local_block(k, group),
                            _local_block(v, group), group=group,
                            causal=causal, scale=scale, attn_fn=attn_fn)
    return _gather_seq(out, group)
