"""Tensor parallelism: Megatron-style column- and row-parallel layers.

Counterpart of ``byteps_tpu/parallel/tensor_parallel.py``. The layout is
the standard pairing over the processes of ``group`` (the JAX version's
``tp`` axis):

    y = f(x @ A) @ B,   A column-sharded, B row-sharded over ``group``
    -> one ``psum`` at the pair's output; the activation between A and B
       stays sharded (its heads or hidden slice), never gathered whole.

Every function is per-process code: the weights passed in are this
process's shards, and ``x`` is the same on every member. The ``psum``
is ``_collectives.psum``, whose backward is a ``psum`` as in JAX: a loss
that every member computes whole from the output is divided by the
group's size, and the gradients of the parameters the members hold alike
(``x``'s producers) are summed over the group afterwards. A group of
``None`` has one member, and the layers are then the dense ones.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from byteps_tpu_torch.parallel._collectives import (Group, group_rank,
                                                    group_size, psum)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


def column_parallel(x: torch.Tensor, w_shard: torch.Tensor,
                    b_shard: Optional[torch.Tensor] = None) -> torch.Tensor:
    """This process's slice of a column-parallel product's output
    features. No communication (``x`` is the same on every member)."""
    y = x @ w_shard
    if b_shard is not None:
        y = y + b_shard
    return y


def row_parallel(x_shard: torch.Tensor, w_shard: torch.Tensor,
                 group: Group = None,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Row-parallel product closing a column-parallel pair: each member's
    partial product over its input slice, one ``psum`` over ``group``,
    the whole output on every member. ``bias`` is the whole (unsharded)
    bias, added after the sum."""
    y = psum(x_shard @ w_shard, group)
    if bias is not None:
        y = y + bias
    return y


def tp_mlp(x: torch.Tensor, w_in_shard: torch.Tensor,
           w_out_shard: torch.Tensor, *, group: Group = None,
           activation: Callable[[torch.Tensor], torch.Tensor] = _gelu,
           b_in_shard: Optional[torch.Tensor] = None,
           b_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The transformer MLP over ``group``: column-parallel in-projection,
    the activation (tanh GELU by default) on the local hidden slice,
    row-parallel out-projection; one all-reduce in all."""
    h = activation(column_parallel(x, w_in_shard, b_in_shard))
    return row_parallel(h, w_out_shard, group, bias=b_out)


def tp_attention(x: torch.Tensor, wq_shard: torch.Tensor,
                 wk_shard: torch.Tensor, wv_shard: torch.Tensor,
                 wo_shard: torch.Tensor, *, group: Group = None,
                 num_local_heads: int, causal: bool = False,
                 attn_fn: Optional[Callable] = None) -> torch.Tensor:
    """Head-parallel self-attention: each member owns ``num_local_heads``
    heads end to end (q/k/v column-sharded by head, the output projection
    row-sharded), one ``psum`` at the output projection.

    ``x``: [batch, seq, d_model], the same on every member; ``w*_shard``:
    [d_model, local_heads * head_dim] (``wo_shard``: [local_heads *
    head_dim, d_model]). ``attn_fn(q, k, v, causal=...)`` on [batch, seq,
    heads, head_dim] defaults to the exact softmax attention
    (``full_attention``); pass the port's ``flash_attention`` for the
    kernels.
    """
    from byteps_tpu_torch.parallel.ring_attention import full_attention

    b, s, _ = x.shape
    q = (x @ wq_shard).reshape(b, s, num_local_heads, -1)
    k = (x @ wk_shard).reshape(b, s, num_local_heads, -1)
    v = (x @ wv_shard).reshape(b, s, num_local_heads, -1)
    inner = attn_fn or full_attention
    out = inner(q, k, v, causal=causal)
    return row_parallel(out.reshape(b, s, -1), wo_shard, group)


def shard_columns(w: torch.Tensor, group: Group = None) -> torch.Tensor:
    """This process's column shard of a whole weight: the slice of its
    LAST dim at the process's index in ``group`` (a view, through which
    autograd reaches the whole weight)."""
    n, i = group_size(group), group_rank(group)
    cols = w.shape[-1] // n
    return w[..., i * cols:(i + 1) * cols]


def shard_rows(w: torch.Tensor, group: Group = None) -> torch.Tensor:
    """This process's row shard: the slice of the FIRST dim."""
    n, i = group_size(group), group_rank(group)
    rows = w.shape[0] // n
    return w[i * rows:(i + 1) * rows]
