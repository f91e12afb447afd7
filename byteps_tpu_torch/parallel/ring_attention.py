"""Ring attention (``attn_impl="ring"``) and the reference attention
(``attn_impl="full"``).

Counterpart of ``byteps_tpu/parallel/ring_attention.py``. The sequence is
split over a process group (the JAX version's ``sp`` mesh axis): each
process holds one Q/K/V block, the K/V blocks travel round the ring (a
``ppermute`` to the next rank) while each process folds its Q's attention
over every block into a streaming softmax, so the result equals full
attention on the gathered sequence, with O(S/n) memory a process for the
K/V it holds. The causal mask compares global positions, and the last
block is folded in without a trailing permute. The block products take
the inputs cast to f32 (exact products of bf16 values, as the reference's
``preferred_element_type=float32``), and everything but them is f32.

``full_attention`` / ``_single_device_attention`` are the unsharded
reference: the whole [s_q, s_k] score matrix in f32, a top-left aligned
causal mask (q_pos >= k_pos, both from 0). Layout [batch, seq, heads,
head_dim]; the output has q's dtype. Every function here is per-process
code: each member of ``group`` calls it with its own block.
"""

from __future__ import annotations

from typing import Optional

import torch

from byteps_tpu_torch.parallel._collectives import (all_gather, group_rank,
                                                    group_size, ppermute)


def _big_neg(dtype: torch.dtype) -> float:
    return float(torch.finfo(dtype).min) / 2


def _block_attn(q, k, v, m, l, o, q_pos, k_pos, causal, scale):
    """One blockwise attention update with streaming-softmax state.

    q: [B, Sq, H, D]; k/v: [B, Sk, H, D]; m/l: [B, H, Sq]; o: [B, Sq, H, D].
    Everything but the products' inputs is float32.
    """
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]
        s = s.masked_fill(~mask[None, None], _big_neg(torch.float32))
    m_new = torch.maximum(m, s.amax(dim=-1))
    # m_new is finite (>= _big_neg) so exp never sees inf - inf
    p = torch.exp(s - m_new[..., None])
    correction = torch.exp(m - m_new)
    l_new = l * correction + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    o_new = o * correction.transpose(1, 2)[..., None] + pv
    return m_new, l_new, o_new


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   group=None, causal: bool = False,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention over a sequence split over ``group`` (the JAX
    version's ``axis``).

    ``q``/``k``/``v`` are this process's sequence blocks, [batch,
    seq_local, heads, head_dim], rank r holding global positions
    [r * seq_local, (r + 1) * seq_local). Returns this block of the
    output, q's shape and dtype. ``causal`` masks by global position, so
    the result equals full causal attention on the gathered sequence.
    Autograd runs through the ring: the backward sends each block's
    gradient back the way the block came.
    """
    n, my = group_size(group), group_rank(group)
    b, s_q, h, d = q.shape
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if n == 1:
        return _single_device_attention(q, k, v, causal=causal, scale=scale)

    dev = q.device
    m = torch.full((b, h, s_q), _big_neg(torch.float32), device=dev)
    l = torch.zeros((b, h, s_q), device=dev)
    o = torch.zeros((b, s_q, h, d), device=dev)
    q_pos = my * s_q + torch.arange(s_q, device=dev)
    kv = (k, v)
    for i in range(n):
        # the block now held came from rank (my - i) mod n
        k_pos = ((my - i) % n) * s_q + torch.arange(kv[0].shape[1],
                                                    device=dev)
        # the rotation does not depend on this block's products; the
        # last block is folded in with no trailing permute
        kv_next = (tuple(ppermute(x, group, 1) for x in kv) if i < n - 1
                   else None)
        m, l, o = _block_attn(q, kv[0], kv[1], m, l, o, q_pos, k_pos,
                              causal, scale)
        kv = kv_next
    out = o / l.transpose(1, 2)[..., None]
    return out.to(q.dtype)


def _single_device_attention(q, k, v, *, causal: bool, scale: float):
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        s_q, s_k = q.shape[1], k.shape[1]
        mask = (torch.arange(s_q, device=q.device)[:, None]
                >= torch.arange(s_k, device=q.device)[None, :])
        s = s.masked_fill(~mask, _big_neg(torch.float32))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.to(p.dtype))
    return out.to(q.dtype)


def full_attention(q, k, v, *, causal: bool = False,
                   scale: Optional[float] = None):
    """Unsharded reference attention."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    return _single_device_attention(q, k, v, causal=causal, scale=scale)


def _local_block(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's block of a global [B, S, ...] tensor's sequence."""
    n, r = group_size(group), group_rank(group)
    s = x.shape[1] // n
    return x[:, r * s:(r + 1) * s]


def _gather_seq(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's [B, S/n, ...] block, concatenated on the sequence in
    rank order (no gradient flows back through the gather)."""
    if group_size(group) == 1:
        return x
    local = x.detach().movedim(1, 0).contiguous()
    out = local.new_empty((group_size(group) * local.shape[0],
                           *local.shape[1:]))
    all_gather(out, local, group)
    return out.movedim(0, 1)


def ring_attention_sharded(q, k, v, group=None, *, causal: bool = False,
                           scale: Optional[float] = None):
    """Convenience wrapper: global [B, S, H, D] tensors in (the same on
    every rank), this rank's sequence block computed by ``ring_attention``
    over ``group``, the global result out, gathered from every rank. For
    evaluation and tests: the gradient of a model goes through
    ``ring_attention`` itself."""
    out = ring_attention(_local_block(q, group), _local_block(k, group),
                         _local_block(v, group), group=group, causal=causal,
                         scale=scale)
    return _gather_seq(out, group)
