"""Reference attention (``attn_impl="full"``).

Counterpart of ``full_attention`` / ``_single_device_attention`` in
``byteps_tpu/parallel/ring_attention.py``: the whole [s_q, s_k] score
matrix in f32, a top-left aligned causal mask (q_pos >= k_pos, both from
0). Layout [batch, seq, heads, head_dim]; the output has q's dtype. Ring
attention itself is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch


def _big_neg(dtype: torch.dtype) -> float:
    return float(torch.finfo(dtype).min) / 2


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
