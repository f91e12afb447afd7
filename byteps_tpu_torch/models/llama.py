"""LLaMA-family decoder (RMSNorm, RoPE, grouped-query attention, SwiGLU).

Counterpart of ``byteps_tpu/models/llama.py`` with the numerics of its
flax modules: parameters in f32, products in ``dtype`` (bfloat16 by
default) with both operands cast before the product and no biases,
RMSNorm statistics in f32 (eps 1e-6) cast back to the input's dtype,
rotary angles and the rotation in f32 (halves, not interleaved pairs),
and a weight-tied head with f32 logits.

GQA repeats each K/V head ``num_heads // num_kv_heads`` times in a row
(``jnp.repeat`` on the head axis) before the attention core, so the
flash kernels see ordinary multi-head attention. ``remat=True`` runs each
block under ``torch.utils.checkpoint`` (non-reentrant): its activations
are recomputed in the backward, which launches each block's forward
kernels twice a step.

Sequence parallelism: with an ``sp_group`` (the JAX modules' ``sp_axis``)
each process holds one block of the sequence, RoPE takes the block's
global positions, and ``ring``, ``ulysses`` and ``flash`` attend over the
whole sequence (``full`` raises). Under ``ulysses`` and ``flash`` with GQA,
where the KV heads divide by the group's size, the all-to-all reshards
the unrepeated K/V heads (1/groups of the bytes) and each process repeats
its KV heads after the exchange, inside the inner attention; ``flash``
runs the port's kernels there, ``ulysses`` ``full_attention``.

``from_flax`` is the transformer family's: the flax names
``embed/embedding``, ``layer_i/{attn_norm,mlp_norm}/scale``,
``layer_i/attn/{q,k,v,o}/kernel`` (``[d, h, hd]``, ``[d, kvh, hd]``,
``[d, kvh, hd]``, ``[h, hd, d]``), ``layer_i/mlp/{gate,up,down}/kernel``
and ``final_norm/scale`` become ``embed.embedding``,
``layers.i.attn.q.kernel`` and so on, in the flax layout.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from byteps_tpu_torch._device import resolve_device
from byteps_tpu_torch.models.transformer import (  # noqa: F401 (from_flax)
    Dense, Embed, _attention_fn, _default_positions, from_flax)
from byteps_tpu_torch.parallel._collectives import group_size
from byteps_tpu_torch.parallel.ring_attention import full_attention
from byteps_tpu_torch.parallel.ulysses import ulysses_attention

_RMS_EPS = 1e-6  # the flax module's (torch.nn.RMSNorm's default differs)


class RMSNorm(nn.Module):
    """x * rsqrt(mean(x^2) + eps) * scale in f32, cast back to x's dtype."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + _RMS_EPS)
        return (y * self.scale).to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor,
          theta: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding over [batch, seq, heads, head_dim]:
    [x1 cos - x2 sin, x1 sin + x2 cos] over the two halves of head_dim,
    angles positions * theta^(-i / half) in f32; ``positions`` [b or 1,
    seq]."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].float() * freqs  # [b, s, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def _repeat_kv(x: torch.Tensor, groups: int) -> torch.Tensor:
    """Each K/V head ``groups`` times in a row on the head axis
    (``jnp.repeat(x, groups, axis=2)``): query head j reads KV head
    j // groups."""
    return torch.repeat_interleave(x, groups, dim=2)


class LlamaAttention(nn.Module):
    """Causal self-attention with RoPE and grouped K/V heads; q/k/v
    kernels ``[d, h or kvh, hd]`` and ``o`` ``[h, hd, d]``, no biases."""

    def __init__(self, d_model: int, num_heads: int, num_kv_heads: int,
                 dtype: torch.dtype, attn_impl: str,
                 generator: torch.Generator, sp_group=None,
                 rope_theta: float = 10000.0):
        super().__init__()
        if num_heads % num_kv_heads:
            raise ValueError(f"num_heads ({num_heads}) must be a multiple of "
                             f"num_kv_heads ({num_kv_heads})")
        head_dim = d_model // num_heads
        dense = partial(Dense, dtype=dtype, generator=generator,
                        use_bias=False)
        self.q = dense((d_model,), (num_heads, head_dim))
        self.k = dense((d_model,), (num_kv_heads, head_dim))
        self.v = dense((d_model,), (num_kv_heads, head_dim))
        self.o = dense((num_heads, head_dim), (d_model,))
        self.groups = num_heads // num_kv_heads
        self.rope_theta = rope_theta
        self.attn = _attention_fn(attn_impl, sp_group)
        # GQA + Ulysses: the K/V heads travel unrepeated
        self.sp_group, self.kv_inner = sp_group, None
        if (self.groups > 1 and sp_group is not None
                and attn_impl in ("ulysses", "flash")
                and num_kv_heads % group_size(sp_group) == 0):
            self.kv_inner = (_attention_fn("flash") if attn_impl == "flash"
                             else full_attention)

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        q = _rope(self.q(x), positions, self.rope_theta)
        k = _rope(self.k(x), positions, self.rope_theta)
        v = self.v(x)
        if self.kv_inner is not None:
            def grouped(q_, k_, v_, *, causal, scale=None):
                return self.kv_inner(q_, _repeat_kv(k_, self.groups),
                                     _repeat_kv(v_, self.groups),
                                     causal=causal, scale=scale)
            return self.o(ulysses_attention(q, k, v, group=self.sp_group,
                                            causal=True, attn_fn=grouped))
        if self.groups > 1:
            k, v = _repeat_kv(k, self.groups), _repeat_kv(v, self.groups)
        return self.o(self.attn(q, k, v, causal=True))


class LlamaMLP(nn.Module):
    """SwiGLU feed-forward: down(silu(gate x) * up x), no biases."""

    def __init__(self, d_model: int, mlp_dim: int, dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        dense = partial(Dense, dtype=dtype, generator=generator,
                        use_bias=False)
        self.gate = dense((d_model,), (mlp_dim,))
        self.up = dense((d_model,), (mlp_dim,))
        self.down = dense((mlp_dim,), (d_model,))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(F.silu(self.gate(x)) * self.up(x))


class LlamaBlock(nn.Module):
    """Pre-norm block: x + attn(attn_norm(x)), then x + mlp(mlp_norm(x))."""

    def __init__(self, d_model: int, num_heads: int, num_kv_heads: int,
                 mlp_dim: int, dtype: torch.dtype, attn_impl: str,
                 generator: torch.Generator, sp_group=None,
                 rope_theta: float = 10000.0):
        super().__init__()
        self.attn_norm = RMSNorm(d_model)
        self.attn = LlamaAttention(d_model, num_heads, num_kv_heads, dtype,
                                   attn_impl, generator, sp_group, rope_theta)
        self.mlp_norm = RMSNorm(d_model)
        self.mlp = LlamaMLP(d_model, mlp_dim, dtype, generator)

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        x = x + self.attn(self.attn_norm(x), positions)
        return x + self.mlp(self.mlp_norm(x))


class LlamaModel(nn.Module):
    """Causal LM: ``tokens`` [batch, seq] -> f32 logits [batch, seq,
    vocab]. Parameters are drawn on the CPU from ``generator`` (seed 0
    when None) and then moved to ``device`` (the current CUDA device when
    None), so one seed gives the same weights on every machine. With
    ``sp_group`` ``tokens`` is this process's block of the sequence and
    the positions default to its global offsets."""

    def __init__(self, vocab_size: int, num_layers: int, d_model: int,
                 num_heads: int, num_kv_heads: int, mlp_dim: int,
                 dtype: torch.dtype = torch.bfloat16,
                 attn_impl: str = "full", sp_group=None,
                 rope_theta: float = 10000.0, remat: bool = False,
                 generator: Optional[torch.Generator] = None,
                 device: "torch.device | str | None" = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.dtype, self.remat, self.sp_group = dtype, remat, sp_group
        self.embed = Embed(vocab_size, d_model, dtype, generator)
        self.layers = nn.ModuleList([
            LlamaBlock(d_model, num_heads, num_kv_heads, mlp_dim, dtype,
                       attn_impl, generator, sp_group, rope_theta)
            for _ in range(num_layers)])
        self.final_norm = RMSNorm(d_model)
        self.to(resolve_device(device))

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        if positions is None:
            positions = _default_positions(tokens.shape[1], self.sp_group,
                                           tokens.device)
        x = self.embed(tokens)
        for layer in self.layers:
            if self.remat:
                x = checkpoint(layer, x, positions, use_reentrant=False)
            else:
                x = layer(x, positions)
        x = self.final_norm(x)
        return self.embed.attend(x.to(self.dtype)).float()


# Tiny is for tests. Llama1B follows TinyLlama-1.1B (22 layers, d 2048, 32
# heads, 4 KV heads, mlp 5632, vocab 32000); Llama7B follows LLaMA-1/2-7B
# (32 layers, d 4096, 32 heads, no GQA, mlp 11008, vocab 32000).
LlamaTiny = partial(LlamaModel, vocab_size=1024, num_layers=2, d_model=64,
                    num_heads=4, num_kv_heads=2, mlp_dim=128)
Llama1B = partial(LlamaModel, vocab_size=32000, num_layers=22,
                  d_model=2048, num_heads=32, num_kv_heads=4, mlp_dim=5632)
Llama7B = partial(LlamaModel, vocab_size=32000, num_layers=32,
                  d_model=4096, num_heads=32, num_kv_heads=32,
                  mlp_dim=11008)

