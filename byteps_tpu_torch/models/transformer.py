"""GPT-style decoder LM, the model the port's main path trains.

Counterpart of ``byteps_tpu/models/transformer.py`` (``MultiHeadAttention``,
``TransformerLayer``, ``TransformerLM``, ``GPT2Small``, ``lm_loss``) with
the numerics of its flax modules: parameters in f32, products in ``dtype``
(bfloat16 by default) with both operands cast before the product, layer
norms in f32 with eps 1e-6, the tanh approximation of GELU, a bf16
residual stream, and weight-tied f32 logits. ``from_flax`` moves a flax
parameter tree over, so the two versions can be held against each other
on the same weights.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from byteps_tpu_torch._device import resolve_device
from byteps_tpu_torch.parallel.ring_attention import full_attention

_LN_EPS = 1e-6  # flax LayerNorm's default (torch's is 1e-5)


def _attention_fn(impl: str) -> Callable:
    if impl == "flash":
        from byteps_tpu_torch.ops.flash_attention import flash_attention
        return flash_attention
    if impl == "full":
        return full_attention
    raise ValueError(f"attn_impl must be full|flash (ring and ulysses are "
                     f"not ported yet), got {impl!r}")


def _normal(shape, std: float, generator: torch.Generator) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape).normal_(0.0, std,
                                                   generator=generator))


class Dense(nn.Module):
    """flax ``Dense`` / ``DenseGeneral``: ``kernel [*in_shape, *out_shape]``
    and ``bias [*out_shape]`` in f32; input and kernel are cast to
    ``dtype`` before the product and the bias is added in ``dtype``."""

    def __init__(self, in_shape: Sequence[int], out_shape: Sequence[int],
                 dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        self.dtype = dtype
        fan_in = math.prod(self.in_shape)
        self.kernel = _normal((*self.in_shape, *self.out_shape),
                              1.0 / math.sqrt(fan_in), generator)
        self.bias = nn.Parameter(torch.zeros(self.out_shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:x.dim() - len(self.in_shape)]
        n_in, n_out = math.prod(self.in_shape), math.prod(self.out_shape)
        y = (x.reshape(*lead, n_in).to(self.dtype)
             @ self.kernel.reshape(n_in, n_out).to(self.dtype))
        y = y + self.bias.reshape(n_out).to(self.dtype)
        return y.reshape(*lead, *self.out_shape)


class Embed(nn.Module):
    """flax ``Embed``: an f32 table cast to ``dtype`` on lookup; ``attend``
    is the weight-tied output projection ``x @ E^T`` in ``dtype``."""

    def __init__(self, num: int, features: int, dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.embedding = _normal((num, features), 1.0 / math.sqrt(features),
                                 generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.embedding).to(self.dtype)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype) @ self.embedding.to(self.dtype).T


class LayerNorm(nn.Module):
    """flax ``LayerNorm(dtype=float32)``: statistics and output in f32."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.scale.shape, self.scale,
                            self.bias, eps=_LN_EPS)


class MultiHeadAttention(nn.Module):
    """Self-attention with a pluggable core (``full`` or ``flash``)."""

    def __init__(self, d_model: int, num_heads: int, dtype: torch.dtype,
                 causal: bool, attn_impl: str, generator: torch.Generator):
        super().__init__()
        head_dim = d_model // num_heads
        qkv = partial(Dense, (d_model,), (num_heads, head_dim), dtype,
                      generator)
        self.query, self.key, self.value = qkv(), qkv(), qkv()
        self.out = Dense((num_heads, head_dim), (d_model,), dtype, generator)
        self.causal = causal
        self.attn = _attention_fn(attn_impl)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.query(x), self.key(x), self.value(x)
        return self.out(self.attn(q, k, v, causal=self.causal))


class TransformerLayer(nn.Module):
    """Pre-LN transformer block (layer norms in f32)."""

    def __init__(self, d_model: int, num_heads: int, mlp_dim: int,
                 dtype: torch.dtype, causal: bool, attn_impl: str,
                 generator: torch.Generator):
        super().__init__()
        self.ln_0 = LayerNorm(d_model)
        self.attention = MultiHeadAttention(d_model, num_heads, dtype, causal,
                                            attn_impl, generator)
        self.ln_1 = LayerNorm(d_model)
        self.mlp_in = Dense((d_model,), (mlp_dim,), dtype, generator)
        self.mlp_out = Dense((mlp_dim,), (d_model,), dtype, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.attention(self.ln_0(x))
        x = x + y.to(x.dtype)
        y = self.mlp_in(self.ln_1(x))
        y = self.mlp_out(F.gelu(y, approximate="tanh"))
        return x + y.to(x.dtype)


class TransformerLM(nn.Module):
    """GPT-style causal decoder LM; returns next-token logits in f32.

    Parameters are drawn on the CPU from ``generator`` (seed 0 when None)
    and then moved to ``device`` (the current CUDA device when None), so
    one seed gives the same weights on every machine.
    """

    def __init__(self, vocab_size: int = 50257, num_layers: int = 12,
                 d_model: int = 768, num_heads: int = 12,
                 mlp_dim: int = 3072, max_len: int = 1024,
                 dtype: torch.dtype = torch.bfloat16,
                 attn_impl: str = "full",
                 generator: Optional[torch.Generator] = None,
                 device: "torch.device | str | None" = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.dtype = dtype
        self.tok_embed = Embed(vocab_size, d_model, dtype, generator)
        self.pos_embed = Embed(max_len, d_model, dtype, generator)
        self.layers = nn.ModuleList([
            TransformerLayer(d_model, num_heads, mlp_dim, dtype, True,
                             attn_impl, generator)
            for _ in range(num_layers)])
        self.final_ln = LayerNorm(d_model)
        self.to(resolve_device(device))

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        if positions is None:
            positions = torch.arange(tokens.shape[1],
                                     device=tokens.device)[None, :]
        x = self.tok_embed(tokens) + self.pos_embed(positions)
        for layer in self.layers:
            x = layer(x)
        x = self.final_ln(x)
        return self.tok_embed.attend(x.to(self.dtype)).float()


GPT2Small = partial(TransformerLM, num_layers=12, d_model=768, num_heads=12,
                    mlp_dim=3072)


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy (shifted), mean over all positions."""
    v = logits.shape[-1]
    return F.cross_entropy(logits[:, :-1].reshape(-1, v).float(),
                           tokens[:, 1:].reshape(-1))


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """A ``TransformerLM`` state_dict from the flax module's parameter tree
    (nested dicts of numpy arrays, with or without the ``params`` level).

    Names map one to one: ``layer_i/LayerNorm_k/...`` becomes
    ``layers.i.ln_k...`` and every other ``/`` a ``.``; kernels keep the
    flax layout (``query/kernel [d, h, hd]``, ``out/kernel [h, hd, d]``,
    ``mlp_in/kernel [d, mlp]``), so no tensor is transposed.
    """
    if set(params) == {"params"}:
        params = params["params"]
    sd = {}
    for key, arr in _flatten(params).items():
        parts = []
        for p in key.split("/"):
            if p.startswith("layer_"):
                parts += ["layers", p[len("layer_"):]]
            elif p.startswith("LayerNorm_"):
                parts.append("ln_" + p[len("LayerNorm_"):])
            else:
                parts.append(p)
        sd[".".join(parts)] = torch.from_numpy(
            np.array(arr, dtype=np.float32))
    return sd
