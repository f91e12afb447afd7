"""The transformer family: the GPT-style decoder LM and the BERT-style
encoder with its MLM head.

Counterpart of ``byteps_tpu/models/transformer.py`` (``MultiHeadAttention``,
``TransformerLayer``, ``TransformerEncoder``, ``TransformerLM``,
``BertBase``, ``BertLarge``, ``GPT2Small``, ``GPT2Medium``,
``masked_lm_loss``, ``lm_loss``) with the numerics of its flax modules:
parameters in f32, products in ``dtype`` (bfloat16 by default) with both
operands cast before the product, layer norms in f32 with eps 1e-6, the
tanh approximation of GELU, a bf16 residual stream, and f32 logits
(weight-tied in the decoder, an f32 ``mlm_out`` in the encoder).
``from_flax`` moves a flax parameter tree over, so the two versions can be
held against each other on the same weights.

Attention is ``full``, ``flash`` (the port's kernels), ``ring`` or
``ulysses``. With an ``sp_group`` (the JAX modules' ``sp_axis``: the
process group the sequence is split over) each process runs its block of
the sequence: ``ring`` and ``ulysses`` exchange K/V or heads over the
group, ``flash`` runs the kernels inside Ulysses, positions default to the
block's global offsets, and ``sp_lm_loss`` scores each block's last
position against the next block's first token.
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
from byteps_tpu_torch.parallel._collectives import (group_rank, group_size,
                                                    ppermute)
from byteps_tpu_torch.parallel.ring_attention import (full_attention,
                                                      ring_attention)
from byteps_tpu_torch.parallel.ulysses import ulysses_attention
from byteps_tpu_torch.utils import timeline as _tl

_LN_EPS = 1e-6  # flax LayerNorm's default (torch's is 1e-5)
# ``Embed.attend`` pads its table to a multiple of this many rows
ATTEND_ROWS = 64


def _attention_fn(impl: str, sp_group=None) -> Callable:
    if impl not in ("full", "flash", "ring", "ulysses"):
        raise ValueError(
            f"attn_impl must be full|flash|ring|ulysses, got {impl!r}")
    if impl == "flash":
        from byteps_tpu_torch.ops.flash_attention import flash_attention
        if sp_group is None:
            return flash_attention
        # sequence parallel + the kernels: Ulysses reshards to whole
        # sequences on each process, the kernels run the inner attention
        return partial(ulysses_attention, group=sp_group,
                       attn_fn=flash_attention)
    if impl == "full":
        if sp_group is not None:
            raise ValueError(
                "attn_impl='full' attends within each process's sequence "
                "block only, which is silently wrong under sequence "
                "parallelism; use 'ring', 'ulysses', or 'flash' with "
                "sp_group")
        return full_attention
    if sp_group is None:
        return full_attention
    if impl == "ring":
        return partial(ring_attention, group=sp_group)
    return partial(ulysses_attention, group=sp_group)


def _default_positions(s: int, sp_group, device) -> torch.Tensor:
    """Global position ids [1, s] of this process's block: under sequence
    parallelism rank r of ``sp_group`` holds positions [r s, (r + 1) s)."""
    return (torch.arange(s, device=device)[None, :]
            + group_rank(sp_group) * s)


def _normal(shape, std: float, generator: torch.Generator) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape).normal_(0.0, std,
                                                   generator=generator))


class Dense(nn.Module):
    """flax ``Dense`` / ``DenseGeneral``: ``kernel [*in_shape, *out_shape]``
    and, with ``use_bias``, ``bias [*out_shape]`` in f32; input and kernel
    are cast to ``dtype`` before the product and the bias is added in
    ``dtype``."""

    def __init__(self, in_shape: Sequence[int], out_shape: Sequence[int],
                 dtype: torch.dtype, generator: torch.Generator,
                 use_bias: bool = True):
        super().__init__()
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        self.dtype = dtype
        fan_in = math.prod(self.in_shape)
        self.kernel = _normal((*self.in_shape, *self.out_shape),
                              1.0 / math.sqrt(fan_in), generator)
        self.bias = (nn.Parameter(torch.zeros(self.out_shape)) if use_bias
                     else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:x.dim() - len(self.in_shape)]
        n_in, n_out = math.prod(self.in_shape), math.prod(self.out_shape)
        y = (x.reshape(*lead, n_in).to(self.dtype)
             @ self.kernel.reshape(n_in, n_out).to(self.dtype))
        if self.bias is not None:
            y = y + self.bias.reshape(n_out).to(self.dtype)
        return y.reshape(*lead, *self.out_shape)


class Embed(nn.Module):
    """flax ``Embed``: an f32 table cast to ``dtype`` on lookup; ``attend``
    is the weight-tied output projection ``x @ E^T`` in ``dtype``.

    ``attend`` multiplies by the cast table with zero rows appended up to
    a multiple of ``ATTEND_ROWS`` and returns the first ``num`` columns, a
    view: with an odd row count (GPT-2's 50257) no operand of the forward
    product or of its two backward products has the 16-byte aligned
    leading dimension cuBLAS's Hopper kernels need. The padded columns
    never leave ``attend``; the slice's backward gives them a zero
    gradient and the pad's backward drops the padded rows' gradient, so
    the parameter and every shape a caller sees stay ``[num, features]``.
    Under a step trace each padded call adds the rows it appended to the
    record's ``head_pad_rows``.
    """

    def __init__(self, num: int, features: int, dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.embedding = _normal((num, features), 1.0 / math.sqrt(features),
                                 generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.embedding).to(self.dtype)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        table = self.embedding.to(self.dtype)
        num = table.shape[0]
        pad = -num % ATTEND_ROWS
        if not pad:
            return x.to(self.dtype) @ table.T
        _tl.add_count("head_pad_rows", pad)
        return (x.to(self.dtype) @ F.pad(table, (0, 0, 0, pad)).T)[..., :num]


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
    """Self-attention with a pluggable, possibly sequence-parallel core
    (``sp_group``: the JAX module's ``sp_axis``)."""

    def __init__(self, d_model: int, num_heads: int, dtype: torch.dtype,
                 causal: bool, attn_impl: str, generator: torch.Generator,
                 sp_group=None):
        super().__init__()
        head_dim = d_model // num_heads
        qkv = partial(Dense, (d_model,), (num_heads, head_dim), dtype,
                      generator)
        self.query, self.key, self.value = qkv(), qkv(), qkv()
        self.out = Dense((num_heads, head_dim), (d_model,), dtype, generator)
        self.causal = causal
        self.attn = _attention_fn(attn_impl, sp_group)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.query(x), self.key(x), self.value(x)
        return self.out(self.attn(q, k, v, causal=self.causal))


class TransformerLayer(nn.Module):
    """Pre-LN transformer block (layer norms in f32)."""

    def __init__(self, d_model: int, num_heads: int, mlp_dim: int,
                 dtype: torch.dtype, causal: bool, attn_impl: str,
                 generator: torch.Generator, sp_group=None):
        super().__init__()
        self.ln_0 = LayerNorm(d_model)
        self.attention = MultiHeadAttention(d_model, num_heads, dtype, causal,
                                            attn_impl, generator, sp_group)
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
    one seed gives the same weights on every machine. With ``sp_group``
    (the JAX module's ``sp_axis``) ``tokens`` is this process's block of
    the sequence.
    """

    def __init__(self, vocab_size: int = 50257, num_layers: int = 12,
                 d_model: int = 768, num_heads: int = 12,
                 mlp_dim: int = 3072, max_len: int = 1024,
                 dtype: torch.dtype = torch.bfloat16,
                 attn_impl: str = "full", sp_group=None,
                 generator: Optional[torch.Generator] = None,
                 device: "torch.device | str | None" = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.dtype, self.sp_group = dtype, sp_group
        self.tok_embed = Embed(vocab_size, d_model, dtype, generator)
        self.pos_embed = Embed(max_len, d_model, dtype, generator)
        self.layers = nn.ModuleList([
            TransformerLayer(d_model, num_heads, mlp_dim, dtype, True,
                             attn_impl, generator, sp_group)
            for _ in range(num_layers)])
        self.final_ln = LayerNorm(d_model)
        self.to(resolve_device(device))

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        if positions is None:
            positions = _default_positions(tokens.shape[1], self.sp_group,
                                           tokens.device)
        x = self.tok_embed(tokens) + self.pos_embed(positions)
        for layer in self.layers:
            x = layer(x)
        x = self.final_ln(x)
        return self.tok_embed.attend(x.to(self.dtype)).float()


class TransformerEncoder(nn.Module):
    """BERT-style bidirectional encoder with an MLM head; returns MLM
    logits [batch, seq, vocab] in f32. The head is ``mlm_dense`` in
    ``dtype``, GELU, ``mlm_ln`` in f32 and ``mlm_out`` in f32 (not tied).
    Parameters are drawn and placed, and ``sp_group`` splits the sequence,
    as in ``TransformerLM``."""

    def __init__(self, vocab_size: int = 30522, num_layers: int = 12,
                 d_model: int = 768, num_heads: int = 12,
                 mlp_dim: int = 3072, max_len: int = 512,
                 dtype: torch.dtype = torch.bfloat16,
                 attn_impl: str = "full", sp_group=None,
                 generator: Optional[torch.Generator] = None,
                 device: "torch.device | str | None" = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.max_len, self.sp_group = max_len, sp_group
        self.tok_embed = Embed(vocab_size, d_model, dtype, generator)
        self.pos_embed = Embed(max_len, d_model, dtype, generator)
        self.layers = nn.ModuleList([
            TransformerLayer(d_model, num_heads, mlp_dim, dtype, False,
                             attn_impl, generator, sp_group)
            for _ in range(num_layers)])
        self.final_ln = LayerNorm(d_model)
        self.mlm_dense = Dense((d_model,), (d_model,), dtype, generator)
        self.mlm_ln = LayerNorm(d_model)
        self.mlm_out = Dense((d_model,), (vocab_size,), torch.float32,
                             generator)
        self.to(resolve_device(device))

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        if positions is None:
            # flax clamps a position past the table; a CUDA lookup traps
            seq = tokens.shape[1] * group_size(self.sp_group)
            if seq > self.max_len:
                raise ValueError(f"sequence length {seq} exceeds "
                                 f"max_len={self.max_len}")
            positions = _default_positions(tokens.shape[1], self.sp_group,
                                           tokens.device)
        x = self.tok_embed(tokens) + self.pos_embed(positions)
        for layer in self.layers:
            x = layer(x)
        x = self.final_ln(x)
        x = F.gelu(self.mlm_dense(x), approximate="tanh")
        return self.mlm_out(self.mlm_ln(x))


# BERT sizes per the original paper; BERT-Large MLM is the reference's
# second headline benchmark.
BertBase = partial(TransformerEncoder, num_layers=12, d_model=768,
                   num_heads=12, mlp_dim=3072)
BertLarge = partial(TransformerEncoder, num_layers=24, d_model=1024,
                    num_heads=16, mlp_dim=4096)
GPT2Small = partial(TransformerLM, num_layers=12, d_model=768, num_heads=12,
                    mlp_dim=3072)
GPT2Medium = partial(TransformerLM, num_layers=24, d_model=1024,
                     num_heads=16, mlp_dim=4096)


def masked_lm_loss(logits: torch.Tensor, labels: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the positions where ``mask`` is 1 (MLM),
    divided by max(mask.sum(), 1)."""
    v = logits.shape[-1]
    nll = F.cross_entropy(logits.reshape(-1, v).float(), labels.reshape(-1),
                          reduction="none")
    mask = mask.reshape(-1).float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy (shifted), mean over all positions."""
    v = logits.shape[-1]
    return F.cross_entropy(logits[:, :-1].reshape(-1, v).float(),
                           tokens[:, 1:].reshape(-1))


def sp_lm_loss(logits: torch.Tensor, tokens: torch.Tensor,
               group) -> torch.Tensor:
    """``lm_loss`` for sequence blocks split over ``group`` (the JAX
    version's ``axis``).

    Plain ``lm_loss`` on each block drops every block-boundary prediction
    (each block loses its last position). Here each process's last
    position is scored against the next block's first token (one ring
    permute), only the globally last position goes unscored, and the
    value is scaled so that the mean over ``group`` (and over any
    data-parallel groups of disjoint batches) equals the full-sequence
    ``lm_loss``.
    """
    k = group_size(group)
    if k == 1:
        return lm_loss(logits, tokens)
    nxt_first = ppermute(tokens[:, 0].contiguous(), group, -1)
    tgt = torch.cat([tokens[:, 1:], nxt_first[:, None]], dim=1)
    v = logits.shape[-1]
    ll = -F.cross_entropy(logits.reshape(-1, v).float(), tgt.reshape(-1),
                          reduction="none").reshape(tgt.shape)
    if group_rank(group) == k - 1:
        # the last process's final position has no successor token
        ll = ll[:, :-1]
    b, s_local = tokens.shape
    total = b * (k * s_local - 1)  # positions scored across the ring
    return -ll.sum() * k / total


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
    """A ``TransformerLM``, ``TransformerEncoder`` or ``LlamaModel``
    state_dict from the flax module's parameter tree (nested dicts of
    numpy arrays, with or without the ``params`` level).

    Names map one to one: ``layer_i/LayerNorm_k/...`` becomes
    ``layers.i.ln_k...`` and every other ``/`` a ``.`` (``final_ln``,
    ``mlm_dense``, ``mlm_ln``, ``mlm_out``, ``attn/q`` keep their names);
    kernels keep the flax layout (``query/kernel [d, h, hd]``,
    ``out/kernel [h, hd, d]``, ``mlp_in/kernel [d, mlp]``), so no tensor
    is transposed.
    """
    if set(params) == {"params"}:
        params = params["params"]
    return {port_name(key): torch.from_numpy(np.array(arr, dtype=np.float32))
            for key, arr in _flatten(params).items()}


def port_name(flax_key: str) -> str:
    """The state_dict name of a flax parameter path (``/``-joined, without
    the ``params`` level), as ``from_flax`` maps it."""
    parts = []
    for p in flax_key.split("/"):
        if p.startswith("layer_"):
            parts += ["layers", p[len("layer_"):]]
        elif p.startswith("LayerNorm_"):
            parts.append("ln_" + p[len("LayerNorm_"):])
        else:
            parts.append(p)
    return ".".join(parts)
