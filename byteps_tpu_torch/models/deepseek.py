"""DeepSeek-V3 decoder (arXiv:2412.19437 §2.1): multi-head latent
attention (MLA) and a layer of fine-grained routed experts beside shared
ones, after leading dense layers. ``Moonlight16B`` is Moonshot's
Moonlight-16B-A3B, which is this architecture at 16B-A3B.

The port's numerics, as the Llama family's: f32 parameters, products in
``dtype`` (bfloat16 by default) with f32 sums, RMSNorm statistics in f32,
rotary angles and the rotation in f32, f32 logits; the router's logits
in f32 from the hidden state in ``dtype`` (DeepSeek-V3's ``MoEGate``
casts both to f32).

Attention (no query compression, ``q_lora_rank`` null): q = W_q x, [h,
nope + rope]; [c_kv, k_r] = W_kva x (kv_lora_rank + rope); c_kv =
RMSNorm(c_kv); [k_nope, v] = W_kvb c_kv, [h, nope + v_dim]; RoPE on
q_rope and on the one k_r that every head shares, over interleaved pairs;
q = [q_nope, q_rope], k = [k_nope, k_r]; causal attention scaled by (nope
+ rope)^-1/2; W_o over [h, v_dim]. With ``attn_impl="flash"`` the port's
kernels run it at head dims (nope + rope, v_dim), 192 and 128 here.

The expert layer (``DeepseekMoE``): s = sigmoid(x W_r) over all
``n_experts``; the top k of s + b, where b is a correction bias (a
buffer, never a weight); weights the chosen s normalised to sum 1 and
scaled; the routed part sum_e w_e SwiGLU_e(x) over the chosen experts
that this process holds (``parallel.moe.RoutedExperts``: one share of an
expert-parallel layer); plus one shared SwiGLU of width ``n_shared``
experts'. Each training forward adds its tokens' choices to the layer's
``load`` buffer on the card; ``DeepseekV3Model.update_bias()``, called
once after each optimizer step, moves the bias, b_i += ``bias_speed``
sign(mean load - load_i), and clears the loads (``parallel.moe.
bias_update``; no host read). Under gradient accumulation the loads of
every micro-batch count towards the one move. Training adds the
sequence-wise balance loss times ``aux_alpha``.

``forward`` returns (f32 logits, the balance loss summed over the expert
layers); ``moe_lm_loss`` adds it to the next-token cross-entropy.

Under a step trace (``utils.timeline.start_steps``) each expert layer
marks the card at the start and end of its forward (``moe_fwd_start``,
``moe_fwd_end``) and of its backward (``moe_bwd_start``, ``moe_bwd_end``),
the layer's index as the mark's leaf, and adds the pairs routed to the
held experts to the step's ``moe_rows`` counter on the card; tracing off
costs one branch a layer.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional, Tuple

import torch
from torch import nn

from byteps_tpu_torch._device import resolve_device
from byteps_tpu_torch.models.llama import LlamaMLP, RMSNorm, _rope
from byteps_tpu_torch.models.transformer import (Dense, Embed,
                                                 _attention_fn, _normal,
                                                 lm_loss)
from byteps_tpu_torch.parallel.moe import (RoutedExperts, bias_update,
                                           expert_load, expert_plan,
                                           route_weights,
                                           sequence_balance_loss,
                                           sigmoid_topk)
from byteps_tpu_torch.utils import timeline as _tl


class MLAttention(nn.Module):
    """DeepSeek-V3's multi-head latent attention without query
    compression, as it trains (K and V expanded from the latent, no
    absorbed form): kernels ``q`` [d, h, nope + rope], ``kv_a`` [d,
    kv_lora_rank + rope], ``kv_b`` [kv_lora_rank, h, nope + v_dim], ``o``
    [h, v_dim, d], no biases; ``kv_norm`` on the latent."""

    def __init__(self, d_model: int, num_heads: int, qk_nope_dim: int,
                 qk_rope_dim: int, v_dim: int, kv_lora_rank: int,
                 dtype: torch.dtype, attn_impl: str,
                 generator: torch.Generator, rope_theta: float,
                 eps: float):
        super().__init__()
        dense = partial(Dense, dtype=dtype, generator=generator,
                        use_bias=False)
        self.heads, self.rank = num_heads, kv_lora_rank
        self.nope, self.rope, self.v_dim = qk_nope_dim, qk_rope_dim, v_dim
        self.q = dense((d_model,), (num_heads, qk_nope_dim + qk_rope_dim))
        self.kv_a = dense((d_model,), (kv_lora_rank + qk_rope_dim,))
        self.kv_norm = RMSNorm(kv_lora_rank, eps)
        self.kv_b = dense((kv_lora_rank,), (num_heads, qk_nope_dim + v_dim))
        self.o = dense((num_heads, v_dim), (d_model,))
        self.rope_theta = rope_theta
        self.attn = _attention_fn(attn_impl)

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        b, s, _ = x.shape
        q_nope, q_rope = self.q(x).split([self.nope, self.rope], dim=-1)
        c_kv, k_rope = self.kv_a(x).split([self.rank, self.rope], dim=-1)
        k_nope, v = self.kv_b(self.kv_norm(c_kv)).split(
            [self.nope, self.v_dim], dim=-1)
        q_rope = _rope(q_rope, positions, self.rope_theta, interleaved=True)
        k_rope = _rope(k_rope[:, :, None], positions, self.rope_theta,
                       interleaved=True)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope.expand(b, s, self.heads, self.rope)],
                      dim=-1)
        o = self.attn(q, k, v.contiguous(), causal=True,
                      scale=(self.nope + self.rope) ** -0.5)
        return self.o(o)


class _F32Logits(torch.autograd.Function):
    """x @ w^T in f32 from ``x`` in its own dtype (DeepSeek-V3's
    ``MoEGate`` casts the hidden state and the weight to f32), keeping x
    and not its f32 copy for the backward."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return x.float() @ w.t()

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return (g @ w).to(x.dtype), g.t() @ x.float()


class DeepseekMoE(nn.Module):
    """The expert layer: router ``router`` [n_experts, d] (f32) and its
    correction bias ``bias`` [n_experts] (a buffer, kept with the model's
    state), the routed experts held here (``experts``: experts [lo, hi) of
    ``n_experts``) and ``n_shared`` shared experts as one SwiGLU
    (``shared``). ``forward(x [b, s, d])`` -> (output, balance loss);
    in training with gradients on it adds the tokens that chose each of
    the ``n_experts`` to ``load`` (a buffer outside the model's state),
    which ``update_bias`` spends."""

    def __init__(self, d_model: int, expert_dim: int, n_experts: int,
                 held: Tuple[int, int], top_k: int, n_shared: int,
                 scaling: float, aux_alpha: float, bias_speed: float,
                 dtype: torch.dtype, generator: torch.Generator,
                 layer: int = 0):
        super().__init__()
        self.top_k, self.scaling = top_k, scaling
        self.aux_alpha, self.bias_speed = aux_alpha, bias_speed
        self.layer = layer
        self.router = _normal((n_experts, d_model), 1.0 / math.sqrt(d_model),
                              generator)
        self.register_buffer("bias", torch.zeros(n_experts))
        self.register_buffer("load", torch.zeros(n_experts),
                             persistent=False)
        self.experts = RoutedExperts(d_model, expert_dim, n_experts, *held,
                                     dtype=dtype, generator=generator)
        self.shared = LlamaMLP(d_model, n_shared * expert_dim, dtype,
                               generator)

    def forward(self, x: torch.Tensor):
        tr = _tl.steps
        if tr is not None:
            x = _Marked.apply(x, "moe_fwd_start", "moe_bwd_end", self.layer)
        b, s, d = x.shape
        flat = x.reshape(b * s, d)
        n = self.router.shape[0]
        scores, idx = sigmoid_topk(_F32Logits.apply(flat, self.router),
                                   self.bias, self.top_k)
        aux = scores.new_zeros(())
        if self.training and torch.is_grad_enabled():
            self.load += expert_load(idx, n)
            aux = sequence_balance_loss(scores, idx, b, self.aux_alpha)
        ex = self.experts
        plan = expert_plan(idx, route_weights(scores, idx, self.scaling),
                           ex.lo, ex.hi - ex.lo)
        out = self.shared(x) + ex(flat, plan).view(b, s, d)
        if tr is not None:
            _tl.add_count("moe_rows", plan.rows)
            out = _Marked.apply(out, "moe_fwd_end", "moe_bwd_start",
                                self.layer)
        return out, aux

    def update_bias(self) -> None:
        """The step's bias move from the loads its forwards counted, then
        the loads cleared for the next step."""
        bias_update(self.bias, self.load, self.bias_speed)
        self.load.zero_()


class _Marked(torch.autograd.Function):
    """The identity; marks the card with ``fwd`` when the forward passes
    and ``bwd`` when the backward does (``utils.timeline.mark``, leaf
    ``layer``), into the step trace's current record."""

    @staticmethod
    def forward(ctx, x, fwd, bwd, layer):
        ctx.bwd, ctx.layer = bwd, layer
        _mark(fwd, layer, x.device)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        _mark(ctx.bwd, ctx.layer, g.device)
        return g, None, None, None


def _mark(name: str, layer: int, device) -> None:
    tr = _tl.steps
    if tr is not None:
        stream = (torch.cuda.current_stream(device)
                  if device.type == "cuda" else None)
        _tl.mark(tr.current(), name, stream, leaf=layer)


class DeepseekBlock(nn.Module):
    """Pre-norm block: x + attn(attn_norm(x)), then x + mlp(mlp_norm(x)),
    the mlp a dense SwiGLU (``LlamaMLP``) or ``DeepseekMoE``; returns
    (x, the layer's balance loss or None)."""

    def __init__(self, d_model: int, attn: MLAttention, mlp: nn.Module,
                 eps: float):
        super().__init__()
        self.attn_norm = RMSNorm(d_model, eps)
        self.attn = attn
        self.mlp_norm = RMSNorm(d_model, eps)
        self.mlp = mlp

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        x = x + self.attn(self.attn_norm(x), positions)
        y = self.mlp(self.mlp_norm(x))
        if isinstance(self.mlp, DeepseekMoE):
            y, aux = y
            return x + y, aux
        return x + y, None


class DeepseekV3Model(nn.Module):
    """Causal LM: ``tokens`` [batch, seq] -> (f32 logits [batch, seq,
    vocab], the balance loss). The first ``first_dense`` layers have a
    dense SwiGLU of ``dense_dim``, the rest the expert layer, holding the
    routed experts ``experts`` = (lo, hi) of ``n_experts`` (all of them
    when None). An untied head. Parameters are drawn on the CPU from
    ``generator`` (seed 0 when None) and moved to ``device`` (the current
    CUDA device when None)."""

    def __init__(self, vocab_size: int, num_layers: int, d_model: int,
                 num_heads: int, qk_nope_dim: int, qk_rope_dim: int,
                 v_dim: int, kv_lora_rank: int, dense_dim: int,
                 expert_dim: int, n_experts: int, top_k: int,
                 n_shared: int, first_dense: int = 1,
                 experts: Optional[Tuple[int, int]] = None,
                 routed_scaling: float = 1.0, aux_alpha: float = 1e-4,
                 bias_speed: float = 1e-3, rope_theta: float = 10000.0,
                 eps: float = 1e-6, dtype: torch.dtype = torch.bfloat16,
                 attn_impl: str = "full",
                 generator: Optional[torch.Generator] = None,
                 device: "torch.device | str | None" = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        held = experts if experts is not None else (0, n_experts)
        self.dtype = dtype
        self.embed = Embed(vocab_size, d_model, dtype, generator)
        layers = []
        for i in range(num_layers):
            attn = MLAttention(d_model, num_heads, qk_nope_dim, qk_rope_dim,
                               v_dim, kv_lora_rank, dtype, attn_impl,
                               generator, rope_theta, eps)
            if i < first_dense:
                mlp = LlamaMLP(d_model, dense_dim, dtype, generator)
            else:
                mlp = DeepseekMoE(d_model, expert_dim, n_experts, held,
                                  top_k, n_shared, routed_scaling,
                                  aux_alpha, bias_speed, dtype, generator,
                                  layer=i)
            layers.append(DeepseekBlock(d_model, attn, mlp, eps))
        self.layers = nn.ModuleList(layers)
        self.final_norm = RMSNorm(d_model, eps)
        self.head = Dense((d_model,), (vocab_size,), dtype, generator,
                          use_bias=False)
        self.to(resolve_device(device))

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None):
        if positions is None:
            positions = torch.arange(tokens.shape[1],
                                     device=tokens.device)[None, :]
        x = self.embed(tokens)
        aux = torch.zeros((), device=tokens.device)
        for layer in self.layers:
            x, a = layer(x, positions)
            if a is not None:
                aux = aux + a
        return self.head(self.final_norm(x)).float(), aux

    def update_bias(self) -> None:
        """DeepSeek-V3's correction-bias update of every expert layer, to
        be called once after each optimizer step (``opt.step()``): each
        bias moves by its speed from the loads of the forwards since the
        last call. On the card, with no host read."""
        for layer in self.layers:
            if isinstance(layer.mlp, DeepseekMoE):
                layer.mlp.update_bias()


def moe_lm_loss(outputs, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy (``lm_loss``) of ``DeepseekV3Model``'s
    logits plus its balance loss."""
    logits, aux = outputs
    return lm_loss(logits, tokens) + aux


# Moonlight-16B-A3B (https://huggingface.co/moonshotai/Moonlight-16B-A3B,
# config.json): DeepSeek-V3's architecture with 27 layers (the first
# dense), d 2048, 16 heads of 128 + 64 / 128, kv_lora_rank 512, dense
# SwiGLU 11264, 64 routed experts of 1408 (6 a token, scaled by 2.446) and
# 2 shared, rope_theta 50000, eps 1e-5, vocabulary 163840. The balance
# loss's alpha and the bias speed are DeepSeek-V3's (§4.2: 1e-4, 0.001).
Moonlight16B = partial(
    DeepseekV3Model, vocab_size=163840, num_layers=27, d_model=2048,
    num_heads=16, qk_nope_dim=128, qk_rope_dim=64, v_dim=128,
    kv_lora_rank=512, dense_dim=11264, expert_dim=1408, n_experts=64,
    top_k=6, n_shared=2, first_dense=1, routed_scaling=2.446,
    aux_alpha=1e-4, bias_speed=1e-3, rope_theta=50000.0, eps=1e-5)
# Tiny is for tests: the same kinds of layer at small widths, 8 experts
# of which a token takes 3.
DeepseekTiny = partial(
    DeepseekV3Model, vocab_size=256, num_layers=3, d_model=64, num_heads=4,
    qk_nope_dim=16, qk_rope_dim=8, v_dim=16, kv_lora_rank=32, dense_dim=96,
    expert_dim=24, n_experts=8, top_k=3, n_shared=2, first_dense=1,
    routed_scaling=2.446, aux_alpha=1e-4, bias_speed=1e-3,
    rope_theta=50000.0, eps=1e-5)
