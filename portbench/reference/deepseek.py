"""Plain DeepSeek-V3 (arXiv:2412.19437 §2.1): the decoder of
``configs/moonlight-16b-a3b`` in f32, written from the published
architecture, with the same share of the routed experts as the program.

Per layer, pre-norm: RMSNorm, multi-head latent attention, residual;
RMSNorm, a SwiGLU (the first ``first_k_dense_replace`` layers) or the
expert layer, residual; a final RMSNorm and an untied head.

- Attention (§2.1.1, no query compression): q = x W_q, heads of nope +
  rope; [c_kv, k_r] = x W_kva; c_kv = RMSNorm(c_kv); [k_nope, v] = c_kv
  W_kvb; RoPE over interleaved pairs of q_rope and of the one k_r all
  heads share; causal softmax attention scaled by (nope + rope)^-1/2;
  o W_o.
- Expert layer (§2.1.2): s = sigmoid(x W_r^T) over all the router's
  experts; each token's top k of s + b (b the correction bias: it
  chooses, never weighs); g = the chosen s over their sum, times the
  routed scaling factor; output sum over the chosen experts held here of
  g_e SwiGLU_e(x), plus the shared experts' SwiGLU. The experts held
  elsewhere (the other chips' shares of the layer) are left out, as the
  program leaves them out.
- Loss: next-token cross-entropy over every position but the last, plus
  the sequence-wise balance loss alpha sum_i f_i P_i a sequence, averaged
  over the sequences, f_i = E / (k S) times the tokens of the sequence
  that chose i, P_i the mean over the sequence of s_i / sum_j s_j.
- After each step, b_i += speed sign(mean load - load_i), the loads the
  tokens' choices of the step (the bias lives on each layer's router
  weight tensor, attribute ``correction_bias``, so that it lasts as long
  as that run's weights; the update is applied once the step's forward
  has made its choices, before its backward, which does not read it).

Departures, all stated by the configuration: the products in f32 (the
program's bf16 products are its precision), RoPE's pairs interleaved as
DeepSeek-V3's code lays them out (its ``apply_rotary_pos_emb`` reorders
each head into halves first; the attention scores are the same), the
initialisation N(0, 0.006) of §4.2. To fit at the cell's full size on the
card, each layer is recomputed in the backward (``torch.utils.checkpoint``)
and attention runs in blocks of ``BLOCK_Q`` queries, each recomputed
too; that changes no value.

The parameter names and layouts are the port's state_dict, so the
benchmark hands both sides one dict of weights.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference import operand

BLOCK_Q = 512


def _held(cfg):
    """(first held expert, experts held, the router's experts)."""
    n = cfg["n_routed_experts"]
    return cfg["expert_rank"] * n, n, n * cfg["expert_parallel"]


def specs(cfg) -> list:
    """[(name, shape, init)]: every weight N(0, init_std), norm scales 1."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    vd, rank = cfg["v_head_dim"], cfg["kv_lora_rank"]
    f, dense = cfg["moe_intermediate_size"], cfg["intermediate_size"]
    _, held, n_router = _held(cfg)
    normal = ("normal", cfg["init_std"])
    out = [("embed.embedding", (cfg["vocab_size"], d), normal)]
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        out += [(p + "attn_norm.scale", (d,), ("ones",)),
                (p + "attn.q.kernel", (d, h, nope + rope), normal),
                (p + "attn.kv_a.kernel", (d, rank + rope), normal),
                (p + "attn.kv_norm.scale", (rank,), ("ones",)),
                (p + "attn.kv_b.kernel", (rank, h, nope + vd), normal),
                (p + "attn.o.kernel", (h, vd, d), normal),
                (p + "mlp_norm.scale", (d,), ("ones",))]
        if i < cfg["first_k_dense_replace"]:
            out += [(p + "mlp.gate.kernel", (d, dense), normal),
                    (p + "mlp.up.kernel", (d, dense), normal),
                    (p + "mlp.down.kernel", (dense, d), normal)]
        else:
            sh = cfg["n_shared_experts"] * f
            out += [(p + "mlp.router", (n_router, d), normal),
                    (p + "mlp.experts.w1", (held, d, 2 * f), normal),
                    (p + "mlp.experts.w2", (held, f, d), normal),
                    (p + "mlp.shared.gate.kernel", (d, sh), normal),
                    (p + "mlp.shared.up.kernel", (d, sh), normal),
                    (p + "mlp.shared.down.kernel", (sh, d), normal)]
    out += [("final_norm.scale", (d,), ("ones",)),
            ("head.kernel", (d, cfg["vocab_size"]), normal)]
    return out


def _rms(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def _rope(x, theta):
    """Interleaved pairs (2i, 2i + 1) of x [b, s, heads, r] rotated by
    position * theta^(-2i / r)."""
    s, r = x.shape[1], x.shape[-1]
    freqs = theta ** (-torch.arange(0, r, 2, device=x.device,
                                    dtype=torch.float32) / r)
    ang = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] \
        * freqs
    cos, sin = ang.cos()[None, :, None], ang.sin()[None, :, None]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                       dim=-1).flatten(-2)


def _attention_block(q, k, v, q0, scale, fp8):
    """Queries q0 .. q0 + bq of q [b, h, bq, dqk] over the keys up to the
    last of them, k [b, h, q0 + bq, dqk], v [b, h, q0 + bq, dv]."""
    bq, n = q.shape[2], k.shape[2]
    s = operand(q, fp8) @ operand(k, fp8).transpose(-1, -2) * scale
    live = (torch.arange(q0, q0 + bq, device=q.device)[:, None]
            >= torch.arange(n, device=q.device)[None, :])
    p = s.masked_fill(~live, float("-inf")).softmax(-1)
    return operand(p, fp8) @ operand(v, fp8)


def _swiglu(x, gate, up, down, fp8):
    def mm(a, m):  # an expert no token chose has an empty a
        return operand(a, fp8 and a.numel() > 0) @ operand(m, fp8)
    return mm(F.silu(mm(x, gate)) * mm(x, up), down)


def _layer(x, w, p, cfg, i, bias, fp8):
    """Layer i: (x out, its balance loss, its loads [E] or None)."""
    b, s, d = x.shape
    h, eps = cfg["num_attention_heads"], cfg["rms_norm_eps"]
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    vd, rank = cfg["v_head_dim"], cfg["kv_lora_rank"]

    def mm(a, m):
        return operand(a, fp8) @ operand(m, fp8)

    y = _rms(x, w[p + "attn_norm.scale"], eps)
    q = mm(y, w[p + "attn.q.kernel"].reshape(d, -1)).view(b, s, h, -1)
    kv = mm(y, w[p + "attn.kv_a.kernel"])
    c_kv, k_r = kv.split([rank, rope], dim=-1)
    kv = mm(_rms(c_kv, w[p + "attn.kv_norm.scale"], eps),
            w[p + "attn.kv_b.kernel"].reshape(rank, -1)).view(b, s, h, -1)
    k_nope, v = kv.split([nope, vd], dim=-1)
    theta = cfg["rope_theta"]
    q = torch.cat([q[..., :nope], _rope(q[..., nope:], theta)], dim=-1)
    k = torch.cat([k_nope, _rope(k_r[:, :, None], theta).expand(
        b, s, h, rope)], dim=-1)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # [b, h, s, .]
    scale = (nope + rope) ** -0.5
    o = torch.cat([
        checkpoint(_attention_block, q[:, :, q0:q0 + BLOCK_Q],
                   k[:, :, :q0 + BLOCK_Q], v[:, :, :q0 + BLOCK_Q], q0, scale,
                   fp8, use_reentrant=False)
        for q0 in range(0, s, BLOCK_Q)], dim=2)
    x = x + mm(o.transpose(1, 2).reshape(b, s, h * vd),
               w[p + "attn.o.kernel"].reshape(h * vd, d))

    y = _rms(x, w[p + "mlp_norm.scale"], eps)
    if i < cfg["first_k_dense_replace"]:
        return x + _swiglu(y, w[p + "mlp.gate.kernel"], w[p + "mlp.up.kernel"],
                           w[p + "mlp.down.kernel"], fp8), None, None
    lo, held, n_router = _held(cfg)
    k_top = cfg["num_experts_per_tok"]
    flat = y.reshape(b * s, d)
    scores = mm(flat, w[p + "mlp.router"].t()).sigmoid()
    idx = torch.topk(scores.detach() + bias, k_top, dim=-1).indices
    g = scores.gather(-1, idx)
    g = g / (g.sum(-1, keepdim=True) + 1e-20) * cfg["routed_scaling_factor"]
    routed = torch.zeros_like(flat)
    w1, w2 = w[p + "mlp.experts.w1"], w[p + "mlp.experts.w2"]
    f = w2.shape[1]
    for e in range(held):
        # an expert that no token chose still enters the graph, with rows
        # of none: its gradient is 0, as the program's
        chose = idx == lo + e  # [T, k]: at most one true a row
        tok = chose.any(-1).nonzero()[:, 0]
        ge = (g * chose)[tok].sum(-1, keepdim=True)
        ye = _swiglu(flat[tok], w1[e, :, :f], w1[e, :, f:], w2[e], fp8)
        routed = routed.index_add(0, tok, ge * ye)
    shared = _swiglu(y, w[p + "mlp.shared.gate.kernel"],
                     w[p + "mlp.shared.up.kernel"],
                     w[p + "mlp.shared.down.kernel"], fp8)
    # sequence-wise balance loss over all the router's experts
    chosen = idx.view(b, s * k_top)
    counts = torch.zeros(b, n_router, device=x.device).scatter_add_(
        1, chosen, torch.ones(chosen.shape, device=x.device))
    frac = counts * (n_router / (k_top * s))
    prob = (scores / scores.sum(-1, keepdim=True)).view(b, s, -1).mean(1)
    aux = cfg["balance_loss_alpha"] * (frac * prob).sum(-1).mean()
    load = torch.zeros(n_router, device=x.device).index_add_(
        0, idx.reshape(-1), torch.ones(idx.numel(), device=x.device))
    return x + shared + routed.view(b, s, d), aux, load


def loss(w: dict, tokens: torch.Tensor, cfg, fp8: bool = False):
    """Next-token cross-entropy of ``tokens`` [batch, seq] plus the
    balance loss; moves each layer's correction bias for the next step."""
    eps, speed = cfg["rms_norm_eps"], cfg["bias_update_speed"]
    _, _, n_router = _held(cfg)
    x = w["embed.embedding"][tokens]
    aux, moves = 0.0, []
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        router = w.get(p + "mlp.router")
        bias = None
        if router is not None:
            if not hasattr(router, "correction_bias"):
                router.correction_bias = torch.zeros(n_router,
                                                     device=x.device)
            bias = router.correction_bias.clone()
        x, a, load = checkpoint(_layer, x, w, p, cfg, i, bias, fp8,
                                use_reentrant=False)
        if a is not None:
            aux = aux + a
            moves.append((router, load))
    for router, load in moves:
        router.correction_bias += speed * torch.sign(load.mean() - load)
    logits = operand(_rms(x, w["final_norm.scale"], eps), fp8) \
        @ operand(w["head.kernel"], fp8)
    v = logits.shape[-1]
    return F.cross_entropy(logits[:, :-1].reshape(-1, v),
                           tokens[:, 1:].reshape(-1)) + aux


def train_flops(cfg, traffic) -> float:
    """Model operations of one training step: 6 x the products' parameters
    x tokens, the routed experts counted at their expected share of a
    token (top-k x held / router experts), the router's product counted,
    the embedding (a lookup) and the norms not; plus 6 x seq x heads x
    (qk head dim + v head dim) a token a layer for attention's two
    products, forward and backward, not halved for causality. Recomputed
    work is not counted."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    vd, rank = cfg["v_head_dim"], cfg["kv_lora_rank"]
    f, dense = cfg["moe_intermediate_size"], cfg["intermediate_size"]
    _, held, n_router = _held(cfg)
    k_top = cfg["num_experts_per_tok"]
    layers, first = cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    attn = d * h * (nope + rope) + d * (rank + rope) + rank * h * (nope + vd) \
        + h * vd * d
    moe = (n_router * d + 3 * d * cfg["n_shared_experts"] * f
           + k_top * held / n_router * 3 * d * f)
    params = (layers * attn + first * 3 * d * dense + (layers - first) * moe
              + d * cfg["vocab_size"])
    tokens = traffic["batch"] * traffic["seq"]
    return (6 * params * tokens
            + 6 * traffic["seq"] * h * (nope + rope + vd) * layers * tokens)
