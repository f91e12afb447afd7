"""Plain DeepSeek-V3 (arXiv:2412.19437 §2.1) in f32 for the port's CPU
tests: the decoder that ``byteps_tpu_torch.models.deepseek`` builds,
written again from the paper with plain torch operations, on a dict of
weights under the port's state_dict names. It imports nothing of the
port and nothing of JAX.

Per layer, pre-norm: RMSNorm, multi-head latent attention (§2.1.1, no
query compression: q = x W_q, heads of nope + rope; [c_kv, k_r] = x
W_kva; c_kv = RMSNorm(c_kv); [k_nope, v] = c_kv W_kvb; RoPE on q_rope and
on the one k_r every head shares; causal softmax scaled by (nope +
rope)^-1/2; o W_o), residual; RMSNorm, a SwiGLU (the leading dense
layers) or the expert layer (§2.1.2: s = sigmoid(x W_r^T) over every
expert of the router; each token's top k of s + b, b the correction bias,
which chooses and never weighs; g = the chosen s over their sum, times
the routed scaling factor; sum over the chosen experts in ``held`` of g_e
SwiGLU_e(x), plus the shared experts' SwiGLU), residual; a final RMSNorm
and an untied head. Loss: next-token cross-entropy plus the sequence-wise
balance loss alpha sum_i f_i P_i a sequence, averaged over sequences (f_i
= E / (k S) times the sequence's tokens that chose i, P_i the mean of s_i
/ sum_j s_j). After each training step b_i += speed sign(mean load -
load_i) over the step's loads.

Departures from the paper, as the port makes them: RoPE's pairs
interleaved (elements 2i, 2i + 1) where DeepSeek-V3's code reorders each
head into halves first (the scores are the same); only the experts
``held`` (the port's expert-parallel share) add their part, the others
being other chips' shares; the balance loss's alpha and the bias speed
are arguments.
"""

import math

import torch
import torch.nn.functional as F


def rms(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def rope(x, theta):
    """Interleaved pairs (2i, 2i + 1) of x [b, s, heads, r] rotated by
    angle position * theta^(-2i / r)."""
    s, r = x.shape[1], x.shape[-1]
    freqs = theta ** (-torch.arange(0, r, 2, dtype=torch.float32) / r)
    ang = torch.arange(s, dtype=torch.float32)[:, None] * freqs
    cos, sin = ang.cos()[None, :, None], ang.sin()[None, :, None]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                       dim=-1).flatten(-2)


def swiglu(x, gate, up, down):
    return (F.silu(x @ gate) * (x @ up)) @ down


def attention(x, w, p, hp):
    b, s, d = x.shape
    h, nope, r = hp["num_heads"], hp["qk_nope_dim"], hp["qk_rope_dim"]
    vd, rank = hp["v_dim"], hp["kv_lora_rank"]
    q = (x @ w[p + "q.kernel"].reshape(d, -1)).view(b, s, h, -1)
    c_kv, k_r = (x @ w[p + "kv_a.kernel"]).split([rank, r], dim=-1)
    kv = (rms(c_kv, w[p + "kv_norm.scale"], hp["eps"])
          @ w[p + "kv_b.kernel"].reshape(rank, -1)).view(b, s, h, -1)
    k_nope, v = kv.split([nope, vd], dim=-1)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], hp["rope_theta"])], -1)
    k = torch.cat([k_nope, rope(k_r[:, :, None], hp["rope_theta"]).expand(
        b, s, h, r)], -1)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(nope + r)
    live = torch.ones(s, s, dtype=torch.bool).tril()
    probs = scores.masked_fill(~live, float("-inf")).softmax(-1)
    o = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, h * vd)
    return o @ w[p + "o.kernel"].reshape(h * vd, d)


def route(y, router, bias, hp):
    """(s [T, E], chosen idx [T, k], weights g [T, k])."""
    scores = (y @ router.t()).sigmoid()
    idx = torch.topk(scores + bias, hp["top_k"], dim=-1).indices
    g = scores.gather(-1, idx)
    return scores, idx, g / g.sum(-1, keepdim=True) * hp["routed_scaling"]


def routed(y, w, p, idx, g, held):
    """sum over each token's chosen experts e in held = (lo, hi) of g_e
    SwiGLU_e(y); expert lo + j's weights are row j of the share's w1
    [held, d, 2 f] (gate, then up) and w2 [held, f, d]."""
    w1, w2 = w[p + "experts.w1"], w[p + "experts.w2"]
    f = w2.shape[1]
    out = torch.zeros_like(y)
    lo, hi = held
    for t in range(y.shape[0]):
        for j in range(idx.shape[1]):
            e = int(idx[t, j])
            if lo <= e < hi:
                out[t] = out[t] + g[t, j] * swiglu(
                    y[t], w1[e - lo, :, :f], w1[e - lo, :, f:], w2[e - lo])
    return out


def balance_loss(scores, idx, seqs, alpha):
    t, e = scores.shape
    k = idx.shape[1]
    s = t // seqs
    loss = 0.0
    for q in range(seqs):
        rows = slice(q * s, (q + 1) * s)
        counts = torch.zeros(e)
        for i in idx[rows].reshape(-1).tolist():
            counts[i] += 1
        frac = counts * e / (k * s)
        prob = (scores[rows] / scores[rows].sum(-1, keepdim=True)).mean(0)
        loss = loss + alpha * (frac * prob).sum()
    return loss / seqs


def expert_layer(y, w, p, bias, hp, held):
    """(the expert layer's output [b, s, d] from the held experts and the
    shared ones, its balance loss, its loads [E])."""
    b, s, d = y.shape
    flat = y.reshape(b * s, d)
    scores, idx, g = route(flat, w[p + "router"], bias, hp)
    out = routed(flat, w, p, idx, g, held) + swiglu(
        flat, w[p + "shared.gate.kernel"], w[p + "shared.up.kernel"],
        w[p + "shared.down.kernel"])
    loads = torch.bincount(idx.reshape(-1), minlength=scores.shape[1])
    return (out.view(b, s, d), balance_loss(scores, idx, b, hp["aux_alpha"]),
            loads.float())


def forward(w, tokens, biases, hp, held):
    """(f32 logits, the balance loss, {layer: loads})."""
    x = w["embed.embedding"][tokens]
    aux, loads = 0.0, {}
    for i in range(hp["num_layers"]):
        p = f"layers.{i}."
        x = x + attention(rms(x, w[p + "attn_norm.scale"], hp["eps"]), w,
                          p + "attn.", hp)
        y = rms(x, w[p + "mlp_norm.scale"], hp["eps"])
        if i < hp["first_dense"]:
            x = x + swiglu(y, w[p + "mlp.gate.kernel"], w[p + "mlp.up.kernel"],
                           w[p + "mlp.down.kernel"])
        else:
            out, a, loads[i] = expert_layer(y, w, p + "mlp.", biases[i], hp,
                                            held)
            x, aux = x + out, aux + a
    x = rms(x, w["final_norm.scale"], hp["eps"])
    return x @ w["head.kernel"], aux, loads


def loss(w, tokens, biases, hp, held):
    """(next-token cross-entropy + balance loss, {layer: loads})."""
    logits, aux, loads = forward(w, tokens, biases, hp, held)
    v = logits.shape[-1]
    ce = F.cross_entropy(logits[:, :-1].reshape(-1, v),
                         tokens[:, 1:].reshape(-1))
    return ce + aux, loads


def bias_update(biases, loads, speed):
    """The correction biases after a step with ``loads``."""
    return {i: b + speed * torch.sign(loads[i].mean() - loads[i])
            for i, b in biases.items()}
