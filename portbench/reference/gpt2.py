"""Plain GPT-2 (Radford et al. 2019): the decoder of ``configs/gpt2-small``
in f32, written from the published architecture.

Pre-LN blocks (layer norm, causal multi-head attention, residual; layer
norm, tanh GELU MLP of 4 x n_embd, residual), a final layer norm and the
output head tied to the token embedding; next-token cross-entropy over
every position but the last. Departures from the published model, all
stated by the configuration: no dropout, and its ``layer_norm_epsilon``.

The parameter names and layouts are the port's state_dict (a query
kernel is [n_embd, n_head, head_dim], as flax lays it out), so the
benchmark hands both sides one dict of weights.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference import operand


def _sizes(cfg):
    d, h = cfg["n_embd"], cfg["n_head"]
    return d, h, d // h, cfg["n_inner"] or 4 * d


def specs(cfg) -> list:
    """[(name, shape, init)]: GPT-2's initialisation, N(0, 0.02) for
    weights and embeddings, with the residual projections' std scaled by
    1 / sqrt(2 n_layer); biases 0, layer norm scales 1."""
    d, h, hd, inner = _sizes(cfg)
    std = cfg["initializer_range"]
    resid = std / math.sqrt(2 * cfg["n_layer"])
    out = [("tok_embed.embedding", (cfg["vocab_size"], d), ("normal", std)),
           ("pos_embed.embedding", (cfg["n_positions"], d),
            ("normal", std))]
    for i in range(cfg["n_layer"]):
        p = f"layers.{i}."
        out += [(p + "ln_0.scale", (d,), ("ones",)),
                (p + "ln_0.bias", (d,), ("zeros",))]
        for proj in ("query", "key", "value"):
            out += [(p + f"attention.{proj}.kernel", (d, h, hd),
                     ("normal", std)),
                    (p + f"attention.{proj}.bias", (h, hd), ("zeros",))]
        out += [(p + "attention.out.kernel", (h, hd, d), ("normal", resid)),
                (p + "attention.out.bias", (d,), ("zeros",)),
                (p + "ln_1.scale", (d,), ("ones",)),
                (p + "ln_1.bias", (d,), ("zeros",)),
                (p + "mlp_in.kernel", (d, inner), ("normal", std)),
                (p + "mlp_in.bias", (inner,), ("zeros",)),
                (p + "mlp_out.kernel", (inner, d), ("normal", resid)),
                (p + "mlp_out.bias", (d,), ("zeros",))]
    out += [("final_ln.scale", (d,), ("ones",)),
            ("final_ln.bias", (d,), ("zeros",))]
    return out


def loss(w: dict, tokens: torch.Tensor, cfg, fp8: bool = False):
    """Mean next-token cross-entropy of ``tokens`` [batch, seq]."""
    d, h, hd, _ = _sizes(cfg)
    eps = cfg["layer_norm_epsilon"]
    b, s = tokens.shape

    def mm(a, m):
        return operand(a, fp8) @ operand(m, fp8)

    def ln(x, name):
        return F.layer_norm(x, (d,), w[name + ".scale"], w[name + ".bias"],
                            eps=eps)

    causal = torch.ones(s, s, dtype=torch.bool,
                        device=tokens.device).triu(1)
    x = w["tok_embed.embedding"][tokens] + w["pos_embed.embedding"][:s]
    for i in range(cfg["n_layer"]):
        p = f"layers.{i}."
        y = ln(x, p + "ln_0")
        q, k, v = (
            (mm(y, w[p + f"attention.{n}.kernel"].reshape(d, d))
             + w[p + f"attention.{n}.bias"].reshape(d)
             ).view(b, s, h, hd).transpose(1, 2)
            for n in ("query", "key", "value"))
        scores = mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
        probs = scores.masked_fill(causal, float("-inf")).softmax(-1)
        o = mm(probs, v).transpose(1, 2).reshape(b, s, d)
        x = x + mm(o, w[p + "attention.out.kernel"].reshape(d, d)) \
            + w[p + "attention.out.bias"]
        y = ln(x, p + "ln_1")
        y = F.gelu(mm(y, w[p + "mlp_in.kernel"]) + w[p + "mlp_in.bias"],
                   approximate="tanh")
        x = x + mm(y, w[p + "mlp_out.kernel"]) + w[p + "mlp_out.bias"]
    logits = mm(ln(x, "final_ln"), w["tok_embed.embedding"].T)
    return F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1))


def train_flops(cfg, traffic) -> float:
    """Model operations of one training step: 6 x parameters x tokens
    (the position table is a lookup, not a product) plus 12 x layers x
    n_embd x seq x tokens for attention's two products, forward and
    backward, not halved for causality. Recomputed work is not
    counted."""
    d, _, _, inner = _sizes(cfg)
    per_layer = 4 * d * d + 4 * d + 2 * d * inner + inner + d + 4 * d
    params = (cfg["vocab_size"] * d + cfg["n_layer"] * per_layer + 2 * d)
    tokens = traffic["batch"] * traffic["seq"]
    return (6 * params * tokens
            + 12 * cfg["n_layer"] * d * traffic["seq"] * tokens)
