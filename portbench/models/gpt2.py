"""GPT-2 through the port: ``byteps_tpu_torch.models.GPT2Small``-style
``TransformerLM`` at the configuration's sizes, flash attention, f32
parameters and bf16 products, the port's ``lm_loss``."""

from __future__ import annotations

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


def build(cfg, weights: dict, device):
    from byteps_tpu_torch.models import TransformerLM, lm_loss

    with torch.device("meta"):
        model = TransformerLM(
            vocab_size=cfg["vocab_size"], num_layers=cfg["n_layer"],
            d_model=cfg["n_embd"], num_heads=cfg["n_head"],
            mlp_dim=cfg["n_inner"] or 4 * cfg["n_embd"],
            max_len=cfg["n_positions"], dtype=_DTYPES[cfg["compute_dtype"]],
            attn_impl=cfg["attention"], device="meta")
    model = model.to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    model.train()

    def loss_fn(model, tokens):
        return lm_loss(model(tokens), tokens)
    return model, loss_fn
