"""DeepSeek-V3 through the port: ``byteps_tpu_torch.models.
DeepseekV3Model`` at the configuration's sizes, holding the configured
share of the routed experts, flash attention, f32 parameters and bf16
products, the port's ``moe_lm_loss`` (next-token cross-entropy and the
balance loss) and the model's correction-bias update once a step."""

from __future__ import annotations

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


def build(cfg, weights: dict, device):
    from byteps_tpu_torch.models import DeepseekV3Model, moe_lm_loss

    held = cfg["n_routed_experts"]
    lo = cfg["expert_rank"] * held
    with torch.device("meta"):
        model = DeepseekV3Model(
            vocab_size=cfg["vocab_size"],
            num_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
            num_heads=cfg["num_attention_heads"],
            qk_nope_dim=cfg["qk_nope_head_dim"],
            qk_rope_dim=cfg["qk_rope_head_dim"], v_dim=cfg["v_head_dim"],
            kv_lora_rank=cfg["kv_lora_rank"],
            dense_dim=cfg["intermediate_size"],
            expert_dim=cfg["moe_intermediate_size"],
            n_experts=held * cfg["expert_parallel"],
            top_k=cfg["num_experts_per_tok"],
            n_shared=cfg["n_shared_experts"],
            first_dense=cfg["first_k_dense_replace"],
            experts=(lo, lo + held),
            routed_scaling=cfg["routed_scaling_factor"],
            aux_alpha=cfg["balance_loss_alpha"],
            bias_speed=cfg["bias_update_speed"],
            rope_theta=float(cfg["rope_theta"]), eps=cfg["rms_norm_eps"],
            dtype=_DTYPES[cfg["compute_dtype"]], attn_impl=cfg["attention"],
            device="meta")
    model = model.to_empty(device=device)
    with torch.no_grad():
        for buf in model.buffers():  # the correction biases start at 0
            buf.zero_()
    kept = model.state_dict()  # the biases, not the step's loads
    model.load_state_dict(dict(weights, **{
        n: b for n, b in model.named_buffers() if n in kept}), strict=True)
    model.train()

    def loss_fn(model, tokens):
        # the program runs zero_grad, this loss, backward and the
        # optimizer's step once a step, so the step before this one has
        # ended here: its correction-bias update (a no-op before the
        # first step, whose loads are zero) before this step's choices
        model.update_bias()
        return moe_lm_loss(model(tokens), tokens)
    return model, loss_fn
