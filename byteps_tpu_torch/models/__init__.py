"""Models the port trains. Counterpart of ``byteps_tpu.models`` (only the
GPT-style decoder is ported yet)."""

from byteps_tpu_torch.models.transformer import (  # noqa: F401
    GPT2Small,
    TransformerLM,
    from_flax,
    lm_loss,
)
