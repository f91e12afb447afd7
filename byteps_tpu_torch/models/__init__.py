"""Models the port trains. Counterpart of ``byteps_tpu.models``: the
transformer family (``transformer``: the GPT-style decoder, the BERT-style
encoder with its MLM head, GPT-2 small and medium, BERT base and large),
the LLaMA family (``llama``: RMSNorm, RoPE, GQA, SwiGLU, remat),
DeepSeek-V3 (``deepseek``: latent attention, routed and shared experts;
Moonlight-16B-A3B),
ResNet-18/34/50/101 with BatchNorm (``resnet``), VGG-16/19 (``vgg``) and
the MLP (``mlp``), each with a ``from_flax`` in its module (``from_flax``
here is the transformer family's, which also names Llama's parameters).
The transformer family and Llama take an ``sp_group`` for sequence
parallelism, with ``sp_lm_loss`` as its loss."""

from byteps_tpu_torch.models.deepseek import (  # noqa: F401
    DeepseekTiny,
    DeepseekV3Model,
    Moonlight16B,
    moe_lm_loss,
)
from byteps_tpu_torch.models.llama import (  # noqa: F401
    Llama1B,
    Llama7B,
    LlamaModel,
    LlamaTiny,
)
from byteps_tpu_torch.models.mlp import MLP  # noqa: F401
from byteps_tpu_torch.models.resnet import (  # noqa: F401
    ResNet,
    ResNet18,
    ResNet34,
    ResNet50,
    ResNet101,
)
from byteps_tpu_torch.models.transformer import (  # noqa: F401
    BertBase,
    BertLarge,
    GPT2Medium,
    GPT2Small,
    TransformerEncoder,
    TransformerLM,
    from_flax,
    lm_loss,
    masked_lm_loss,
    sp_lm_loss,
)
from byteps_tpu_torch.models.vgg import VGG, VGG16, VGG19  # noqa: F401
