"""Models the port trains. Counterpart of ``byteps_tpu.models``: the
GPT-style decoder (``transformer``), ResNet-18/34/50/101 with BatchNorm
(``resnet``), VGG-16/19 (``vgg``) and the MLP (``mlp``), each with a
``from_flax`` in its module (``from_flax`` here is the decoder's). The
encoder and Llama are not ported yet."""

from byteps_tpu_torch.models.mlp import MLP  # noqa: F401
from byteps_tpu_torch.models.resnet import (  # noqa: F401
    ResNet,
    ResNet18,
    ResNet34,
    ResNet50,
    ResNet101,
)
from byteps_tpu_torch.models.transformer import (  # noqa: F401
    GPT2Small,
    TransformerLM,
    from_flax,
    lm_loss,
)
from byteps_tpu_torch.models.vgg import VGG, VGG16, VGG19  # noqa: F401
