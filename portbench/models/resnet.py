"""ResNet through the port: ``byteps_tpu_torch.models.ResNet`` with
bottleneck blocks at the configuration's stages, channels_last, bf16
convolutions, f32 parameters and statistics, train-mode batch norm, the
port's ``cross_entropy_loss``."""

from __future__ import annotations

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


def build(cfg, weights: dict, device):
    from byteps_tpu_torch.models.resnet import BottleneckResNetBlock, ResNet
    from byteps_tpu_torch.stateful import cross_entropy_loss

    with torch.device("meta"):
        model = ResNet(stage_sizes=cfg["stage_sizes"],
                       block_cls=BottleneckResNetBlock,
                       num_classes=cfg["num_classes"],
                       num_filters=cfg["num_filters"],
                       dtype=_DTYPES[cfg["compute_dtype"]], device="meta")
    model = model.to_empty(device=device).to(
        memory_format=torch.channels_last)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            buf.fill_(1.0 if name.endswith(".var") else 0.0)
    model.load_state_dict(dict(weights, **dict(model.named_buffers())),
                          strict=True)
    model.train()

    def loss_fn(model, batch):
        images, labels = batch
        return cross_entropy_loss(model(images), labels)
    return model, loss_fn
