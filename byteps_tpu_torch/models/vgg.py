"""VGG with flax's numerics: the huge-``fc1`` image model.

Counterpart of ``byteps_tpu/models/vgg.py`` (``VGG``, ``VGG16``,
``VGG19``): 3x3 SAME convolutions with bias (stride 1, so the pad is
symmetric) and ReLU, 2x2 max-pools, then ``fc1``, ``fc2`` in ``dtype``
and an f32 ``fc3``; no BatchNorm. Parameters are f32.

The flax module flattens NHWC activations, so ``fc1``'s rows are in
(h, w, c) order. This module permutes the activations to NHWC before it
flattens (free in ``channels_last``, where that permutation is already
contiguous), so ``fc1``'s kernel is flax's as it is.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from byteps_tpu_torch._device import resolve_device
from byteps_tpu_torch.models.resnet import Conv, flax_state_dict
from byteps_tpu_torch.models.transformer import Dense

# Conv filter counts per stage; "M" = 2x2 max-pool.
_VGG16 = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
          512, 512, 512, "M", 512, 512, 512, "M")
_VGG19 = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
          512, 512, 512, 512, "M", 512, 512, 512, 512, "M")


class VGG(nn.Module):
    """VGG over NCHW images of ``image_size`` (which fixes ``fc1``'s
    width); returns f32 logits. Parameters are drawn on the CPU from
    ``generator`` (seed 0 when None) and moved to ``device`` (the current
    CUDA device when None) in ``channels_last``."""

    def __init__(self, cfg: Sequence = _VGG16, num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16, image_size: int = 224,
                 generator: Optional[torch.Generator] = None,
                 device: "torch.device | str | None" = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg, self.dtype = tuple(cfg), dtype
        cin, side = 3, image_size
        for i, c in enumerate(self.cfg):
            if c == "M":
                side //= 2
            else:
                self.add_module(f"conv_{i}", Conv(cin, c, 3, 1, dtype,
                                                  generator, bias=True))
                cin = c
        self.fc1 = Dense((side * side * cin,), (4096,), dtype, generator)
        self.fc2 = Dense((4096,), (4096,), dtype, generator)
        self.fc3 = Dense((4096,), (num_classes,), torch.float32, generator)
        self.to(resolve_device(device), memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        for i, c in enumerate(self.cfg):
            if c == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = F.relu(getattr(self, f"conv_{i}")(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        return self.fc3(x).float()


VGG16 = partial(VGG, cfg=_VGG16)
VGG19 = partial(VGG, cfg=_VGG19)


def from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """A ``VGG`` state_dict from the flax module's parameter tree (with
    or without the ``params`` level): names map one to one (``conv_i``,
    ``fc1``-``fc3``), conv kernels go from HWIO to OIHW."""
    if set(params) == {"params"}:
        params = params["params"]
    return flax_state_dict((params,), lambda key: key.replace("/", "."))
