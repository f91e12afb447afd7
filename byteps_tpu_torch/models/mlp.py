"""Small MLP, the minimum end-to-end model.

Counterpart of ``byteps_tpu/models/mlp.py``: flatten, cast to ``dtype``,
then ``Dense`` layers (f32 parameters, both operands cast to ``dtype``)
with a ReLU between them and none after the last.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from byteps_tpu_torch._device import resolve_device
from byteps_tpu_torch.models.resnet import flax_state_dict
from byteps_tpu_torch.models.transformer import Dense


class MLP(nn.Module):
    """``in_features`` inputs (flax infers them from the first batch)
    through ``features``; the output is in ``dtype``. Parameters are drawn
    on the CPU from ``generator`` (seed 0 when None) and moved to
    ``device`` (the current CUDA device when None)."""

    def __init__(self, in_features: int,
                 features: Sequence[int] = (128, 128, 10),
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 device: "torch.device | str | None" = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.dtype = dtype
        widths = [in_features, *features]
        self.layers = nn.ModuleList([
            Dense((a,), (b,), dtype, generator)
            for a, b in zip(widths[:-1], widths[1:])])
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


def from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """An ``MLP`` state_dict from the flax module's parameter tree (with
    or without the ``params`` level): ``Dense_i`` -> ``layers.i``."""
    if set(params) == {"params"}:
        params = params["params"]
    return flax_state_dict(
        (params,), lambda key: key.replace("Dense_", "layers.")
        .replace("/", "."))
