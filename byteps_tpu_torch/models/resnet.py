"""ResNet v1.5 with flax's numerics, the flagship image model.

Counterpart of ``byteps_tpu/models/resnet.py`` (``ResNetBlock``,
``BottleneckResNetBlock``, ``ResNet``, ``ResNet18/34/50/101``). It takes
NCHW images, the PyTorch idiom, and runs in ``channels_last`` so that
cuDNN takes its NHWC tensor-core kernels. Where it departs from a
torchvision transcription, it follows the flax module:

- SAME padding: a 3x3 stride-2 convolution or max-pool pads (0, 1) on an
  even input, not (1, 1); ``same_pads`` computes XLA's split and the pad
  is explicit where it is uneven (-inf for the pool);
- BatchNorm: momentum 0.9 on the running average (torch would call it
  0.1), eps 1e-5, statistics in f32 as E[x^2] - E[x]^2 clipped at 0, the
  biased variance into the running average, the input normalised in f32
  and the output cast to ``dtype``; the last norm of each block starts
  with scale 0;
- parameters in f32, convolutions in ``dtype`` (bf16 by default), the
  global mean pool in ``dtype`` over an f32 sum, an f32 head and f32
  logits.

``from_flax(params, batch_stats)`` moves a flax variable tree over.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from byteps_tpu_torch._device import resolve_device
from byteps_tpu_torch.models.transformer import Dense, _flatten

_BN_MOMENTUM = 0.9  # flax's convention: weight of the old running average
_BN_EPS = 1e-5


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial axis: (low, high), the odd pixel
    on the high side."""
    total = max((math.ceil(size / stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _same(x: torch.Tensor, kernel: int, stride: int, value: float = 0.0):
    """(input, symmetric padding) for a SAME window op on ``x`` (N, C, H,
    W): an even split is left to the op; an uneven one is padded here with
    ``value``, in ``x``'s memory format (``F.pad`` returns NCHW)."""
    n, c, h, w = x.shape
    ph, pw = same_pads(h, kernel, stride), same_pads(w, kernel, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return x, (ph[0], pw[0])
    fmt = (torch.channels_last
           if x.is_contiguous(memory_format=torch.channels_last)
           else torch.contiguous_format)
    out = torch.empty((n, c, h + sum(ph), w + sum(pw)), dtype=x.dtype,
                      device=x.device, memory_format=fmt).fill_(value)
    out[:, :, ph[0]:ph[0] + h, pw[0]:pw[0] + w] = x
    return out, (0, 0)


class Conv(nn.Module):
    """flax ``Conv(dtype)``: an f32 ``weight`` (O, I, kH, kW) and, with
    ``bias``, an f32 ``bias``; input and weight are cast to ``dtype`` and
    the bias is added in ``dtype`` after the product. ``padding`` None is
    SAME, else the symmetric pad of each spatial axis."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int,
                 dtype: torch.dtype, generator: torch.Generator,
                 padding: Optional[int] = None, bias: bool = False):
        super().__init__()
        self.kernel, self.stride, self.padding = kernel, stride, padding
        self.dtype = dtype
        fan_in = cin * kernel * kernel
        self.weight = nn.Parameter(torch.empty(
            (cout, cin, kernel, kernel)).normal_(
                0.0, 1.0 / math.sqrt(fan_in), generator=generator))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.padding is None:
            x, pad = _same(x, self.kernel, self.stride)
        else:
            pad = (self.padding, self.padding)
        y = F.conv2d(x, self.weight.to(self.dtype), stride=self.stride,
                     padding=pad)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)[:, None, None]
        return y


class BatchNorm(nn.Module):
    """flax ``BatchNorm(momentum=0.9, epsilon=1e-5, dtype)`` over the
    channels of NCHW: parameters ``scale`` and ``bias``, running
    statistics ``mean`` and ``var`` (flax's ``batch_stats``), all f32.
    Train mode normalises by the batch's statistics and updates the
    running ones in place; eval mode uses the running ones."""

    def __init__(self, features: int, dtype: torch.dtype,
                 scale_init: float = 1.0):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.full((features,), scale_init))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training:
            mean = xf.mean((0, 2, 3))
            var = torch.clamp((xf * xf).mean((0, 2, 3)) - mean * mean,
                              min=0.0)
            with torch.no_grad():
                self.mean.copy_(_BN_MOMENTUM * self.mean
                                + (1 - _BN_MOMENTUM) * mean)
                self.var.copy_(_BN_MOMENTUM * self.var
                               + (1 - _BN_MOMENTUM) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + _BN_EPS) * self.scale
        y = (xf - mean[:, None, None]) * mul[:, None, None]
        return (y + self.bias[:, None, None]).to(self.dtype)


class ResNetBlock(nn.Module):
    """Basic two-conv residual block (ResNet-18/34)."""

    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int,
                 dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        self.conv_0 = Conv(cin, filters, 3, stride, dtype, generator)
        self.bn_0 = BatchNorm(filters, dtype)
        self.conv_1 = Conv(filters, filters, 3, 1, dtype, generator)
        self.bn_1 = BatchNorm(filters, dtype, scale_init=0.0)
        self.has_proj = stride != 1 or cin != filters
        if self.has_proj:
            self.conv_proj = Conv(cin, filters, 1, stride, dtype, generator)
            self.norm_proj = BatchNorm(filters, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn_0(self.conv_0(x)))
        y = self.bn_1(self.conv_1(y))
        if self.has_proj:
            x = self.norm_proj(self.conv_proj(x))
        return F.relu(x + y)


class BottleneckResNetBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck block (ResNet-50/101), the stride on
    the 3x3 (v1.5)."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int,
                 dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        self.conv_0 = Conv(cin, filters, 1, 1, dtype, generator)
        self.bn_0 = BatchNorm(filters, dtype)
        self.conv_1 = Conv(filters, filters, 3, stride, dtype, generator)
        self.bn_1 = BatchNorm(filters, dtype)
        self.conv_2 = Conv(filters, filters * 4, 1, 1, dtype, generator)
        self.bn_2 = BatchNorm(filters * 4, dtype, scale_init=0.0)
        self.has_proj = stride != 1 or cin != filters * 4
        if self.has_proj:
            self.conv_proj = Conv(cin, filters * 4, 1, stride, dtype,
                                  generator)
            self.norm_proj = BatchNorm(filters * 4, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn_0(self.conv_0(x)))
        y = F.relu(self.bn_1(self.conv_1(y)))
        y = self.bn_2(self.conv_2(y))
        if self.has_proj:
            x = self.norm_proj(self.conv_proj(x))
        return F.relu(x + y)


class ResNet(nn.Module):
    """ResNet over NCHW images; returns f32 logits. Train mode
    (``model.train()``, flax's ``train=True``) normalises by the batch and
    updates the running statistics; eval mode uses them.

    Parameters are drawn on the CPU from ``generator`` (seed 0 when None)
    and then moved to ``device`` (the current CUDA device when None) in
    ``channels_last``."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None,
                 device: "torch.device | str | None" = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.dtype = dtype
        self.conv_init = Conv(3, num_filters, 7, 2, dtype, generator,
                              padding=3)
        self.bn_init = BatchNorm(num_filters, dtype)
        blocks, cin = [], num_filters
        for i, n in enumerate(stage_sizes):
            filters = num_filters * 2 ** i
            for j in range(n):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(block_cls(cin, filters, stride, dtype,
                                        generator))
                cin = filters * block_cls.expansion
        self.blocks = nn.ModuleList(blocks)
        self.head = Dense((cin,), (num_classes,), torch.float32, generator)
        self.to(resolve_device(device), memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        x = F.relu(self.bn_init(self.conv_init(x)))
        x, pad = _same(x, 3, 2, float("-inf"))
        x = F.max_pool2d(x, 3, 2, padding=pad)
        for block in self.blocks:
            x = block(x)
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        x = x.mean((2, 3)).to(self.dtype)
        return self.head(x).float()


ResNet18 = partial(ResNet, stage_sizes=[2, 2, 2, 2], block_cls=ResNetBlock)
ResNet34 = partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=ResNetBlock)
ResNet50 = partial(ResNet, stage_sizes=[3, 4, 6, 3],
                   block_cls=BottleneckResNetBlock)
ResNet101 = partial(ResNet, stage_sizes=[3, 4, 23, 3],
                    block_cls=BottleneckResNetBlock)


def _torch_name(key: str) -> str:
    """flax path -> state_dict key: ``*ResNetBlock_k`` -> ``blocks.k``,
    ``Conv_j`` -> ``conv_j``, ``BatchNorm_j`` -> ``bn_j``, ``Dense_0`` ->
    ``head``."""
    parts = []
    for p in key.split("/"):
        block, _, k = p.rpartition("_")
        if block.endswith("ResNetBlock"):
            parts += ["blocks", k]
        elif block == "Conv":
            parts.append(f"conv_{k}")
        elif block == "BatchNorm":
            parts.append(f"bn_{k}")
        elif p == "Dense_0":
            parts.append("head")
        else:
            parts.append(p)
    return ".".join(parts)


def flax_state_dict(trees, rename) -> Dict[str, torch.Tensor]:
    """A state_dict from flax variable trees (nested dicts of numpy
    arrays), each path named by ``rename``; a conv ``kernel`` (4-D, HWIO)
    becomes an OIHW ``weight``."""
    sd = {}
    for tree in trees:
        for key, arr in _flatten(tree).items():
            arr = np.array(arr, dtype=np.float32)
            name = rename(key)
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
                name = name[:-len("kernel")] + "weight"
            sd[name] = torch.from_numpy(np.ascontiguousarray(arr))
    return sd


def from_flax(params: Mapping, batch_stats: Optional[Mapping] = None
              ) -> Dict[str, torch.Tensor]:
    """A ``ResNet`` state_dict from the flax module's ``params`` and
    ``batch_stats`` (``params`` may be the whole variable dict). The
    head's kernel keeps flax's [in, out] layout (``Dense``)."""
    if batch_stats is None and "batch_stats" in params:
        batch_stats = params["batch_stats"]
    if "params" in params:
        params = params["params"]
    return flax_state_dict((params, batch_stats or {}), _torch_name)
