"""Wire compression around push_pull: the casts ``make_train_step``
applies before the reduction and undoes after it.

Counterpart of ``byteps_tpu/jax/compression.py`` (``none``, ``fp16``,
``bf16``). The int8 quantized transport is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class Compressor:
    """A (compress, decompress) pair applied around push_pull."""

    name: str
    compress: Callable[[torch.Tensor], torch.Tensor]
    decompress: Callable[[torch.Tensor, torch.dtype], torch.Tensor]


def _identity(x):
    return x


def _restore(x, dtype):
    return x.to(dtype)


class Compression:
    """Namespace of wire compressors (reference: Compression.none/fp16)."""

    none = Compressor("none", _identity, lambda x, d: x)
    fp16 = Compressor("fp16", lambda x: x.to(torch.float16), _restore)
    # bfloat16 keeps f32's exponent range, so gradient casts need no loss
    # scaling.
    bf16 = Compressor("bf16", lambda x: x.to(torch.bfloat16), _restore)
