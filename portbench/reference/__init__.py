"""Plain PyTorch references of the benchmark's models and optimizers, and
the weights and batches both sides are given.

Nothing here imports the port: the reference is handed the seed, makes
the same weights and batches the benchmark gave the program, and works
out again whatever the program derived from them. It computes in f32
with TF32 off (``exact_f32``); ``fp8`` is the control's rounding, the
nearest precision below the bf16 products the configurations state.
"""

from __future__ import annotations

import contextlib
import math

import torch

_GOLDEN = 0x9E3779B97F4A7C15


def sub_seed(seed: int, stream: int) -> int:
    """A generator seed for one use (``stream``) of the run's seed; any
    whole number a caller passes maps into 63 bits."""
    return (seed * _GOLDEN + stream * 0x632BE59BD9B4E019) % (1 << 63)


def make_weights(specs, seed: int, device) -> dict:
    """{name: f32 tensor} from ``specs`` [(name, shape, init)], where init
    is ("normal", std), ("zeros",) or ("ones",): every normal draw in one
    call of a generator on ``device``, in spec order."""
    n = sum(math.prod(shape) for _, shape, init in specs
            if init[0] == "normal")
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    flat = torch.empty(n, device=device).normal_(generator=gen)
    out, at = {}, 0
    for name, shape, init in specs:
        if init[0] == "normal":
            k = math.prod(shape)
            out[name] = flat[at:at + k].view(shape).mul_(init[1])
            at += k
        elif init[0] == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif init[0] == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            raise ValueError(f"unknown init {init!r} of {name}")
    return out


@contextlib.contextmanager
def exact_f32():
    """f32 products in f32: TF32 off for cuBLAS and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _round(x: torch.Tensor, fp8: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``fp8`` with one scale a tensor, which takes its
    largest magnitude to the format's largest."""
    scale = x.abs().amax().clamp_min(1e-30) / torch.finfo(fp8).max
    return (x / scale).to(fp8).to(x.dtype) * scale


class _RoundFp8(torch.autograd.Function):
    """fp8 training's rounding of a product's operand: e4m3 in the
    forward, and the gradient that flows back through it e5m2."""

    @staticmethod
    def forward(ctx, x):
        return _round(x.detach(), torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


def operand(x: torch.Tensor, fp8: bool) -> torch.Tensor:
    """An operand of a matrix product or convolution: as it is, or
    rounded to fp8 for the control."""
    return _RoundFp8.apply(x) if fp8 else x
