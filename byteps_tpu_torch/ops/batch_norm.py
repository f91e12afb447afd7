"""Batch norm with an optional ReLU: a hand-written Hopper kernel pair plus
its plain version.

Replaces no TPU kernel: flax's ``nn.BatchNorm`` (``byteps_tpu/models/
resnet.py``) is left to XLA, which fuses it with its neighbours. Run as
PyTorch ops, the norm made an f32 copy of each bf16 activation, squared
it, took two means, normalised in f32 and cast back, and autograd kept the
f32 copies for its backward: about 176 bytes an element over forward and
backward, with the ReLU after it. It is bound by bytes, as every
normalisation is; ``csrc/batch_norm.cu`` moves about 16 bytes an element
in bf16 (forward: x read twice, y written; backward: x and dy read twice,
dx written), keeps the statistics in f32 and saves only x and three f32
vectors a channel for the backward, which recomputes xhat and the ReLU
mask with the forward's own arithmetic. Its note says how.

Numerics, flax's (``_plain``): statistics in f32 over (N, H, W), var =
max(E[x^2] - E[x]^2, 0), the biased var into the running average with
momentum 0.9 (the old average's weight), eps 1e-5, y = (x - mean) *
(rsqrt(var + eps) * scale) + bias in f32, then the ReLU, cast to x's dtype.

``batch_norm`` runs the plain version when x lies on the CPU and the
kernels, or raises, when it lies on a CUDA device: those take bf16 or f32
``channels_last`` (NHWC-dense) activations. ``LAUNCHES[name]`` counts the
kernel entries called (``train``: statistics, their combination and the
normalise pass; ``eval``: the normalise pass; ``backward``: its three
passes); the plain version never counts. While a step trace runs
(``utils.timeline.start_steps``) each entry also counts in the current
step record's ``bn_launches``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from byteps_tpu_torch.utils import timeline as _tl

MOMENTUM = 0.9  # flax's convention: weight of the old running average
EPS = 1e-5

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 256
# blocks a launch aims at: two waves of the three 256-thread blocks that
# each of the H100's 132 SMs holds at once (the kernels' launch bounds)
TARGET_BLOCKS = 132 * 3 * 2

LAUNCHES = {"train": 0, "eval": 0, "backward": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# --- plain PyTorch version --------------------------------------------------

def _plain(x, scale, bias, mean, var, training: bool, relu: bool):
    """Batch norm of NCHW (any memory format) ``x`` over its channels in
    torch ops, in f32 (float64 for float64 ``x``), output in x's dtype.
    Train mode normalises by the batch's statistics and updates ``mean``
    and ``var`` in place; eval mode uses them."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    if training:
        m = xf.mean((0, 2, 3))
        v = torch.clamp((xf * xf).mean((0, 2, 3)) - m * m, min=0.0)
        with torch.no_grad():
            mean.copy_(MOMENTUM * mean + (1 - MOMENTUM) * m)
            var.copy_(MOMENTUM * var + (1 - MOMENTUM) * v)
    else:
        m, v = mean, var
    mul = torch.rsqrt(v + EPS) * scale
    y = (xf - m[:, None, None]) * mul[:, None, None]
    y = y + bias[:, None, None]
    if relu:
        y = F.relu(y)
    return y.to(x.dtype)


def _plain_backward(x, dy, scale, bias, mean, var, keep, relu: bool):
    """The kernels' backward in torch ops (dx, dscale, dbias), from the
    forward's statistics: ``keep`` (1 where E[x^2] - E[x]^2 was not
    clipped) in train mode, None for eval's running statistics. With xc =
    x - mean, mul = rstd * scale and dy' = dy under the ReLU mask
    (recomputed from xc): dbias = sum dy', dscale = rstd sum dy' xc, dx =
    mul dy' - (xc cx + bx) with bx = mul dbias / n and cx = mul rstd
    dscale / n (0 where var was clipped, and both 0 in eval). The CPU
    tests hold it to autograd of ``_plain``."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    d = dy.to(xf.dtype)
    rstd = torch.rsqrt(var + EPS)
    mul = rstd * scale
    xc = xf - mean[:, None, None]
    if relu:
        d = d * (xc * mul[:, None, None] + bias[:, None, None] > 0)
    dbias = d.sum((0, 2, 3))
    dscale = rstd * (d * xc).sum((0, 2, 3))
    dx = d * mul[:, None, None]
    if keep is not None:
        n = x.numel() // x.shape[1]
        bx = mul * dbias / n
        cx = keep * mul * rstd * dscale / n
        dx = dx - (xc * cx[:, None, None] + bx[:, None, None])
    return dx.to(x.dtype), dscale, dbias


# --- kernel wrappers --------------------------------------------------------

class Geometry(NamedTuple):
    """A launch over [rows, C]: ``vec`` channels a thread load, a block of
    ``tx`` x ``ty`` threads (tx along C), a grid of ``tiles`` channel
    tiles x ``slabs`` row slabs of ``rows_per_slab`` rows."""
    vec: int
    tx: int
    ty: int
    tiles: int
    slabs: int
    rows_per_slab: int


def geometry(rows: int, channels: int, elem: int,
             aligned: bool = True) -> Geometry:
    """The launch of every pass over ``rows`` x ``channels`` elements of
    ``elem`` bytes: 16-byte loads along C where C allows (and the
    pointers are ``aligned``), up to 32 threads across a tile of
    channels, the rest of the block's 256 down the rows, and as many row
    slabs as bring the grid to about TARGET_BLOCKS blocks, each thread
    with at least one row."""
    per16 = 16 // elem
    vec = per16 if aligned and channels % per16 == 0 else 1
    groups = channels // vec
    tx = min(groups, 32)
    ty = THREADS // tx
    tiles = -(-groups // tx)
    slabs = max(1, min(-(-TARGET_BLOCKS // tiles), -(-rows // ty)))
    rows_per_slab = -(-rows // slabs)
    return Geometry(vec, tx, ty, tiles, -(-rows // rows_per_slab),
                    rows_per_slab)


_lib = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from byteps_tpu_torch.ops import _cuda_lib
        lib = _cuda_lib.load("batch_norm")
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        lib.btt_bn_forward.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i,
                                       ll, i, i, i, i, i, ll, f, f, f, p]
        lib.btt_bn_backward.argtypes = [p, p, p, p, p, p, p, p, p, p, p, p,
                                        i, i, i, ll, i, i, i, i, i, ll, f, p]
        for fn in (lib.btt_bn_forward, lib.btt_bn_backward):
            fn.restype = ctypes.c_int
        lib.btt_bn_error_string.argtypes = [ctypes.c_int]
        lib.btt_bn_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _kernels().btt_bn_error_string(rc).decode()
        raise RuntimeError(f"batch norm {what} launch failed: {msg} "
                           f"(cudaError {rc})")


def _check(x, *vectors) -> None:
    """Raise on anything the kernels do not take."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"batch norm kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous(
            memory_format=torch.channels_last):
        raise ValueError(f"batch norm kernel needs a channels_last (NHWC-"
                         f"dense) [N, C, H, W] tensor, got shape "
                         f"{tuple(x.shape)} strides {x.stride()}")
    c = x.shape[1]
    for t in vectors:
        if (t.dtype != torch.float32 or tuple(t.shape) != (c,)
                or not t.is_contiguous() or t.device != x.device):
            raise ValueError(f"batch norm kernel needs contiguous f32 "
                             f"[{c}] scale, bias and statistics on "
                             f"{x.device}")


def _launch_geometry(*tensors) -> Geometry:
    x = tensors[0]
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    return geometry(x.numel() // x.shape[1], x.shape[1], x.element_size(),
                    aligned)


def _count(name: str) -> None:
    LAUNCHES[name] += 1
    tr = _tl.steps
    if tr is not None:
        rec = tr.current()
        rec["bn_launches"] = rec.get("bn_launches", 0) + 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _forward(x, scale, bias, mean, var, training: bool, relu: bool):
    """The kernels' forward: (y, stats) where stats is [3, C] f32 (the
    batch's mean and var, and 1 where var was not clipped) in train mode,
    and None in eval."""
    _check(x, scale, bias, mean, var)
    c = x.shape[1]
    y = torch.empty_like(x)
    g = _launch_geometry(x, y)
    stats = part = None
    if training:
        stats = torch.empty((3, c), dtype=torch.float32, device=x.device)
        part = torch.empty((2, g.slabs, c), dtype=torch.float32,
                           device=x.device)
    rc = _kernels().btt_bn_forward(
        x.data_ptr(), y.data_ptr(), None if part is None else part.data_ptr(),
        None if stats is None else stats.data_ptr(), mean.data_ptr(),
        var.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        _DTYPE_CODES[x.dtype], g.vec, int(relu), int(training),
        x.numel() // c, c, g.tx, g.ty, g.tiles, g.slabs, g.rows_per_slab,
        EPS, MOMENTUM, 1 - MOMENTUM, _stream(x))
    _raise_on(rc, "forward")
    _count("train" if training else "eval")
    return y, stats


def _backward(x, dy, scale, bias, mean, var, keep, relu: bool):
    """The kernels' backward: (dx, dscale, dbias) from the forward's
    statistics (``keep`` None for eval's running statistics)."""
    _check(x, scale, bias, mean, var)
    dy = dy.to(x.dtype).contiguous(memory_format=torch.channels_last)
    c = x.shape[1]
    dx = torch.empty_like(x)
    dscale = torch.empty_like(scale)
    dbias = torch.empty_like(bias)
    g = _launch_geometry(x, dy, dx)
    part = torch.empty((2, g.slabs, c), dtype=torch.float32, device=x.device)
    coef = torch.empty((2, c), dtype=torch.float32, device=x.device)
    rc = _kernels().btt_bn_backward(
        x.data_ptr(), dy.data_ptr(), dx.data_ptr(), part.data_ptr(),
        mean.data_ptr(), var.data_ptr(),
        None if keep is None else keep.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), dscale.data_ptr(), dbias.data_ptr(), coef.data_ptr(),
        _DTYPE_CODES[x.dtype], g.vec, int(relu), x.numel() // c, c, g.tx,
        g.ty, g.tiles, g.slabs, g.rows_per_slab, EPS, _stream(x))
    _raise_on(rc, "backward")
    _count("backward")
    return dx, dscale, dbias


class _BatchNorm(torch.autograd.Function):
    """Forward through the kernels; saves x and the f32 statistics (the
    batch's, or copies of the running ones in eval), and its backward is
    the kernels' backward."""

    @staticmethod
    def forward(ctx, x, scale, bias, mean, var, training, relu):
        y, stats = _forward(x, scale, bias, mean, var, training, relu)
        if stats is None:
            stats = torch.stack((mean, var))
        ctx.save_for_backward(x, scale, bias, stats)
        ctx.relu = relu
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, scale, bias, stats = ctx.saved_tensors
        keep = stats[2] if stats.shape[0] == 3 else None
        dx, dscale, dbias = _backward(x, dy, scale, bias, stats[0], stats[1],
                                      keep, ctx.relu)
        return dx, dscale, dbias, None, None, None, None


def batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               mean: torch.Tensor, var: torch.Tensor, training: bool,
               relu: bool = False) -> torch.Tensor:
    """Batch norm of ``x`` [N, C, H, W] over its channels, then ``relu``
    if asked, in x's dtype: f32 ``scale`` and ``bias``, f32 running
    statistics ``mean`` and ``var`` (updated in place in ``training``
    mode, used in eval mode). The plain version on the CPU; the kernels,
    which take bf16 or f32 ``channels_last`` x, on a CUDA device."""
    if x.device.type == "cpu":
        return _plain(x, scale, bias, mean, var, training, relu)
    if x.device.type != "cuda":
        raise ValueError(f"batch norm runs on the CPU or a CUDA device, "
                         f"got {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return _BatchNorm.apply(x, scale, bias, mean, var, training, relu)
    return _forward(x, scale, bias, mean, var, training, relu)[0]
