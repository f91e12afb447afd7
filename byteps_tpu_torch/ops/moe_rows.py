"""The dropless expert layer's row passes on the held rows only: gather,
SwiGLU and combine, each a hand-written Hopper kernel plus its plain
version.

Replaces no TPU kernel: the JAX package has no dropless expert layer.
``parallel/moe.py`` ``_routed`` ran these passes as PyTorch ops over all
P = T k (token, expert) pair rows of its buffers, which are sized for the
worst case because the count of held rows stays on the card, while 4-12 %
of them are held at Moonlight's routing; each pass was a gather or an
elementwise op and a masked copy of [P, d] or [P, f], forward, recompute
and backward. They are bound by bytes. ``csrc/moe_rows.cu`` reads the
count on the card (``offs[-1]``, or ``mine``) and walks only the held
rows, so no block is launched for an absent row and the host never waits;
its note says how, and why no value of a row at or past ``offs[-1]``
(which ``torch._grouped_mm`` leaves unset) reaches an output or a
gradient: no kernel reads one.

Three autograd functions, whose adjoints reuse the same kernels:

- ``gather_rows(x, src, pos, mine, offs)``: xs[p] = x[src[p]] for p <
  offs[-1]; backward dx[t] = sum_j [mine[t k + j]] dxs[pos[t k + j]], the
  combine kernel (a per-token f32 sum in j order, no atomics);
- ``swiglu_rows(h, weight, offs)``: a = silu(g) u weight for h = [g | u]
  [P, 2f], in f32, rounded once; backward one pass writing dh = [dg | du]
  and dweight (an f32 row sum, 0 from offs[-1] on: ``weight`` carries the
  router's gradient);
- ``combine_rows(y, pos, mine, src, offs, k)``: out[t] = sum_j [mine[t k
  + j]] y[pos[t k + j]] for every token (0 where none is held), in f32,
  rounded once; backward dy[p] = dout[src[p]], the gather kernel.

Each runs its plain version (``*_plain``, PyTorch ops that zero the rows
past offs[-1]) when its tensors lie on the CPU, and its kernels, or
raises, on a CUDA device: bf16 or f32 rows whose widths d and f are
multiples of 8, int64 ``src`` and ``pos``, bool ``mine``, int32 ``offs``,
f32 ``weight``. ``LAUNCHES[name]`` counts the kernel entries called; the
plain versions never count. While a step trace runs
(``utils.timeline.start_steps``) each entry also counts in the current
step record's ``moe_row_launches``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from byteps_tpu_torch.utils import timeline as _tl

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = {"gather": 0, "combine": 0, "swiglu": 0, "swiglu_backward": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# --- plain PyTorch versions ---------------------------------------------------

def _held(offs: torch.Tensor, n: int) -> torch.Tensor:
    """[n] bool: row p is below offs[-1], the held pairs."""
    return torch.arange(n, device=offs.device) < offs[-1]


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def gather_plain(x, src, offs):
    """[P, d]: row p < offs[-1] is x[src[p]], the rest 0."""
    return torch.where(_held(offs, src.numel())[:, None], x[src], 0)


def combine_plain(y, pos, mine, k: int):
    """[P // k, d]: token t's sum of y[pos[t k + j]] over its mine pairs,
    in f32 (float64 for float64 y), in y's dtype."""
    back = torch.where(mine[:, None], y[pos], 0).to(_acc(y.dtype))
    return back.view(-1, k, y.shape[1]).sum(1).to(y.dtype)


def swiglu_plain(h, weight, offs):
    """[P, f]: silu(g) u weight for rows below offs[-1], 0 past them, in
    f32 (float64 for float64 h), in h's dtype."""
    g, u = h.to(_acc(h.dtype)).chunk(2, dim=-1)
    a = F.silu(g) * u * weight[:, None].to(g.dtype)
    return torch.where(_held(offs, h.shape[0])[:, None], a, 0).to(h.dtype)


def swiglu_backward_plain(h, weight, da, offs):
    """(dh [P, 2f] in h's dtype, dweight [P] in weight's) of
    ``swiglu_plain`` for rows below offs[-1], 0 past them: the kernel's
    arithmetic, which the CPU tests hold to autograd."""
    keep = _held(offs, h.shape[0])
    g, u = h.to(_acc(h.dtype)).chunk(2, dim=-1)
    dai = da.to(g.dtype)
    s = torch.sigmoid(g)
    silu = g * s
    m = dai * weight[:, None].to(g.dtype)
    dh = torch.cat([m * u * s * (1 + g * (1 - s)), m * silu], dim=-1)
    dw = (dai * (silu * u)).sum(-1)
    return (torch.where(keep[:, None], dh, 0).to(h.dtype),
            torch.where(keep, dw, 0).to(weight.dtype))


# --- kernel wrappers ----------------------------------------------------------

_lib = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from byteps_tpu_torch.ops import _cuda_lib
        lib = _cuda_lib.load("moe_rows")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.btt_moe_gather.argtypes = [p, p, p, i, p, ll, i, i, p]
        lib.btt_moe_combine.argtypes = [p, p, p, p, ll, i, i, i, p]
        lib.btt_moe_swiglu.argtypes = [p, p, p, i, p, ll, i, i, p]
        lib.btt_moe_swiglu_backward.argtypes = [p, p, p, p, i, p, p, ll, i,
                                                i, p]
        for fn in (lib.btt_moe_gather, lib.btt_moe_combine,
                   lib.btt_moe_swiglu, lib.btt_moe_swiglu_backward):
            fn.restype = ctypes.c_int
        lib.btt_moe_error_string.argtypes = [ctypes.c_int]
        lib.btt_moe_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _empty(shape, dtype, device) -> torch.Tensor:
    """An output or scratch buffer of a kernel entry: rows the kernel does
    not write are left as the allocator gives them."""
    return torch.empty(shape, dtype=dtype, device=device)


def _launch(name: str, fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        msg = _kernels().btt_moe_error_string(rc).decode()
        raise RuntimeError(f"expert row {name} launch failed: {msg} "
                           f"(cudaError {rc})")
    LAUNCHES[name] += 1
    tr = _tl.steps
    if tr is not None:
        rec = tr.current()
        rec["moe_row_launches"] = rec.get("moe_row_launches", 0) + 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _on_card(*rows) -> bool:
    """False for CPU tensors (the plain versions); True for CUDA row
    tensors the kernels take; raises on anything else."""
    dev = rows[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"expert row passes run on the CPU or a CUDA "
                         f"device, got {dev}")
    for t in rows:
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"expert row kernels take float32 or bfloat16, "
                            f"got {t.dtype}")
        if (t.dim() != 2 or not t.is_contiguous() or t.shape[1] % 8
                or t.data_ptr() % 16 or t.device != dev
                or t.dtype != rows[0].dtype):
            raise ValueError(f"expert row kernels need contiguous 16-byte "
                             f"aligned [rows, width] tensors of one dtype "
                             f"on {dev}, width a multiple of 8; got shape "
                             f"{tuple(t.shape)} strides {t.stride()}")
    return True


def _check_index(dev, src=None, pos=None, mine=None, offs=None,
                 weight=None, rows=None) -> None:
    """Raise unless each vector given is contiguous, of its dtype, on
    ``dev`` (``offs`` not empty, ``weight`` of ``rows`` entries)."""
    for name, t, dtype in (("src", src, torch.int64),
                           ("pos", pos, torch.int64),
                           ("mine", mine, torch.bool),
                           ("offs", offs, torch.int32),
                           ("weight", weight, torch.float32)):
        if t is not None and (t.dtype != dtype or t.dim() != 1
                              or not t.is_contiguous() or t.device != dev
                              or (name == "offs" and t.numel() == 0)
                              or (name == "weight" and t.numel() != rows)):
            raise ValueError(f"expert row kernels need a contiguous "
                             f"{dtype} vector {name} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _half_width(h) -> int:
    """f of h = [g | u] [P, 2f], which the kernels take a multiple of 8."""
    if h.shape[1] % 16:
        raise ValueError(f"expert row kernels need h [P, 2f] with f a "
                         f"multiple of 8, got width {h.shape[1]}")
    return h.shape[1] // 2


def _gather(x, src, offs):
    if not _on_card(x):
        return gather_plain(x, src, offs)
    _check_index(x.device, src=src, offs=offs)
    out = _empty((src.numel(), x.shape[1]), x.dtype, x.device)
    _launch("gather", _kernels().btt_moe_gather, x.data_ptr(),
            src.data_ptr(), offs.data_ptr(), offs.numel(), out.data_ptr(),
            src.numel(), x.shape[1], _DTYPE_CODES[x.dtype], _stream(x))
    return out


def _combine(y, pos, mine, k: int):
    if not _on_card(y):
        return combine_plain(y, pos, mine, k)
    _check_index(y.device, pos=pos, mine=mine)
    tokens = pos.numel() // k
    out = _empty((tokens, y.shape[1]), y.dtype, y.device)
    _launch("combine", _kernels().btt_moe_combine, y.data_ptr(),
            pos.data_ptr(), mine.data_ptr(), out.data_ptr(), tokens, k,
            y.shape[1], _DTYPE_CODES[y.dtype], _stream(y))
    return out


def _swiglu(h, weight, offs):
    if not _on_card(h):
        return swiglu_plain(h, weight, offs)
    _check_index(h.device, offs=offs, weight=weight, rows=h.shape[0])
    f = _half_width(h)
    a = _empty((h.shape[0], f), h.dtype, h.device)
    _launch("swiglu", _kernels().btt_moe_swiglu, h.data_ptr(),
            weight.data_ptr(), offs.data_ptr(), offs.numel(), a.data_ptr(),
            h.shape[0], f, _DTYPE_CODES[h.dtype], _stream(h))
    return a


def _swiglu_backward(h, weight, da, offs):
    if not _on_card(h):
        return swiglu_backward_plain(h, weight, da, offs)
    da = da.to(h.dtype).contiguous()
    _on_card(h, da)
    _check_index(h.device, offs=offs, weight=weight, rows=h.shape[0])
    f = _half_width(h)
    dh = _empty(h.shape, h.dtype, h.device)
    dw = _empty(weight.shape, torch.float32, h.device)
    _launch("swiglu_backward", _kernels().btt_moe_swiglu_backward,
            h.data_ptr(), weight.data_ptr(), da.data_ptr(), offs.data_ptr(),
            offs.numel(), dh.data_ptr(), dw.data_ptr(), h.shape[0], f,
            _DTYPE_CODES[h.dtype], _stream(h))
    return dh, dw


def _check_pairs(tokens: int, pairs: int) -> int:
    if tokens == 0 or pairs % tokens:
        raise ValueError(f"{pairs} pairs are not k for each of {tokens} "
                         f"tokens")
    return pairs // tokens


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, src, pos, mine, offs):
        ctx.k = _check_pairs(x.shape[0], src.numel())
        ctx.save_for_backward(pos, mine)
        return _gather(x, src, offs)

    @staticmethod
    @once_differentiable
    def backward(ctx, dxs):
        pos, mine = ctx.saved_tensors
        return _combine(dxs.contiguous(), pos, mine, ctx.k), None, None, \
            None, None


class _SwiGLURows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, weight, offs):
        ctx.save_for_backward(h, weight, offs)
        return _swiglu(h, weight, offs)

    @staticmethod
    @once_differentiable
    def backward(ctx, da):
        h, weight, offs = ctx.saved_tensors
        dh, dw = _swiglu_backward(h, weight, da, offs)
        return dh, dw, None


class _CombineRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, pos, mine, src, offs, k):
        ctx.save_for_backward(src, offs)
        return _combine(y, pos, mine, k)

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        src, offs = ctx.saved_tensors
        return _gather(dout.contiguous(), src, offs), None, None, None, \
            None, None


def gather_rows(x: torch.Tensor, src: torch.Tensor, pos: torch.Tensor,
                mine: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """[P, d]: each sorted pair's token row of ``x`` [T, d] (``src`` [P]),
    for the held pairs (rows below offs[-1]); ``pos`` and ``mine`` (the
    ``ExpertPlan``'s, [P]) give its backward."""
    return _GatherRows.apply(x, src, pos, mine, offs)


def swiglu_rows(h: torch.Tensor, weight: torch.Tensor,
                offs: torch.Tensor) -> torch.Tensor:
    """[P, f]: silu(g) u ``weight`` of ``h`` = [g | u] [P, 2f] for the held
    rows (below offs[-1]); ``weight`` [P] f32 gets its gradient."""
    return _SwiGLURows.apply(h, weight, offs)


def combine_rows(y: torch.Tensor, pos: torch.Tensor, mine: torch.Tensor,
                 src: torch.Tensor, offs: torch.Tensor,
                 k: int) -> torch.Tensor:
    """[T, d]: each token's sum of its held pairs' rows of ``y`` [P, d]
    (``pos``, ``mine``; P = T k), 0 for a token with none; ``src`` and
    ``offs`` give its backward."""
    return _CombineRows.apply(y, pos, mine, src, offs, k)
